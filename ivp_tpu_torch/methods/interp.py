"""Dense-interpolant registry (``ivp_tpu.methods.interp``): a method's
interpolant without building its engine."""
from __future__ import annotations

from ..types import NCOEFF


def get_interp(method: str):
    """``(interp_fn, ncoeff)`` of a canonical method name."""
    method = method.upper()
    if method in ("RK4", "RK23", "DOPRI5", "DOP853"):
        from . import erk
        fn = {"RK4": erk.rk4_interp, "RK23": erk.rk23_interp,
              "DOPRI5": erk.dopri5_interp, "DOP853": erk.dop853_interp}[method]
    elif method == "RADAU":
        from .radau import radau_interp as fn
    elif method == "BDF":
        from .bdf import bdf_interp as fn
    else:
        raise ValueError(f"unknown method {method!r}")
    return fn, NCOEFF[method]
