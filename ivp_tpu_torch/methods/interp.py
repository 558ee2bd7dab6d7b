"""Dense-interpolant registry (``ivp_tpu.methods.interp``): a method's
interpolant without building its engine."""
from __future__ import annotations

from ..types import NCOEFF


def get_interp(method: str):
    """``(interp_fn, ncoeff)`` of a canonical method name.  The stiff
    methods raise NotImplementedError naming their ROADMAP slice."""
    method = method.upper()
    if method in ("RADAU", "BDF"):
        raise NotImplementedError(
            f"method {method!r} is not ported yet: ROADMAP §1 item 7 "
            f"(the stiff tier)")
    if method not in ("RK4", "RK23", "DOPRI5", "DOP853"):
        raise ValueError(f"unknown method {method!r}")
    from . import erk
    fn = {"RK4": erk.rk4_interp, "RK23": erk.rk23_interp,
          "DOPRI5": erk.dopri5_interp, "DOP853": erk.dop853_interp}[method]
    return fn, NCOEFF[method]
