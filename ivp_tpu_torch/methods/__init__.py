"""Method registry: canonical name -> step engine (``ivp_tpu.methods``)."""
from __future__ import annotations

from .base import Engine, RunArgs, StepProposal  # noqa: F401
from . import erk


def get_engine(method: str, *, need_cont: bool, jac_fn=None, const_jac=False,
               mass=None, nind=(None, None, None), n=0, **overrides):
    """Build (Engine, params) for a canonical method name; ``overrides`` are
    the engine's ``solver_options``.  The explicit methods ignore the
    Jacobian; RADAU and BDF take ``jac_fn(t (B,), y (B, n)) -> (B, n, n)``
    (methods/jacobian.py builds it).  The mass matrix and the DAE index
    options raise NotImplementedError (ROADMAP §1 item 15)."""
    method = method.upper()
    if mass is not None and method != "RADAU":
        raise ValueError(
            f"mass matrices are only supported by method='Radau' "
            f"(got method={method!r} with mass=).  BDF and the explicit "
            f"methods integrate y' = f(t, y) only.")
    if method in ("RK4", "RK23", "DOPRI5", "DOP853"):
        return erk.make_engine(method, need_cont, **overrides)
    if method == "RADAU":
        from . import radau
        return radau.make_engine(need_cont, jac_fn=jac_fn,
                                 const_jac=const_jac, mass=mass, nind=nind,
                                 n=n, **overrides)
    if method == "BDF":
        from . import bdf
        return bdf.make_engine(need_cont, jac_fn=jac_fn, const_jac=const_jac,
                               n=n, **overrides)
    raise ValueError(f"unknown method {method!r}")
