"""Method registry: canonical name -> step engine (``ivp_tpu.methods``)."""
from __future__ import annotations

from .base import Engine, RunArgs, StepProposal  # noqa: F401
from . import erk


def get_engine(method: str, *, need_cont: bool, **overrides):
    """Build (Engine, params) for a canonical method name; ``overrides`` are
    the engine's ``solver_options``.  The explicit tier is ported; the stiff
    methods raise NotImplementedError naming their ROADMAP slice."""
    method = method.upper()
    if method in ("RK4", "RK23", "DOPRI5", "DOP853"):
        return erk.make_engine(method, need_cont, **overrides)
    if method in ("RADAU", "BDF"):
        raise NotImplementedError(
            f"method {method!r} is not ported yet: ROADMAP §1 item 7 "
            f"(the stiff tier)")
    raise ValueError(f"unknown method {method!r}")
