"""Engine protocol shared by the integrators (``ivp_tpu.methods.base``).

An *engine* is three functions that the driver (core/driver.py) composes:

* ``init(rhs, t0, y0, first_step, ra, p) -> (ms, nfev)``: the method state.
* ``attempt(rhs, t, y, naccpt, ms, ra, p) -> StepProposal``: one step attempt
  (accepted or rejected) for every lane at once, masked per lane.
* ``interp(cont, xold, h, ti) -> y``: the step's dense interpolant, from the
  ``(B, C, n)`` coefficients of a step, its left edge and size ``(B,)`` and
  one time per lane ``ti (B,)``.

Batched: state tensors are ``(B, n)``, per-lane scalars ``(B,)``.  The RHS
the engines call is ``rhs(t, y)`` with ``t`` of shape ``(B,)`` and ``y`` of
shape ``(B, n)``, returning ``(B, n)``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class RunArgs(NamedTuple):
    """Per-solve arguments, each with a leading batch axis."""

    tend: Any       # (B,)
    rtol: Any       # (B, n)
    atol: Any       # (B, n)
    hmax: Any       # (B,) |max_step|
    hmin: Any       # (B,) |min_step|
    max_steps: int
    t_grid: Any = None  # (B, m) sorted sample times for in-loop emission


class StepProposal(NamedTuple):
    accepted: Any      # bool — error test passed (statistics)
    advance: Any       # bool — state actually advances (accepted & healthy)
    finished: Any      # bool — this accepted step reached tend
    status: Any        # int32 — Status.RUNNING unless the engine failed
    t_new: Any
    y_new: Any
    xold: Any          # left edge of the step (== t)
    h_used: Any        # signed step size actually attempted
    cont: Any          # (B, C, n) dense coefficients (valid when advance),
    #                    None when the engine was built without them
    nfev_inc: Any      # int, or (B,) int32 where lanes differ (DOP853)
    njev_inc: Any      # int, or (B,) int32 (the stiff engines)
    nlu_inc: Any
    count_step: Any    # bool — whether nstep increments for this attempt
    count_reject: Any  # bool — whether nrejct increments
    ms: Any            # updated method state


class Engine(NamedTuple):
    name: str
    ncoeff: int
    init: Callable
    attempt: Callable
    interp: Callable
    # Jacobian evaluations inside ``init`` (BDF's), which the driver adds to
    # njev on an event restart (a restart runs ``init`` again).
    init_njev: int = 0


def dotk(coeffs, ks):
    """Sparse linear combination of stage derivatives.

    ``coeffs`` is {stage_index: weight} or a dense sequence.  Zero weights are
    skipped and the sum runs left to right, as in ``ivp_tpu``: the step
    sequences depend on that order.
    """
    if isinstance(coeffs, dict):
        items = coeffs.items()
    else:
        items = ((i, c) for i, c in enumerate(coeffs))
    acc = None
    for i, c in items:
        c = float(c)
        if c == 0.0:
            continue
        term = c * ks[i]
        acc = term if acc is None else acc + term
    if acc is None:
        return torch.zeros_like(ks[0])
    return acc
