"""Generic integration driver, lean mode (``ivp_tpu.core.driver``).

The reference runs one ``lax.while_loop`` around an engine's attempt and
vmaps it over the ensemble; here the loop is a Python loop over batched
attempts:

    carry -> engine.attempt -> counters/status -> carry

Every lane keeps its own step size, counters and status.  A lane that is
done is frozen (its carry is kept by a masked select), so each lane's
result is the one it would have alone, as under ``vmap`` in the reference.

Only the lean final-state mode is ported: no record buffers, events or
``t_eval`` samples (ROADMAP §1 items 3, 5 and 6).  This is the plain version
of the fused CUDA kernel (kernels/dopri5_ensemble.py), and the CPU route.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..types import Status
from ..methods.base import Engine, RunArgs


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    """Driver configuration (the lean fields of ``ivp_tpu``'s)."""

    unroll: int = 1  # masked attempts per check of the done mask (a host
    #                  sync on a GPU); results do not depend on it


class Carry(NamedTuple):
    t: Any        # (B,)
    y: Any        # (B, n)
    ms: Any       # engine state, fields with a leading (B,) axis
    status: Any   # (B,) int32, Status.RUNNING while integrating
    done: Any     # (B,) bool
    nfev: Any     # (B,) int32
    nstep: Any
    naccpt: Any
    nrejct: Any


def tree_where(mask, a, b):
    """Per-lane select over (nested) NamedTuples of batched tensors."""
    if isinstance(a, tuple):
        return type(a)(*(tree_where(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _i32(like, v):
    return torch.full(like.shape[:1], v, dtype=torch.int32, device=like.device)


def make_driver(engine: Engine, p, cfg: DriverConfig, rhs):
    """Build ``(init_carry, run_chunk, run_bounded)`` for an engine."""

    def init_carry(t0, y0, first_step, ra: RunArgs) -> Carry:
        ms, nfev0 = engine.init(rhs, t0, y0, first_step, ra, p)
        # Per-lane zero-interval fast path (|tend - t0| < 1e-15): the lane
        # is done at init with its initial state; its init nfev counts.
        trivial = torch.abs(ra.tend - t0) < 1e-15
        return Carry(
            t=t0, y=y0, ms=ms,
            status=torch.where(trivial, Status.SUCCESS,
                               Status.RUNNING).to(torch.int32),
            done=trivial,
            nfev=_i32(y0, nfev0), nstep=_i32(y0, 0), naccpt=_i32(y0, 0),
            nrejct=_i32(y0, 0),
        )

    def step_body(c: Carry, ra: RunArgs) -> Carry:
        """One step attempt on every lane (done lanes are frozen by the
        caller)."""
        res = engine.attempt(rhs, c.t, c.y, c.naccpt, c.ms, ra, p)

        nstep = c.nstep + res.count_step.to(torch.int32)
        naccpt = c.naccpt + res.accepted.to(torch.int32)
        nrejct = c.nrejct + res.count_reject.to(torch.int32)
        nfev = c.nfev + res.nfev_inc

        # Status priority: engine failure > reached tend > step budget.
        status = res.status
        running = status == Status.RUNNING
        status = torch.where(running & res.finished, Status.SUCCESS, status)
        running = status == Status.RUNNING
        status = torch.where(running & (nstep > ra.max_steps),
                             Status.NEED_LARGER_NMAX, status).to(torch.int32)
        return Carry(t=res.t_new, y=res.y_new, ms=res.ms, status=status,
                     done=status != Status.RUNNING, nfev=nfev, nstep=nstep,
                     naccpt=naccpt, nrejct=nrejct)

    def body(c: Carry, ra: RunArgs) -> Carry:
        """``cfg.unroll`` attempts, freezing lanes as they finish."""
        for _ in range(max(1, cfg.unroll)):
            c = tree_where(c.done, c, step_body(c, ra))
        return c

    def run_chunk(c: Carry, ra: RunArgs) -> Carry:
        """Integrate every lane until it is done."""
        while not bool(c.done.all()):
            c = body(c, ra)
        return c

    def run_bounded(c: Carry, ra: RunArgs, max_attempts: int) -> Carry:
        """Integrate each lane while it is not done and has made fewer than
        ``max_attempts`` counted attempts since the call (in units of
        ``cfg.unroll`` attempts, as the reference's vmapped while loop)."""
        start = c.nstep
        while True:
            go = ~c.done & (c.nstep - start < max_attempts)
            if not bool(go.any()):
                return c
            c = tree_where(go, body(c, ra), c)

    return init_carry, run_chunk, run_bounded


def run_args(tend, rtol, atol, hmax, hmin, max_steps, y0) -> RunArgs:
    """Batched RunArgs: ``tend/hmax/hmin`` broadcast to ``(B,)`` and
    ``rtol/atol`` to ``(B, n)``, in ``y0``'s dtype and on its device."""
    B, n = y0.shape
    kw = dict(dtype=y0.dtype, device=y0.device)

    def lane(v):
        return torch.broadcast_to(torch.as_tensor(v, **kw), (B,)).contiguous()

    def comp(v):
        return torch.broadcast_to(torch.as_tensor(v, **kw), (B, n)).contiguous()

    return RunArgs(tend=lane(tend), rtol=comp(rtol), atol=comp(atol),
                   hmax=torch.abs(lane(hmax)), hmin=torch.abs(lane(hmin)),
                   max_steps=int(max_steps))
