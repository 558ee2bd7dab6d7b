"""In-loop event detection (``ivp_tpu.core.events``): sign-change tests,
Brent refinement on the step's dense interpolant, terminal logic.

Runs in the driver after every advanced step, on the whole batch: each lane
tests each event against its value at the previous accepted point, refines
a crossing with :func:`~ivp_tpu_torch.core.common.brentq` on the step's
interpolant, and records the root in its own ``(E, cap)`` buffers.  As in
the reference (and SciPy):

* the crossing test is direction-aware;
* the roots use ``scipy.optimize.brentq``'s tolerances (``xtol=2e-12``), and
  a root at an end of the step takes that end's exact state;
* the events of one step count in chronological (integration-direction)
  order, and a terminal event drops the later ones of its step;
* a full buffer drops further occurrences and sets ``overflow``.

A lane's row is written at its own cursor with an indexed write, in place
(the reference's one-hot masked selects are a TPU lowering).  This is the
plain version of the event mode of ``csrc/erk_common.cuh``'s kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from .common import brentq


@dataclasses.dataclass(frozen=True)
class EventSpec:
    """Event configuration."""

    n_events: int
    directions: Tuple[int, ...]       # -1 / 0 / +1 per event
    terminal_counts: Tuple[int, ...]  # 0 = never terminates
    cap: int = 512                    # recorded occurrences per event


class EvState(NamedTuple):
    g_prev: Any    # (B, E) event values at the previous accepted point
    hits: Any      # (B, E) int32 occurrence counts (for terminal counts)
    n_rec: Any     # (B, E) int32 recorded counts (saturating at cap)
    t_buf: Any     # (B, E, cap) event times
    y_buf: Any     # (B, E, cap, n) states at them
    overflow: Any  # (B, E) bool: an occurrence was dropped (buffer full)
    n_brent: Any   # (B,) int32 Brent evaluations of gfun (a measure of the
    #                event work; the reference does not count it)


# The buffers written in place, lane by lane: never selected whole.
BUFFERS = ("t_buf", "y_buf")


class EventOutcome(NamedTuple):
    state: EvState
    terminal: Any  # (B,) bool: a terminal event fired this step
    t_term: Any    # (B,) time of the earliest terminal event
    y_term: Any    # (B, n) state at that event
    i_term: Any    # (B,) int64 index of that event (0 unless terminal)


def init_ev_state(events_fn, t0, y0, spec: EventSpec) -> EvState:
    """Zero counts and buffers, and the event values at ``(t0, y0)``."""
    B, n = y0.shape
    E, cap = spec.n_events, spec.cap
    i32 = dict(dtype=torch.int32, device=y0.device)
    return EvState(
        g_prev=events_fn(t0, y0),
        hits=torch.zeros((B, E), **i32),
        n_rec=torch.zeros((B, E), **i32),
        t_buf=y0.new_zeros((B, E, cap)),
        y_buf=y0.new_zeros((B, E, cap, n)),
        overflow=torch.zeros((B, E), dtype=torch.bool, device=y0.device),
        n_brent=torch.zeros((B,), **i32))


def keep_state(mask, new: EvState, old: EvState, where) -> EvState:
    """``new`` on the lanes of ``mask``, ``old`` elsewhere (``where``: the
    driver's per-lane select); the in-place buffers are ``new``'s."""
    return EvState(*(n if f in BUFFERS else where(mask, n, o)
                     for f, n, o in zip(EvState._fields, new, old)))


def _crossed(g_prev, g_curr, direction: int):
    if direction > 0:
        return (g_prev < 0.0) & (g_curr >= 0.0)
    if direction < 0:
        return (g_prev > 0.0) & (g_curr <= 0.0)
    return (((g_prev <= 0.0) & (g_curr >= 0.0))
            | ((g_prev >= 0.0) & (g_curr <= 0.0)))


def process_events(events_fn, interp, cont, xold, h_used, t_old, y_old,
                   t_new, y_new, posneg, ev: EvState, spec: EventSpec,
                   write) -> EventOutcome:
    """Detect, refine and record the events of one step on every lane.
    ``events_fn(t (B,), y (B, n)) -> (B, E)``; ``interp`` the engine's, on
    the step's ``cont``, ``xold`` and ``h_used``.  Only the lanes of
    ``write`` (advanced and live) write their buffers; the caller keeps the
    rest of the returned state on those lanes only."""
    g_curr = events_fn(t_new, y_new)
    E = spec.n_events
    roots, y_roots, crossed = [], [], []
    n_brent = ev.n_brent
    for i in range(E):
        gp, gc = ev.g_prev[:, i], g_curr[:, i]
        cr = _crossed(gp, gc, spec.directions[i])

        def gfun(tau, i=i):
            return events_fn(tau, interp(cont, xold, h_used, tau))[:, i]

        if bool(cr.any()):
            root, evals = brentq(gfun, t_old, t_new, gp, gc, cr)
            root = torch.where(cr, root, t_new)
            n_brent = n_brent + evals
            y_root = interp(cont, xold, h_used, root)
        else:
            root, y_root = t_new, y_new
        # Exact endpoint states.
        y_root = torch.where((root == t_new)[:, None], y_new, y_root)
        y_root = torch.where((root == t_old)[:, None], y_old, y_root)
        roots.append(root)
        y_roots.append(y_root)
        crossed.append(cr)
    roots = torch.stack(roots, dim=1)       # (B, E)
    y_roots = torch.stack(y_roots, dim=1)   # (B, E, n)
    crossed = torch.stack(crossed, dim=1)   # (B, E)

    tc = torch.as_tensor(spec.terminal_counts, dtype=torch.int32,
                         device=roots.device)
    trigger = crossed & (tc > 0) & (ev.hits + 1 >= tc)

    # Chronological ordering with terminal truncation.
    order_key = roots * posneg[:, None]
    term_key = torch.where(trigger, order_key,
                           torch.full_like(order_key, float("inf")))
    terminal = trigger.any(dim=1)
    cut_key = term_key.min(dim=1).values
    record = crossed & torch.where(terminal[:, None],
                                   order_key <= cut_key[:, None],
                                   torch.ones_like(crossed))

    # Each recorded occurrence at its event's cursor; a full buffer drops it.
    lane, e = torch.nonzero(record & write[:, None]
                            & (ev.n_rec < spec.cap), as_tuple=True)
    at = (lane, e, ev.n_rec[lane, e].to(torch.int64))
    ev.t_buf.index_put_(at, roots[lane, e])
    ev.y_buf.index_put_(at, y_roots[lane, e])
    rec = record.to(torch.int32)
    overflow = ev.overflow | (record & (ev.n_rec >= spec.cap))
    n_rec = torch.clamp_max(ev.n_rec + rec, spec.cap)

    i_term = torch.argmin(term_key, dim=1)
    rows = torch.arange(roots.shape[0], device=roots.device)
    state = EvState(g_prev=g_curr, hits=ev.hits + rec, n_rec=n_rec,
                    t_buf=ev.t_buf, y_buf=ev.y_buf, overflow=overflow,
                    n_brent=n_brent)
    return EventOutcome(state=state, terminal=terminal,
                        t_term=roots[rows, i_term],
                        y_term=y_roots[rows, i_term], i_term=i_term)
