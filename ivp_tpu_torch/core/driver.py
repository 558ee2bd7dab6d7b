"""Generic integration driver (``ivp_tpu.core.driver``): lean mode, in-loop
``t_grid`` samples and step records.

The reference runs one ``lax.while_loop`` around an engine's attempt and
vmaps it over the ensemble; here the loop is a Python loop over batched
attempts:

    carry -> engine.attempt -> [events, restart] -> [record] -> [sample emission]
          -> counters/status -> carry

Every lane keeps its own step size, counters and status.  A lane that is
done is frozen (its carry is kept by a masked select), so each lane's
result is the one it would have alone, as under ``vmap`` in the reference.

Sample mode (``DriverConfig.sample_cap > 0``) follows the reference's
stall-based emission: a lane with a sample due inside the span it has
covered spends the iteration on that sample, interpolated from the last
accepted segment it carries, and the iteration's attempt is thrown away,
counters included.  A lane's own row is written through its cursor with an
ordinary indexed write (the reference's one-hot select is a TPU lowering).

Record mode (``DriverConfig.rec_cap > 0``) is the reference's while design
(``rec_scan=False``): each advanced step writes its endpoint t, state y, left
edge xold and signed h, and with ``record_cont`` its dense coefficients as
one flat row of ``C*n``, at the lane's cursor ``n_rec``.  A lane stops when
its buffer holds ``rec_cap`` rows; the host drains the rows, clears the
cursors (:func:`reset_records`) and runs the next chunk from the carry.  The
record buffers are written in place, each lane only its own rows: no
whole-buffer select per attempt.  The reference's scan tier is a TPU
lowering and is not ported.

Events (``DriverConfig.event_spec``) run on every advanced step
(core/events.py).  A terminal event ends the lane at the event point: its
step is truncated there (``t``, ``y`` and the record row are the event's),
and no sample past it is emitted.  With ``max_restarts > 0`` a terminal
event whose restart map is given instead restarts the lane from the event
point with the mapped state: the engine's init runs again there (RK4 keeps
its step, ``|h_used|``), its evaluations count in ``nfev``, the event values
restart from the new state and the restarting event's hit count goes back
to 0 (the others keep theirs).  Status priority: engine failure > terminal
event > reached ``tend`` > step budget.

This is the plain version of the fused CUDA kernels (kernels/erk_ensemble.py,
kernels/erk_record.py), and the CPU route.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from ..types import Status
from ..methods.base import Engine, RunArgs
from .events import (EventSpec, EvState, init_ev_state, keep_state,
                     process_events)


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    """Driver configuration (the ported fields of ``ivp_tpu``'s)."""

    unroll: int = 1  # masked attempts per check of the done mask (a host
    #                  sync on a GPU); results do not depend on it
    sample_cap: int = 0  # in-loop t_grid emission buffer size (0 = off)
    rec_cap: int = 0     # step records per chunk (0 = no records)
    record_cont: bool = False  # also record dense coefficients
    event_spec: Optional[EventSpec] = None
    max_restarts: int = 0  # in-loop event restarts a lane may make (0 = off)


class Carry(NamedTuple):
    t: Any        # (B,)
    y: Any        # (B, n)
    ms: Any       # engine state, fields with a leading (B,) axis
    status: Any   # (B,) int32, Status.RUNNING while integrating
    done: Any     # (B,) bool
    nfev: Any     # (B,) int32
    njev: Any     # (B,) int32 Jacobian evaluations (the stiff engines)
    nlu: Any      # (B,) int32 decompositions
    nstep: Any
    naccpt: Any
    nrejct: Any
    n_rec: Any      # (B,) int32: rows recorded in this chunk
    rec_t: Any      # (B, rec_cap) step endpoints
    rec_y: Any      # (B, rec_cap, n) states at rec_t
    rec_xold: Any   # (B, rec_cap) step left edges
    rec_h: Any      # (B, rec_cap) signed step sizes
    rec_cont: Any   # (B, rec_cap, C*n) flat dense coefficients ((B, cap, 0)
    #                 without record_cont); a drain reshapes to (k, C, n)
    s_cursor: Any   # (B,) int32: next t_grid sample to emit
    sample_y: Any   # (B, sample_cap, n) in-loop interpolated samples
    # Last accepted segment (sample mode; zero-size otherwise), from which
    # due samples are interpolated.
    seg_cont: Any   # (B, C, n) dense coefficients of the last accepted step
    seg_xold: Any   # (B,) left edge
    seg_h: Any      # (B,) signed step size
    seg_valid: Any  # (B,) bool: at least one step accepted
    ev: Any = None  # EvState with an event_spec, else None
    n_restarts: Any = None  # (B,) int32 in-loop event restarts made


def tree_where(mask, a, b):
    """Per-lane select over (nested) NamedTuples of batched tensors."""
    if a is None:
        return None
    if isinstance(a, EvState):
        return keep_state(mask, a, b, tree_where)
    if isinstance(a, tuple):
        vals = [tree_where(mask, x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _i32(like, v):
    return torch.full(like.shape[:1], v, dtype=torch.int32, device=like.device)


# Carry fields written in place, lane by lane (record mode): a frozen lane's
# rows are never touched, so no select keeps them.
_IN_PLACE = ("rec_t", "rec_y", "rec_xold", "rec_h", "rec_cont")


def _keep(frozen, old: Carry, new: Carry) -> Carry:
    """``new`` on live lanes, ``old`` on frozen ones; the record buffers are
    ``new``'s (the same tensors, written only on live lanes)."""
    return Carry(*(n if f in _IN_PLACE else tree_where(frozen, o, n)
                   for f, o, n in zip(Carry._fields, old, new)))


def reset_records(c: Carry) -> Carry:
    """Clear every lane's record cursor between chunks (the rows stay)."""
    return c._replace(n_rec=torch.zeros_like(c.n_rec))


def make_driver(engine: Engine, p, cfg: DriverConfig, rhs, events_fn=None,
                restart_fns=None):
    """Build ``(init_carry, run_chunk, run_bounded)`` for an engine; a
    record-mode caller clears the cursors between chunks with
    :func:`reset_records`.  With ``cfg.event_spec``: ``events_fn(t (B,), y
    (B, n)) -> (B, E)`` and ``restart_fns``, per event a map ``y_new = f(t
    (B,), y (B, n))`` or None (no restart)."""
    spec = cfg.event_spec
    has_events = spec is not None and spec.n_events > 0
    if has_events and not engine.ncoeff:
        raise ValueError("events need an engine built with need_cont")
    restart_fns = list(restart_fns or [])
    has_restarts = (has_events and cfg.max_restarts > 0
                    and any(f is not None for f in restart_fns))
    m = cfg.sample_cap
    Cs = engine.ncoeff if m else 0
    if m and not Cs:
        raise ValueError("sample mode needs an engine built with need_cont")
    cap = cfg.rec_cap
    Cr = engine.ncoeff if cfg.record_cont else 0
    if cfg.record_cont and not Cr:
        raise ValueError("record_cont needs an engine built with need_cont")

    def init_carry(t0, y0, first_step, ra: RunArgs) -> Carry:
        ms, nfev0 = engine.init(rhs, t0, y0, first_step, ra, p)
        B, n = y0.shape
        # Per-lane zero-interval fast path (|tend - t0| < 1e-15): the lane
        # is done at init with its initial state; its init nfev counts.
        trivial = torch.abs(ra.tend - t0) < 1e-15
        return Carry(
            t=t0, y=y0, ms=ms,
            status=torch.where(trivial, Status.SUCCESS,
                               Status.RUNNING).to(torch.int32),
            done=trivial,
            nfev=_i32(y0, nfev0), njev=_i32(y0, 0), nlu=_i32(y0, 0),
            nstep=_i32(y0, 0), naccpt=_i32(y0, 0),
            nrejct=_i32(y0, 0),
            n_rec=_i32(y0, 0),
            rec_t=y0.new_zeros((B, cap)), rec_y=y0.new_zeros((B, cap, n)),
            rec_xold=y0.new_zeros((B, cap)), rec_h=y0.new_zeros((B, cap)),
            rec_cont=y0.new_zeros((B, cap, Cr * n)),
            s_cursor=_i32(y0, 0),
            sample_y=y0.new_zeros((B, m, n)),
            seg_cont=y0.new_zeros((B, Cs, n)),
            seg_xold=torch.zeros_like(t0), seg_h=torch.zeros_like(t0),
            seg_valid=torch.zeros_like(trivial),
            ev=init_ev_state(events_fn, t0, y0, spec) if has_events else None,
            n_restarts=_i32(y0, 0),
        )

    def step_body(c: Carry, ra: RunArgs, live, stall=None) -> Carry:
        """One step attempt on every lane (the caller freezes the lanes
        that are not ``live``; their record rows are not written).
        ``stall`` (sample mode): lanes whose iteration goes to a sample
        emission; every effect of their attempt is masked out."""
        res = engine.attempt(rhs, c.t, c.y, c.naccpt, c.ms, ra, p)
        act = torch.ones_like(c.done) if stall is None else ~stall
        adv = res.advance & act

        # ---- Events (on advanced steps only) ----
        t_rec, y_rec = res.t_new, res.y_new
        ev_new, terminal = c.ev, torch.zeros_like(adv)
        ms_next, finished, n_restarts = res.ms, res.finished, c.n_restarts
        nfev_inc, njev_inc = res.nfev_inc, res.njev_inc
        if has_events:
            out = process_events(
                events_fn, engine.interp, res.cont, res.xold, res.h_used,
                c.t, c.y, res.t_new, res.y_new, c.ms.posneg, c.ev, spec,
                adv & live)
            ev_new = keep_state(adv, out.state, c.ev, tree_where)
            terminal = adv & out.terminal
            t_rec = torch.where(terminal, out.t_term, t_rec)
            y_rec = torch.where(terminal[:, None], out.y_term, y_rec)

        # ---- In-loop event restart ----
        if has_restarts:
            can = torch.as_tensor([f is not None for f in restart_fns],
                                  device=adv.device)
            before_end = (out.t_term - ra.tend) * c.ms.posneg < 0.0
            do_restart = (terminal & can[out.i_term] & before_end
                          & (c.n_restarts < cfg.max_restarts))
            if bool(do_restart.any()):
                # The restarting event's map on the event state.
                y_re = out.y_term
                for i, rf in enumerate(restart_fns):
                    if rf is not None:
                        y_re = torch.where((out.i_term == i)[:, None],
                                           rf(out.t_term, out.y_term), y_re)
                # A fresh engine state from the event point (RK4 keeps its
                # fixed step).
                fs_re = (torch.abs(res.h_used) if engine.name == "RK4"
                         else None)
                ms_re, nfev_re = engine.init(rhs, out.t_term, y_re, fs_re,
                                             ra, p)
                ms_next = tree_where(do_restart, ms_re, ms_next)
                nfev_inc = nfev_inc + nfev_re * do_restart.to(torch.int32)
                njev_inc = (njev_inc + engine.init_njev
                            * do_restart.to(torch.int32))
                # Event values restart from the mapped state; only the
                # restarting event's hit count goes back to 0.
                E = spec.n_events
                hit0 = (torch.arange(E, device=adv.device)[None, :]
                        == out.i_term[:, None]) & do_restart[:, None]
                ev_new = ev_new._replace(
                    g_prev=torch.where(do_restart[:, None],
                                       events_fn(out.t_term, y_re),
                                       ev_new.g_prev),
                    hits=torch.where(hit0, 0, ev_new.hits).to(torch.int32))
                terminal = terminal & ~do_restart
                # A restarted lane runs on even if this step reached tend.
                finished = finished & ~do_restart
                t_rec = torch.where(do_restart, out.t_term, t_rec)
                y_rec = torch.where(do_restart[:, None], y_re, y_rec)
                n_restarts = n_restarts + do_restart.to(torch.int32)

        # ---- Record the advanced step at the lane's cursor, in place ----
        n_rec = c.n_rec
        if cap:
            w = adv & live
            rows = torch.nonzero(w)[:, 0]
            at = (rows, c.n_rec[rows].to(torch.int64))
            c.rec_t.index_put_(at, t_rec[rows])
            c.rec_y.index_put_(at, y_rec[rows])
            c.rec_xold.index_put_(at, res.xold[rows])
            c.rec_h.index_put_(at, res.h_used[rows])
            if Cr:
                c.rec_cont.index_put_(at, res.cont[rows].flatten(1))
            n_rec = c.n_rec + w.to(torch.int32)

        # ---- Carried segment for the t_grid emission (in ``body``) ----
        if m:
            seg_cont = torch.where(adv[:, None, None], res.cont, c.seg_cont)
            seg_xold = torch.where(adv, res.xold, c.seg_xold)
            seg_h = torch.where(adv, res.h_used, c.seg_h)
            seg_valid = c.seg_valid | adv
        else:
            seg_cont, seg_xold = c.seg_cont, c.seg_xold
            seg_h, seg_valid = c.seg_h, c.seg_valid

        # ---- Counters (masked out on stall iterations) ----
        nstep = c.nstep + (res.count_step & act).to(torch.int32)
        naccpt = c.naccpt + (res.accepted & act).to(torch.int32)
        nrejct = c.nrejct + (res.count_reject & act).to(torch.int32)
        nfev = c.nfev + nfev_inc * act.to(torch.int32)
        njev = c.njev + njev_inc * act.to(torch.int32)
        nlu = c.nlu + res.nlu_inc * act.to(torch.int32)

        # Status priority: engine failure > terminal event > reached tend >
        # step budget.
        status = res.status
        running = status == Status.RUNNING
        status = torch.where(running & terminal, Status.USER_INTERRUPT, status)
        running = status == Status.RUNNING
        status = torch.where(running & finished, Status.SUCCESS, status)
        running = status == Status.RUNNING
        status = torch.where(running & (nstep > ra.max_steps),
                             Status.NEED_LARGER_NMAX, status).to(torch.int32)

        # ---- Stall masking of the state advance (sample mode) ----
        # (the event state and restarts were kept on advanced lanes only,
        # and a stalled lane does not advance)
        t_step, y_step = t_rec, y_rec
        if stall is not None:
            t_step = torch.where(act, t_step, c.t)
            y_step = torch.where(act[:, None], y_step, c.y)
            ms_next = tree_where(act, ms_next, c.ms)
            status = torch.where(act, status, c.status)
        # In sample mode ``body`` decides ``done``: a lane whose engine is
        # finished may still owe due samples.
        return Carry(t=t_step, y=y_step, ms=ms_next, status=status,
                     done=status != Status.RUNNING, nfev=nfev, njev=njev,
                     nlu=nlu, nstep=nstep,
                     naccpt=naccpt, nrejct=nrejct, n_rec=n_rec,
                     rec_t=c.rec_t, rec_y=c.rec_y, rec_xold=c.rec_xold,
                     rec_h=c.rec_h, rec_cont=c.rec_cont,
                     s_cursor=c.s_cursor, sample_y=c.sample_y,
                     seg_cont=seg_cont, seg_xold=seg_xold, seg_h=seg_h,
                     seg_valid=seg_valid, ev=ev_new, n_restarts=n_restarts)

    def _due(cursor, valid, t, posneg, ra):
        """Lanes whose next sample lies inside the covered span, and that
        sample's index and time."""
        idx = torch.clamp_max(cursor, m - 1).to(torch.int64)
        tau = ra.t_grid.gather(1, idx[:, None])[:, 0]
        return (cursor < m) & valid & ((tau - t) * posneg <= 0.0), idx, tau

    def body(c: Carry, ra: RunArgs, live) -> Carry:
        """One driver iteration: one step attempt (step_body) or, where a
        t_grid sample is due inside the span already covered, one sample
        emission from the carried segment with the attempt discarded (the
        lane stalls until its due samples are drained, so every sample
        interpolates the segment that covered it)."""
        if not m:
            return step_body(c, ra, live)
        posneg = c.ms.posneg
        due, idx, tau = _due(c.s_cursor, c.seg_valid, c.t, posneg, ra)
        c2 = step_body(c, ra, live, stall=due)

        yi = engine.interp(c.seg_cont, c.seg_xold, c.seg_h, tau)
        rows = torch.nonzero(due)[:, 0]
        sample_y = c.sample_y.index_put((rows, idx[rows]), yi[rows])
        s_cursor = c.s_cursor + due.to(torch.int32)
        still, _, _ = _due(s_cursor, c2.seg_valid, c2.t, posneg, ra)
        return c2._replace(sample_y=sample_y, s_cursor=s_cursor,
                           done=(c2.status != Status.RUNNING) & ~still)

    def frozen(c: Carry):
        """Lanes that take no iteration: done, or with a full buffer."""
        return c.done | (c.n_rec >= cap) if cap else c.done

    def body_unrolled(c: Carry, ra: RunArgs, allow=None) -> Carry:
        """``cfg.unroll`` iterations, freezing lanes as they finish or fill
        their buffer; lanes outside ``allow`` stay frozen."""
        for _ in range(max(1, cfg.unroll)):
            f = frozen(c) if allow is None else frozen(c) | ~allow
            c = _keep(f, c, body(c, ra, ~f))
        return c

    def run_chunk(c: Carry, ra: RunArgs) -> Carry:
        """Integrate every lane until it is done or its buffer is full."""
        while not bool(frozen(c).all()):
            c = body_unrolled(c, ra)
        return c

    def run_bounded(c: Carry, ra: RunArgs, max_attempts: int) -> Carry:
        """Integrate each lane while it is not done and has made fewer than
        ``max_attempts`` counted attempts since the call (in units of
        ``cfg.unroll`` iterations, as the reference's vmapped while loop)."""
        start = c.nstep
        while True:
            go = ~frozen(c) & (c.nstep - start < max_attempts)
            if not bool(go.any()):
                return c
            c = body_unrolled(c, ra, allow=go)

    return init_carry, run_chunk, run_bounded


def run_args(tend, rtol, atol, hmax, hmin, max_steps, y0,
             t_grid=None) -> RunArgs:
    """Batched RunArgs: ``tend/hmax/hmin`` broadcast to ``(B,)``,
    ``rtol/atol`` to ``(B, n)`` and ``t_grid`` (shared ``(m,)`` or per-lane
    ``(B, m)``) to ``(B, m)``, in ``y0``'s dtype and on its device."""
    B, n = y0.shape
    kw = dict(dtype=y0.dtype, device=y0.device)

    # A Python number is filled on the device (a host-to-device copy of a
    # pageable scalar would wait for the work queued on the stream); a
    # tensor already of its shape is taken as it is.
    def batched(v, shape):
        if isinstance(v, (int, float)):
            return torch.full(shape, float(v), **kw)
        v = torch.as_tensor(v, **kw)
        if v.shape == shape and v.is_contiguous():
            return v
        return torch.broadcast_to(v, shape).contiguous()

    def positive(v):
        if isinstance(v, (int, float)):
            return batched(abs(float(v)), (B,))
        return torch.abs(batched(v, (B,)))

    if t_grid is not None:
        t_grid = torch.as_tensor(t_grid, **kw)
        t_grid = torch.broadcast_to(t_grid, (B, t_grid.shape[-1]))
    return RunArgs(tend=batched(tend, (B,)), rtol=batched(rtol, (B, n)),
                   atol=batched(atol, (B, n)), hmax=positive(hmax),
                   hmin=positive(hmin), max_steps=int(max_steps),
                   t_grid=t_grid)
