"""The explicit tier's record mode: router, chunked launches, drain, plain
version.

``erk_record`` integrates a ``(B, n)`` ensemble with one of DOPRI5, DOP853,
RK23 and RK4 and records every advanced step of every lane: its endpoint
``t``, state ``y``, left edge ``xold`` and signed ``h``, and with
``record_cont`` its dense coefficients, optionally with in-loop samples on a
``t_grid``.  ``solve.py::solve_ivp`` (one lane) and the recording ensemble
(``batch.py``, ``record_trajectories`` / ``dense_output``) call it.  It
picks the route from the device of ``y0``:

* a CPU tensor runs :func:`erk_record_torch`, the plain version: the ported
  driver in record mode (core/driver.py, ``rec_cap``/``record_cont``), one
  chunk of ``rec_cap`` rows a lane at a time;
* a CUDA tensor with a :class:`~ivp_tpu_torch.rhs.CudaRHS` runs
  :func:`erk_record_cuda`: the record mode of ``csrc/erk_common.cuh``'s
  ``erk_kernel`` (entries ``ivp_<kernel>_record_<rhs>`` of
  ``csrc/erk_{dopri5,dop853,rk23,rk4}.cu``), one launch a chunk, each lane's
  whole carry kept in device memory between launches;
* a CUDA tensor with any other callable raises NotImplementedError.

Radau and BDF (``params`` a StiffSpec) record through the same chunk loop
and drain: the plain driver on CPU tensors, and on CUDA tensors the RECORD
mode of ``csrc/radau.cu`` and ``csrc/bdf.cu`` (:func:`stiff_record_launches`,
one :class:`~ivp_tpu_torch.kernels.stiff_ensemble.StiffLaunch` a chunk
from the lane carry to itself): their rows staged and written in bulk
copies at :func:`record_stride`, as the explicit kernels' are.

With ``events`` the record mode detects events and restarts lanes as the
lean solve does (kernels/erk_ensemble.py): the plain driver with events, or
the record-event entries ``ivp_<kernel>_record_ev_<rhs>_<set>``, which keep
each lane's event state (its event values at the last point, hit counts,
cursors, overflow flags and restart count) in device memory between
launches too.  The row of a step that an event ends or restarts has the
event's time and the event's (or the restarted) state.

These kernels replace the XLA-fused ``ivp_tpu.core.driver.run_chunk`` in
record mode (``step_body``'s record writes, ``:286-310``, and the stop at a
full buffer, ``:448-457``) around each engine of ``ivp_tpu.methods.erk``;
no TPU kernel stands behind them.  On an H100 they are bound by float64
operations, or with coefficient records by the bytes of the rows they
write (:func:`record_bound`).  Each lane stages its rows in shared memory
and writes a run of them with one bulk copy, so a row's stride in the
chunk buffer is its width rounded up to an even number of doubles
(:func:`record_stride`; the pad at the row's end is never read).

The drain is a concatenation.  A lane still running at the end of a chunk
has written exactly ``rec_cap`` rows in it, so each lane's rows, taken
chunk after chunk and each chunk cut to its ``max(n_rec)``, form a prefix;
the rows past a lane's count are zeroed.  Each chunk costs the host one
read of ``max(n_rec)`` and of whether any lane still runs.  There is no
fallback: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import torch

from ..core.driver import reset_records, run_args
from ..methods.jacobian import StiffSpec
from ..rhs import CudaRHS
from ..types import Status
from . import build
from . import erk_ensemble as E
from . import stiff_ensemble as S
from .erk_ensemble import record_coeffs, record_stride, record_width
from .dopri5_ensemble import FP64_PEAK, HBM_RATE

# Launches made by this process: one per chunk, per method and record mode
# (``<method>_record``: steps; ``<method>_record_cont``: with coefficients).
# A caller may reset a count to 0.
LAUNCHES = {f"{k}_record{c}{e}": 0 for k in ("dopri5", "dop853", "rk23", "rk4")
            for c in ("", "_cont") for e in ("", "_ev")}

# What the resumable solver does not run on the card yet.
STIFF_MODES_ON_CARD = (
    "the resumable solver runs t_eval samples and events with device='cpu'; "
    "on the card it runs the lean solve (the ensemble, the recording "
    "ensemble and solve_ivp run samples and events there, Radau and BDF "
    "too): ROADMAP §1 item 16 (samples and events in the resumable solver)")

# method -> the LAUNCHES prefix
_NAMES = {"DOPRI5": "dopri5", "DOP853": "dop853", "RK23": "rk23", "RK4": "rk4"}


class RecordResult(NamedTuple):
    t: Any        # (B,) final time
    y: Any        # (B, n) final state
    status: Any   # (B,) int32
    nfev: Any
    nstep: Any
    naccpt: Any
    nrejct: Any
    y_samples: Any   # (B, m, n), or None without a grid
    n_samples: Any   # (B,) int32, or None
    n_rec: Any    # (B,) int64 rows recorded
    rec_t: Any    # (B, S) step endpoints (rows past n_rec zero)
    rec_y: Any    # (B, S, n)
    rec_xold: Any  # (B, S)
    rec_h: Any    # (B, S)
    rec_cont: Any  # (B, S, C, n), or None without record_cont
    events: Any   # erk_ensemble.EventOut, or None without events
    njev: Any     # (B,) int32 Jacobian evaluations (the plain version's
    #               stiff solves), or None
    nlu: Any      # (B,) int32 decompositions, or None
    chunks: int   # chunks run (kernel launches on the CUDA route)


def _assemble(pieces, B, n, C, counts, last, chunks, events=None,
              counters=None):
    """Concatenate the chunks' rows, zero each lane's rows past its count
    and return the RecordResult, whose record fields are views of the rows.
    ``pieces``: per chunk, the ``(B, k, stride)`` rows ``[t, xold, h, y,
    cont, pad]`` of its first ``k = max(n_rec)``, ``stride >= 3 + n + C*n``
    (the views skip the pad)."""
    dev, dt = last[1].device, last[1].dtype
    W = 3 + n + C * n
    if pieces:
        rows = torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0]
    else:
        rows = torch.zeros((B, 0, W), dtype=dt, device=dev)
    S = rows.shape[1]
    past = torch.arange(S, device=dev)[None, :] >= counts[:, None]
    rows.masked_fill_(past[:, :, None], 0.0)
    cont = rows[:, :, 3 + n:W].reshape(B, S, C, n) if C else None
    return RecordResult(*last, counts, rows[:, :, 0], rows[:, :, 3:3 + n],
                        rows[:, :, 1], rows[:, :, 2], cont, events,
                        *(counters or (None, None)), chunks)


def erk_record_torch(method, fun, y0, t0, tf, hmax, first_step, rtol, atol,
                     args=(), max_steps=100_000, t_grid=None, params=None,
                     rec_cap=1024, record_cont=False,
                     events=None, hmin=0.0) -> RecordResult:
    """Plain PyTorch version: the ported driver in record mode on the whole
    batch, chunk by chunk, on the device of ``y0`` and in its dtype.
    ``params`` may be a stiff solve's StiffSpec; ``hmin``: the least step
    size (the stiff engines read it).  The result holds the lanes' njev and
    nlu."""
    method = method.upper()
    B, n = y0.shape
    dtype = y0.dtype
    m = 0 if t_grid is None else int(t_grid.shape[-1])
    p = _params(method, m, record_cont, params, events)
    C = record_coeffs(method) if record_cont else 0
    init_carry, run_chunk = E.plain_driver(
        method, fun, y0, args, m, p, events, rec_cap=int(rec_cap),
        record_cont=record_cont)
    ra = run_args(tf, rtol, atol, hmax, hmin, max_steps, y0, t_grid=t_grid)
    t0 = torch.broadcast_to(torch.as_tensor(t0, dtype=dtype, device=y0.device),
                            (B,))
    c = init_carry(t0, y0, first_step, ra)
    pieces, chunks = [], 0
    counts = torch.zeros(B, dtype=torch.int64, device=y0.device)
    while True:
        if chunks:
            c = reset_records(c)
        c = run_chunk(c, ra)
        chunks += 1
        k = int(c.n_rec.max()) if B else 0
        counts = counts + c.n_rec.to(torch.int64)
        if k:   # a copy: the next chunk writes the buffers again
            pieces.append(torch.cat(
                [c.rec_t[:, :k, None], c.rec_xold[:, :k, None],
                 c.rec_h[:, :k, None], c.rec_y[:, :k], c.rec_cont[:, :k]],
                dim=2))
        if B == 0 or bool(c.done.all()):
            break
    samples = (c.sample_y, c.s_cursor) if m else (None, None)
    last = (c.t, c.y, c.status, c.nfev, c.nstep, c.naccpt, c.nrejct, *samples)
    return _assemble(pieces, B, n, C, counts, last, chunks,
                     None if events is None else E.carry_events(c),
                     (c.njev, c.nlu))


def _params(method, m, record_cont, params, events=None):
    """``method``'s params with dense output where samples, coefficient
    records or events need it: ``params`` if given (it must agree), else
    the cached defaults; a stiff solve's StiffSpec as it is."""
    if isinstance(params, StiffSpec):
        return params
    need = m > 0 or record_cont or events is not None
    if params is None:
        return E._default_params(method, need)
    if params.method != method or params.need_cont != need:
        raise ValueError(f"params are for {params.method} with need_cont="
                         f"{params.need_cont}, the solve is {method} with "
                         f"need_cont={need}")
    return params


class KernelCarry(ctypes.Structure):
    """``ErkCarry`` of csrc/erk_common.cuh (same layout)."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "k1", "h", "facold", "hlamb", "reject", "iasti", "nonstiff",
        "stiff_in")] + [("init", ctypes.c_int)])


_P, _I = ctypes.c_void_p, ctypes.c_int
# The lean entry's arguments up to n_samples; the carry; rows, n_rec, cap,
# the row stride, the record mode (1 steps, 2 with coefficients); stream.
_ARGTYPES = E._ARGTYPES[:-1] + [KernelCarry, _P, _P, _I, _I, _I, _P]
# The same without the stride: a build from before the staged stores
# (unpadded rows), which an A/B may pass as ``lib``.
_ARGTYPES_UNSTAGED = E._ARGTYPES[:-1] + [KernelCarry, _P, _P, _I, _I, _P]
# The record-event entries: the staged arguments with the events before
# the stream.
_ARGTYPES_EV = _ARGTYPES[:-1] + [E.KernelEvents, _P]


def erk_record_cuda(method, fun: CudaRHS, y0, t0, tf, hmax, first_step,
                    rtol, atol, args=(), max_steps=100_000, t_grid=None,
                    params=None, rec_cap=1024, record_cont=False,
                    events=None) -> RecordResult:
    """Run ``method``'s record-mode kernel chunk by chunk on the current
    stream.  float64 only; ``t_grid`` is ``(B, m)`` (a shared grid as an
    expanded view is read through its strides)."""
    if not isinstance(fun, CudaRHS):
        raise TypeError(f"the CUDA kernel runs a CudaRHS, got {fun!r}")
    dev = y0.device
    if dev.type != "cuda":
        raise ValueError(f"y0 must be a CUDA tensor, got {dev}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return record_launches(
            method, fun, y0, t0, tf, hmax, first_step, rtol, atol, args,
            max_steps, t_grid, params, rec_cap, record_cont, None, stream,
            events=events)


class RecordLaunch:
    """One record-mode solve on the device: its lane carry, outputs and one
    chunk's rows on ``y0``'s device, and :meth:`launch`, one chunk's launch
    from ``lib`` (default: the package's build of the method's source) on
    ``stream``.  :func:`record_launches` loops over it;
    measure_kernel.py times one launch alone.

    The chunk buffer's row stride is :func:`record_stride`'s for a build
    with staged stores; a build from before them (no
    ``ivp_<kernel>_record_layout_<rhs>`` entry, passed as ``lib`` for an
    A/B) writes unpadded rows and is called without the stride.  With
    ``events``: the record-event entry of their set, its event outputs
    (``ev_out``) and event carry on the device."""

    def __init__(self, method, fun: CudaRHS, y0, t0, tf, hmax, first_step,
                 rtol, atol, args, max_steps, t_grid, params, rec_cap,
                 record_cont, lib, stream, events=None):
        method = method.upper()
        dev = y0.device
        B, n = y0.shape if y0.dim() == 2 else (-1, -1)
        m = 0 if t_grid is None else int(t_grid.shape[-1])
        p = _params(method, m, record_cont, params, events)
        first_step, grid_ptr, grid_stride = E.check_inputs(
            fun, y0, t0, tf, hmax, first_step, rtol, atol, t_grid)
        kargs = fun.kernel_args(args, B, dev)
        cap = int(rec_cap)
        if cap < 1:
            raise ValueError(f"rec_cap must be at least 1, got {rec_cap}")
        kernel, source = E.KERNELS[method]
        # (a build with event entries stages its rows)
        staged = lib is None or events is not None or hasattr(
            lib, f"ivp_{kernel}_record_layout_{fun.name}")
        stride = (record_stride if staged else record_width)(
            method, n, record_cont)
        f64, i32 = torch.float64, torch.int32

        self.B, self.n, self.m, self.cap = B, n, m, cap
        self.C = record_coeffs(method) if record_cont else 0
        self.name = record_kernel(method, record_cont, events is not None)
        self.ev_out = ev_arg = None
        if events is not None:
            self.ev_out, self.ev_keep = E.event_buffers(events, B, n, dev,
                                                        carry=True)
            ev_set, ev_arg = E.kernel_events(fun, events, self.ev_out,
                                             self.ev_keep)
        self.t_out = torch.empty((B,), dtype=f64, device=dev)
        self.y_out = torch.empty((B, n), dtype=f64, device=dev)
        self.ints = [torch.empty((B,), dtype=i32, device=dev)
                     for _ in range(5)]
        self.y_samples = (torch.zeros((B, m, n), dtype=f64, device=dev)
                          if m else None)
        self.n_samples = (torch.zeros((B,), dtype=i32, device=dev)
                          if m else None)
        k1 = torch.empty((B, n), dtype=f64, device=dev)
        lane_f = [torch.empty((B,), dtype=f64, device=dev) for _ in range(3)]
        lane_i = [torch.empty((B,), dtype=i32, device=dev) for _ in range(4)]
        self.lane_carry = dict(zip(
            ("k1", "h", "facold", "hlamb", "reject", "iasti", "nonstiff",
             "stiff_in"), (k1, *lane_f, *lane_i)))
        self.rows = torch.empty((B, cap, stride), dtype=f64, device=dev)
        self.n_rec = torch.zeros((B,), dtype=i32, device=dev)
        self.carry = KernelCarry(k1.data_ptr(),
                                 *(x.data_ptr() for x in lane_f),
                                 *(x.data_ptr() for x in lane_i), 1)
        if B == 0:
            return
        self.lib = build.library(source) if lib is None else lib
        E.check_functor(self.lib, fun, kargs)
        if events is None:
            entry = build.entry(f"ivp_{kernel}_record_{fun.name}",
                                _ARGTYPES if staged else _ARGTYPES_UNSTAGED,
                                lib=self.lib)
        else:
            entry = build.entry(
                f"ivp_{kernel}_record_ev_{fun.name}_{ev_set.name}",
                _ARGTYPES_EV, lib=self.lib)
        outs = (self.t_out, self.y_out, *self.ints)
        self._args = (
            B, y0.data_ptr(), t0.data_ptr(), tf.data_ptr(), hmax.data_ptr(),
            first_step.data_ptr(), rtol.data_ptr(), atol.data_ptr(),
            kargs.data_ptr(), int(max_steps), E.kernel_options(p), grid_ptr,
            m, grid_stride, *(x.data_ptr() for x in outs),
            self.y_samples.data_ptr() if m else 0,
            self.n_samples.data_ptr() if m else 0)
        self._rest = (self.rows.data_ptr(), self.n_rec.data_ptr(), cap,
                      *((stride,) if staged else ()),
                      2 if record_cont else 1,
                      *(() if ev_arg is None else (ev_arg,)), stream)
        self._entry = entry
        # Held: the entry reads the buffers through their pointers.
        self._keep = (y0, t0, tf, hmax, first_step, rtol, atol, kargs, t_grid)

    def last(self):
        """``RecordResult``'s fields up to ``n_samples``."""
        return (self.t_out, self.y_out, *self.ints, self.y_samples,
                self.n_samples)

    def launch(self, init=None):
        """One chunk: from y0, t0 on a solve's first launch (or ``init``
        True), else from the carry the last one stored."""
        if init is not None:
            self.carry.init = int(init)
        err = self._entry(*self._args, self.carry, *self._rest)
        build.check(err, f"{self.name} kernel launch (B={self.B}, m={self.m}"
                    f", cap={self.cap})", self.lib)
        LAUNCHES[self.name] += 1
        self.carry.init = 0


def _drain(launch, n_rec, rows, status):
    """Run a record-mode solve chunk by chunk until no lane runs:
    ``launch(first)`` launches one chunk (``first`` on the solve's first),
    which writes each lane's rows into ``rows`` ``(B, cap, stride)``, their
    number into ``n_rec`` and the lanes' ``status``, all in place.  Returns
    ``(pieces, counts, chunks)`` for :func:`_assemble`."""
    counts = torch.zeros(n_rec.shape, dtype=torch.int64, device=n_rec.device)
    pieces, chunks = [], 0
    while n_rec.numel():
        if pieces:   # the next launch overwrites the rows: keep them
            pieces[-1] = pieces[-1].clone()
        launch(not chunks)
        chunks += 1
        counts += n_rec
        # One read a chunk: the fullest lane's rows and whether any lane
        # still runs.
        k, running = torch.stack([
            n_rec.max(),
            (status == Status.RUNNING).any().to(torch.int32)]).tolist()
        if k:
            pieces.append(rows[:, :k])
        if not running:
            break
    return pieces, counts, chunks


def record_launches(method, fun: CudaRHS, y0, t0, tf, hmax, first_step, rtol,
                    atol, args, max_steps, t_grid, params, rec_cap,
                    record_cont, lib, stream, carry_out=None,
                    events=None) -> RecordResult:
    """What :func:`erk_record_cuda` does once it has checked the device: a
    :class:`RecordLaunch` (``lib`` as it takes it),
    launched until no lane runs, and the drain.  ``carry_out``: a dict to
    receive the lane carry after the last launch (``k1``, ``h``,
    ``facold``, ``hlamb``, ``reject``, ``iasti``, ``nonstiff``,
    ``stiff_in``; with events also ``g_prev`` and ``hits``)."""
    r = RecordLaunch(method, fun, y0, t0, tf, hmax, first_step, rtol, atol,
                     args, max_steps, t_grid, params, rec_cap, record_cont,
                     lib, stream, events)
    pieces, counts, chunks = _drain(lambda first: r.launch(), r.n_rec,
                                    r.rows, r.ints[0])
    if carry_out is not None:
        carry_out.update(r.lane_carry)
        if r.ev_out is not None:
            carry_out.update(zip(("g_prev", "hits"), r.ev_keep))
    return _assemble(pieces, r.B, r.n, r.C, counts, r.last(), chunks,
                     r.ev_out)


def stiff_record_launches(method, fun: CudaRHS, y0, t0, tf, hmax, first_step,
                          rtol, atol, args, max_steps, t_grid,
                          spec: StiffSpec, rec_cap, record_cont, hmin=0.0,
                          lib=None, stream=None,
                          events=None) -> RecordResult:
    """Radau's or BDF's record mode on ``y0``'s device: a lean carry and a
    :class:`~ivp_tpu_torch.kernels.stiff_ensemble.StiffLaunch` in RECORD
    mode (``lib``, default the package's build; ``stream`` as it takes it,
    0 for a g++ build on CPU tensors), launched from the carry to itself,
    the first launch from ``y0`` and ``t0``, through :func:`_drain`; with
    a ``t_grid`` the samples too, with ``events`` (an EventArgs) the event
    entry of their set (``lib`` then a build of csrc/<kernel>_ev.cu), its
    event state kept on the device between chunks.  The result holds njev
    and nlu."""
    method = method.upper()
    B, n = y0.shape
    dev = y0.device
    p = spec.params()
    c = S.empty_carry(method, B, n, S.controller_dtype(p), dev)
    ra = run_args(tf, rtol, atol, hmax, hmin, max_steps, y0)
    modes = S.Modes(method, B, n, dev, t_grid, rec_cap, record_cont)
    first_step = S.nan_first_step(first_step, B, dev)
    launch = (S.StiffLaunch(method, fun, ra, args, p, lib, modes, events)
              if B else None)
    ev_out = (None if events is None else launch.ev_out if B else
              E.event_buffers(events, B, n, dev)[0])
    pieces, counts, chunks = _drain(
        lambda first: launch(c, c, y0, t0, first_step, first, S.UNBOUNDED,
                             stream),
        modes.n_rec, modes.rows, c.status)
    last = (c.t, c.y, c.status, c.nfev, c.nstep, c.naccpt, c.nrejct,
            modes.y_samples, modes.n_samples)
    return _assemble(pieces, B, n, modes.C, counts, last, chunks, ev_out,
                     counters=(c.njev, c.nlu))


def erk_record(method, fun, y0, t0, tf, hmax, first_step, rtol, atol,
               args=(), max_steps=100_000, t_grid=None, params=None,
               rec_cap=1024, record_cont=False, events=None,
               hmin=0.0) -> RecordResult:
    """Route by the device of ``y0``: CPU -> plain version, CUDA -> kernel
    (a stiff solve, ``params`` a StiffSpec, through
    :func:`stiff_record_launches`)."""
    method = method.upper()
    a = (fun, y0, t0, tf, hmax, first_step, rtol, atol, args, max_steps,
         t_grid, params)
    kw = dict(rec_cap=rec_cap, record_cont=record_cont, events=events)
    if y0.device.type == "cpu":
        return erk_record_torch(method, *a, **kw, hmin=hmin)
    if isinstance(params, StiffSpec) and y0.device.type == "cuda":
        S.check_card(params, fun)
        if int(rec_cap) < 1:
            raise ValueError(f"rec_cap must be at least 1, got {rec_cap}")
        with torch.cuda.device(y0.device):
            stream = torch.cuda.current_stream(y0.device).cuda_stream
            return stiff_record_launches(method, *a, int(rec_cap),
                                         record_cont, hmin, None, stream,
                                         events)
    if y0.device.type != "cuda":
        raise NotImplementedError(f"no route for device {y0.device}")
    if not isinstance(fun, CudaRHS):
        raise NotImplementedError(E.NO_GPU_CALLABLE)
    return erk_record_cuda(method, *a, **kw)


def record_bound(method, fun: CudaRHS, nstep, naccpt, n_rec, record_cont,
                 n_samples=None, m=0, peak=FP64_PEAK, rate=HBM_RATE,
                 events=None):
    """``(ms, bound_by)``: the least time a card could take for a record-mode
    solve whose lanes made ``nstep`` attempts, ``naccpt`` accepted, and
    recorded ``n_rec`` rows: :func:`erk_ensemble.solve_bound`'s work and
    bytes, with the dense rows built on every recorded step when
    ``record_cont``, else with events on the steps that need them
    (:func:`erk_ensemble.event_dense_steps`), else on the emitting steps
    as for samples, each recorded row of ``3 + n + C*n`` doubles written once,
    and with ``events`` ``(set, EventOut)`` the event work
    (:func:`erk_ensemble.event_work`)."""
    C = record_coeffs(method) if record_cont else 0
    rows = float(torch.as_tensor(n_rec).to(torch.float64).sum())
    ev_flops, ev_bytes = (0.0, 0.0) if events is None else E.event_work(
        method, fun, events[0], naccpt, events[1])
    return E.solve_bound(
        method, fun, nstep, naccpt, n_samples, m, peak, rate,
        dense_steps=(n_rec if record_cont else None if events is None else
                     E.event_dense_steps(events[1], naccpt, n_samples)),
        extra_bytes=8.0 * rows * (3 + fun.n + C * fun.n) + ev_bytes,
        extra_flops=ev_flops)


def record_layout(method, fun: CudaRHS, record_cont, lib=None) -> dict:
    """The staging of ``method``'s record kernel for ``fun`` in a mode, as
    the solves with default options run it (no samples, the controller in
    float) and its build (``lib``, default the package's) reports it:
    ``row_stride`` (doubles), ``staged_rows`` (K, slots a lane),
    ``smem_bytes_per_block``, ``blocks_per_sm``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, on the current device)
    and ``threads``."""
    method = method.upper()
    kernel, source = E.KERNELS[method]
    lib = build.library(source) if lib is None else lib
    fn = build.entry(f"ivp_{kernel}_record_layout_{fun.name}", [_I, _P],
                     lib=lib)
    info = (ctypes.c_int * 5)()
    build.check(fn(2 if record_cont else 1, info),
                f"{record_kernel(method, record_cont)} layout ({fun.name})",
                lib)
    return dict(zip(("row_stride", "staged_rows", "smem_bytes_per_block",
                     "blocks_per_sm", "threads"), info))


def record_kernel(method: str, record_cont: bool, events=False) -> str:
    """The LAUNCHES key of ``method``'s record kernel in a mode (its event
    mode with ``events``)."""
    return (f"{_NAMES[method.upper()]}_record{'_cont' if record_cont else ''}"
            f"{'_ev' if events else ''}")
