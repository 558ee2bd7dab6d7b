"""The explicit tier's fused ensemble kernels: router, launches, plain version.

``erk_ensemble`` integrates a ``(B, n)`` ensemble with one of DOPRI5, DOP853,
RK23 and RK4, to each lane's final state or with in-loop samples on a
``t_grid``.  It is the one entry the solvers call (batch.py), and it picks
the route from the device of ``y0``:

* a CPU tensor runs :func:`erk_ensemble_torch`, the plain version: the ported
  driver (core/driver.py) around the ported engine (methods/erk.py) on the
  whole batch;
* a CUDA tensor with a :class:`~ivp_tpu_torch.rhs.CudaRHS` launches one
  hand-written kernel per solve (:func:`erk_ensemble_cuda`):

  ============== ============================ ===========================
  kernel         source                       serves
  ============== ============================ ===========================
  dopri5         csrc/dopri5_ensemble.cu      DOPRI5, lean, default options
  dopri5_sampled csrc/erk_dopri5.cu           DOPRI5 with samples, or lean
                                              with ``solver_options``
  dop853         csrc/erk_dop853.cu           DOP853, lean and sampled
  rk23           csrc/erk_rk23.cu             RK23, lean and sampled
  rk4            csrc/erk_rk4.cu              RK4, lean and sampled
  ============== ============================ ===========================

  They replace the XLA-fused, vmapped ``ivp_tpu.core.driver.run_chunk``
  around each engine of ``ivp_tpu.methods.erk``; none has a TPU kernel of
  its own behind it (the one TPU kernel, attic/pallas_erk.py, is DOPRI5's);
* a CUDA tensor with any other callable raises NotImplementedError.

With ``events`` (an :class:`~ivp_tpu_torch.events.EventArgs`) the solve
detects events and restarts lanes in the loop: the plain version runs the
driver with events (core/events.py), and on the card each kernel's event
mode runs (entries ``ivp_<kernel>_ev_<rhs>_<set>``, one per declared event
set of the RHS, ivp_tpu_torch/events.py), still one launch a solve, the lean
DOPRI5 solve included.  An event mode builds the step's dense rows, which
Brent's iteration reads, only on a step where an event crosses for a set
without a restart map, and on every advanced step for one with a restart
map (the ball); a lean solve of a set without one queues its crossing
steps and rebuilds their rows later (csrc/erk_common.cuh, DEFER).

There is no fallback: a failed build or launch raises.  Every route takes
the same per-lane arguments, already broadcast by the caller: ``y0 (B, n)``,
``t0, tf, hmax (B,)``, ``first_step (B,)`` or None (hinit), ``rtol, atol
(B, n)``, the RHS ``args``, ``max_steps``, ``t_grid (B, m)`` or None, the
engine's ``params`` and ``events`` or None.  Each returns ``(t, y, status,
nfev, nstep, naccpt, nrejct, y_samples, n_samples)``, the last two None
without a grid, and with events an :class:`EventOut` after them.

:func:`solve_bound` gives the least time an H100 could take for a solve,
from the float64 work its lanes did (``FLOPS``) and the bytes it must move.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, NamedTuple

import torch

from ..core.driver import DriverConfig, make_driver, run_args
from ..events import MAX_EVENTS, EventArgs, device_set
from ..methods import get_engine
from ..methods.erk import ERKParams
from ..methods.jacobian import StiffSpec
from ..rhs import CudaRHS
from ..types import NCOEFF
from . import build
from . import dopri5_ensemble as lean_dopri5
from .dopri5_ensemble import FP64_PEAK, HBM_RATE, _check

# Launches made by this process, per kernel of this module (the lean DOPRI5
# kernel counts its own in kernels/dopri5_ensemble.py).  erk_ensemble_cuda
# adds one per launch; a caller may reset a count to 0.
LAUNCHES = {f"{k}{e}": 0 for k in ("dopri5_sampled", "dop853", "rk23", "rk4")
            for e in ("", "_ev")}

# Masked attempts per host check of the done mask in the plain version
# (build_ensemble_solver's default unroll in ivp_tpu).
_UNROLL = 4

# method -> (kernel name, source under csrc/)
KERNELS = {"DOPRI5": ("dopri5_sampled", "erk_dopri5"),
           "DOP853": ("dop853", "erk_dop853"),
           "RK23": ("rk23", "erk_rk23"),
           "RK4": ("rk4", "erk_rk4")}


class Flops(NamedTuple):
    """float64 operations of a kernel's loop, counted as the sources do them:
    an add, subtract or multiply 1 (an FMA 2), a division 1; compares, fabs,
    selects and the float32 controller 0.  ``*_n`` are per state component,
    ``rhs_*`` RHS evaluations, the rest per lane."""

    attempt_n: int     # every attempt
    attempt: int
    rhs_attempt: int
    rhs_accept: int    # more on an accepted attempt, lean
    dense_n: int       # the dense rows of a step that emits a sample
    rhs_dense: int
    sample_n: int      # each emitted sample
    sample: int


FLOPS = {
    # Stage sums of stages 2-6 and ynew, 3+5+7+9+11+11 = 46, and the error
    # vector, 12, per component; too_small 2, last 4, h/fac 1, t+h 1.  Dense:
    # ydiff 1, bspl 2, row 3 3, h*(D.k) 12.  A sample: (ti-xold)/h, 1-theta;
    # four nested multiply-adds per component.
    "DOPRI5": Flops(58, 8, 6, 0, 18, 0, 8, 3),
    # Stage rows of 1,2,2,3,3,4,5,6,7,8,9 terms: 2*50 + 11 = 111; b.k 15,
    # ynew 2, err2 6, err5 15: 149 per component; the same 8 per lane.  An
    # accepted attempt evaluates f(ynew).  Dense: three stages of 8 terms
    # (17 each) with their RHS, ydiff 1, bspl 2, row 3 3, four rows of 12
    # terms (24 each): 153.  A sample: 7 nested multiply-adds.
    "DOP853": Flops(149, 8, 11, 1, 153, 3, 14, 3),
    # Stages 2 and 3 (2 each), ynew 7, error vector 8 per component; h/2,
    # 3h/4, too_small 2, last 3, h*factor 1, t+h 1.  Dense: two rows of 4
    # terms.  A sample: 10 per component, (ti-xold)/h.
    "RK23": Flops(19, 9, 3, 0, 14, 0, 10, 2),
    # Three stage states (2 each) and ynew 9 per component; h/2, last 4,
    # t+h 1.  No dense rows: the Hermite reads the segment's ends.  A
    # sample: the four Hermite weights and their products with h (15), 7
    # per component.
    "RK4": Flops(15, 6, 4, 0, 0, 0, 7, 17),
}
# float64 operations of one RHS evaluation (csrc/rhs/*.cuh; a square root
# counts 1, as a division; the ball's is a negation and a copy).
RHS_FLOPS = {"vdp": 5, "decay": 1, "lorenz": 8, "cr3bp": 39, "ball": 0,
             "robertson": 13}


class EventOut(NamedTuple):
    """A solve's event results, each lane's own."""

    t_events: Any        # (B, E, cap) event times (valid up to n_events)
    y_events: Any        # (B, E, cap, n) states at them
    n_events: Any        # (B, E) int32 recorded occurrences
    event_overflow: Any  # (B, E) bool: occurrences dropped (buffer full)
    n_restarts: Any      # (B,) int32 in-loop restarts made
    n_brent: Any         # (B,) int32 event evaluations of the Brent
    #                      iterations (the event work's measure)


class KernelEvents(ctypes.Structure):
    """``ErkEvents`` of csrc/erk_common.cuh (same layout): the event
    buffers, the record mode's event carry, the capacity, the restart budget
    and mask, and each event's direction and terminal count."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "t_ev", "y_ev", "n_ev", "overflow", "n_restarts", "n_brent",
        "g_prev", "hits")]
        + [(f, ctypes.c_int) for f in ("cap", "max_restarts", "restart_mask")]
        + [("direction", ctypes.c_int * MAX_EVENTS),
           ("terminal", ctypes.c_int * MAX_EVENTS)])


def event_buffers(ev: EventArgs, B: int, n: int, device, carry=False):
    """``(EventOut, (g_prev, hits) or None)``: zeroed event outputs on
    ``device`` (rows past a lane's count stay zero, as in the plain
    version), and with ``carry`` the record mode's event carry."""
    E, cap = ev.n_events, ev.cap
    f64, i32 = torch.float64, torch.int32
    out = EventOut(
        torch.zeros((B, E, cap), dtype=f64, device=device),
        torch.zeros((B, E, cap, n), dtype=f64, device=device),
        torch.zeros((B, E), dtype=i32, device=device),
        torch.zeros((B, E), dtype=torch.bool, device=device),
        torch.zeros((B,), dtype=i32, device=device),
        torch.zeros((B,), dtype=i32, device=device))
    keep = ((torch.empty((B, E), dtype=f64, device=device),
             torch.empty((B, E), dtype=i32, device=device)) if carry else None)
    return out, keep


def kernel_events(fun, ev: EventArgs, out: EventOut, keep=None):
    """The launch argument of ``ev``'s events for ``fun``'s declared set:
    ``(set, KernelEvents)``; raises NotImplementedError (item 12) for
    events the kernels cannot run."""
    s, mask = device_set(fun, ev)
    spec = ev.spec()
    k = KernelEvents(
        *(x.data_ptr() for x in out),
        *((x.data_ptr() for x in keep) if keep is not None else (0, 0)),
        ev.cap, ev.max_restarts, mask)
    for i in range(s.n_events):
        k.direction[i] = spec.directions[i]
        k.terminal[i] = spec.terminal_counts[i]
    return s, k


class KernelOptions(ctypes.Structure):
    """``ErkOptions`` of csrc/erk_common.cuh: the numeric fields of
    :class:`ERKParams` and the controller's type."""

    _fields_ = ([(f, ctypes.c_double) for f in (
        "uround", "safety", "facc1", "facc2", "beta", "expo1",
        "stiff_threshold", "scale_min", "scale_max")]
                + [(f, ctypes.c_int) for f in (
                    "stiff_test", "iord", "sqrt_chain", "state_precision")])


def kernel_options(p: ERKParams) -> KernelOptions:
    """``p`` as the kernels' launch argument.  Each float is the Python
    float the plain version hands to a tensor operation; the kernel rounds
    it once to its controller's type (float, or double under
    ``controller_precision="state"``), as that operation does, so both
    routes compute with the same constants."""
    order = {"DOPRI5": (0.2, 0.75), "DOP853": (1.0 / 8.0, 0.2)}
    e0, eb = order.get(p.method, (0.0, 0.0))
    expo1 = e0 - p.beta * eb
    return KernelOptions(
        uround=p.uround, safety=p.safety, facc1=1.0 / p.scale_min,
        facc2=1.0 / p.scale_max, beta=p.beta, expo1=expo1,
        stiff_threshold=p.stiff_threshold, scale_min=p.scale_min,
        scale_max=p.scale_max, stiff_test=p.stiff_test, iord=p.iord,
        sqrt_chain=int(p.method == "DOP853" and p.beta == 0.0
                       and expo1 == 0.125),
        state_precision=int(p.controller_precision != "float32"))


def record_coeffs(method: str) -> int:
    """Coefficient rows a step record holds (``types.NCOEFF``; RK4's are
    the Hermite rows of its segment's ends)."""
    return NCOEFF[method.upper()]


def record_width(method: str, n: int, record_cont: bool) -> int:
    """Doubles of a record row ``[t, xold, h, y, cont]`` (kernels/
    erk_record.py, the stiff kernels' RECORD mode)."""
    return 3 + n + (record_coeffs(method) * n if record_cont else 0)


def record_stride(method: str, n: int, record_cont: bool) -> int:
    """Doubles from one row to the next in a kernel's chunk buffer: the
    row's width rounded up to even (csrc/erk_common.cuh ``RecStage::WP``,
    csrc/stiff_common.cuh ``row_stride``), so that each lane's rows go out
    in bulk copies of whole 16 bytes."""
    w = record_width(method, n, record_cont)
    return w + w % 2


def plain_driver(method, fun, y0, args, m, params, events, bounded=False,
                 unroll=None, **cfg):
    """The plain version's driver for a solve: ``(init_carry, run_chunk)``
    (``run_bounded`` for ``run_chunk`` with ``bounded``; ``unroll`` masked
    attempts between two checks, 4 by default) of the ported
    driver with ``method``'s engine (dense output where samples, events or
    ``cfg``'s coefficient records need it) and the events' functions, in
    ``y0``'s dtype and on its device.  ``params``: the explicit engines'
    ERKParams, or a stiff solve's StiffSpec (methods/jacobian.py)."""
    dtype = y0.dtype

    def rhs(t, y):
        return torch.as_tensor(fun(t, y, *args), dtype=dtype,
                               device=y.device).reshape(y.shape)

    need = m > 0 or events is not None or bool(cfg.get("record_cont"))
    if isinstance(params, StiffSpec):
        engine, p = params.engine(fun, rhs, args, dtype, need)
    else:
        engine, p = _engine(method, need, params)
    fns = ((None, None) if events is None else
           events.functions(args, dtype, y0.device))
    init_carry, run_chunk, run_bounded = make_driver(
        engine, p, DriverConfig(
            unroll=_UNROLL if unroll is None else unroll, sample_cap=m,
            event_spec=None if events is None else events.spec(),
            max_restarts=0 if events is None else events.max_restarts,
            **cfg), rhs, *fns)
    return init_carry, run_bounded if bounded else run_chunk


def carry_events(c) -> "EventOut":
    """The EventOut of a plain driver's carry."""
    ev = c.ev
    return EventOut(ev.t_buf, ev.y_buf, ev.n_rec, ev.overflow, c.n_restarts,
                    ev.n_brent)


def erk_ensemble_torch(method, fun, y0, t0, tf, hmax, first_step, rtol, atol,
                       args=(), max_steps=100_000, t_grid=None, params=None,
                       events=None, hmin=0.0, counters=False):
    """Plain PyTorch version: the ported driver on the whole batch, on the
    device of ``y0`` and in its dtype (float32 or float64).  ``hmin``: the
    least step size (the stiff engines read it); ``counters``: append the
    ``(njev, nlu)`` counters to the result."""
    B = y0.shape[0]
    m = 0 if t_grid is None else int(t_grid.shape[-1])
    init_carry, run_chunk = plain_driver(method, fun, y0, args, m, params,
                                         events)
    ra = run_args(tf, rtol, atol, hmax, hmin, max_steps, y0, t_grid=t_grid)
    t0 = torch.broadcast_to(torch.as_tensor(t0, dtype=y0.dtype,
                                            device=y0.device), (B,))
    c = run_chunk(init_carry(t0, y0, first_step, ra), ra)
    samples = (c.sample_y, c.s_cursor) if m else (None, None)
    out = (c.t, c.y, c.status, c.nfev, c.nstep, c.naccpt, c.nrejct, *samples)
    if events is not None:
        out = (*out, carry_events(c))
    return (*out, (c.njev, c.nlu)) if counters else out


def _engine(method, need_cont, params):
    """The engine of ``method`` with ``params`` (an ERKParams of that method,
    or None for its defaults), with dense output where samples or events
    need it (``need_cont``)."""
    if params is None:
        return get_engine(method, need_cont=need_cont)
    if params.method != method.upper() or params.need_cont != need_cont:
        raise ValueError(f"params are for {params.method} with need_cont="
                         f"{params.need_cont}, the solve is {method} with "
                         f"need_cont={need_cont}")
    engine, _ = get_engine(method, need_cont=need_cont)
    return engine, params


@functools.lru_cache(maxsize=None)
def _default_params(method: str, need_cont: bool) -> ERKParams:
    return get_engine(method, need_cont=need_cont)[1]


def is_default(p: ERKParams) -> bool:
    """Whether ``p`` holds its method's default options (the defaults are
    built once per method and mode)."""
    return p == _default_params(p.method, p.need_cont)


# (library, functor name) -> (n, nargs) the library's functor declares.
# Keyed by the library object itself, which the dict keeps alive, so a
# collected library's id cannot alias another's.
_FUNCTOR_SHAPES: dict = {}


def check_functor(lib, fun: CudaRHS, kargs) -> None:
    """Raise unless ``fun``'s state size and arg count are those of its
    CUDA functor in ``lib``; the library is asked once per functor."""
    key = (lib, fun.name)
    shape = _FUNCTOR_SHAPES.get(key)
    if shape is None:
        shape = tuple(build.entry(f"ivp_rhs_{q}_{fun.name}", [], lib=lib)()
                      for q in ("n", "nargs"))
        _FUNCTOR_SHAPES[key] = shape
    if shape != (fun.n, kargs.shape[1]):
        raise RuntimeError(
            f"{fun!r} has n={fun.n}, {kargs.shape[1]} args; its CUDA functor "
            f"has n={shape[0]}, {shape[1]} args")


NO_GPU_CALLABLE = (
    "on a CUDA device the solve runs a CudaRHS (ivp_tpu_torch.rhs) through "
    "the fused kernel; an arbitrary torch RHS on the GPU is not ported yet: "
    "ROADMAP §1 item 12 (arbitrary RHS on the GPU)")


def check_inputs(fun: CudaRHS, y0, t0, tf, hmax, first_step, rtol, atol,
                 t_grid):
    """Check the per-lane inputs of a kernel launch (float64, on ``y0``'s
    device, contiguous, shaped for ``fun``): ``(first_step, grid_ptr,
    grid_stride)``, first_step NaN-filled where hinit picks it and the grid
    as the kernel reads it (row 0 of a shared grid given as an expanded
    view, else each lane's row)."""
    dev = y0.device
    B, n = y0.shape if y0.dim() == 2 else (-1, -1)
    f64 = torch.float64
    _check("y0", y0, (B, fun.n), f64, dev)
    for name, x in (("t0", t0), ("tf", tf), ("hmax", hmax)):
        _check(name, x, (B,), f64, dev)
    if first_step is None:
        first_step = torch.full((B,), float("nan"), dtype=f64, device=dev)
    _check("first_step", first_step, (B,), f64, dev)
    _check("rtol", rtol, (B, n), f64, dev)
    _check("atol", atol, (B, n), f64, dev)
    grid_ptr, grid_stride, _ = grid_arg(t_grid, B, dev)
    return first_step, grid_ptr, grid_stride


def grid_arg(t_grid, B, dev):
    """``(grid_ptr, grid_stride, grid)``: a ``(B, m)`` float64 ``t_grid``
    (or None: 0, 0, None) as a kernel reads it, row 0 of a shared grid given
    as an expanded view, else each lane's row of a contiguous copy
    (``grid``, which the caller holds while the kernel reads it)."""
    if t_grid is None:
        return 0, 0, None
    m = int(t_grid.shape[-1])
    grid_stride = 0
    if t_grid.stride(0) == 0 and t_grid.stride(1) == 1:
        grid = t_grid[:1]        # shared: every lane reads row 0
    else:
        grid = t_grid.contiguous()
        grid_stride = m
    _check("t_grid", grid, (grid.shape[0], m), torch.float64, dev)
    if grid.shape[0] not in (1, B):
        raise ValueError(f"t_grid must have {B} rows, got {grid.shape[0]}")
    return grid.data_ptr(), grid_stride, grid


_P, _I = ctypes.c_void_p, ctypes.c_int
# B; y0, t0, tf, hmax, first_step, rtol, atol, args; max_steps; options;
# t_grid, m, grid_stride; t, y and five counters, y_samples, n_samples; stream.
_ARGTYPES = ([_I] + [_P] * 8 + [_I, KernelOptions, _P, _I, _I]
             + [_P] * 9 + [_P])
# The event entries: the same with the events before the stream.
_ARGTYPES_EV = _ARGTYPES[:-1] + [KernelEvents, _P]


def erk_ensemble_cuda(method, fun: CudaRHS, y0, t0, tf, hmax, first_step,
                      rtol, atol, args=(), max_steps=100_000, t_grid=None,
                      params=None, lib=None, events=None):
    """Launch ``method``'s CUDA kernel on the current stream (no
    synchronisation).  float64 only; ``t_grid`` is ``(B, m)`` (a shared grid
    as an expanded view is read through its strides, not copied).  ``lib``:
    a library from ``build.load`` to launch from instead of the package's
    (measure_kernel.py's A/B and launch-bound sweep).  ``events``: the
    event mode of the kernel for the declared set they form."""
    if not isinstance(fun, CudaRHS):
        raise TypeError(f"the CUDA kernel runs a CudaRHS, got {fun!r}")
    dev = y0.device
    if dev.type != "cuda":
        raise ValueError(f"y0 must be a CUDA tensor, got {dev}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return ensemble_launch(method, fun, y0, t0, tf, hmax, first_step,
                               rtol, atol, args, max_steps, t_grid, params,
                               lib, stream, events)


def ensemble_launch(method, fun: CudaRHS, y0, t0, tf, hmax, first_step, rtol,
                    atol, args, max_steps, t_grid, params, lib, stream,
                    events=None):
    """What :func:`erk_ensemble_cuda` does once it has checked the device:
    the outputs allocated on ``y0``'s device and one launch from ``lib``
    (default: the package's build of the method's source) on ``stream``, so
    that a build rehearsed without nvcc runs it on CPU tensors with stream
    0."""
    method = method.upper()
    dev = y0.device
    B, n = y0.shape if y0.dim() == 2 else (-1, -1)
    f64 = torch.float64
    m = 0 if t_grid is None else int(t_grid.shape[-1])
    _, p = _engine(method, m > 0 or events is not None, params)
    opts = kernel_options(p)
    if events is not None:
        ev_out, _ = event_buffers(events, B, n, dev)
        ev_set, ev_arg = kernel_events(fun, events, ev_out)
    first_step, grid_ptr, grid_stride = check_inputs(
        fun, y0, t0, tf, hmax, first_step, rtol, atol, t_grid)
    kargs = fun.kernel_args(args, B, dev)

    t_out = torch.empty((B,), dtype=f64, device=dev)
    y_out = torch.empty((B, n), dtype=f64, device=dev)
    ints = [torch.empty((B,), dtype=torch.int32, device=dev) for _ in range(5)]
    # Rows past a lane's n_samples stay zero, as in the plain version.
    y_samples = torch.zeros((B, m, n), dtype=f64, device=dev) if m else None
    n_samples = (torch.zeros((B,), dtype=torch.int32, device=dev) if m
                 else None)
    out = (t_out, y_out, *ints, y_samples, n_samples)
    if events is not None:
        out = (*out, ev_out)
    if B == 0:
        return out

    kernel, source = KERNELS[method]
    lib = build.library(source) if lib is None else lib
    check_functor(lib, fun, kargs)
    if events is None:
        name, key, tail = f"ivp_{kernel}_{fun.name}", kernel, ()
    else:
        name = f"ivp_{kernel}_ev_{fun.name}_{ev_set.name}"
        key, tail = f"{kernel}_ev", (ev_arg,)
    launch = build.entry(name, _ARGTYPES if events is None else _ARGTYPES_EV,
                         lib=lib)
    err = launch(B, y0.data_ptr(), t0.data_ptr(), tf.data_ptr(),
                 hmax.data_ptr(), first_step.data_ptr(), rtol.data_ptr(),
                 atol.data_ptr(), kargs.data_ptr(), int(max_steps), opts,
                 grid_ptr, m, grid_stride,
                 t_out.data_ptr(), y_out.data_ptr(),
                 *(x.data_ptr() for x in ints),
                 y_samples.data_ptr() if m else 0,
                 n_samples.data_ptr() if m else 0, *tail, stream)
    build.check(err, f"{name} kernel launch (B={B}, m={m})", lib)
    LAUNCHES[key] += 1
    return out


def erk_ensemble(method, fun, y0, t0, tf, hmax, first_step, rtol, atol,
                 args=(), max_steps=100_000, t_grid=None, params=None,
                 events=None):
    """Route by the device of ``y0``: CPU -> plain version, CUDA -> kernel."""
    method = method.upper()
    a = (fun, y0, t0, tf, hmax, first_step, rtol, atol, args, max_steps)
    if y0.device.type == "cpu":
        return erk_ensemble_torch(method, *a, t_grid, params, events)
    if y0.device.type != "cuda":
        raise NotImplementedError(f"no route for device {y0.device}")
    if not isinstance(fun, CudaRHS):
        raise NotImplementedError(NO_GPU_CALLABLE)
    if (method == "DOPRI5" and t_grid is None and events is None
            and (params is None or is_default(params))):
        return (*lean_dopri5.dopri5_ensemble_cuda(*a), None, None)
    return erk_ensemble_cuda(method, *a, t_grid, params, events=events)


def solve_flops(method, fun: CudaRHS, nstep, naccpt, n_samples=None,
                dense_steps=None) -> float:
    """float64 operations of a solve whose lanes made ``nstep`` attempts,
    ``naccpt`` of them accepted, and emitted ``n_samples`` samples (None:
    none).  The dense rows count on ``dense_steps`` steps a lane (a record
    of coefficients builds them on every recorded step), by default, with
    samples, min(naccpt, n_samples): a lane emits its samples from at most
    that many steps, so that is the least work that gives them.  Each lane's
    hinit and the stiffness differences (1 attempt in ~1000) are left out,
    so a bound from this stays a lower one."""
    f, n, r = FLOPS[method.upper()], fun.n, RHS_FLOPS[fun.name]
    as64 = lambda x: torch.as_tensor(x).to(torch.float64)
    tot = lambda x: float(as64(x).sum())
    flops = tot(nstep) * (n * f.attempt_n + f.attempt + r * f.rhs_attempt)
    flops += tot(naccpt) * r * f.rhs_accept
    if dense_steps is None and n_samples is not None:
        dense_steps = torch.minimum(as64(naccpt), as64(n_samples))
    if dense_steps is not None:
        flops += tot(dense_steps) * (n * f.dense_n + r * f.rhs_dense)
    if n_samples is not None:
        flops += tot(n_samples) * (n * f.sample_n + f.sample)
    return flops


# hinit's float64 operations besides its RHS evaluation (core/common.py:
# per component the scale, two quotients and their squares, the Euler
# probe and the difference quotient's square; per lane the step choice).
INIT_FLOPS_N, INIT_FLOPS = 14, 10


def event_work(method, fun: CudaRHS, ev_set, naccpt, out: EventOut):
    """``(flops, bytes)`` of the event mode's work on a solve, besides
    :func:`solve_flops`'s: each event function at every advanced step
    (``naccpt``), one interpolant and one event function a Brent
    evaluation (``out.n_brent``, the kernel's own count), and each
    restart's map, event values and method init (two RHS evaluations and
    hinit); the bytes are the recorded occurrences (a time and a state
    each) and each lane's counts, flags and restart count.  ``ev_set``: the
    declared set (events.SETS)."""
    f, n, r = FLOPS[method.upper()], fun.n, RHS_FLOPS[fun.name]
    tot = lambda x: float(torch.as_tensor(x).to(torch.float64).sum())
    values = float(sum(ev_set.value_flops))
    brent = n * f.sample_n + f.sample + max(ev_set.value_flops)
    restart = (max(ev_set.restart_flops) + values + 2 * r
               + n * INIT_FLOPS_N + INIT_FLOPS)
    flops = (tot(naccpt) * values + tot(out.n_brent) * brent
             + tot(out.n_restarts) * restart)
    B, E = out.n_events.shape
    nbytes = (8.0 * (1 + n) * tot(out.n_events)
              + B * (E * (4 + 1) + 4 + 4))
    return flops, nbytes


def crossing_steps(out: EventOut):
    """``(B,)`` float64: the steps of each lane on which an event crossed,
    as few as its recorded occurrences allow (a step where several events
    cross counts once, so the most occurrences of one event)."""
    return out.n_events.to(torch.float64).amax(dim=1)


def event_dense_steps(out: EventOut, naccpt, n_samples=None):
    """``(B,)``: the steps whose dense rows an event solve needs, as few as
    the outputs allow: each crossing step (:func:`crossing_steps`), whose
    Brent iteration reads them, and, sampled, the steps that emit (at least
    min(naccpt, n_samples), as :func:`solve_flops` takes them), whichever
    is more.  A kernel may build more (csrc/erk_common.cuh: every advanced
    step of a set with a restart map, a deferred crossing's step twice);
    the bound counts what the function needs."""
    steps = crossing_steps(out)
    if n_samples is not None:
        steps = torch.maximum(steps, torch.minimum(
            torch.as_tensor(naccpt).to(steps), torch.as_tensor(
                n_samples).to(steps)))
    return steps


def event_bound(method, fun: CudaRHS, ev_set, nstep, naccpt, out: EventOut,
                n_samples=None, m=0, peak=FP64_PEAK, rate=HBM_RATE):
    """``(ms, bound_by, ms_rows_every_accept)``: :func:`solve_bound` of an
    event-mode solve (no record) with the event work (:func:`event_work`)
    and the dense rows on the steps that need them
    (:func:`event_dense_steps`); and the same bound with rows on every
    accepted step (the kernels' own count before the rows were lazy).
    ``ev_set``: the declared set (events.SETS)."""
    fl, by = event_work(method, fun, ev_set, naccpt, out)
    dense = event_dense_steps(out, naccpt, n_samples)
    ms, bound_by = solve_bound(method, fun, nstep, naccpt, n_samples, m, peak,
                               rate, dense_steps=dense, extra_bytes=by,
                               extra_flops=fl)
    every = solve_bound(method, fun, nstep, naccpt, n_samples, m, peak, rate,
                        dense_steps=naccpt, extra_bytes=by, extra_flops=fl)[0]
    return ms, bound_by, every


def solve_bound(method, fun: CudaRHS, nstep, naccpt, n_samples=None, m=0,
                peak=FP64_PEAK, rate=HBM_RATE, dense_steps=None,
                extra_bytes=0.0, extra_flops=0.0):
    """``(ms, bound_by)``: the least time a card with float64 rate ``peak``
    and memory rate ``rate`` could take for the solve of
    :func:`solve_flops`.  The larger of that work over ``peak`` and, over
    ``rate``, the bytes read once (y0, rtol, atol; t0, tf, hmax, first_step;
    the args; a lane's ``m`` grid times) and written once (t, y; five int32
    counters; ``m`` rows of samples and their count), plus ``extra_bytes``
    (a record mode's rows, the event buffers) and ``extra_flops`` (the
    events' work, :func:`event_work`)."""
    B, n = torch.as_tensor(nstep).numel(), fun.n
    flops = solve_flops(method, fun, nstep, naccpt, n_samples, dense_steps)
    flops += extra_flops
    lane = 8 * (3 * n + 4 + len(fun.defaults)) + 8 * (1 + n) + 4 * 5
    if n_samples is not None:
        lane += 8 * m + 8 * m * n + 4
    t_ops, t_bytes = flops / peak, (B * lane + extra_bytes) / rate
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")
