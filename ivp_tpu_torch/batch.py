"""Batched ensemble solving (``ivp_tpu.batch``): the explicit tier.

Thousands of independent IVPs integrate together, each with its own
adaptive step size, step counters and status code, to each lane's final
state or with in-loop samples on a ``t_eval`` grid, or recording every
step (``record_trajectories``) and its dense coefficients
(``dense_output``, evaluated by :class:`BatchOdeSolution`).  The reference
vmaps a ``lax.while_loop``; here the batch axis is explicit and the solve
runs through ``kernels/erk_ensemble.py`` (``kernels/erk_record.py`` when
recording): the plain PyTorch driver for CPU tensors, fused CUDA kernel
launches for CUDA tensors with a :class:`~ivp_tpu_torch.rhs.CudaRHS`.  A
torch tensor ``y0_batch`` keeps its device (a ``device`` argument that names
another raises); anything else (a numpy array, a list) goes to the card
(``torch.device("cuda")``) unless the caller passes ``device="cpu"``.  There
is no fallback: with no CUDA device such a call raises.

The RHS is batched: ``fun(t, y, *args)`` takes ``t`` of shape ``(B,)`` and
``y`` of shape ``(B, n)`` and returns ``(B, n)``.

Ported: ``"RK45"``, ``"DOP853"``, ``"RK23"``, ``"RK4"``, ``"Radau"`` and
``"BDF"`` with ``t_eval``, the engines' ``solver_options``, ``jac``, the
recording tier, events with in-loop restarts (``events``,
``event_capacity``, ``max_restarts``; ivp_tpu_torch/events.py has the
contract), the resumable solver (:func:`build_resumable_solver`: the carry
is the checkpoint) and an integer ``lane_chunk``.  The stiff methods run on
the card to each lane's final state or with ``t_eval`` samples in one
launch, recording in chunks, or resumably (kernels/stiff_ensemble.py,
kernels/erk_record.py), each with events too but the resumable solver,
which runs samples and events on the CPU.  Options of later
slices raise NotImplementedError naming their ROADMAP item, and so does
float32 on the card, all before anything is placed on a device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .types import canonical_method
from .core.cache import LRUCache, cache_token
from .events import as_list, device_set, event_args
from .rhs import CudaRHS
from .methods import get_engine
from .methods.interp import get_interp
from .methods.ddtier import resolve_auto_dtype
from .methods.jacobian import stiff_spec
from .methods.radau import STIFF_REST_ITEM
from .core.driver import run_args
from .kernels import erk_ensemble as E
from .kernels import resumable as RES
from .kernels import stiff_ensemble as S
from .kernels.erk_ensemble import erk_ensemble
from .kernels.erk_record import STIFF_MODES_ON_CARD, erk_record

STIFF = ("RADAU", "BDF")


class EnsembleResult(NamedTuple):
    """The fields, in their order, of ``ivp_tpu.batch.EnsembleResult``
    (``switched`` waits for ``method="auto"``, ROADMAP §1 item 8), and the
    stiff methods' ``njev`` and ``nlu`` (which ``ivp_tpu`` keeps in its
    carry only)."""

    t: Any        # (B,) final time per trajectory
    y: Any        # (B, n) final state
    status: Any   # (B,) int32 status codes (0 = success)
    nfev: Any     # (B,) int32
    nstep: Any    # (B,) int32
    naccpt: Any   # (B,) int32
    nrejct: Any   # (B,) int32
    t_events: Any = None   # (B, E, cap) event times (valid up to n_events)
    y_events: Any = None   # (B, E, cap, n) states at them
    n_events: Any = None   # (B, E) int32 recorded occurrences per event
    y_samples: Any = None  # (B, m, n) states at the t_eval grid
    n_samples: Any = None  # (B,) int32 emitted sample counts
    n_restarts: Any = None  # (B,) int32 in-loop event restarts made
    event_overflow: Any = None  # (B, E) bool: occurrences dropped because
    #                             the fixed-capacity buffer was full
    ts: Any = None         # (B, S) recorded step endpoints (recording tier;
    #                        rows past a lane's n_steps_rec are zero)
    ys: Any = None         # (B, S, n) recorded states
    n_steps_rec: Any = None  # (B,) int64 recorded steps per lane
    njev: Any = None       # (B,) int32 Jacobian evaluations (Radau, BDF)
    nlu: Any = None        # (B,) int32 decompositions (Radau, BDF)
    sol: Any = None        # BatchOdeSolution (dense_output)


def _unported(**opts):
    """Raise NotImplementedError for the first option set to a value this
    slice does not run.  ``opts`` maps name -> (is_set, ROADMAP item)."""
    for name, (is_set, where) in opts.items():
        if is_set:
            raise NotImplementedError(
                f"{name} is not ported to ivp_tpu_torch yet: ROADMAP §1 {where}")


def _later_slices(time_dtype, jac_sparsity):
    """The solver factories' options of later slices: NotImplementedError
    naming the first one set."""
    _unported(time_dtype=(time_dtype is not None, TIME_DTYPE_ITEM),
              jac_sparsity=(jac_sparsity is not None, STIFF_REST_ITEM))


def _solver_params(method, n, jac, solver_options, need_cont):
    """The params a solve hands its route: a Radau or BDF solve's
    StiffSpec (whose unported options raise here), else the explicit
    engine's ERKParams.  ``jac`` is read by the stiff methods only."""
    if method in STIFF:
        return stiff_spec(method, n, jac, solver_options)
    return get_engine(method, need_cont=need_cont,
                      **(solver_options or {}))[1]


def _refuse_stiff_on_card(method, spec, fun, y0, device):
    """What the stiff kernels do not run (``stiff_ensemble.check_card``)
    raises NotImplementedError on a CUDA placement, before anything is
    placed."""
    if method in STIFF and placement(y0, device).type == "cuda":
        S.check_card(spec, fun)


def _auto_lane_chunk(method, n, B, dtype, solver_options) -> Optional[int]:
    """Default lane-chunk size of ``lane_chunk="auto"``: the base table of
    ``ivp_tpu.batch._auto_lane_chunk`` (its off-TPU reading; the halving
    for a TPU kind it has not measured is not ported).  Radau and BDF
    (and ``method="auto"``, whose stiff leg needs it) at ``n >= 16`` solve
    in sub-batches of 8192 lanes (n < 48), 1024 (n < 96; 2048 with float32
    factors: float32 or double-float state, ``newton_precision="mixed"``
    or ``factor_f32``) or 256, where ``B`` exceeds the chunk; None (no
    chunking) otherwise."""
    m = str(method).upper() if isinstance(method, str) else ""
    if m == "AUTO":
        m = "RADAU"
    else:
        m = canonical_method(method) if isinstance(method, str) else ""
    if m not in ("RADAU", "BDF") or n < 16:
        return None
    so = solver_options or {}
    f32_factor = ((isinstance(dtype, str)
                   and dtype.lower() in ("dd", "ddf32", "double-float"))
                  or (dtype is not None and not isinstance(dtype, str)
                      and _is_float32(dtype))
                  or so.get("newton_precision") == "mixed"
                  or so.get("factor_f32"))
    if n < 48:
        chunk = 8192
    elif n < 96:
        chunk = 2048 if f32_factor else 1024
    else:
        chunk = 256
    return chunk if B > chunk else None


def _is_float32(dtype) -> bool:
    """Whether a dtype object (torch's or numpy's) is float32."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    try:
        return np.dtype(dtype) == np.float32
    except TypeError:
        return False


def _auto_event_capacity(y0_shape, events, dtype, lane_chunk=None) -> int:
    """Default per-event record capacity of the ensemble tier
    (``ivp_tpu.batch._auto_event_capacity``): the buffers of one solve (a
    sub-batch of ``lane_chunk`` lanes where the lanes are chunked) hold
    ``B * E * cap * (n + 1)`` values, so budget ~32 MiB for them and clamp
    to [16, 512]; small ensembles get the single-IVP facade's 512, huge
    ones 16 (overflow is flagged on ``EnsembleResult.event_overflow`` and
    warned about)."""
    if not events:
        return 16
    n_ev = 1 if callable(events) else max(1, len(list(events)))
    B, n = int(y0_shape[0]), max(1, int(y0_shape[1]))
    if lane_chunk is not None:
        B = min(B, int(lane_chunk))
    itemsize = 4 if dtype == torch.float32 else 8
    cap = (32 * 1024 * 1024) // max(1, B * n_ev * (n + 1) * itemsize)
    return int(min(512, max(16, cap)))


def _warn_event_overflow(res):
    """Warn when the event buffers overflowed on some lane (occurrences
    were dropped: a silent flag is easy to miss)."""
    ov = res.event_overflow
    if ov is not None and ov.numel() and bool(ov.any()):
        import warnings
        warnings.warn(
            "event record buffers overflowed on some lanes (occurrences "
            "were dropped; see EnsembleResult.event_overflow).  Raise "
            "event_capacity= to keep them.", UserWarning, stacklevel=3)
    return res


def _event_fields(out) -> dict:
    """The event buffers' EnsembleResult fields of a solve's EventOut
    (``out``, or None without events)."""
    if out is None:
        return {}
    return dict(t_events=out.t_events, y_events=out.y_events,
                n_events=out.n_events, event_overflow=out.event_overflow)


# Where ROADMAP §1 keeps time_dtype (f64 time with f32 state).
TIME_DTYPE_ITEM = "item 14 (time_dtype: f64 time with f32 state)"


def _check_method(method):
    if isinstance(method, str) and method.lower() == "auto":
        raise NotImplementedError(
            "method='auto' is not ported to ivp_tpu_torch yet: ROADMAP §1 "
            "item 8 (auto.py)")
    return canonical_method(method)


def _norm_sample_grid(t_eval):
    """Validate a t_eval grid: (m,) shared or (B, m) per-lane, each lane
    monotone (the in-loop sample cursor only moves forward, so an unsorted
    grid would be sampled wrongly without a word: refuse it up front)."""
    grid = np.atleast_1d(np.asarray(t_eval, dtype=float))
    if grid.ndim > 2:
        raise ValueError("t_eval must be 1-D (shared) or 2-D (per-lane)")
    if grid.shape[-1] > 1:
        d = np.diff(grid, axis=-1)
        mono = (np.all(d >= 0.0, axis=-1) | np.all(d <= 0.0, axis=-1))
        if not np.all(mono):
            raise ValueError(
                "t_eval must be sorted (monotone in the integration "
                "direction) for ensemble solvers")
    return grid


def _norm_tol(v, B, n, dtype, device, name):
    """Normalize a tolerance to a contiguous ``(B, n)`` tensor.

    scalar / (n,)            -> shared across the batch
    (B,) with B != n         -> per-lane scalar
    (B, 1) or (B, n)         -> per-lane (possibly per-component)

    A 1-D length-B array with B == n is ambiguous and treated as
    per-component; pass shape (B, 1) to force per-lane in that case.
    """
    if isinstance(v, (int, float)):
        return torch.full((B, n), float(v), dtype=dtype, device=device)
    a = torch.as_tensor(v, dtype=dtype, device=device)
    if a.ndim == 1 and a.shape[0] == B and B != n:
        a = a[:, None]
    if a.ndim == 2:
        if a.shape[0] != B:
            raise ValueError(
                f"{name} with 2 dims must have leading batch dim {B}, "
                f"got {tuple(a.shape)}")
        return torch.broadcast_to(a, (B, n)).contiguous()
    return torch.broadcast_to(torch.broadcast_to(a, (n,)), (B, n)).contiguous()


def _lanes(v, B, dtype, device) -> torch.Tensor:
    """A scalar or (B,) value as a contiguous (B,) tensor.  Python numbers
    are filled on the device: a host-to-device copy of a pageable scalar
    would wait for the work already queued on the stream."""
    if isinstance(v, (int, float)):
        return torch.full((B,), float(v), dtype=dtype, device=device)
    return torch.broadcast_to(torch.as_tensor(v, dtype=dtype, device=device),
                              (B,)).contiguous()


F32_ON_CARD = ("float32 on the card is not ported to ivp_tpu_torch yet: "
               "ROADMAP §2 open item 3 (float32 state on the card); run "
               "float32 with device='cpu', or float64 on the card")


def placement(y0, device) -> torch.device:
    """Where a solve would run, without placing anything: a tensor's own
    device, else ``device``, else the card."""
    if isinstance(y0, torch.Tensor):
        return y0.device
    return torch.device("cuda" if device is None else device)


def _refuse_f32_on_card(dtype, y0, device):
    """float32 on a CUDA placement raises NotImplementedError (the kernels
    are float64), before anything is placed or the card is looked for."""
    if dtype == torch.float32 and placement(y0, device).type == "cuda":
        raise NotImplementedError(F32_ON_CARD)


def _refuse_events_on_card(fun, ev, y0, device):
    """Events the kernels cannot run (a plain callable, another RHS's set)
    on a CUDA placement raise NotImplementedError, before anything is
    placed."""
    if ev is not None and placement(y0, device).type == "cuda":
        device_set(fun, ev)


def _place(y0_batch, device) -> torch.device:
    """The device a solve runs on: a tensor's own, else ``device``, else the
    card.  Raises ValueError when ``device`` is given and is not the
    tensor's, and RuntimeError, naming the argument, when the solve would
    run on a card and there is none: nothing moves or falls back silently."""
    if isinstance(y0_batch, torch.Tensor):
        own = y0_batch.device
        if device is not None:
            want = torch.device(device)
            if want.type != own.type or want.index not in (None, own.index):
                raise ValueError(
                    f"y0_batch is a tensor on {own} and device={str(want)!r} "
                    "was asked for; move the tensor or drop device")
        return own
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "y0_batch is not a tensor, so the solve runs on the card "
            "(torch.device('cuda')), and there is no CUDA device; pass "
            "device='cpu' to run on the CPU")
    return dev


def _as_state(y0_batch, dtype, device) -> torch.Tensor:
    dev = _place(y0_batch, device)
    if isinstance(y0_batch, torch.Tensor):
        return y0_batch.to(dtype).contiguous()
    return torch.as_tensor(np.asarray(y0_batch, dtype=float), dtype=dtype,
                           device=dev)


def build_ensemble_solver(fun, method="RK45", *, n, dtype=None, args=(),
                          jac=None, jac_sparsity=None,
                          max_steps: int = 100_000,
                          first_step: Optional[float] = None,
                          max_step: Optional[float] = None,
                          min_step: float = 0.0,
                          events=None, event_capacity: int = 16,
                          unroll: int = 4, t_eval=None,
                          solver_options: Optional[dict] = None,
                          args_batched: bool = False,
                          max_restarts: int = 0,
                          time_dtype=None) -> Callable:
    """Return ``solver(y0_batch, t0, tf, rtol, atol) -> EnsembleResult``.

    ``method``: ``"RK45"``/``"DOPRI5"``, ``"DOP853"``, ``"RK23"``,
    ``"RK4"`` (fixed step: pass ``first_step``, else hinit picks it),
    ``"Radau"`` or ``"BDF"`` (the result then has ``njev`` and ``nlu``).

    ``jac`` (Radau, BDF; methods/jacobian.py has the contract): None (the
    CudaRHS's own Jacobian, else forward-mode differentiation of ``fun``),
    a batched callable ``jac(t (B,), y (B, n), *args) -> (B, n, n)``, or a
    constant ``(n, n)`` matrix.  On the card a stiff solve runs a CudaRHS
    with a Jacobian and ``jac=None``.

    ``y0_batch`` has shape ``(B, n)``; ``t0``/``tf`` are scalars or ``(B,)``
    per-lane spans; ``rtol``/``atol`` are scalars, ``(n,)``, ``(B,)``,
    ``(B, 1)`` or ``(B, n)`` (see :func:`_norm_tol`).

    ``args_batched=True``: every element of ``args`` carries a leading
    ``(B,)`` axis, one value per lane (parameter sweeps).

    ``dtype``: ``None``, ``"auto"`` and ``"dd"`` resolve to float64 (native
    f64 on CPUs and GPUs); ``torch.float32`` runs the CPU route only (on a
    CUDA placement it raises NotImplementedError before placing anything).

    ``t_eval``: a sorted grid, ``(m,)`` shared or ``(B, m)`` per lane.  Each
    lane's states there come back as ``y_samples (B, m, n)``, interpolated
    inside the loop from the step that covers each time, with ``n_samples``
    the count a lane emitted (fewer than ``m`` where it stopped early; rows
    past it are zero).

    ``solver_options``: the explicit engines' controller options
    (``uround, safety, scale_min, scale_max, beta, stiff_test,
    stiff_threshold, iord, controller_precision``); an unknown one raises
    TypeError.

    ``events``: event callables (ivp_tpu_torch/events.py), each called
    batched, ``g(t (B,), y (B, n), *args) -> (B,)``; on the card a declared
    event set of ``fun``.  Each lane records up to ``event_capacity``
    occurrences of each event (``t_events (B, E, cap)``, ``y_events (B, E,
    cap, n)``, ``n_events (B, E)``, ``event_overflow (B, E)`` where one was
    dropped); a terminal event stops its lane with status 1.
    ``max_restarts``: an event with a ``restart`` map that fires terminally
    restarts its lane from the event point with the mapped state, up to
    that many times a lane (``n_restarts (B,)``).  ``terminal``,
    ``direction`` and ``restart`` are read at each call.

    ``min_step`` bounds the stiff engines' step sizes and is, as in
    ivp_tpu, unused by the explicit ones.  ``unroll`` is accepted and has
    no effect: the kernels loop per lane, and the plain version's
    host-check cadence is fixed.  ``time_dtype`` and ``jac_sparsity`` raise
    NotImplementedError naming their slice.
    """
    del unroll
    _later_slices(time_dtype, jac_sparsity)
    method = _check_method(method)
    dtype = resolve_auto_dtype(dtype)
    args = tuple(args)
    ev_list = as_list(events)
    sample_grid = None if t_eval is None else _norm_sample_grid(t_eval)
    sample_cap = 0 if sample_grid is None else int(sample_grid.shape[-1])
    params = _solver_params(method, n, jac, solver_options,
                            sample_cap > 0 or bool(ev_list))
    hmin = abs(float(min_step))
    grids = {}   # the build-time grid on each device it has run on

    def solver(y0_batch, t0, tf, rtol, atol, t_grid=None, batched_args=None,
               device=None):
        """``t_grid`` / ``batched_args`` override the ``t_eval`` grid given
        at build time (same length) / the per-lane ``args`` (requires
        ``args_batched=True``).  ``device``: where a ``y0_batch``
        that is not a tensor goes; the card by default, ``"cpu"`` for the
        plain version.  A tensor keeps its own device; a ``device`` given
        with it must name that device (ValueError otherwise)."""
        _refuse_f32_on_card(dtype, y0_batch, device)
        ev = event_args(ev_list, event_capacity, max_restarts)
        _refuse_stiff_on_card(method, params, fun, y0_batch, device)
        _refuse_events_on_card(fun, ev, y0_batch, device)
        y0 = _as_state(y0_batch, dtype, device)
        if y0.ndim != 2 or y0.shape[1] != n:
            raise ValueError(f"y0_batch must have shape (B, {n}), "
                             f"got {tuple(y0.shape)}")
        B, dev = y0.shape[0], y0.device
        kw = dict(dtype=dtype, device=dev)
        t0_b = _lanes(t0, B, **kw)
        tf_b = _lanes(tf, B, **kw)
        hmax = torch.abs(tf_b - t0_b)
        if max_step is not None:
            hmax = torch.clamp_max(hmax, abs(float(max_step)))
        fs = (torch.full((B,), float(first_step), **kw)
              if first_step is not None else None)
        if batched_args is not None and not args_batched:
            raise ValueError("explicit batched_args requires args_batched=True")
        lane_args = args if batched_args is None else tuple(batched_args)
        if args_batched:
            lane_args = tuple(_lane_arg(a, B, **kw) for a in lane_args)
        if t_grid is not None:
            grid = torch.as_tensor(t_grid, **kw)
        elif sample_grid is not None:
            grid = grids.get(dev)
            if grid is None:
                grid = grids[dev] = torch.as_tensor(sample_grid, **kw)
        else:
            grid = None
        if grid is not None:
            if (t_grid is not None and (sample_cap == 0 or grid.ndim == 0
                                        or grid.shape[-1] != sample_cap)):
                raise ValueError(
                    f"explicit t_grid must match the t_eval length "
                    f"{sample_cap} given at build time, got "
                    f"{tuple(grid.shape)}")
            if grid.ndim == 2 and grid.shape[0] != B:
                raise ValueError(f"a per-lane t_eval grid needs {B} rows, "
                                 f"got {tuple(grid.shape)}")
            grid = torch.broadcast_to(grid, (B, sample_cap))
        a = (fun, y0, t0_b, tf_b, hmax, fs,
             _norm_tol(rtol, B, n, dtype, dev, "rtol"),
             _norm_tol(atol, B, n, dtype, dev, "atol"), lane_args, max_steps)
        counters = {}
        if method in STIFF:
            out = S.stiff_ensemble(method, *a, params, hmin, grid, ev)
            counters = dict(njev=out[-2], nlu=out[-1])
            out = out[:-2]
        else:
            out = erk_ensemble(method, *a, grid, params, ev)
        kw = _event_fields(out[9] if ev is not None else None)
        if max_restarts:   # as ivp_tpu's, which gives it only then
            kw["n_restarts"] = (out[9].n_restarts if ev is not None
                                else torch.zeros_like(out[4]))
        return EnsembleResult(*out[:7], y_samples=out[7], n_samples=out[8],
                              **kw, **counters)

    return solver


def _lane_arg(a, B, dtype, device):
    a = torch.as_tensor(a, device=device)
    if a.is_floating_point():
        a = a.to(dtype)
    if a.ndim == 0 or a.shape[0] != B:
        raise ValueError(f"args_batched args need a leading batch dim {B}, "
                         f"got {tuple(a.shape)}")
    return a


_ENSEMBLE_CACHE = LRUCache(maxsize=64)


def _grid_token(t_eval):
    if t_eval is None:
        return None
    return cache_token(t_eval if isinstance(t_eval, torch.Tensor)
                       else np.asarray(t_eval, float))


def solve_ivp_ensemble(fun, t_span, y0_batch, method="RK45", *, rtol=1e-3,
                       atol=1e-6, args=(), jac=None, jac_sparsity=None,
                       max_steps: int = 100_000,
                       first_step=None, max_step=None, min_step: float = 0.0,
                       dtype=None, events=None,
                       event_capacity: Optional[int] = None, t_eval=None,
                       chunk_steps: int = 16384,
                       solver_options: Optional[dict] = None,
                       max_restarts: int = 0,
                       dense_output: bool = False,
                       record_trajectories: bool = False,
                       rec_chunk: int = 1024,
                       lane_chunk="auto",
                       time_dtype=None, device=None) -> EnsembleResult:
    """Batched solve of ``y0_batch (B, n)`` over ``t_span = (t0, tf)`` to
    each lane's final state, with its states on ``t_eval`` if given.

    ``record_trajectories=True`` records every accepted step of every lane
    (``ts (B, S)``, ``ys (B, S, n)``, ``n_steps_rec (B,)``); ``dense_output``
    records each step's dense coefficients too and returns ``sol``, a
    :class:`BatchOdeSolution`.  Records run in chunks of ``rec_chunk`` rows
    a lane (one kernel launch each on the card) and stay on the solve's
    device.

    ``events``, ``max_restarts``: as for :func:`build_ensemble_solver`;
    ``event_capacity`` None picks one from the ensemble's size
    (:func:`_auto_event_capacity`), and a buffer that overflowed on some
    lane gives a UserWarning.

    ``chunk_steps`` is accepted and has no effect (ivp_tpu bounds each
    device call to that many attempts; the kernel runs each lane to its
    end in one launch).  ``lane_chunk``: an integer solves the lanes in
    sub-batches of that many, one after another, and concatenates the
    results (``sol`` becomes a :class:`ChunkedBatchSolution`), and the
    default event capacity is sized for one sub-batch; ``None`` means no
    chunking; ``"auto"`` takes :func:`_auto_lane_chunk`'s table (Radau and
    BDF at ``n >= 16`` only; on the card those raise NotImplementedError
    first, ROADMAP §1 item 15).  ``device`` is as for :func:`build_ensemble_solver`'s
    solver: a tensor ``y0_batch`` keeps its device (a conflicting
    ``device`` raises ValueError), anything else goes to the card unless
    ``device="cpu"``.  The options :func:`build_ensemble_solver` does not
    run raise NotImplementedError naming their slice.  Solvers are built
    once per configuration (an LRU cache keyed on the callable, its args
    and every option).
    """
    del chunk_steps
    if isinstance(lane_chunk, str) and lane_chunk != "auto":
        raise ValueError(f"lane_chunk must be an int, None or 'auto', "
                         f"got {lane_chunk!r}")
    # Every option is checked before anything is placed on a device.
    if isinstance(y0_batch, torch.Tensor):
        y0 = torch.atleast_2d(y0_batch)
        finite = y0.numel() == 0 or bool(torch.isfinite(y0).all())
    else:
        y0 = np.atleast_2d(np.asarray(y0_batch, float))
        finite = bool(np.isfinite(y0).all())
    B, n = y0.shape
    record = bool(dense_output or record_trajectories)
    if isinstance(lane_chunk, str):
        lane_chunk = _auto_lane_chunk(method, n, B, dtype, solver_options)
    if event_capacity is None:
        event_capacity = _auto_event_capacity(
            (B, n), events, resolve_auto_dtype(dtype), lane_chunk)
    opts = dict(
        n=n, dtype=dtype, args=tuple(args), jac=jac,
        jac_sparsity=jac_sparsity, max_steps=max_steps, first_step=first_step,
        max_step=max_step, min_step=min_step, events=events,
        event_capacity=event_capacity, t_eval=t_eval,
        solver_options=solver_options, max_restarts=max_restarts,
        time_dtype=time_dtype)
    key = ("ensemble", str(method), n, str(dtype),
           cache_token(fun), tuple(cache_token(a) for a in tuple(args)),
           cache_token(jac), cache_token(jac_sparsity), max_steps, first_step,
           max_step, min_step,
           tuple(cache_token(e) for e in as_list(events)), event_capacity,
           _grid_token(t_eval),
           tuple(sorted((k, cache_token(v))
                        for k, v in (solver_options or {}).items())),
           max_restarts, str(time_dtype), record, bool(dense_output),
           rec_chunk if record else 0)
    if record:
        solver = _ENSEMBLE_CACHE.get_or_build(key, lambda: build_recording_solver(
            fun, method, dense_output=dense_output, rec_chunk=rec_chunk,
            **opts))
    else:
        solver = _ENSEMBLE_CACHE.get_or_build(
            key, lambda: build_ensemble_solver(fun, method, **opts))
    if not finite:
        raise ValueError("All components of the initial states `y0_batch` "
                         "must be finite.")
    if isinstance(lane_chunk, int) and 0 < lane_chunk < B:
        return _solve_lane_chunked(
            fun, t_span, y0_batch, method, int(lane_chunk), t_eval,
            dict(rtol=rtol, atol=atol, args=args, jac=jac,
                 jac_sparsity=jac_sparsity, max_steps=max_steps,
                 first_step=first_step, max_step=max_step, min_step=min_step,
                 dtype=dtype, events=events, event_capacity=event_capacity,
                 solver_options=solver_options, max_restarts=max_restarts,
                 dense_output=dense_output,
                 record_trajectories=record_trajectories,
                 rec_chunk=rec_chunk, time_dtype=time_dtype, device=device))
    t0, tf = float(t_span[0]), float(t_span[1])
    if n == 0:
        # Empty system: nothing to integrate.
        _refuse_f32_on_card(resolve_auto_dtype(dtype), y0_batch, device)
        dev = _place(y0_batch, device)
        z = torch.zeros((B,), dtype=torch.int32, device=dev)
        kw = {}
        if record:
            kw = dict(ts=torch.zeros((B, 0), dtype=torch.float64, device=dev),
                      ys=torch.zeros((B, 0, 0), dtype=torch.float64,
                                     device=dev),
                      n_steps_rec=z.to(torch.int64))
        return EnsembleResult(
            t=torch.full((B,), tf, dtype=torch.float64, device=dev),
            y=torch.as_tensor(y0, dtype=torch.float64, device=dev), status=z,
            nfev=z, nstep=z, naccpt=z, nrejct=z, **kw)
    if record:
        return _warn_event_overflow(
            _run_recording(solver, y0, t_span, rtol, atol, device))
    return _warn_event_overflow(solver(y0, t0, tf, rtol, atol, device=device))


def _lane_rows(v, sl, B, n):
    """Lanes ``sl`` of a per-lane value (a ``(B, ...)`` tensor or array, a
    ``(B,)`` tolerance read per lane as :func:`_norm_tol` reads it), else
    ``v`` as it is (shared)."""
    if v is None or isinstance(v, (int, float)):
        return v
    a = v if isinstance(v, torch.Tensor) else np.asarray(v)
    if a.ndim == 1 and a.shape[0] == B and B != n:
        return a[sl, None]
    if a.ndim == 2 and a.shape[0] == B:
        return a[sl]
    return v


class ChunkedBatchSolution:
    """A lane-chunked ensemble's dense solution (``ivp_tpu.batch.
    ChunkedBatchSolution``): each sub-batch's :class:`BatchOdeSolution`,
    concatenated along the lane axis, with the same query surface (scalar,
    shared ``(m,)`` or per-lane ``(B, m)`` times)."""

    def __init__(self, sols, counts):
        self._sols = list(sols)
        self._counts = [int(c) for c in counts]
        self.n_lanes = sum(self._counts)
        self.method = sols[0].method
        self.t_mins = torch.cat([s.t_mins for s in self._sols])
        self.t_maxs = torch.cat([s.t_maxs for s in self._sols])

    def t_span(self):
        return self.t_mins, self.t_maxs

    def __call__(self, t):
        t_arr = torch.as_tensor(t, dtype=torch.float64)
        if t_arr.ndim == 2:
            if t_arr.shape[0] != self.n_lanes:
                raise ValueError(
                    f"per-lane query grid must have leading dim "
                    f"{self.n_lanes}, got {tuple(t_arr.shape)}")
            outs, off = [], 0
            for s, c in zip(self._sols, self._counts):
                outs.append(s(t_arr[off:off + c]))
                off += c
            return torch.cat(outs)
        if t_arr.ndim > 2:
            raise ValueError("query times must be scalar, (m,) or (B, m)")
        return torch.cat([s(t) for s in self._sols])


def _solve_lane_chunked(fun, t_span, y0_batch, method, lane_chunk, t_eval,
                        kw) -> EnsembleResult:
    """Solve the lanes in sub-batches of ``lane_chunk`` and concatenate the
    results (``ivp_tpu.batch._solve_lane_chunked``; no padding: a sub-batch
    of another size costs no compile here)."""
    y0 = (torch.atleast_2d(y0_batch) if isinstance(y0_batch, torch.Tensor)
          else np.atleast_2d(np.asarray(y0_batch, float)))
    B, n = y0.shape
    te = None if t_eval is None else np.asarray(
        t_eval.cpu() if isinstance(t_eval, torch.Tensor) else t_eval, float)
    parts, counts = [], []
    for lo in range(0, B, lane_chunk):
        sl = slice(lo, min(lo + lane_chunk, B))
        sub = dict(kw, rtol=_lane_rows(kw["rtol"], sl, B, n),
                   atol=_lane_rows(kw["atol"], sl, B, n))
        te_c = te[sl] if te is not None and te.ndim == 2 else te
        parts.append(solve_ivp_ensemble(fun, t_span, y0[sl], method,
                                        t_eval=te_c, lane_chunk=None, **sub))
        counts.append(sl.stop - sl.start)

    def cat(f):
        vals = [getattr(r, f) for r in parts]
        if any(v is None for v in vals):
            return None
        if f == "sol":
            return ChunkedBatchSolution(vals, counts)
        if f in ("ts", "ys"):   # pad the step axis to the widest sub-batch
            S = max(v.shape[1] for v in vals)
            vals = [torch.nn.functional.pad(
                v, (0, 0) * (v.dim() - 2) + (0, S - v.shape[1]))
                for v in vals]
        return torch.cat(vals)

    return EnsembleResult(**{f: cat(f) for f in EnsembleResult._fields})


# =============================================================================
# Batched trajectory recording + dense output
# =============================================================================

# The coefficients BatchOdeSolution gathers for one block of query times.
_QUERY_BLOCK_BYTES = 1 << 28

class BatchOdeSolution:
    """Batched continuous solution: one piecewise interpolant per lane
    (``ivp_tpu.batch.BatchOdeSolution``), evaluated with torch operations
    on the device that holds the records.

    * ``sol(t)`` with scalar ``t`` -> ``(B, n)``
    * ``sol(ts)`` with a shared grid ``(m,)`` -> ``(B, n, m)``
    * ``sol(ts)`` with per-lane grids ``(B, m)`` -> ``(B, n, m)``

    Extrapolates beyond each lane's covered span with its first or last
    segment (SciPy semantics).  Per-lane spans are in ``t_mins`` /
    ``t_maxs``.  Queries are answered in blocks of times, so that the
    coefficients gathered at once stay near ``_QUERY_BLOCK_BYTES``.
    """

    def __init__(self, method, interp, xolds, hs, conts, edges, counts,
                 t0, y0_batch):
        self.method = method
        self._interp = interp
        self._xolds = xolds                  # (B, S)
        self._hs = hs                        # (B, S)
        self._conts = conts                  # (B, S, C, n)
        self._edges = edges                  # (B, S) recorded endpoints
        self._counts = counts.to(torch.int64)  # (B,)
        self._y0 = y0_batch                  # (B, n)
        B, S = xolds.shape
        dev, dt = xolds.device, xolds.dtype
        self.n_lanes = B
        self._t0 = torch.broadcast_to(torch.as_tensor(t0, dtype=dt, device=dev),
                                      (B,))
        if S:
            has = self._counts > 0
            lastv = edges[torch.arange(B, device=dev),
                          torch.clamp_min(self._counts - 1, 0)]
            t_end = torch.where(has, lastv, self._t0)
            t_start = torch.where(has, xolds[:, 0], self._t0)
        else:
            t_end = t_start = self._t0
        self.t_mins = torch.minimum(t_start, t_end)
        self.t_maxs = torch.maximum(t_start, t_end)
        self._forward = bool((t_end >= t_start).all())
        # Pad edges past each lane's count so searchsorted never selects a
        # padded segment (the clip keeps queries on the last real one).
        pad = float("inf") if self._forward else float("-inf")
        mask = torch.arange(S, device=dev)[None, :] >= self._counts[:, None]
        self._search_edges = torch.where(mask, torch.full_like(edges, pad),
                                         edges)

    def __call__(self, t):
        dev, dt = self._xolds.device, self._xolds.dtype
        t_arr = torch.as_tensor(t, dtype=dt, device=dev)
        scalar = t_arr.ndim == 0
        if t_arr.ndim <= 1:
            t1 = torch.atleast_1d(t_arr)
            ts = torch.broadcast_to(t1[None, :], (self.n_lanes, t1.shape[0]))
        elif t_arr.ndim == 2:
            if t_arr.shape[0] != self.n_lanes:
                raise ValueError(
                    f"per-lane query grid must have leading dim "
                    f"{self.n_lanes}, got {tuple(t_arr.shape)}")
            ts = t_arr
        else:
            raise ValueError("query times must be scalar, (m,) or (B, m)")
        B, m = ts.shape
        if self._xolds.shape[1] == 0:
            out = torch.broadcast_to(self._y0[:, :, None],
                                     (B, self._y0.shape[1], m)).clone()
            return out[:, :, 0] if scalar else out
        sgn = 1.0 if self._forward else -1.0
        C, n = self._conts.shape[2:]
        step = max(1, _QUERY_BLOCK_BYTES // max(1, B * C * n * 8))
        out = [self._eval(ts[:, j:j + step], sgn) for j in range(0, m, step)]
        ys = torch.cat(out, dim=2) if len(out) > 1 else out[0]
        return ys[:, :, 0] if scalar else ys

    def t_span(self):
        """Per-lane covered spans: ``(t_mins, t_maxs)``, each ``(B,)``."""
        return self.t_mins, self.t_maxs

    def _eval(self, ts, sgn):
        """``(B, n, m)`` at the ``(B, m)`` times ``ts``."""
        B, m = ts.shape
        idx = torch.searchsorted((sgn * self._search_edges).contiguous(),
                                 (sgn * ts).contiguous(), side="left")
        idx = torch.minimum(idx, torch.clamp_min(self._counts - 1, 0)[:, None])
        rows = torch.arange(B, device=ts.device)[:, None]
        C, n = self._conts.shape[2:]
        conts = self._conts[rows, idx].reshape(B * m, C, n)
        ys = self._interp(conts, self._xolds[rows, idx].reshape(-1),
                          self._hs[rows, idx].reshape(-1), ts.reshape(-1))
        return ys.reshape(B, m, n).permute(0, 2, 1)


def build_recording_solver(fun, method="RK45", *, n, dtype=None, args=(),
                           jac=None, jac_sparsity=None,
                           max_steps: int = 100_000,
                           first_step: Optional[float] = None,
                           max_step: Optional[float] = None,
                           min_step: float = 0.0, events=None,
                           event_capacity: int = 16, t_eval=None,
                           solver_options: Optional[dict] = None,
                           max_restarts: int = 0, dense_output: bool = True,
                           rec_chunk: int = 1024, time_dtype=None) -> Callable:
    """Return ``solver(y0_batch, t0, tf, rtol, atol, device=None) ->
    EnsembleResult`` that records every accepted step of every lane
    (``ivp_tpu.batch.build_recording_solver``): ``ts``, ``ys`` and
    ``n_steps_rec``, with ``dense_output`` each step's coefficients and
    ``sol``, a :class:`BatchOdeSolution`; with ``t_eval`` the in-loop samples
    too, and with ``events`` the event buffers and restarts (the row of a
    step an event ends or restarts holds the event's time and state, and
    ``sol``'s segments end at the recorded times).  Arguments as for
    :func:`build_ensemble_solver`; ``rec_chunk`` rows a lane are recorded
    between two drains.  ``t0`` may be a scalar or ``(B,)``; the largest
    ``|tf - t0|`` (capped by ``max_step``) is every lane's ``hmax``, as in
    ivp_tpu.  Radau and BDF record on the card too, with events on the CPU
    only (ROADMAP §1 item 16)."""
    _later_slices(time_dtype, jac_sparsity)
    method = _check_method(method)
    dtype = resolve_auto_dtype(dtype)
    args = tuple(args)
    ev_list = as_list(events)
    sample_grid = None if t_eval is None else _norm_sample_grid(t_eval)
    sample_cap = 0 if sample_grid is None else int(sample_grid.shape[-1])
    need = bool(dense_output or sample_cap or ev_list)
    params = _solver_params(method, n, jac, solver_options, need)
    interp, _ = get_interp(method)
    hmin = abs(float(min_step))
    grids = {}

    def solver(y0_batch, t0, tf, rtol, atol, device=None):
        _refuse_f32_on_card(dtype, y0_batch, device)
        ev = event_args(ev_list, event_capacity, max_restarts)
        _refuse_stiff_on_card(method, params, fun, y0_batch, device)
        _refuse_events_on_card(fun, ev, y0_batch, device)
        y0 = _as_state(y0_batch, dtype, device)
        if y0.ndim != 2 or y0.shape[1] != n:
            raise ValueError(f"y0_batch must have shape (B, {n}), "
                             f"got {tuple(y0.shape)}")
        B, dev = y0.shape[0], y0.device
        kw = dict(dtype=dtype, device=dev)
        t0_b = _lanes(t0, B, **kw)
        tf_b = _lanes(tf, B, **kw)
        hmax = float(np.max(np.abs(float(tf) - np.asarray(
            t0.cpu() if isinstance(t0, torch.Tensor) else t0, float))))
        if max_step is not None:
            hmax = min(hmax, abs(float(max_step)))
        fs = (torch.full((B,), float(first_step), **kw)
              if first_step is not None else None)
        grid = None
        if sample_grid is not None:
            grid = grids.get(dev)
            if grid is None:
                grid = grids[dev] = torch.as_tensor(sample_grid, **kw)
            if grid.ndim == 2 and grid.shape[0] != B:
                raise ValueError(f"a per-lane t_eval grid needs {B} rows, "
                                 f"got {tuple(grid.shape)}")
            grid = torch.broadcast_to(grid, (B, sample_cap))
        rec = erk_record(method, fun, y0, t0_b, tf_b, _lanes(hmax, B, **kw),
                         fs, _norm_tol(rtol, B, n, dtype, dev, "rtol"),
                         _norm_tol(atol, B, n, dtype, dev, "atol"), args,
                         max_steps, grid, params, rec_cap=rec_chunk,
                         record_cont=dense_output, events=ev, hmin=hmin)
        return _recording_result(interp, method, rec, dense_output, t0_b, y0)

    return solver


def build_resumable_solver(fun, method="RK45", *, n, dtype=None, args=(),
                           jac=None, jac_sparsity=None,
                           chunk_steps: int = 1024,
                           max_steps: int = 100_000, events=None,
                           event_capacity: int = 16,
                           first_step: Optional[float] = None,
                           max_step: Optional[float] = None,
                           min_step: float = 0.0, t_eval=None,
                           solver_options: Optional[dict] = None,
                           max_restarts: int = 0, unroll: int = 1,
                           time_dtype=None):
    """Checkpointable ensemble integration (``ivp_tpu.batch.
    build_resumable_solver``): the carry is the checkpoint.

    Returns ``(start, resume, extract)``:

    * ``start(y0_batch, t0, tf, rtol, atol, device=None) -> (carry, ra)``;
      ``t0`` is a scalar or ``(B,)`` per-lane start times, ``tf`` a
      scalar; ``device`` as for :func:`build_ensemble_solver`'s solver;
    * ``resume(carry, ra) -> carry`` advances every lane by at most
      ``chunk_steps`` counted attempts (``carry.done`` says which lanes are
      finished); the carry given is not changed.  RK23 counts its
      accepted attempts and, unlike ivp_tpu's, an attempt whose error
      estimate is not finite (a stated deviation, ROADMAP §3 fault 7):
      such a lane is rejected on every attempt, and ivp_tpu's never ends
      it, where the port's ends at ``max_steps`` (NEED_LARGER_NMAX), so a
      ``resume`` with ``chunk_steps`` bounds it as any other;
    * ``extract(carry) -> EnsembleResult``.

    ``carry`` is the plain driver's :class:`~ivp_tpu_torch.core.driver.Carry`
    (a NamedTuple of tensors, the engine's state in ``carry.ms``) and ``ra``
    its :class:`~ivp_tpu_torch.methods.base.RunArgs`: move them to the host
    and back (or save them) and resume where they left off, on either
    route; ``convert.py`` turns an ``ivp_tpu`` carry into one.  On the CPU
    the plain driver's ``run_bounded`` runs each chunk (``unroll`` attempts
    between its checks of the budget, as ivp_tpu's); on the card each
    ``resume`` is one kernel launch (kernels/resumable.py), lean only:
    ``t_eval`` and ``events`` raise NotImplementedError there (ROADMAP §1
    item 16).  Other options as for :func:`build_ensemble_solver`."""
    _later_slices(time_dtype, jac_sparsity)
    method = _check_method(method)
    dtype = resolve_auto_dtype(dtype)
    args = tuple(args)
    ev_list = as_list(events)
    sample_grid = None if t_eval is None else _norm_sample_grid(t_eval)
    sample_cap = 0 if sample_grid is None else int(sample_grid.shape[-1])
    params = _solver_params(method, n, jac, solver_options,
                            sample_cap > 0 or bool(ev_list))
    drivers = {}   # the plain driver, per (device, dtype)
    solves = []    # the launches on the card, made at the first start there

    def on_card():
        if not solves:
            solves.append(RES.CardSolve(method, fun, args, params))
        return solves[0]

    def plain(y0, ev):
        key = (y0.device, y0.dtype)
        if key not in drivers:
            drivers[key] = E.plain_driver(method, fun, y0, args, sample_cap,
                                          params, ev, bounded=True,
                                          unroll=max(1, unroll))
        return drivers[key]

    def start(y0_batch, t0, tf, rtol, atol, device=None):
        _refuse_f32_on_card(dtype, y0_batch, device)
        ev = event_args(ev_list, event_capacity, max_restarts)
        card = placement(y0_batch, device).type == "cuda"
        if card and (ev is not None or sample_cap):
            raise NotImplementedError(STIFF_MODES_ON_CARD)
        _refuse_stiff_on_card(method, params, fun, y0_batch, device)
        if card and not isinstance(fun, CudaRHS):
            raise NotImplementedError(E.NO_GPU_CALLABLE)
        y0 = _as_state(y0_batch, dtype, device)
        if y0.ndim != 2 or y0.shape[1] != n:
            raise ValueError(f"y0_batch must have shape (B, {n}), "
                             f"got {tuple(y0.shape)}")
        B, dev = y0.shape[0], y0.device
        kw = dict(dtype=dtype, device=dev)
        t0_b = _lanes(t0, B, **kw)
        if isinstance(t0, (int, float)):
            hmax = abs(float(tf) - float(t0))
        else:
            t0_host = np.atleast_1d(np.asarray(
                t0.cpu() if isinstance(t0, torch.Tensor) else t0, float))
            hmax = float(np.max(np.abs(float(tf) - t0_host)))
        if max_step is not None:
            hmax = min(hmax, abs(float(max_step)))
        grid = None
        if sample_grid is not None:
            grid = torch.broadcast_to(torch.as_tensor(sample_grid, **kw),
                                      (B, sample_cap))
        ra = run_args(_lanes(tf, B, **kw),
                      _norm_tol(rtol, B, n, dtype, dev, "rtol"),
                      _norm_tol(atol, B, n, dtype, dev, "atol"), hmax,
                      abs(float(min_step)), max_steps, y0, t_grid=grid)
        fs = (torch.full((B,), abs(float(first_step)), **kw)
              if first_step is not None else None)
        if card:
            with torch.cuda.device(dev):
                return on_card().start(y0, t0_b, fs, ra), ra
        init_carry, _ = plain(y0, ev)
        return init_carry(t0_b, y0, fs, ra), ra

    def resume(carry, ra):
        if carry.y.device.type == "cuda":
            with torch.cuda.device(carry.y.device):
                return on_card().resume(carry, ra, chunk_steps)
        ev = event_args(ev_list, event_capacity, max_restarts)
        _, run_bounded = plain(carry.y, ev)
        return run_bounded(carry, ra, chunk_steps)

    def extract(carry):
        kw = {}
        if ev_list:
            kw = _event_fields(E.carry_events(carry))
        if sample_cap:
            kw.update(y_samples=carry.sample_y, n_samples=carry.s_cursor)
        if max_restarts:
            kw.update(n_restarts=carry.n_restarts)
        if method in STIFF:
            kw.update(njev=carry.njev, nlu=carry.nlu)
        return EnsembleResult(t=carry.t, y=carry.y, status=carry.status,
                              nfev=carry.nfev, nstep=carry.nstep,
                              naccpt=carry.naccpt, nrejct=carry.nrejct, **kw)

    return start, resume, extract


def _recording_result(interp, method, rec, dense_output, t0,
                      y0_batch) -> EnsembleResult:
    """Assemble the EnsembleResult of a drained recording run."""
    sol = None
    if dense_output:
        sol = BatchOdeSolution(method, interp, rec.rec_xold, rec.rec_h,
                               rec.rec_cont, rec.rec_t, rec.n_rec, t0,
                               y0_batch)
    # ivp_tpu's recording solver gives n_restarts always.
    n_restarts = (rec.events.n_restarts if rec.events is not None else
                  torch.zeros_like(rec.nstep))
    counters = ({} if method not in STIFF else
                dict(njev=rec.njev, nlu=rec.nlu))
    return EnsembleResult(rec.t, rec.y, rec.status, rec.nfev, rec.nstep,
                          rec.naccpt, rec.nrejct, y_samples=rec.y_samples,
                          n_samples=rec.n_samples, ts=rec.rec_t, ys=rec.rec_y,
                          n_steps_rec=rec.n_rec, sol=sol,
                          **_event_fields(rec.events),
                          n_restarts=n_restarts, **counters)


def _run_recording(solver, y0_batch, t_span, rtol, atol,
                   device=None) -> EnsembleResult:
    """The recording solve of :func:`solve_ivp_ensemble` over ``t_span``."""
    t0, tf = float(t_span[0]), float(t_span[1])
    return solver(y0_batch, t0, tf, rtol, atol, device=device)
