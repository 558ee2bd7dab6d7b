"""Batched ensemble solving to the final state (``ivp_tpu.batch``).

Thousands of independent IVPs integrate together, each with its own
adaptive step size, step counters and status code.  The reference vmaps a
``lax.while_loop``; here the batch axis is explicit and the solve runs
through ``kernels/dopri5_ensemble.py``: the plain PyTorch driver for CPU
tensors, one fused CUDA kernel launch for CUDA tensors with a
:class:`~ivp_tpu_torch.rhs.CudaRHS`.  A torch tensor ``y0_batch`` keeps its
device (a ``device`` argument that names another raises); anything else (a numpy array, a list) goes to the card
(``torch.device("cuda")``) unless the caller passes ``device="cpu"``.  There
is no fallback: with no CUDA device such a call raises.

The RHS is batched: ``fun(t, y, *args)`` takes ``t`` of shape ``(B,)`` and
``y`` of shape ``(B, n)`` and returns ``(B, n)``.

Only the lean final-state mode with DOPRI5 (``"RK45"``) is ported.  Options
of later slices raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from .types import canonical_method
from .methods import get_engine
from .methods.ddtier import resolve_auto_dtype
from .kernels.dopri5_ensemble import dopri5_ensemble


class EnsembleResult(NamedTuple):
    t: Any        # (B,) final time per trajectory
    y: Any        # (B, n) final state
    status: Any   # (B,) int32 status codes (0 = success)
    nfev: Any     # (B,) int32
    nstep: Any    # (B,) int32
    naccpt: Any   # (B,) int32
    nrejct: Any   # (B,) int32


def _unported(**opts):
    """Raise NotImplementedError for the first option set to a value this
    slice does not run.  ``opts`` maps name -> (is_set, ROADMAP item)."""
    for name, (is_set, where) in opts.items():
        if is_set:
            raise NotImplementedError(
                f"{name} is not ported to ivp_tpu_torch yet: ROADMAP §1 {where}")


def _check_method(method):
    if isinstance(method, str) and method.lower() == "auto":
        raise NotImplementedError(
            "method='auto' is not ported to ivp_tpu_torch yet: ROADMAP §1 "
            "item 8 (auto.py)")
    method = canonical_method(method)
    get_engine(method, need_cont=False)   # raises for unported methods
    return method


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

    ``y0_batch`` has shape ``(B, n)``; ``t0``/``tf`` are scalars or ``(B,)``
    per-lane spans; ``rtol``/``atol`` are scalars, ``(n,)``, ``(B,)``,
    ``(B, 1)`` or ``(B, n)`` (see :func:`_norm_tol`).

    ``args_batched=True``: every element of ``args`` carries a leading
    ``(B,)`` axis, one value per lane (parameter sweeps).

    ``dtype``: ``None``, ``"auto"`` and ``"dd"`` resolve to float64 (native
    f64 on CPUs and GPUs); ``torch.float32`` runs the CPU route only.

    ``min_step`` is accepted and, as in ivp_tpu, unused by DOPRI5.
    ``unroll`` is accepted and has no effect: the kernel loops per lane, and
    the plain version's host-check cadence is fixed.  ``events``,
    ``t_eval``, ``max_restarts``, ``time_dtype``, ``jac``, ``jac_sparsity``
    and ``solver_options`` raise NotImplementedError naming their slice.
    """
    del unroll, min_step, event_capacity
    _unported(events=(bool(events), "item 5 (events and restarts)"),
              t_eval=(t_eval is not None, "item 3 (t_eval emission)"),
              max_restarts=(bool(max_restarts), "item 5 (events and restarts)"),
              time_dtype=(time_dtype is not None, "item 4 (the single-IVP facade)"),
              jac=(jac is not None, "item 7 (the stiff tier)"),
              jac_sparsity=(jac_sparsity is not None, "item 7 (the stiff tier)"),
              solver_options=(bool(solver_options),
                              "item 3 (the rest of the explicit tier)"))
    _check_method(method)
    dtype = resolve_auto_dtype(dtype)
    args = tuple(args)

    def solver(y0_batch, t0, tf, rtol, atol, batched_args=None, device=None):
        """``batched_args`` overrides the builder's per-lane ``args``
        (requires ``args_batched=True``).  ``device``: where a ``y0_batch``
        that is not a tensor goes; the card by default, ``"cpu"`` for the
        plain version.  A tensor keeps its own device; a ``device`` given
        with it must name that device (ValueError otherwise)."""
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
        out = dopri5_ensemble(fun, y0, t0_b, tf_b, hmax, fs,
                              _norm_tol(rtol, B, n, dtype, dev, "rtol"),
                              _norm_tol(atol, B, n, dtype, dev, "atol"),
                              lane_args, max_steps)
        return EnsembleResult(*out)

    return solver


def _lane_arg(a, B, dtype, device):
    a = torch.as_tensor(a, device=device)
    if a.is_floating_point():
        a = a.to(dtype)
    if a.ndim == 0 or a.shape[0] != B:
        raise ValueError(f"args_batched args need a leading batch dim {B}, "
                         f"got {tuple(a.shape)}")
    return a


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
    each lane's final state.

    ``chunk_steps`` is accepted and has no effect (ivp_tpu bounds each
    device call to that many attempts; the kernel runs each lane to its
    end in one launch).  ``lane_chunk="auto"`` and ``None`` mean no
    chunking.  ``device`` is as for :func:`build_ensemble_solver`'s solver:
    a tensor ``y0_batch`` keeps its device (a conflicting ``device`` raises
    ValueError), anything else goes to the card unless ``device="cpu"``.
    ``dense_output``, ``record_trajectories``, an
    integer ``lane_chunk`` and the options :func:`build_ensemble_solver`
    does not run raise NotImplementedError naming their slice.
    """
    del chunk_steps, rec_chunk
    _unported(dense_output=(dense_output, "item 6 (the recording tier)"),
              record_trajectories=(record_trajectories,
                                   "item 6 (the recording tier)"),
              lane_chunk=(lane_chunk not in ("auto", None),
                          "item 6 (the resumable tier)"))
    # Every option is checked before anything is placed on a device.
    if isinstance(y0_batch, torch.Tensor):
        y0 = torch.atleast_2d(y0_batch)
        finite = y0.numel() == 0 or bool(torch.isfinite(y0).all())
    else:
        y0 = np.atleast_2d(np.asarray(y0_batch, float))
        finite = bool(np.isfinite(y0).all())
    B, n = y0.shape
    solver = build_ensemble_solver(
        fun, method, n=n, dtype=dtype, args=tuple(args), jac=jac,
        jac_sparsity=jac_sparsity, max_steps=max_steps, first_step=first_step,
        max_step=max_step, min_step=min_step, events=events, t_eval=t_eval,
        solver_options=solver_options, max_restarts=max_restarts,
        time_dtype=time_dtype)
    if not finite:
        raise ValueError("All components of the initial states `y0_batch` "
                         "must be finite.")
    t0, tf = float(t_span[0]), float(t_span[1])
    if n == 0:
        # Empty system: nothing to integrate.
        dev = _place(y0_batch, device)
        z = torch.zeros((B,), dtype=torch.int32, device=dev)
        return EnsembleResult(
            t=torch.full((B,), tf, dtype=torch.float64, device=dev),
            y=torch.as_tensor(y0, dtype=torch.float64, device=dev), status=z,
            nfev=z, nstep=z, naccpt=z, nrejct=z)
    return solver(y0, t0, tf, rtol, atol, device=device)
