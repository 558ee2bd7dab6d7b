"""SciPy-compatible ``solve_ivp`` facade (``ivp_tpu.solve``): one IVP.

The RHS contract:

* a plain callable is SciPy-style, ``fun(t, y, *args)`` with ``t`` a 0-d
  tensor and ``y`` of shape ``(n,)``, returning ``(n,)`` (a tensor, array or
  list); the port wraps it onto the batched driver as one lane.  It runs on
  the CPU (``device="cpu"``); on the card it raises NotImplementedError
  (ROADMAP §1 item 12);
* a :class:`~ivp_tpu_torch.rhs.CudaRHS` is batched and runs as one lane on
  either route: the plain driver on the CPU, the record-mode kernel on the
  card (kernels/erk_record.py).

A torch tensor ``y0`` keeps its device; anything else (a list, a numpy
array) goes to the card unless ``device="cpu"`` is passed, and with no CUDA
device that raises.  The integration runs in chunks of ``chunk_steps``
recorded steps; ``t_eval``, ``dense_output`` and ``first_step``'s output
enforcement are passes over the records afterwards, as in ivp_tpu.  The
result holds numpy arrays, as ivp_tpu's and SciPy's do.

Events (ivp_tpu_torch/events.py): a plain callable event is SciPy-style
too, ``g(t, y (n,), *args)`` with ``terminal``, ``direction`` and ``restart``
(``y_new = restart(t, y)``) attributes, and runs on the CPU; a
:class:`~ivp_tpu_torch.events.CudaEvent` is batched and runs on either
route (on the card the events must form a declared event set of the
CudaRHS).

Ported: ``"RK45"``/``"DOPRI5"``, ``"DOP853"``, ``"RK23"``, ``"RK4"``,
``"Radau"`` and ``"BDF"`` with ``t_eval``, ``dense_output``,
``first_step``, ``max_step``, ``min_step``, ``max_steps``, ``chunk_steps``,
``solver_options``, ``jac``, ``events``, ``event_capacity`` and
``max_restarts``; Radau and BDF run on the card with a CudaRHS that has a
Jacobian (their kernels' record mode), with events too (their event
entries).  What a later slice brings raises NotImplementedError naming its
ROADMAP item, checked before anything is placed on a device.
``vectorized`` is accepted and ignored.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .types import Status, scipy_message
from .batch import (TIME_DTYPE_ITEM, _check_method as _check_auto, _place,
                    _refuse_f32_on_card, _unported, placement)
from .core.cache import LRUCache, cache_token
from .events import EventArgs, as_list, device_set, lane_events
from .methods import get_engine
from .methods.ddtier import resolve_auto_dtype
from .methods.interp import get_interp
from .kernels.erk_record import erk_record
from .kernels.stiff_ensemble import check_card
from .methods.jacobian import stiff_spec
from .methods.radau import STIFF_REST_ITEM
from .rhs import CudaRHS

_TOL = 1e-12  # endpoint matching tolerance (ivp_tpu.solve._TOL)


# =============================================================================
# Result containers
# =============================================================================

class OdeResult(dict):
    """SciPy-style bunch: attribute and item access.

    Fields: t, y, sol, t_events, y_events, nfev, njev, nlu, nstep, naccpt,
    nrejct, status, message, success, n_restarts, event_overflow,
    raw_status, t_reached, y_reached (those of ``ivp_tpu.solve.OdeResult``).
    """

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __repr__(self):
        keys = ", ".join(sorted(self.keys()))
        return f"OdeResult({keys})"


def _interp_many(interp, conts, xolds, hs, ts):
    """``interp`` on one segment per query time: ``(m, C, n)`` coefficients,
    ``(m,)`` edges, sizes and times -> ``(m, n)`` numpy."""
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    return interp(T(conts), T(xolds), T(hs), T(ts)).numpy()


class OdeSolution:
    """Continuous solution: piecewise per-step interpolants, callable like
    SciPy's OdeSolution (extrapolates beyond the covered span with the
    first or last segment), with the strict ``sol``/``sol_many``/``sol_span``
    that raise outside it.  Holds numpy arrays; the method's torch
    interpolant (methods/erk.py) evaluates them on the CPU."""

    def __init__(self, method: str, interp: Callable, xolds, hs, conts, t0, y0,
                 t_ends=None):
        self.method = method
        self._interp = interp
        self._xolds = np.asarray(xolds)
        self._hs = np.asarray(hs)
        self._conts = np.asarray(conts)
        self._t0 = float(t0)
        self._y0 = np.asarray(y0)
        self.n_segments = self._xolds.shape[0]
        if self.n_segments:
            # Segment right edges in integration order for searchsorted:
            # the recorded endpoints where given, else xold + h.
            if t_ends is not None:
                self._edges = np.asarray(t_ends)
            else:
                self._edges = self._xolds + self._hs
            t_start = self._xolds[0]
            t_end = self._edges[-1]
            self.t_min = float(min(t_start, t_end))
            self.t_max = float(max(t_start, t_end))
            self._forward = (t_end - t_start) >= 0
        else:
            self.t_min = self.t_max = self._t0
            self._forward = True
            self._edges = np.zeros((0,))

    def _find_segments(self, ts: np.ndarray) -> np.ndarray:
        if self.n_segments == 0:
            return np.zeros(ts.shape, np.int64)
        if self._forward:
            idx = np.searchsorted(self._edges, ts, side="left")
        else:
            idx = np.searchsorted(-self._edges, -ts, side="left")
        return np.clip(idx, 0, self.n_segments - 1)

    def __call__(self, t):
        t_arr = np.asarray(t, dtype=float)
        scalar = t_arr.ndim == 0
        ts = np.atleast_1d(t_arr)
        if self.n_segments == 0:
            out = np.broadcast_to(self._y0[:, None],
                                  (self._y0.shape[0], ts.shape[0]))
            return out[:, 0] if scalar else np.array(out)
        idx = self._find_segments(ts)
        ys = _interp_many(self._interp, self._conts[idx], self._xolds[idx],
                          self._hs[idx], ts).T   # (n, m)
        return ys[:, 0] if scalar else ys

    def t_span(self):
        """``(t_min, t_max)`` covered by the interpolants."""
        return self.t_min, self.t_max

    def _check_range(self, ts):
        eps = 1e-12 * max(1.0, abs(self.t_min), abs(self.t_max))
        bad = (ts < self.t_min - eps) | (ts > self.t_max + eps)
        if np.any(bad):
            t_bad = np.atleast_1d(ts)[np.atleast_1d(bad)][0]
            raise ValueError(
                f"t={t_bad} outside the solution span "
                f"[{self.t_min}, {self.t_max}] (strict evaluation; use the "
                f"callable form for SciPy-style extrapolation)")

    def sol(self, t):
        """Strict scalar evaluation: raises outside [t_min, t_max]."""
        t_arr = np.asarray(t, dtype=float)
        self._check_range(t_arr)
        return self(t)

    def sol_many(self, ts):
        """Strict vectorized evaluation."""
        ts = np.asarray(ts, dtype=float)
        self._check_range(ts)
        return self(ts)

    def sol_span(self, t_start, t_end, m):
        """Evaluate on ``m`` evenly spaced points of [t_start, t_end], all of
        which must lie inside the covered span.  Returns (ts (m,), ys (n, m))."""
        ts = np.linspace(float(t_start), float(t_end), int(m))
        self._check_range(ts)
        return ts, self(ts)


# =============================================================================
# Refusals and placement, before any device work
# =============================================================================

def _check_method(method):
    """The canonical name of a method; ``"auto"`` raises
    NotImplementedError naming its ROADMAP item."""
    return _check_auto(method)


def _scipy_jac(jac, n):
    """A SciPy-style ``jac(t, y (n,), *args) -> (n, n)`` as the batched
    callable of one lane; a matrix stays as it is."""
    if jac is None or not callable(jac):
        return jac

    def batched(t, y, *a):
        j = jac(t[0], y[0], *a)
        if hasattr(j, "toarray"):
            j = j.toarray()
        return torch.as_tensor(j, dtype=y.dtype, device=y.device).reshape(
            1, n, n)
    return batched


# =============================================================================
# solve_ivp
# =============================================================================

_SOLVER_CACHE = LRUCache(maxsize=64)


def solve_ivp(
    fun: Callable,
    t_span,
    y0,
    method: str = "RK45",
    t_eval=None,
    dense_output: bool = False,
    events=None,
    vectorized: bool = False,
    args=None,
    *,
    rtol=1e-3,
    atol=1e-6,
    jac=None,
    jac_sparsity=None,
    max_step: float = math.inf,
    min_step: float = 0.0,
    first_step: Optional[float] = None,
    max_steps: Optional[int] = None,
    mass=None,
    nind1: Optional[int] = None,
    nind2: Optional[int] = None,
    nind3: Optional[int] = None,
    dtype=None,
    time_dtype=None,
    chunk_steps: int = 4096,
    event_capacity: int = 512,
    solver_options: Optional[dict] = None,
    max_restarts: int = 0,
    device=None,
) -> OdeResult:
    """Solve an initial value problem y' = f(t, y) (``ivp_tpu.solve_ivp``).

    ``fun``: a SciPy-style callable (CPU only) or a CudaRHS (both routes);
    see the module docstring.  ``method``: ``"RK45"``/``"DOPRI5"``,
    ``"DOP853"``, ``"RK23"`` or ``"RK4"`` (fixed step: ``first_step``, by
    default ``|tf - t0| / 100``).  ``max_step`` inf means ``|tf - t0|``;
    ``max_steps`` None means 2**31 - 2.  ``chunk_steps`` bounds the rows
    recorded between two host drains (a kernel launch each on the card);
    results do not depend on it.  ``dtype``: None, ``"auto"`` and ``"dd"``
    resolve to float64; float32 runs on the CPU only.  ``device``: where a
    ``y0`` that is not a tensor goes (the card by default).

    ``events``: one event or a list (see the module docstring); their
    occurrences come back as ``t_events`` / ``y_events``, one array per
    event, up to ``event_capacity`` each (``event_overflow`` flags a
    dropped one), and a terminal event ends the solve with status 1 at the
    event point.  ``max_restarts``: a terminal event with a ``restart`` map
    restarts the integration from the event point with the mapped state,
    up to that many times (``n_restarts``); the dense output and ``t_eval``
    follow the restarted solution.

    ``jac`` (Radau, BDF): None (the CudaRHS's own Jacobian, else
    forward-mode differentiation of ``fun``), a SciPy-style callable
    ``jac(t, y (n,), *args) -> (n, n)`` or a constant matrix (then njev
    stays 0); ``min_step`` bounds the stiff engines' steps.
    ``jac_sparsity``, ``mass``, ``nind1..3``, ``time_dtype`` and
    ``method="auto"`` raise NotImplementedError naming their ROADMAP item;
    ``vectorized`` is accepted and unused.
    """
    del vectorized
    method = _check_method(method)
    _unported(
        jac_sparsity=(jac_sparsity is not None, STIFF_REST_ITEM),
        mass=(mass is not None, STIFF_REST_ITEM),
        nind=(any(v is not None for v in (nind1, nind2, nind3)),
              STIFF_REST_ITEM),
        time_dtype=(time_dtype is not None, TIME_DTYPE_ITEM))
    stiff = method in ("RADAU", "BDF")
    dtype = resolve_auto_dtype(dtype)
    _refuse_f32_on_card(dtype, y0, device)
    ev_list = as_list(events)
    ev = (EventArgs(tuple(lane_events(ev_list)), int(event_capacity),
                    int(max_restarts)) if ev_list else None)
    on_card = placement(y0, device).type == "cuda"
    if on_card:
        if not isinstance(fun, CudaRHS):
            raise NotImplementedError(
                "solve_ivp on the card runs a CudaRHS (ivp_tpu_torch.rhs); a "
                "plain callable runs with device='cpu'.  An arbitrary torch "
                "RHS on the GPU is not ported yet: ROADMAP §1 item 12 "
                "(arbitrary RHS on the GPU)")
        if ev is not None:
            device_set(fun, ev)   # a plain callable event raises here

    if isinstance(y0, torch.Tensor):
        y0_host = y0.detach().cpu().to(torch.float64).numpy().reshape(-1)
    else:
        y0_host = np.atleast_1d(np.asarray(y0, dtype=float)).reshape(-1)
    if y0_host.size and not np.all(np.isfinite(y0_host)):
        raise ValueError(
            "All components of the initial state `y0` must be finite.")
    t0, tf = (float(t_span[0]), float(t_span[1]))
    n = int(y0_host.shape[0])
    args = () if args is None else tuple(args)

    # -- t_eval validation (SciPy semantics) --
    t_eval_arr = None
    if t_eval is not None:
        t_eval_arr = np.atleast_1d(np.asarray(t_eval, dtype=float))
        lo, hi = min(t0, tf), max(t0, tf)
        if t_eval_arr.size and (t_eval_arr.min() < lo - _TOL
                                or t_eval_arr.max() > hi + _TOL):
            raise ValueError("Values in `t_eval` are not within `t_span`.")

    # -- fast paths: zero interval / empty system --
    n_events = len(ev_list)
    if abs(tf - t0) < 1e-15:
        return _zero_interval_result(method, t0, y0_host, t_eval_arr,
                                     dense_output, n_events,
                                     events is not None)
    if n == 0:
        return _empty_system_result(method, t0, tf, t_eval_arr, dense_output,
                                    n_events, events is not None)

    need_cont = bool(dense_output or t_eval_arr is not None or n_events
                     or first_step is not None)
    if stiff:
        params = stiff_spec(method, n, _scipy_jac(jac, n), solver_options)
        if on_card:   # what the stiff kernels do not run, before placing
            check_card(params, fun)
        interp, ncoeff = get_interp(method)
    else:
        key = ("solve", method, need_cont,
               tuple(sorted((k, cache_token(v))
                            for k, v in (solver_options or {}).items())))
        engine, params = _SOLVER_CACHE.get_or_build(
            key, lambda: get_engine(method, need_cont=need_cont,
                                    **(solver_options or {})))
        interp, ncoeff = engine.interp, engine.ncoeff

    # -- placement and the per-lane arguments (one lane) --
    dev = _place(y0, device)
    if isinstance(fun, CudaRHS):
        rhs = fun
    else:
        def rhs(t, y, *a):
            return torch.as_tensor(fun(t[0], y[0], *a), dtype=y.dtype,
                                   device=y.device).reshape(1, -1)
    kw = dict(dtype=dtype, device=dev)
    y0_t = torch.as_tensor(y0_host, **kw).reshape(1, n)
    hmax = abs(tf - t0) if not np.isfinite(max_step) else abs(float(max_step))
    nmax = int(max_steps) if max_steps is not None else 2**31 - 2
    fs = first_step
    if method == "RK4" and fs is None:
        fs = abs(tf - t0) / 100.0
    lane = lambda v: torch.full((1,), float(v), **kw)
    rec = erk_record(
        method, rhs, y0_t, lane(t0), lane(tf), lane(hmax),
        None if fs is None else lane(abs(float(fs))),
        _broadcast_tol(rtol, n, **kw), _broadcast_tol(atol, n, **kw), args,
        nmax, None, params, rec_cap=int(chunk_steps), record_cont=need_cont,
        events=ev, hmin=abs(float(min_step)) if stiff else 0.0)

    # -- the records on the host, as numpy --
    k = int(rec.n_rec[0])
    rec_t = rec.rec_t[0, :k].cpu().numpy()
    rec_y = rec.rec_y[0, :k].cpu().numpy()
    rec_xold = rec.rec_xold[0, :k].cpu().numpy()
    rec_h = rec.rec_h[0, :k].cpu().numpy()
    rec_cont = (rec.rec_cont[0, :k].cpu().numpy() if need_cont
                else np.zeros((0, ncoeff, n)))
    status = int(rec.status[0])
    terminated = status == Status.USER_INTERRUPT
    y0_np = y0_host
    posneg = 1.0 if tf >= t0 else -1.0

    def interp_at(ts: np.ndarray) -> np.ndarray:
        """Dense evaluation of many times against the records."""
        if ts.size == 0:
            return np.zeros((0, n))
        # The recorded endpoints, not xold + h: a step an event truncated
        # (and restarted) must not shadow the segments after it.
        edges = rec_t
        if posneg > 0:
            idx = np.searchsorted(edges, ts - _TOL, side="left")
        else:
            idx = np.searchsorted(-edges, -(ts + _TOL), side="left")
        idx = np.clip(idx, 0, len(edges) - 1)
        return _interp_many(interp, rec_cont[idx], rec_xold[idx],
                            rec_h[idx], ts)

    if t_eval_arr is not None:
        # The points inside the completed steps; on a terminal event the
        # terminal step's points are left out and the event point is
        # appended.
        if terminated and len(rec_t):
            t_limit = rec_xold[-1]
        else:
            t_limit = carry_t_reached(rec_t, t0)
        sel = (((t_eval_arr - t0) * posneg >= -_TOL)
               & ((t_eval_arr - t_limit) * posneg <= _TOL))
        ts = t_eval_arr[sel]
        ys = np.zeros((ts.size, n))
        at_t0 = np.abs(ts - t0) <= _TOL
        if np.any(~at_t0):
            ys[~at_t0] = interp_at(ts[~at_t0])
        ys[at_t0] = y0_np
        t_out, y_out = list(ts), list(ys)
        if terminated and len(rec_t):
            t_out.append(rec_t[-1])
            y_out.append(rec_y[-1])
    else:
        t_out = [t0] + list(rec_t)
        y_out = [y0_np] + list(rec_y)
        if first_step is not None and method != "RK4" and len(rec_t):
            t_out, y_out = _enforce_first_step(
                t_out, y_out, rec_t, rec_y, t0, posneg, float(first_step),
                interp_at)
        t_out, y_out = _dedup(t_out, y_out)

    t_arr = np.asarray(t_out, dtype=float)
    y_arr = np.stack(y_out, axis=1) if len(y_out) else np.zeros((n, 0))

    # -- events: one array per event --
    t_events = y_events = event_overflow = None
    n_restarts = 0
    if events is not None:
        t_events, y_events = [], []
        event_overflow = np.zeros((0,), bool)
    if ev is not None:
        out = rec.events
        counts = out.n_events[0].cpu().numpy()
        tb = out.t_events[0].cpu().numpy()
        yb = out.y_events[0].cpu().numpy()
        for i in range(n_events):
            t_events.append(np.array(tb[i, :counts[i]]))
            y_events.append(np.array(yb[i, :counts[i]]))
        event_overflow = out.event_overflow[0].cpu().numpy()
        n_restarts = int(out.n_restarts[0])

    # The dense output's segments end at the recorded endpoints.
    sol = None
    if dense_output:
        sol = OdeSolution(method, interp, rec_xold, rec_h, rec_cont,
                          t0, y0_np, t_ends=rec_t)

    scipy_status = Status.to_scipy(status)
    return OdeResult(
        t=t_arr, y=y_arr, sol=sol, t_events=t_events, y_events=y_events,
        nfev=int(rec.nfev[0]),
        njev=int(rec.njev[0]) if stiff else 0,
        nlu=int(rec.nlu[0]) if stiff else 0, nstep=int(rec.nstep[0]),
        naccpt=int(rec.naccpt[0]), nrejct=int(rec.nrejct[0]),
        status=scipy_status, message=scipy_message(status),
        success=scipy_status >= 0, n_restarts=n_restarts,
        event_overflow=event_overflow,
        raw_status=status, t_reached=float(rec.t[0]),
        y_reached=rec.y[0].cpu().numpy(),
    )


# =============================================================================
# Helpers
# =============================================================================

def carry_t_reached(rec_t, t0):
    return rec_t[-1] if len(rec_t) else t0


def _broadcast_tol(tol, n, dtype, device):
    """A scalar or ``(n,)`` tolerance as the ``(1, n)`` tensor of one lane."""
    arr = np.asarray(tol, dtype=float).reshape(-1)
    if arr.shape[0] == 1:
        arr = np.broadcast_to(arr, (n,))
    elif arr.shape[0] != n:
        raise ValueError(f"tolerance vector length {arr.shape[0]} != n={n}")
    return torch.as_tensor(np.array(arr), dtype=dtype,
                           device=device).reshape(1, n)


def _dedup(t_out, y_out):
    td, yd = [], []
    for t, y in zip(t_out, y_out):
        if td and abs(td[-1] - t) <= _TOL:
            continue
        td.append(t)
        yd.append(y)
    return td, yd


def _enforce_first_step(t_out, y_out, rec_t, rec_y, t0, posneg, h0, interp_at):
    """first_step output enforcement: the first reported point after t0 is
    exactly t0 +/- h0, obtained by interpolation; the accepted steps before
    it are left out."""
    target = t0 + posneg * h0
    j = None
    for k, t in enumerate(rec_t):
        if posneg * (t - target) >= -_TOL:
            j = k
            break
    if j is None:
        return t_out, y_out  # never reached the target; keep raw records
    new_t = [t0]
    new_y = [y_out[0]]
    y_target = interp_at(np.asarray([target]))[0]
    new_t.append(target)
    new_y.append(y_target)
    if abs(rec_t[j] - target) > _TOL:
        new_t.append(rec_t[j])
        new_y.append(rec_y[j])
    new_t.extend(rec_t[j + 1:])
    new_y.extend(rec_y[j + 1:])
    return new_t, new_y


def _no_events(n_events, events_given, n):
    """``(t_events, y_events)`` of a solve that took no step."""
    if not events_given:
        return None, None
    return ([np.zeros((0,)) for _ in range(n_events)],
            [np.zeros((0, n)) for _ in range(n_events)])


def _zero_interval_result(method, t0, y0_np, t_eval_arr, dense_output,
                          n_events=0, events_given=False):
    n = y0_np.shape[0]
    if t_eval_arr is not None:
        ts = t_eval_arr[np.abs(t_eval_arr - t0) < _TOL]
    else:
        ts = np.asarray([t0])
    y = np.broadcast_to(y0_np[:, None], (n, ts.size)).copy()
    sol = None
    if dense_output:
        interp, ncoeff = get_interp(method)
        sol = OdeSolution(method, interp, np.zeros((0,)), np.zeros((0,)),
                          np.zeros((0, ncoeff, n)), t0, y0_np)
    t_events, y_events = _no_events(n_events, events_given, n)
    return OdeResult(
        t=ts, y=y, sol=sol, t_events=t_events, y_events=y_events,
        nfev=0, njev=0, nlu=0, nstep=0, naccpt=0, nrejct=0,
        status=0, message=scipy_message(Status.SUCCESS), success=True,
        raw_status=Status.SUCCESS, t_reached=t0, y_reached=y0_np,
    )


def _empty_system_result(method, t0, tf, t_eval_arr, dense_output,
                         n_events=0, events_given=False):
    ts = t_eval_arr if t_eval_arr is not None else np.asarray([t0, tf])
    y = np.zeros((0, ts.size))
    sol = None
    if dense_output:
        interp, ncoeff = get_interp(method)
        sol = OdeSolution(method, interp, np.zeros((0,)), np.zeros((0,)),
                          np.zeros((0, ncoeff, 0)), t0, np.zeros((0,)))
    t_events, y_events = _no_events(n_events, events_given, 0)
    return OdeResult(
        t=np.asarray(ts, dtype=float), y=y, sol=sol,
        t_events=t_events, y_events=y_events,
        nfev=0, njev=0, nlu=0, nstep=0, naccpt=0, nrejct=0,
        status=0, message=scipy_message(Status.SUCCESS), success=True,
        raw_status=Status.SUCCESS, t_reached=tf, y_reached=np.zeros((0,)),
    )
