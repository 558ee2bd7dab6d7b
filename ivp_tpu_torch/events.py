"""Events: what the solves take, and the event sets the kernels run.

The event contract follows SciPy's ``solve_ivp``, with ``ivp_tpu``'s
``restart``.  An event is a callable with optional attributes:

* ``terminal``: False (never stops), True (stops at its first occurrence)
  or a count (stops at that occurrence);
* ``direction``: 0 (every zero crossing), +1 (upward only), -1 (downward
  only);
* ``restart``: a map ``y_new = restart(t, y)``.  With ``max_restarts > 0``
  a terminal occurrence of this event restarts the integration from the
  event point with the mapped state, up to ``max_restarts`` times a lane,
  instead of stopping it.

On the CPU any such callable runs.  The ensemble solves call it batched, as
the RHS: ``g(t (B,), y (B, n), *args) -> (B,)`` and ``restart(t (B,), y (B,
n)) -> (B, n)``; ``solve_ivp`` calls a plain callable SciPy-style, ``g(t
0-d, y (n,), *args)`` and ``restart(t, y (n,))``.

On the card the events of a solve must be one declared **event set** of its
:class:`~ivp_tpu_torch.rhs.CudaRHS`, all of its events in order: a set pairs
:class:`CudaEvent` objects (batched torch callables, which the CPU route
and the plain version run) with a device functor in
``csrc/events/<set>.cuh`` that computes the same event functions and restart
maps.  ``direction``, ``terminal`` and whether the restart is used are read
from the objects at each call and passed to the kernel as launch arguments:
changing them needs no rebuild (:meth:`CudaEvent.replace` gives a copy with
other attributes).  A plain callable event on a CUDA tensor raises
NotImplementedError (ROADMAP §1 item 12: arbitrary functions on the GPU).

The sets declared here:

* ``ground`` (of ``rhs.ball``): ``y[0]``, the height, downward, terminal,
  restart ``[0, -0.8 v]`` (a bounce with restitution 0.8);
* ``section`` (of ``rhs.lorenz``): the Poincaré section ``z - (rho - 1)``,
  downward, not terminal (``lorenz_section.replace(terminal=5)`` stops a
  lane at its fifth crossing);
* ``crossing`` (of ``rhs.vdp``, for Radau and BDF): the position ``y[0]``,
  downward, not terminal: a relaxation oscillator's zero crossings, whose
  times give its period and phase;
* ``replenish`` (of ``rhs.decay``, for Radau and BDF): ``y[0] - 0.5``,
  downward, terminal, restart ``y_new = 1``: a store refilled when it has
  decayed to half (the sawtooth of a dosing or replenishment model).

The explicit kernels run ``ground`` and ``section``, the stiff kernels
``crossing`` and ``replenish``; another pairing raises NotImplementedError
on the card from ``kernels/build.py::entry`` (its entry is not built).

To add a set: write ``csrc/events/<set>.cuh`` (``E`` events of the functor
``F``, ``value(e, t, y, args)`` and ``restart(e, t, y, args, y_new)``, which
runs where ``RESTARTS`` has event ``e``'s bit), give its counts to
:data:`SETS` and declare its :class:`CudaEvent` objects here.  For the
explicit methods include it in ``csrc/erk_common.cuh`` and add its
``IVP_ERK_EVENT_ENTRY`` line to each ``csrc/erk_*.cu``; for Radau and BDF
include it in ``csrc/radau_ev.cu`` and ``csrc/bdf_ev.cu`` and add its
``IVP_RADAU_EVENT_ENTRY`` and ``IVP_BDF_EVENT_ENTRY`` lines there (the
functor's threads and blocks as its ``IVP_RADAU_ENTRY`` and
``IVP_BDF_ENTRY`` lines give them).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from . import rhs as _rhs
from .core.events import EventSpec

# Most events one set may hold (csrc/erk_common.cuh IVP_MAX_EVENTS).
MAX_EVENTS = 8

NO_GPU_EVENT = (
    "on a CUDA device the events must be an event set declared for the "
    "CudaRHS (ivp_tpu_torch.events: a CudaEvent list, the whole set in "
    "order), whose device functor the fused kernel runs; an arbitrary event "
    "function or restart map on the GPU is not ported yet: ROADMAP §1 item "
    "12 (arbitrary RHS on the GPU)")


class CudaEvent:
    """One event of a declared set: a batched torch event function ``fn(t
    (B,), y (B, n), *args) -> (B,)`` of the set's RHS (it gets the RHS's
    args, defaults filled in), with SciPy's ``terminal`` and ``direction``
    and the set's ``restart`` map (batched, ``(t, y) -> y_new``) or None."""

    def __init__(self, set_name: str, index: int, rhs, fn: Callable, *,
                 terminal=False, direction=0, restart=None):
        self.set_name = set_name
        self.index = index
        self.rhs = rhs
        self.fn = fn
        self.terminal = terminal
        self.direction = direction
        self.restart = restart
        self.declared_restart = restart

    def __call__(self, t, y, *args):
        return self.fn(t, y, *self.rhs._full(args))

    def __repr__(self):
        return (f"CudaEvent({self.set_name!r}[{self.index}], terminal="
                f"{self.terminal!r}, direction={self.direction!r}, "
                f"restart={'declared' if self.restart is not None else None})")

    def replace(self, **attrs) -> "CudaEvent":
        """A copy with other ``terminal``, ``direction`` or ``restart``
        (None, or the declared map); the same device functor."""
        bad = set(attrs) - {"terminal", "direction", "restart"}
        if bad:
            raise TypeError(f"CudaEvent.replace takes terminal, direction "
                            f"and restart, got {sorted(bad)}")
        out = copy.copy(self)
        for k, v in attrs.items():
            setattr(out, k, v)
        return out


class EventSet(NamedTuple):
    """A declared set: its name, RHS, event count, and the float64
    operations of one event value and of one restart map (per event), for
    the kernels' bound."""

    name: str
    rhs: Any
    n_events: int
    value_flops: tuple
    restart_flops: tuple


def _ground(t, y, g=9.81):
    return y[:, 0]


def _ground_restart(t, y):
    return torch.stack([torch.zeros_like(y[:, 0]), -0.8 * y[:, 1]], dim=-1)


def _section(t, y, sigma=10.0, rho=28.0, beta=8.0 / 3.0):
    return y[:, 2] - (rho - 1.0)


def _crossing(t, y, mu=1.0):
    return y[:, 0]


def _replenish(t, y, k=1.0):
    return y[:, 0] - 0.5


def _replenish_restart(t, y):
    return torch.ones_like(y)


SETS = {
    "ground": EventSet("ground", _rhs.ball, 1, (0,), (1,)),
    "section": EventSet("section", _rhs.lorenz, 1, (2,), (0,)),
    "crossing": EventSet("crossing", _rhs.vdp, 1, (0,), (0,)),
    "replenish": EventSet("replenish", _rhs.decay, 1, (1,), (0,)),
}

# The ball's bounce: terminal on the way down, restarted with restitution
# 0.8 where the solve allows restarts.
ground = CudaEvent("ground", 0, _rhs.ball, _ground, terminal=True,
                   direction=-1, restart=_ground_restart)
# The Lorenz attractor's Poincaré section z = rho - 1, crossed downward.
lorenz_section = CudaEvent("section", 0, _rhs.lorenz, _section, direction=-1)
# Van der Pol's downward zero crossings of y[0].
vdp_crossing = CudaEvent("crossing", 0, _rhs.vdp, _crossing, direction=-1)
# The decay refilled to 1 when it reaches 0.5 on the way down: terminal,
# restarted where the solve allows restarts.
replenish = CudaEvent("replenish", 0, _rhs.decay, _replenish, terminal=True,
                      direction=-1, restart=_replenish_restart)


def as_list(events) -> list:
    """``events`` as a list: None -> [], one callable -> [it]."""
    if events is None:
        return []
    if callable(events):
        return [events]
    return list(events)


def directions(ev_list) -> tuple:
    """The sign of each event's ``direction`` (0 where it has none)."""
    ds = (float(getattr(e, "direction", 0) or 0) for e in ev_list)
    return tuple(int(d > 0) - int(d < 0) for d in ds)


def terminal_counts(ev_list) -> tuple:
    """SciPy's reading: True -> 1, a count -> that count, else 0."""
    return tuple(1 if getattr(e, "terminal", False) is True
                 else int(getattr(e, "terminal", 0) or 0) for e in ev_list)


class EventArgs(NamedTuple):
    """The events of one solve, read at call time: the callables (batched,
    as the ensemble solves call them), the buffer capacity per event and
    the restart budget per lane."""

    events: tuple
    cap: int
    max_restarts: int

    @property
    def n_events(self) -> int:
        return len(self.events)

    def spec(self) -> EventSpec:
        return EventSpec(len(self.events), directions(self.events),
                         terminal_counts(self.events), int(self.cap))

    def restart_maps(self) -> list:
        """Per event its ``restart`` attribute (None: no restart)."""
        return [getattr(e, "restart", None) for e in self.events]

    def functions(self, args, dtype, device):
        """``(events_fn, restart_fns)`` for the plain driver:
        ``events_fn(t (B,), y (B, n)) -> (B, E)`` calls each event with
        ``args``; each restart map's output is shaped ``(B, n)``."""
        evs = self.events

        def events_fn(t, y):
            return torch.stack([torch.as_tensor(
                e(t, y, *args), dtype=dtype, device=device).reshape(y.shape[0])
                for e in evs], dim=1)

        def wrap(rf):
            if rf is None:
                return None
            return lambda t, y: torch.as_tensor(
                rf(t, y), dtype=dtype, device=device).reshape(y.shape)

        return events_fn, [wrap(rf) for rf in self.restart_maps()]


def event_args(events, cap, max_restarts) -> Optional[EventArgs]:
    """The EventArgs of a solve, or None without events."""
    ev_list = as_list(events)
    if not ev_list:
        return None
    cap = int(cap)
    if cap < 1:
        raise ValueError(f"event_capacity must be at least 1, got {cap}")
    return EventArgs(tuple(ev_list), cap, int(max_restarts))


def device_set(fun, ev: EventArgs):
    """The declared set ``ev``'s events form for the CudaRHS ``fun``, and
    the launch's restart mask (bit e: event e restarts; none when
    ``max_restarts`` is 0).  Raises NotImplementedError for anything the
    kernels cannot run."""
    evs = ev.events
    if not all(isinstance(e, CudaEvent) for e in evs):
        raise NotImplementedError(NO_GPU_EVENT)
    name = evs[0].set_name
    s = SETS.get(name)
    if (s is None or s.rhs.name != getattr(fun, "name", None)
            or tuple((e.set_name, e.index) for e in evs)
            != tuple((name, i) for i in range(s.n_events))):
        raise NotImplementedError(
            f"{NO_GPU_EVENT}; got {list(evs)} for {fun!r}")
    mask = 0
    for i, e in enumerate(evs):
        if e.restart is None:
            continue
        if e.restart is not e.declared_restart:
            raise NotImplementedError(
                f"{e!r}: a restart map other than its set's declared one; "
                f"{NO_GPU_EVENT}")
        if ev.max_restarts > 0:
            mask |= 1 << i
    return s, mask


def lane_events(ev_list: Sequence) -> list:
    """``solve_ivp``'s events as batched callables of one lane: a
    CudaEvent as it is; a plain callable, SciPy-style, wrapped (its
    ``terminal``, ``direction`` and ``restart`` read at call time)."""
    return [e if isinstance(e, CudaEvent) else _LaneEvent(e) for e in ev_list]


class _LaneEvent:
    """A SciPy-style event ``g(t, y (n,), *args)`` seen as a batched one of
    one lane."""

    def __init__(self, e):
        self.e = e
        self.terminal = getattr(e, "terminal", False)
        self.direction = getattr(e, "direction", 0)
        rf = getattr(e, "restart", None)
        self.restart = (None if rf is None else
                        lambda t, y: torch.as_tensor(
                            rf(t[0], y[0]), dtype=y.dtype,
                            device=y.device).reshape(1, -1))

    def __call__(self, t, y, *args):
        return torch.as_tensor(self.e(t[0], y[0], *args), dtype=y.dtype,
                               device=y.device).reshape(1)
