"""Events through the single-IVP facade: ``ivp_tpu_torch.solve_ivp`` against
``ivp_tpu.solve_ivp`` on the CPU, for each case of tests/test_events.py that
runs an explicit method, and ``core.common.brentq`` against SciPy's.

A SciPy-style event (``g(t, y)`` with ``terminal``, ``direction`` and
``restart``) runs through the port's plain driver as one lane, beside the
same jnp event in ivp_tpu.  Bounds, per case:

* status, every counter, ``n_restarts``, the number of occurrences of each
  event and the number of output points equal;
* event times within 1e-10 scaled by max(1, |t|), event states within 1e-8
  scaled by max(1, |y|);
* the final state within 1e-8 scaled; ``t_eval`` outputs: ``t`` equal and
  ``y`` within 1e-8 scaled; step outputs: ``t`` within 1e-5 relative (the
  float32 controller rounds step sizes apart in their last float32 bits,
  as tests/test_torch_solve.py states), the last one within 1e-10 scaled;
* ``sol`` on fixed times within 1e-8 scaled.

Each case also keeps its own assertions from tests/test_events.py (the
closed-form bounce times and so on).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402  (enables x64)
import scipy.optimize  # noqa: E402

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import events as E  # noqa: E402
from ivp_tpu_torch.core.common import brentq  # noqa: E402

COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct", "n_restarts")
T_EV, Y_EV = 1e-10, 1e-8
G, COR = 9.81, 0.8


def scaled(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)),
                        initial=0.0))


def both(jfun, tfun, jevents, tevents, span, y0, **kw):
    """The same solve through both packages: ``(ivp_tpu's, the port's)``,
    held to the module's bounds."""
    ref = ivp_tpu.solve_ivp(jfun, span, y0, events=jevents, **kw)
    got = it.solve_ivp(tfun, span, y0, events=tevents, device="cpu", **kw)
    for f in COUNTERS:
        assert got[f] == ref[f], (f, got[f], ref[f])
    assert len(got.t_events) == len(ref.t_events)
    for i in range(len(ref.t_events)):
        assert len(got.t_events[i]) == len(ref.t_events[i]), i
        assert scaled(got.t_events[i], ref.t_events[i]) <= T_EV
        assert scaled(got.y_events[i], ref.y_events[i]) <= Y_EV
    np.testing.assert_array_equal(got.event_overflow, ref.event_overflow)
    assert got.t.shape == np.asarray(ref.t).shape
    assert scaled(got.y_reached, ref.y_reached) <= Y_EV
    if kw.get("t_eval") is not None:
        np.testing.assert_array_equal(got.t, ref.t)
        assert scaled(got.y, ref.y) <= Y_EV
    else:
        np.testing.assert_allclose(got.t, ref.t, rtol=1e-5, atol=1e-6)
        assert scaled(got.t[-1], ref.t[-1]) <= T_EV
        assert scaled(got.y[:, -1], ref.y[:, -1]) <= Y_EV
    return ref, got


# ---- the problems, as jnp (ivp_tpu) and torch (the port) callables ----

def jrational(t, y):
    return jnp.array([y[1] / t,
                      y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])


def trational(t, y):
    return torch.stack([y[1] / t,
                        y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])


def jsho(t, y):
    return jnp.array([y[1], -y[0]])


def tsho(t, y):
    return torch.stack([y[1], -y[0]])


def jball(t, y):
    return jnp.array([y[1], -G])


def tball(t, y):
    return torch.stack([y[1], torch.zeros_like(y[1]) - G])


def event(fn, terminal=None, direction=None, restart=None):
    if terminal is not None:
        fn.terminal = terminal
    if direction is not None:
        fn.direction = direction
    if restart is not None:
        fn.restart = restart
    return fn


def ground_pair(restart=True, terminal=True):
    """The bounce event (height, downward) in both packages, with the
    restitution map where ``restart``."""
    j = event(lambda t, y: y[0], terminal, -1,
              (lambda t, y: jnp.array([0.0, -COR * y[1]])) if restart
              else None)
    t = event(lambda t, y: y[0], terminal, -1,
              (lambda t, y: torch.stack([torch.zeros_like(y[1]),
                                         -COR * y[1]])) if restart else None)
    return j, t


# ---- tests/test_events.py's cases ----

@pytest.mark.parametrize("method", ["RK23", "RK45", "DOP853"])
def test_events_two_functions(method):
    ev = [(lambda t, y: y[0] - y[1] ** 0.7), (lambda t, y: y[1] ** 0.6 - y[0])]
    ref, got = both(jrational, trational, ev, ev, [5, 8], [1 / 3, 2 / 9],
                    method=method)
    assert got.status == 0
    assert [len(x) for x in got.t_events] == [1, 1]
    assert 5.3 < got.t_events[0][0] < 5.7 and 7.3 < got.t_events[1][0] < 7.7
    y = got.y_events[0][0]
    assert abs(y[0] - y[1] ** 0.7) <= 1e-10


def test_terminal_event():
    ev = event(lambda t, y: t - 7.4, terminal=True)
    ref, got = both(jrational, trational, ev, ev, [5, 8], [1 / 3, 2 / 9],
                    method="RK45", dense_output=True)
    assert got.status == 1 and got.success
    assert len(got.t_events[0]) == 1 and 7.3 < got.t_events[0][0] < 7.5
    assert abs(got.t[-1] - got.t_events[0][0]) <= 1e-10
    ts = np.linspace(5.0, got.t[-1], 7)
    assert scaled(got.sol(ts), ref.sol(ts)) <= Y_EV


@pytest.mark.parametrize("direction, count", [(1, 1), (-1, 0)])
def test_event_direction(direction, count):
    ev = event(lambda t, y: y[0] - y[1] ** 0.7, direction=direction)
    ref, got = both(jrational, trational, ev, ev, [5, 8], [1 / 3, 2 / 9],
                    method="RK45")
    assert got.status == 0 and len(got.t_events[0]) == count


@pytest.mark.parametrize("method", ["RK45", "DOP853", "RK23", "RK4"])
def test_sho_zero_crossings_terminal_count(method):
    ev = event(lambda t, y: y[0], terminal=2)
    ref, got = both(jsho, tsho, ev, ev, (0.0, 4 * np.pi), [1.0, 0.0],
                    method=method, rtol=1e-9, atol=1e-9)
    assert got.status == 1 and len(got.t_events[0]) == 2
    if method != "RK4":   # a fixed step of 4 pi / 100
        np.testing.assert_allclose(got.t_events[0], [np.pi / 2, 3 * np.pi / 2],
                                   rtol=1e-6)
        np.testing.assert_allclose(got.t[-1], 3 * np.pi / 2, rtol=1e-6)


def test_sho_direction_filtering():
    crossing = (lambda t, y: y[0])
    pos = event(lambda t, y: y[0], direction=1)
    neg = event(lambda t, y: y[0], direction=-1)
    evs = [crossing, pos, neg]
    ref, got = both(jsho, tsho, evs, evs, (0.0, 2 * np.pi), [1.0, 0.0],
                    method="RK45", rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.t_events[0], [np.pi / 2, 3 * np.pi / 2],
                               rtol=1e-6)
    np.testing.assert_allclose(got.t_events[1], [3 * np.pi / 2], rtol=1e-6)
    np.testing.assert_allclose(got.t_events[2], [np.pi / 2], rtol=1e-6)


def test_duplicate_timestamps():
    """The upward cannon with a tiny max_step (SciPy's case)."""
    def jcannon(t, y):
        return jnp.array([y[1], -9.80665])

    def tcannon(t, y):
        return torch.stack([y[1], torch.zeros_like(y[1]) - 9.80665])

    ev = event(lambda t, y: y[0], terminal=True, direction=-1)
    ref, got = both(jcannon, tcannon, ev, ev, [0, np.inf], [0, 0.01],
                    max_step=0.05 * 0.001 / 9.80665, dense_output=True)
    np.testing.assert_allclose(got.sol(0.01), [-0.00039033, -0.08806632],
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got.t_events[0], [0.00203943], rtol=1e-5,
                               atol=1e-8)
    assert got.success and got.status == 1
    # Against ivp_tpu inside the span (sol(0.01) extrapolates the last,
    # 5e-6-long step 1600 of its lengths out).
    ts = np.linspace(0.0, got.t_events[0][0], 9)
    assert scaled(got.sol(ts), ref.sol(ts)) <= Y_EV


def test_bouncing_ball_host_restart():
    """examples/bouncing_ball.py::main: a terminal event, restarted from the
    host with the restitution applied."""
    jg, tg = ground_pair(restart=False)
    t0, y = 0.0, [10.0, 0.0]
    bounces = []
    for _ in range(3):
        ref, got = both(jball, tball, jg, tg, (t0, t0 + 20.0), y,
                        method="RK45", rtol=1e-9, atol=1e-9)
        assert got.status == 1
        t0 = float(got.t_events[0][0])
        bounces.append(t0)
        y = [0.0, -COR * float(got.y_events[0][0][1])]
    t1 = np.sqrt(2 * 10.0 / G)
    np.testing.assert_allclose(bounces[0], t1, rtol=1e-6)
    dt1, dt2 = bounces[1] - bounces[0], bounces[2] - bounces[1]
    np.testing.assert_allclose(dt1, 2 * COR * t1, rtol=1e-5)
    np.testing.assert_allclose(dt2 / dt1, COR, rtol=1e-5)


def test_backward_events():
    ev = (lambda t, y: y[0])
    ref, got = both(jsho, tsho, ev, ev, (2 * np.pi, 0.0), [1.0, 0.0],
                    method="RK45", rtol=1e-9, atol=1e-9)
    assert got.success
    np.testing.assert_allclose(np.sort(got.t_events[0]),
                               [np.pi / 2, 3 * np.pi / 2], rtol=1e-6)


@pytest.mark.parametrize("method", ["RK45", "RK23", "RK4"])
def test_solve_ivp_in_device_restart(method):
    """Every bounce restarted in the loop by the event's restart map, up to
    max_restarts (status 1 at the 11th bounce).  DOP853 is held on the
    Lorenz and SHO cases: on the ball's exact parabola its error estimate
    is rounding noise, which XLA's FMAs and torch's separate operations
    size apart (ROADMAP §3 fault 2)."""
    jg, tg = ground_pair()
    kw = dict(first_step=1e-2) if method == "RK4" else {}
    ref, got = both(jball, tball, [jg], [tg], (0.0, 12.0), [10.0, 0.0],
                    method=method, rtol=1e-9, atol=1e-9, max_restarts=10,
                    **kw)
    assert got.n_restarts == 10 and got.status == 1
    if method != "RK4":
        t1, v0 = np.sqrt(2 * 10.0 / G), np.sqrt(2 * G * 10.0)
        np.testing.assert_allclose(got.t_events[0][0], t1, atol=1e-9)
        np.testing.assert_allclose(got.t_events[0][1], t1 + 2 * COR * v0 / G,
                                   atol=1e-9)


def test_in_device_restart_cuda_event_set():
    """The declared set ``events.ground`` of ``rhs.ball`` (what the card
    runs) through the CPU route: the same solve as a SciPy-style event."""
    jg, _ = ground_pair()
    ref, got = both(jball, it.rhs.ball, [jg], [E.ground], (0.0, 12.0),
                    [10.0, 0.0], method="RK45", rtol=1e-9, atol=1e-9,
                    max_restarts=10)
    assert got.n_restarts == 10 and got.status == 1


def test_restart_dense_output_segments():
    """Dense output and t_eval across a restart follow the segments after
    it, not the truncated step's interpolant past the event point."""
    jg, tg = ground_pair()
    t1 = np.sqrt(2 * 10.0 / G)
    v1 = COR * np.sqrt(2 * G * 10.0)
    grid = np.linspace(t1 + 0.01, t1 + 0.5, 9)
    ref, got = both(jball, tball, [jg], [tg], (0.0, 5.0), [10.0, 0.0],
                    method="RK45", rtol=1e-9, atol=1e-9, max_restarts=4,
                    dense_output=True, t_eval=grid)
    dt = grid - t1
    exact = v1 * dt - 0.5 * G * dt ** 2
    np.testing.assert_allclose(got.y[0], exact, rtol=1e-7, atol=1e-9)
    assert np.all(got.y[0] > 0)
    np.testing.assert_allclose(got.sol(grid)[0], exact, rtol=1e-7, atol=1e-9)
    assert scaled(got.sol(grid), ref.sol(grid)) <= Y_EV


def test_restart_preserves_other_event_counters():
    """A restart resets only the restarting event's hit count: the third
    apex stops the run though every bounce resets the ground's."""
    jg, tg = ground_pair()
    japex = event(lambda t, y: y[1], terminal=3, direction=-1)
    tapex = event(lambda t, y: y[1], terminal=3, direction=-1)
    ref, got = both(jball, tball, [jg, japex], [tg, tapex], (0.0, 30.0),
                    [10.0, 0.0], method="RK45", rtol=1e-9, atol=1e-9,
                    max_restarts=10)
    assert got.status == 1 and len(got.t_events[1]) == 3
    assert got.n_restarts < 10


def test_zero_span_and_empty_events():
    """A zero span gives one empty array per event; events=[] gives none."""
    ev = (lambda t, y: y[0])
    got = it.solve_ivp(tsho, (1.0, 1.0), [1.0, 0.0], events=[ev, ev],
                       device="cpu")
    assert [x.shape for x in got.t_events] == [(0,), (0,)]
    assert [x.shape for x in got.y_events] == [(0, 2), (0, 2)]
    got = it.solve_ivp(tsho, (0.0, 1.0), [1.0, 0.0], events=[], device="cpu")
    assert got.t_events == [] and got.y_events == [] and got.status == 0


def test_plain_callable_event_on_the_card_raises(monkeypatch):
    """A plain callable event (or an event set of another RHS) on the card
    raises NotImplementedError naming item 12, before anything is placed."""
    monkeypatch.setattr(it.solve, "_place", lambda *a, **k: pytest.fail(
        "placed before the events were checked"))
    for events in ([lambda t, y: y[0]], [E.lorenz_section]):
        for device in (None, "cuda"):
            with pytest.raises(NotImplementedError, match="item 12"):
                it.solve_ivp(it.rhs.ball, (0.0, 1.0), [1.0, 0.0],
                             events=events, device=device)


# ---- Brent against SciPy ----

def test_brentq_matches_scipy():
    """Per lane, the port's lock-step Brent against scipy.optimize.brentq
    with the same tolerances (xtol 2e-12, rtol 4 * eps): within xtol; lanes
    that are not active keep b; an end with |f| <= xtol is the root."""
    rng = np.random.default_rng(0)
    B = 64
    c = rng.uniform(0.5, 3.0, B)
    k = rng.uniform(-2.0, 2.0, B)

    def f(x, i):
        return np.tanh(c[i] * (x - k[i])) + 0.1 * (x - k[i]) ** 3

    a = k - rng.uniform(0.1, 3.0, B)
    b = k + rng.uniform(0.1, 3.0, B)
    a[3], b[5] = k[3], k[5]            # roots at an end
    T = lambda v: torch.as_tensor(v, dtype=torch.float64)
    ct, kt = T(c), T(k)

    def g(x):
        return torch.tanh(ct * (x - kt)) + 0.1 * (x - kt) ** 3

    active = torch.ones(B, dtype=torch.bool)
    active[7] = False
    root, evals = brentq(g, T(a), T(b), g(T(a)), g(T(b)), active)
    for i in range(B):
        if i == 7:
            assert float(root[i]) == b[i]
            continue
        want = scipy.optimize.brentq(lambda x: f(x, i), a[i], b[i],
                                     xtol=2e-12, rtol=4 * np.finfo(float).eps)
        assert abs(float(root[i]) - want) <= 4e-12, i
    assert float(root[3]) == a[3] and float(root[5]) == b[5]
    assert int(evals[7]) == 0 and int(evals.max()) <= 100
