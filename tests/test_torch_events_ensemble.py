"""Events and in-loop restarts through the ensemble solves: the port's
``build_ensemble_solver`` (lean and with ``t_eval``) and recording tier
(``dense_output``, ``record_trajectories``) against ``ivp_tpu``'s on the
CPU, with per-lane args, and the default event capacity.

The problem is a declared event set of the port (ivp_tpu_torch/events.py),
so the CPU route runs here what the kernels' event modes run on the card:
the bouncing ball (``rhs.ball`` with ``events.ground`` and its restart map,
per-lane gravity).  tests/test_torch_events_lorenz.py holds the other set,
the Lorenz Poincaré section, and the buffers' overflow.  ivp_tpu gets the
same functions in jnp.  Bounds, per lane:

* status, ``n_events``, ``n_restarts``, ``event_overflow``, ``nfev``,
  ``nstep``, ``naccpt``, ``nrejct`` (and ``n_samples``, ``n_steps_rec``)
  equal on every lane;
* event times within 1e-10 scaled by max(1, |t|); event states, final
  states, samples and recorded states within 1e-8 scaled by max(1, |y|).

DOP853 runs the Lorenz set only: on the ball's exact parabola its error
estimate is rounding noise, which XLA's FMAs and torch's separate
operations size apart (ROADMAP §3 fault 2).  Each ivp_tpu solver is built
once (one jit per method and mode); B is small.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402,F401  (enables x64)
from ivp_tpu.batch import _auto_event_capacity as jax_auto_capacity  # noqa
from ivp_tpu.batch import build_ensemble_solver as jax_build  # noqa: E402
from ivp_tpu.batch import solve_ivp_ensemble as jax_ensemble  # noqa: E402

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import batch as tb  # noqa: E402
from ivp_tpu_torch import convert  # noqa: E402
from ivp_tpu_torch import events as E  # noqa: E402

B = 12
COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct", "n_events",
            "n_restarts", "event_overflow")
T_EV, Y_EV = 1e-10, 1e-8
COR = 0.8
BALL_TF, LORENZ_TF = 15.0, 5.0


def jball(t, y, g):
    return jnp.array([y[1], -g])


def jground(t, y, g):
    return y[0]


jground.terminal = True
jground.direction = -1
jground.restart = lambda t, y: jnp.array([0.0, -COR * y[1]])


def ball_inputs(seed=0):
    """Heights 2..20 m, per-lane gravity."""
    rng = np.random.default_rng(seed)
    y0 = np.stack([np.linspace(2.0, 20.0, B), np.zeros(B)], axis=1)
    return y0, (rng.uniform(9.0, 10.5, B),)


def ball_options(method):
    return dict(first_step=5e-2) if method == "RK4" else {}


@functools.lru_cache(maxsize=None)
def jax_ball(method, t_eval=None, max_restarts=8):
    return jax.jit(jax_build(
        jball, method, n=2, args=ball_inputs()[1], args_batched=True,
        events=[jground], event_capacity=16, max_restarts=max_restarts,
        t_eval=None if t_eval is None else np.asarray(t_eval),
        **ball_options(method)))


def port_ball(method, t_eval=None, max_restarts=8):
    return it.build_ensemble_solver(
        it.rhs.ball, method, n=2, args=ball_inputs()[1], args_batched=True,
        events=[E.ground], event_capacity=16, max_restarts=max_restarts,
        t_eval=t_eval, **ball_options(method))


def assert_matches(ref, got, samples=False):
    got = convert.result_to_numpy(got)
    for f in COUNTERS + (("n_samples",) if samples else ()):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    scale = lambda a: np.maximum(1.0, np.abs(np.asarray(a)))
    for f, tol in (("t_events", T_EV), ("y_events", Y_EV), ("t", T_EV),
                   ("y", Y_EV)) + ((("y_samples", Y_EV),) if samples else ()):
        ref_f = np.asarray(getattr(ref, f))
        err = np.abs(getattr(got, f) - ref_f) / scale(ref_f)
        assert float(err.max()) <= tol, (f, float(err.max()))


@pytest.mark.parametrize("method", ["RK45", "RK23", "RK4"])
def test_lean_ball_restarts(method):
    """examples/bouncing_ball.py::main_in_device on 12 lanes with per-lane
    gravity: every bounce restarts its lane, the ninth ends it."""
    y0, args = ball_inputs()
    ref = jax_ball(method)(y0, 0.0, BALL_TF, 1e-9, 1e-9)
    got = port_ball(method)(y0, 0.0, BALL_TF, 1e-9, 1e-9, device="cpu")
    assert_matches(ref, got)
    assert int(got.n_restarts.max()) == 8 and int(got.n_events.min()) >= 2
    assert got.t_events.shape == (B, 1, 16)


GRID = np.linspace(0.0, BALL_TF, 31)


def test_sampled_ball_restarts_then_terminal():
    """t_eval samples across restarts and past the terminal bounce (two
    restarts allowed, the third bounce ends the lane): no sample past the
    event point."""
    y0, _ = ball_inputs()
    ref = jax_ball("RK45", tuple(GRID), 2)(y0, 0.0, BALL_TF, 1e-9, 1e-9)
    got = port_ball("RK45", GRID, 2)(y0, 0.0, BALL_TF, 1e-9, 1e-9,
                                     device="cpu")
    assert_matches(ref, got, samples=True)
    assert (got.status == it.Status.USER_INTERRUPT).all()
    n = got.n_samples.numpy()
    assert (n < len(GRID)).all()
    t_end = got.t.numpy()
    assert (GRID[np.maximum(n - 1, 0)] <= t_end).all()
    assert (GRID[np.minimum(n, len(GRID) - 1)] > t_end).all()


@pytest.mark.parametrize("method", ["RK45", "RK4"])
def test_recording_ball_restarts(method):
    """solve_ivp_ensemble(dense_output=True) with restarts, the event state
    carried across chunks of 7 rows: rows, events and sol equal ivp_tpu's;
    the row of each bounce holds the event time and the restarted state."""
    y0, _ = ball_inputs(1)
    kw = dict(method=method, rtol=1e-9, atol=1e-9, args=(9.81,),
              event_capacity=16, max_restarts=4, dense_output=True,
              **ball_options(method))
    ref = jax_ensemble(jball, (0.0, 8.0), y0, events=[jground], **kw)
    got = it.solve_ivp_ensemble(it.rhs.ball, (0.0, 8.0), y0, events=[E.ground],
                                rec_chunk=7, device="cpu", **kw)
    assert_matches(ref, got)
    np.testing.assert_array_equal(got.n_steps_rec.numpy(),
                                  np.asarray(ref.n_steps_rec))
    S = int(got.n_steps_rec.max())
    for f in ("ts", "ys"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))[:, :S]
        assert float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max()) \
            <= Y_EV, f
    # A restarted step's row: the event time, the restarted state (0, v).
    tev = got.t_events.numpy()[:, 0]
    ts, ys = got.ts.numpy(), got.ys.numpy()
    for lane in range(B):
        for t_hit in tev[lane, :int(got.n_restarts[lane])]:
            j = int(np.argmin(np.abs(ts[lane] - t_hit)))
            assert ts[lane, j] == t_hit and ys[lane, j, 0] == 0.0
    grid = np.linspace(0.0, 8.0, 41)
    a, b = got.sol(grid).numpy(), np.asarray(ref.sol(grid))
    assert float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max()) <= Y_EV


def test_recording_chunks_and_trajectories():
    """The port against itself: rec_chunk 5 and 4096 give the same rows,
    events and counters bit for bit, and record_trajectories the same steps
    as dense_output."""
    y0, _ = ball_inputs(2)
    kw = dict(method="RK23", rtol=1e-8, atol=1e-8, args=(9.5,),
              event_capacity=16, max_restarts=3, device="cpu")
    runs = [it.solve_ivp_ensemble(it.rhs.ball, (0.0, 6.0), y0,
                                  events=[E.ground], rec_chunk=c,
                                  dense_output=d, record_trajectories=not d,
                                  **kw)
            for c, d in ((5, True), (4096, True), (5, False))]
    for other in runs[1:]:
        for f in ("t", "y", "status", "nfev", "nstep", "naccpt", "nrejct",
                  "t_events", "y_events", "n_events", "n_restarts",
                  "event_overflow", "ts", "ys", "n_steps_rec"):
            assert torch.equal(getattr(runs[0], f), getattr(other, f)), f
    assert runs[2].sol is None and int(runs[0].n_restarts.max()) == 3


@pytest.mark.parametrize("shape, n_ev, dtype", [
    ((4, 2), 1, torch.float64), ((131072, 6), 2, torch.float64),
    ((8192, 3), 1, torch.float32), ((2000000, 2), 3, torch.float64),
    ((4, 2), 0, torch.float64)])
def test_auto_event_capacity(shape, n_ev, dtype):
    """The port's default capacity equals ivp_tpu's for the same sizes."""
    evs = [E.ground] * n_ev if n_ev else None
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    assert (tb._auto_event_capacity(shape, evs, dtype)
            == jax_auto_capacity(shape, evs, jdt))


@pytest.mark.parametrize("record", [False, True])
def test_plain_callable_event_on_the_card_raises(record, monkeypatch):
    """A plain callable event on the card raises NotImplementedError naming
    item 12, before y0_batch is placed; so does another RHS's set."""
    monkeypatch.setattr(tb, "_place", lambda *a, **k: pytest.fail(
        "placed before the events were checked"))
    for events in ([lambda t, y: y[:, 0]], [E.lorenz_section]):
        for device in (None, "cuda"):
            with pytest.raises(NotImplementedError, match="item 12"):
                it.solve_ivp_ensemble(it.rhs.ball, (0.0, 1.0),
                                      np.ones((4, 2)), events=events,
                                      dense_output=record, device=device)


@pytest.mark.parametrize("mode", ["lean", "record"])
def test_functor_without_entry_raises(mode):
    """The ball has kernel entries only with its event set: a launch
    without events finds no entry in the library and raises
    NotImplementedError (a stand-in library with the functor's shape
    entries and no solve entries, on CPU tensors)."""
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import erk_record as R

    class Lib:
        ivp_rhs_n_ball = staticmethod(lambda: 2)
        ivp_rhs_nargs_ball = staticmethod(lambda: 1)

    lib = Lib()
    B = 3
    T = lambda v: torch.full((B,), v, dtype=torch.float64)
    tol = torch.full((B, 2), 1e-6, dtype=torch.float64)
    a = (torch.ones((B, 2), dtype=torch.float64), T(0.0), T(1.0), T(1.0),
         None, tol, tol, (), 1000, None, None)
    with pytest.raises(NotImplementedError, match="ivp_dop853_.*ball"):
        if mode == "lean":
            K.ensemble_launch("DOP853", it.rhs.ball, *a, lib, 0)
        else:
            R.record_launches("DOP853", it.rhs.ball, *a, 8, True, lib, 0)
