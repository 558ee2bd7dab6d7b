"""Radau and BDF with events and in-loop restarts: the port's plain version
(the route ``device="cpu"`` runs, and the kernels' event modes'
counterpart) against ``ivp_tpu`` on the CPU, under
``controller_precision="state"``, for the two event sets the stiff kernels
run (ivp_tpu_torch/events.py):

* ``crossing``: VdP at mu=300 (two downward crossings of y[0] a lane) on
  tests/test_torch_stiff_cases.py's short span [0, 1000], B=8, event
  capacity 4;
* ``replenish``: the sawtooth of tests/test_events.py's stiff restart test
  (decay refilled to 1 at y = 0.5, terminal, ``max_restarts=20``), with a
  per-lane rate k in [40, 90] over its ten periods at k = 50.

Each runs through the ensemble solver with a 21-point ``t_eval`` (its
final states and samples) and through ``solve_ivp`` with ``dense_output`` (the last lane),
against one ``ivp_tpu`` ensemble solve with the same ``t_eval`` (one jit
per method and set, module-scoped).  Bounds, per lane: status, ``n_events``,
``n_restarts`` and the overflow flags equal on every lane, nfev, nstep,
naccpt and nrejct too but on Radau's sawtooth (``SHARE``: 7 of 8 lanes) (``ivp_tpu``'s ensemble has no njev or nlu; tests/
test_torch_stiff_events_kernel.py holds those to the kernels); event times,
event states, samples, the dense solution on the grid and the final y
within test_torch_stiff_cases.py's ``Y_TOL`` (1e-7) of their scale
max(1, |x|); BDF's event times within 1.6e-9 of it (the host libm's last
bits in its step sizes, as tests/test_torch_stiff_modes_ivp_tpu.py states).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_stiff_cases as C  # noqa: E402  (imports ivp_tpu, jax)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from ivp_tpu.batch import build_ensemble_solver as jax_build  # noqa: E402

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import Status  # noqa: E402
from ivp_tpu_torch import events as EV  # noqa: E402

LANES, M = 8, 21
SO = {"controller_precision": "state"}
METHODS = ("Radau", "BDF")
SETS = ("crossing", "replenish")
COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct", "n_events",
            "n_restarts", "event_overflow")
MU = 300.0
PERIOD = np.log(2.0) / 50.0
T_TOL = {"Radau": C.Y_TOL, "BDF": 1.6e-9}
# The least share of lanes whose counters all equal ivp_tpu's: every lane
# but Radau's on the sawtooth, where 7 of 8 do.  There the reference's step
# sizes part from the port's at the fourth attempt of each period by
# 1.6e-10 relative (its error estimate, a sum of products, comes out of
# XLA's CPU compilation other than from the port's separate roundings,
# ROADMAP §3 fault 5, while the port's plain version and its kernels agree
# bit for bit), and on the lane at k = 47.1 one Newton iteration more a
# period in the reference follows: nfev 561 against 534, every other
# counter, event count and restart equal.
SHARE = {("Radau", "replenish"): 7 / 8}


def jvdp(t, y, mu):
    return jnp.array([y[1], mu * (1.0 - y[0] ** 2) * y[1] - y[0]])


def jcross(t, y, mu):
    return y[0]


jcross.direction = -1


def jdecay(t, y, k):
    return -k * y


def jlow(t, y, k):
    return y[0] - 0.5


jlow.terminal = True
jlow.direction = -1
jlow.restart = lambda t, y: jnp.ones_like(y)


def problem(name):
    """``(port RHS, ivp_tpu RHS, n, y0, per-lane args, tf, rtol, atol, port
    events, ivp_tpu events, capacity, max_restarts)``."""
    if name == "crossing":
        return (it.rhs.vdp, jvdp, 2, C.stiff_y0(LANES),
                np.full(LANES, MU), C.SHORT_TF, C.RTOL, C.ATOL,
                [EV.vdp_crossing], [jcross], 4, 0)
    k = np.linspace(40.0, 90.0, LANES)
    return (it.rhs.decay, jdecay, 1, np.ones((LANES, 1)), k,
            10 * PERIOD * 1.01, 1e-8, 1e-10, [EV.replenish], [jlow], 16, 20)


def grid(name):
    return np.linspace(0.0, problem(name)[5], M)


@functools.lru_cache(maxsize=None)
def reference(method, name):
    """``ivp_tpu``'s ensemble solve with the ``t_eval`` grid, as numpy."""
    _, jf, n, y0, a, tf, rtol, atol, _, jev, cap, mr = problem(name)
    solve = jax.jit(jax_build(jf, method, n=n, args=(a,), args_batched=True,
                              events=jev, event_capacity=cap,
                              max_restarts=mr, t_eval=grid(name),
                              solver_options=SO))
    out = solve(jnp.asarray(y0), 0.0, tf, rtol, atol)
    return {k: np.asarray(v) for k, v in out._asdict().items()
            if v is not None}


def port(method, name):
    f, _, n, y0, a, tf, rtol, atol, ev, _, cap, mr = problem(name)
    solve = it.batch.build_ensemble_solver(
        f, method, n=n, args=(torch.tensor(a),), args_batched=True,
        events=ev, event_capacity=cap, max_restarts=mr, t_eval=grid(name),
        solver_options=SO)
    out = solve(y0, 0.0, tf, rtol, atol, device="cpu")
    return {k: v.numpy() for k, v in out._asdict().items()
            if isinstance(v, torch.Tensor)}


def scaled(got, ref):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    return np.abs(got - ref) / np.maximum(1.0, np.abs(ref))


def assert_events(method, got, ref, lanes=slice(None)):
    """Counts equal; every recorded time and state within its bound."""
    cnt = ref["n_events"][lanes]
    np.testing.assert_array_equal(got["n_events"], cnt)
    assert cnt.min() >= 2
    for i in range(cnt.shape[0]):
        for e in range(cnt.shape[1]):
            c = cnt[i, e]
            tg, tr = got["t_events"][i, e, :c], ref["t_events"][lanes][i, e, :c]
            assert np.all(scaled(tg, tr) <= T_TOL[method]), (i, tg, tr)
            yg = got["y_events"][i, e, :c]
            yr = ref["y_events"][lanes][i, e, :c]
            assert np.all(scaled(yg, yr) <= C.Y_TOL), (i, yg, yr)


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("method", METHODS)
def test_ensemble_matches_ivp_tpu(method, name):
    ref = reference(method, name)
    got = port(method, name)
    same = np.ones(LANES, bool)
    for f in COUNTERS:   # n_restarts where the solve allows restarts
        assert (f in got) == (f in ref), f
        if f in ref:
            same &= (got[f] == ref[f]).reshape(LANES, -1).all(axis=1)
    assert same.mean() >= SHARE.get((method, name), 1.0), same
    for f in ("status", "n_events", "n_restarts", "event_overflow"):
        if f in ref:
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert_events(method, got, ref)
    assert np.all(scaled(got["y"], ref["y"]) <= C.Y_TOL)
    np.testing.assert_array_equal(got["n_samples"], ref["n_samples"])
    assert np.all(scaled(got["y_samples"], ref["y_samples"]) <= C.Y_TOL)
    if name == "replenish":
        # Every lane restarts on each of its periods within the budget.
        assert np.all(got["n_restarts"] >= 8)
        assert set(got["status"].tolist()) == {Status.SUCCESS}
    else:
        assert "n_restarts" not in got


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("method", METHODS)
def test_solve_ivp_matches_ivp_tpu(method, name):
    """``solve_ivp`` with ``dense_output`` on the last lane (on the
    sawtooth the one whose buffer overflows): the counters, the events and
    the dense solution on the grid against the ensemble reference's
    lane."""
    ref = reference(method, name)
    f, _, n, y0, a, tf, rtol, atol, ev, _, cap, mr = problem(name)
    for lane in (LANES - 1,):
        r = it.solve_ivp(f, (0.0, tf), y0[lane], method, args=(a[lane],),
                         events=ev, event_capacity=cap, max_restarts=mr,
                         rtol=rtol, atol=atol, dense_output=True,
                         solver_options=SO, device="cpu")
        assert r.raw_status == ref["status"][lane]
        for fld in ("nfev", "nstep", "naccpt", "nrejct"):
            assert getattr(r, fld) == ref[fld][lane], fld
        assert r.n_restarts == ref.get("n_restarts", [0] * LANES)[lane]
        np.testing.assert_array_equal(r.event_overflow,
                                      ref["event_overflow"][lane])
        got = {"n_events": np.array([[len(r.t_events[0])]]),
               "t_events": np.asarray(r.t_events[0])[None, None],
               "y_events": np.asarray(r.y_events[0])[None, None]}
        assert_events(method, got, ref, slice(lane, lane + 1))
        dense = np.asarray(r.sol(grid(name))).T
        assert np.all(scaled(dense, ref["y_samples"][lane]) <= C.Y_TOL)
        assert np.all(scaled(r.y_reached, ref["y"][lane]) <= C.Y_TOL)
