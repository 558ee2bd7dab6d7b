"""Events through the ensemble solves on the second declared event set of
the port, the Lorenz Poincaré section (``rhs.lorenz`` with
``events.lorenz_section``: ``z - (rho - 1)``, downward), against
``ivp_tpu``'s on the CPU: lean with per-lane rho, with ``t_eval`` and a
terminal count, and recording with ``dense_output``; and the event
buffers' overflow.

DOP853 at bench.py's Lorenz tolerances (rtol 1e-8, atol 1e-10), lanes held
on t in [0, 4] (beyond, a last-bit difference grows like exp(0.9 t)).
Bounds, per lane: status, ``n_events``, ``event_overflow`` and every
counter equal; event times within 1e-10 scaled by max(1, |t|); event and
final states within 1e-8 scaled by max(1, |y|) (tests/
test_torch_events_ensemble.py's ``assert_matches``).
"""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402,F401  (enables x64)
from ivp_tpu.batch import build_ensemble_solver as jax_build  # noqa: E402
from ivp_tpu.batch import solve_ivp_ensemble as jax_ensemble  # noqa: E402

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import events as E  # noqa: E402

from test_torch_events_ensemble import B, assert_matches  # noqa: E402

LORENZ_TF = 4.0


def jlorenz(t, y, sigma, rho, beta):
    return jnp.array([sigma * (y[1] - y[0]), y[0] * (rho - y[2]) - y[1],
                      y[0] * y[1] - beta * y[2]])


def jsection(t, y, sigma, rho, beta):
    return y[2] - (rho - 1.0)


jsection.direction = -1


def lorenz_inputs(seed=0):
    rng = np.random.default_rng(seed)
    y0 = np.array([1.0, 1.0, 1.0]) + rng.standard_normal((B, 3))
    return y0, (np.full(B, 10.0), rng.uniform(26.0, 30.0, B),
                np.full(B, 8.0 / 3.0))


@functools.lru_cache(maxsize=None)
def jax_lorenz(terminal):
    jsection.terminal = terminal
    return jax.jit(jax_build(
        jlorenz, "DOP853", n=3, args=lorenz_inputs()[1], args_batched=True,
        events=[jsection], event_capacity=64))


@pytest.mark.parametrize("terminal", [False, 5])
def test_lean_lorenz_section(terminal):
    """DOP853 on the Lorenz Poincaré section, per-lane rho: every crossing
    recorded, or the lane stopped at its fifth."""
    y0, args = lorenz_inputs()
    ref = jax_lorenz(terminal)(y0, 0.0, LORENZ_TF, 1e-8, 1e-10)
    ev = E.lorenz_section.replace(terminal=terminal)
    got = it.build_ensemble_solver(
        it.rhs.lorenz, "DOP853", n=3, args=args, args_batched=True,
        events=[ev], event_capacity=64)(y0, 0.0, LORENZ_TF, 1e-8, 1e-10,
                                        device="cpu")
    assert_matches(ref, got)
    assert got.n_restarts is None   # as ivp_tpu's without max_restarts
    if terminal:
        stopped = got.status.numpy() == it.Status.USER_INTERRUPT
        assert stopped.any()
        assert (got.n_events[:, 0].numpy()[stopped] == 5).all()



def test_overflow_flag_and_warning():
    """A buffer of 2 keeps each lane's first two crossings, flags the lanes
    that had more, and solve_ivp_ensemble warns."""
    y0, _ = lorenz_inputs(3)
    kw = dict(method="DOP853", rtol=1e-8, atol=1e-10,
              events=[E.lorenz_section], device="cpu")
    with pytest.warns(UserWarning, match="overflowed"):
        small = it.solve_ivp_ensemble(it.rhs.lorenz, (0.0, LORENZ_TF), y0,
                                      event_capacity=2, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        big = it.solve_ivp_ensemble(it.rhs.lorenz, (0.0, LORENZ_TF), y0,
                                    event_capacity=64, **kw)
    nb = big.n_events[:, 0]
    assert torch.equal(small.n_events[:, 0], torch.clamp_max(nb, 2))
    assert torch.equal(small.event_overflow[:, 0], nb > 2)
    assert bool((nb > 2).any()) and not bool(big.event_overflow.any())
    assert torch.equal(small.t_events, big.t_events[:, :, :2])
    for f in ("t", "y", "status", "nfev", "nstep"):
        assert torch.equal(getattr(small, f), getattr(big, f)), f


@functools.lru_cache(maxsize=None)
def jax_lorenz_sampled():
    jstop = lambda t, y, sigma, rho, beta: jsection(t, y, sigma, rho, beta)
    jstop.direction, jstop.terminal = -1, 3
    return jax.jit(jax_build(
        jlorenz, "DOP853", n=3, args=lorenz_inputs()[1], args_batched=True,
        events=[jstop], event_capacity=8,
        t_eval=np.linspace(0.0, LORENZ_TF, 21)))


def test_sampled_lorenz_stop3():
    """t_eval samples with the third crossing terminal: every lane stops
    mid-grid, and no sample past its event point is emitted."""
    y0, args = lorenz_inputs(4)[0], lorenz_inputs()[1]   # the jit's args
    ref = jax_lorenz_sampled()(y0, 0.0, LORENZ_TF, 1e-8, 1e-10)
    got = it.build_ensemble_solver(
        it.rhs.lorenz, "DOP853", n=3, args=args, args_batched=True,
        events=[E.lorenz_section.replace(terminal=3)], event_capacity=8,
        t_eval=np.linspace(0.0, LORENZ_TF, 21))(y0, 0.0, LORENZ_TF, 1e-8,
                                                1e-10, device="cpu")
    assert_matches(ref, got, samples=True)
    assert bool((got.status == it.Status.USER_INTERRUPT).all())
    assert bool((got.n_samples < 21).all())


def test_recording_lorenz_dense():
    """solve_ivp_ensemble(dense_output=True) with the section, chunks of 9
    rows: counters, rows and events against ivp_tpu's (rows' times within
    1e-5 relative and states within 1e-10 scaled after moving ivp_tpu's row
    along f by the time difference, as tests/test_torch_recording.py holds
    them: the float32 controller rounds step sizes apart in their last
    float32 bits), sol on a grid within 1e-8 scaled."""
    y0, _ = lorenz_inputs(5)
    kw = dict(method="DOP853", rtol=1e-8, atol=1e-10, event_capacity=8,
              dense_output=True)
    jsec = lambda t, y: jsection(t, y, 10.0, 28.0, 8.0 / 3.0)
    jsec.direction = -1
    ref = jax_ensemble(lambda t, y: jlorenz(t, y, 10.0, 28.0, 8.0 / 3.0),
                       (0.0, 3.0), y0, events=[jsec], **kw)
    got = it.solve_ivp_ensemble(it.rhs.lorenz, (0.0, 3.0), y0,
                                events=[E.lorenz_section], rec_chunk=9,
                                device="cpu", **kw)
    assert_matches(ref, got)
    n = got.n_steps_rec.numpy()
    np.testing.assert_array_equal(n, np.asarray(ref.n_steps_rec))
    S = int(n.max())
    ts, rts = got.ts.numpy(), np.asarray(ref.ts)[:, :S]
    np.testing.assert_allclose(ts, rts, rtol=1e-5, atol=1e-6)
    f = lambda y: np.stack([10.0 * (y[..., 1] - y[..., 0]),
                            y[..., 0] * (28.0 - y[..., 2]) - y[..., 1],
                            y[..., 0] * y[..., 1] - (8.0 / 3.0) * y[..., 2]], -1)
    rys = np.asarray(ref.ys)[:, :S]
    moved = rys + f(rys) * (ts - rts)[..., None]
    err = np.abs(got.ys.numpy() - moved) / np.maximum(1.0, np.abs(rys))
    assert float(err.max()) <= 1e-10
    grid = np.linspace(0.0, 3.0, 31)
    a, b = got.sol(grid).numpy(), np.asarray(ref.sol(grid))
    assert float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max()) <= 1e-8
