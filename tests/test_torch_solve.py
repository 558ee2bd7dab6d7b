"""The single-IVP facade ``ivp_tpu_torch.solve_ivp`` against
``ivp_tpu.solve_ivp`` on the CPU.

A SciPy-style callable runs through the port's plain driver as one lane.
Bounds, per case:

* status, message, every counter and the number of output points equal;
* ``t_eval`` outputs: ``t`` equal, ``y`` within 1e-10 scaled by max(1, |y|);
* step outputs (no ``t_eval``): ``t`` within 1e-5 relative (1e-6
  absolute) and ``y`` as
  points of one trajectory, within 1e-10 scaled after moving ivp_tpu's
  point along f by the two times' difference (the float32 controller
  rounds step sizes apart in their last float32 bits: tests/
  test_torch_record.py);
* ``sol(ts)`` on fixed times within 1e-10 scaled;
* ``chunk_steps`` changes nothing: bit for bit.

CR3BP (the Arenstorf orbit of tests/test_gates.py, DOP853 at rtol 1e-12,
``rhs.cr3bp`` on the CPU, ~3 s) holds the gate's own bounds: periodicity
within 1e-6 and the Jacobi constant within 1e-8 on 200 dense points.
Against ivp_tpu there the step sequences part on the second step: on the
first steps after hinit the error estimate is rounding noise (ROADMAP §3
fault 2), which XLA's FMAs and torch's separate operations make of another
size.  So nstep, naccpt and nrejct are held within 1% and 2 (measured:
408 / 354 / 54 against 407 / 354 / 53), and the final state within 1e-8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402  (enables x64)
import ivp_tpu_torch as it  # noqa: E402

MU = 0.012277471
COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct", "njev", "nlu")
TOL = dict(rtol=1e-8, atol=1e-10)


def jvdp(t, y):
    return jnp.array([y[1], (1.0 - y[0] ** 2) * y[1] - y[0]])


def tvdp(t, y):
    return torch.stack([y[1], (1.0 - y[0] ** 2) * y[1] - y[0]])


def vdp_np(y):
    return np.array([y[1], (1.0 - y[0] ** 2) * y[1] - y[0]])


def jcr3bp(t, state, mu):
    x, y, z, vx, vy, vz = state
    r1 = jnp.sqrt((x + mu) ** 2 + y ** 2 + z ** 2)
    r2 = jnp.sqrt((x - 1 + mu) ** 2 + y ** 2 + z ** 2)
    ax = x + 2 * vy - (1 - mu) * (x + mu) / r1 ** 3 - mu * (x - 1 + mu) / r2 ** 3
    ay = y - 2 * vx - (1 - mu) * y / r1 ** 3 - mu * y / r2 ** 3
    az = -(1 - mu) * z / r1 ** 3 - mu * z / r2 ** 3
    return jnp.array([vx, vy, vz, ax, ay, az])


def jacobi_constant(state, mu):
    x, y, z, vx, vy, vz = state
    r1 = np.sqrt((x + mu) ** 2 + y ** 2 + z ** 2)
    r2 = np.sqrt((x - 1 + mu) ** 2 + y ** 2 + z ** 2)
    U = 0.5 * (x ** 2 + y ** 2) + (1 - mu) / r1 + mu / r2
    return 2 * U - (vx ** 2 + vy ** 2 + vz ** 2)


def both(t_span, y0, method, **kw):
    ref = ivp_tpu.solve_ivp(jvdp, t_span, y0, method=method, **kw)
    got = it.solve_ivp(tvdp, t_span, y0, method=method, device="cpu", **kw)
    return ref, got


def assert_counters(ref, got):
    for f in COUNTERS + ("message", "success", "raw_status"):
        assert got[f] == ref[f], f
    assert got.t.shape == ref.t.shape and got.y.shape == np.shape(ref.y)


def assert_trajectory(ref, got, f=vdp_np, tol=1e-10):
    """Step outputs as points of one trajectory (module docstring)."""
    t, y, tr, yr = got.t, got.y, np.asarray(ref.t), np.asarray(ref.y)
    np.testing.assert_allclose(t, tr, rtol=1e-5, atol=1e-6)
    scale = np.maximum(1.0, np.abs(yr).max())
    shifted = yr + np.stack([f(y[:, i]) for i in range(y.shape[1])],
                            axis=1) * (t - tr)[None, :]
    assert np.abs(shifted - y).max() <= tol * scale


def assert_sol(ref, got, ts, tol=1e-10):
    a, b = got.sol(ts), np.asarray(ref.sol(ts))
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("method", ["RK45", "DOP853", "RK23", "RK4"])
def test_dense_output_matches_ivp_tpu(method):
    """Every method with dense output, forward and backward: outputs,
    counters, the strict and extrapolating ``sol``."""
    for span in ((0.0, 4.0), (4.0, 0.5)):
        ref, got = both(span, [2.0, 0.0], method, dense_output=True, **TOL)
        assert_counters(ref, got)
        assert_trajectory(ref, got)
        ts = np.linspace(*span, 17)
        assert_sol(ref, got, ts)
        assert_sol(ref, got, span[0] + 0.3 * (span[1] - span[0]))
        np.testing.assert_allclose(got.sol.t_span(), ref.sol.t_span(),
                                   rtol=1e-5)
        # Extrapolation, a little past the end: the last segment's
        # polynomial, whose edges carry the step sizes' shift.
        out = np.array([span[1] + 1e-3 * np.sign(span[1] - span[0])])
        assert_sol(ref, got, out, tol=1e-8)
        with pytest.raises(ValueError, match="outside"):
            got.sol.sol(out[0])
        with pytest.raises(ValueError, match="outside"):
            got.sol.sol_many(out)
        tt, yy = got.sol.sol_span(span[0], span[1], 9)
        np.testing.assert_allclose(yy, got.sol(tt), rtol=0, atol=0)
        assert got.sol.n_segments == ref.sol.n_segments


def test_t_eval_first_step_and_lean_match_ivp_tpu():
    """RK45 with t_eval (forward and backward, with and without dense
    output, one grid off the ends), with first_step (output enforcement),
    and without either (no coefficients recorded)."""
    for span, grid in (((0.0, 5.0), np.linspace(0.0, 5.0, 11)),
                       ((5.0, 0.0), np.linspace(5.0, 0.0, 7)),
                       ((0.0, 5.0), [0.3, 1.7, 4.99])):
        for dense in (False, True):
            ref, got = both(span, [2.0, 0.0], "RK45", t_eval=grid,
                            dense_output=dense, **TOL)
            assert_counters(ref, got)
            np.testing.assert_array_equal(got.t, ref.t)
            np.testing.assert_allclose(got.y, ref.y, rtol=1e-10, atol=1e-10)
            assert (got.sol is None) == (not dense)
    ref, got = both((0.0, 5.0), [2.0, 0.0], "RK45", first_step=0.01, **TOL)
    assert_counters(ref, got)
    assert got.t[1] == 0.01 and ref.t[1] == got.t[1]
    assert_trajectory(ref, got)
    ref, got = both((0.0, 5.0), [2.0, 0.0], "RK45", **TOL)
    assert_counters(ref, got)
    assert_trajectory(ref, got)
    assert got.sol is None and got.t_events is None
    np.testing.assert_allclose(got.y_reached, ref.y_reached, rtol=1e-9)


def test_chunk_steps_and_max_steps():
    """chunk_steps=5 (many drains) equals the default bit for bit; a step
    budget ends the solve with ivp_tpu's status and message."""
    a = it.solve_ivp(tvdp, (0.0, 4.0), [2.0, 0.0], "DOP853",
                     dense_output=True, device="cpu", **TOL)
    b = it.solve_ivp(tvdp, (0.0, 4.0), [2.0, 0.0], "DOP853",
                     dense_output=True, device="cpu", chunk_steps=5, **TOL)
    for f in ("t", "y", "y_reached") + COUNTERS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    ts = np.linspace(0.0, 4.0, 33)
    np.testing.assert_array_equal(a.sol(ts), b.sol(ts))
    ref, got = both((0.0, 4.0), [2.0, 0.0], "RK45", max_steps=12, **TOL)
    assert got.status == -1 and not got.success
    assert_counters(ref, got)
    assert got.message == "Maximum number of steps exceeded."


def test_zero_interval_and_empty_system_match_ivp_tpu():
    for method in ("RK45", "DOP853"):
        ref = ivp_tpu.solve_ivp(jvdp, (4.0, 4.0), [2.0, 3.0], method=method,
                                dense_output=True)
        got = it.solve_ivp(tvdp, (4.0, 4.0), [2.0, 3.0], method=method,
                           dense_output=True, device="cpu")
        assert_counters(ref, got)
        np.testing.assert_array_equal(got.t, ref.t)
        np.testing.assert_array_equal(got.y, ref.y)
        np.testing.assert_array_equal(got.sol([4, 5, 6]), [[2, 2, 2], [3, 3, 3]])
        got = it.solve_ivp(tvdp, (4.0, 4.0), [2.0, 3.0], method=method,
                           t_eval=[4.0], device="cpu")
        np.testing.assert_array_equal(got.y, [[2.0], [3.0]])

        def empty(t, y):
            return jnp.zeros((0,))

        ref = ivp_tpu.solve_ivp(empty, (0.0, 10.0), np.zeros(0),
                                method=method, dense_output=True)
        got = it.solve_ivp(lambda t, y: torch.zeros(0), (0.0, 10.0),
                           np.zeros(0), method=method, dense_output=True,
                           device="cpu")
        assert_counters(ref, got)
        np.testing.assert_array_equal(got.t, ref.t)
        assert got.sol(10).shape == (0,) and got.sol([1, 2, 3]).shape == (0, 3)


def test_cr3bp_arenstorf_gate_through_the_plain_version():
    state0 = np.array([0.994, 0, 0, 0, -2.00158510637908252240537862224, 0])
    period = 17.0652165601579625588917206249
    kw = dict(method="DOP853", args=(MU,), rtol=1e-12, atol=1e-14,
              dense_output=True)
    got = it.solve_ivp(it.rhs.cr3bp, (0, period), state0, device="cpu", **kw)
    assert got.success, got.message
    final = got.y[:, -1]
    assert abs(final[0] - state0[0]) < 1e-6
    assert abs(final[1] - state0[1]) < 1e-6
    ts = np.linspace(0, period, 200)
    traj = got.sol(ts)
    C0 = jacobi_constant(state0, MU)
    Cs = np.array([jacobi_constant(traj[:, i], MU) for i in range(200)])
    assert np.max(np.abs(Cs - C0)) < 1e-8

    ref = ivp_tpu.solve_ivp(jcr3bp, (0, period), state0, **kw)
    assert got.status == ref.status == 0
    for f in ("nstep", "naccpt", "nrejct"):
        assert abs(got[f] - ref[f]) <= max(2, 0.01 * ref[f]), f
    np.testing.assert_allclose(got.y[:, -1], np.asarray(ref.y)[:, -1],
                               rtol=0, atol=1e-8)
    # The same functor through a plain callable: the same solve.
    plain = it.solve_ivp(lambda t, s, mu: it.rhs.cr3bp(t[None], s[None],
                                                       mu)[0],
                         (0, 1.0), state0, device="cpu",
                         **dict(kw, dense_output=False))
    cuda_rhs = it.solve_ivp(it.rhs.cr3bp, (0, 1.0), state0, device="cpu",
                            **dict(kw, dense_output=False))
    np.testing.assert_array_equal(plain.y, cuda_rhs.y)
