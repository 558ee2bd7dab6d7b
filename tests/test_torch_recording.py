"""The recording ensemble (``solve_ivp_ensemble(record_trajectories=...,
dense_output=...)``) and ``BatchOdeSolution`` in the port, against
``ivp_tpu.batch.solve_ivp_ensemble`` on the CPU.

Bounds, as tests/test_torch_record.py states them for the rows:

* status, every counter and ``n_steps_rec`` equal on every lane, and the
  record shapes (``S`` = the most steps a lane recorded) equal;
* ``ts`` within 1e-5 relative (1e-6 absolute) and ``ys`` within 1e-10 scaled by max(1,
  |y|) after moving ivp_tpu's row along f by the two rows' time difference
  (the float32 controller rounds the step sizes apart in their last
  float32 bits); rows past a lane's count zero in both;
* ``sol`` at fixed times (a scalar, a shared grid, per-lane grids) and
  ``y_samples`` within 1e-10 scaled; a little past the span's end
  (extrapolation from the last segment, whose edges carry the shift)
  within 1e-8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402,F401  (enables x64)
from ivp_tpu.batch import solve_ivp_ensemble as jax_ensemble  # noqa: E402
import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import convert  # noqa: E402

B = 5
TOL = dict(rtol=1e-8, atol=1e-10)
COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct", "n_steps_rec")


def jvdp(t, y):
    return jnp.array([y[1], (1.0 - y[0] ** 2) * y[1] - y[0]])


def vdp_np(y):
    return np.stack([y[..., 1], (1.0 - y[..., 0] ** 2) * y[..., 1] - y[..., 0]],
                    axis=-1)


def y0s():
    rng = np.random.default_rng(3)
    return np.array([2.0, 0.0]) + 0.05 * rng.standard_normal((B, 2))


def both(method, span, **kw):
    ref = jax_ensemble(jvdp, span, y0s(), method, **TOL, **kw)
    got = it.solve_ivp_ensemble(it.rhs.vdp, span, y0s(), method, **TOL,
                                device="cpu", **kw)
    return ref, got


def assert_records_match(ref, got):
    g = convert.result_to_numpy(got)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(g, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    ts, ys = np.asarray(ref.ts), np.asarray(ref.ys)
    assert g.ts.shape == ts.shape and g.ys.shape == ys.shape
    np.testing.assert_allclose(g.ts, ts, rtol=1e-5, atol=1e-6)
    scale = np.maximum(1.0, np.abs(ys).max())
    shifted = ys + vdp_np(g.ys) * (g.ts - ts)[..., None]
    assert np.abs(shifted - g.ys).max() <= 1e-10 * scale
    past = np.arange(ts.shape[1])[None, :] >= g.n_steps_rec[:, None]
    assert not g.ts[past].any() and not g.ys[past].any()
    np.testing.assert_allclose(g.y, np.asarray(ref.y), rtol=1e-9, atol=1e-9)


def assert_close(a, b, tol=1e-10):
    a = a.numpy() if torch.is_tensor(a) else a
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("method, span", [
    ("DOP853", (0.0, 4.0)), ("RK45", (1.5, 0.0)), ("RK23", (0.0, 3.0)),
    ("RK4", (1.5, 0.5))], ids=["DOP853", "RK45-backward", "RK23",
                               "RK4-backward"])
def test_dense_output_matches_ivp_tpu(method, span):
    kw = dict(first_step=0.01) if method == "RK4" else {}
    ref, got = both(method, span, dense_output=True, **kw)
    assert_records_match(ref, got)
    assert got.ts.device.type == "cpu" and got.y_samples is None
    sol, rsol = got.sol, ref.sol
    assert isinstance(sol, it.BatchOdeSolution)
    for q in (span[0] + 0.37 * (span[1] - span[0]),            # scalar
              np.linspace(*span, 9),                            # shared
              span[0] + np.outer(np.linspace(0.1, 0.9, B),      # per lane
                                 np.linspace(0.0, 1.0, 4)) * (span[1] - span[0])):
        out = sol(q)
        assert out.device.type == "cpu"
        assert_close(out, rsol(q))
    end = span[1] + 1e-3 * np.sign(span[1] - span[0])
    assert_close(sol(end), rsol(end), tol=1e-8)
    for a, b in zip(sol.t_span(), rsol.t_span()):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5)
    with pytest.raises(ValueError, match="leading dim"):
        sol(np.zeros((B + 1, 3)))


def test_record_trajectories_with_samples_match_ivp_tpu():
    """record_trajectories with a t_eval grid: the records and the in-loop
    samples, and no coefficients or ``sol``."""
    grid = np.linspace(0.0, 3.0, 7)
    ref, got = both("RK45", (0.0, 3.0), record_trajectories=True, t_eval=grid)
    assert_records_match(ref, got)
    assert got.sol is None and ref.sol is None
    np.testing.assert_array_equal(got.n_samples.numpy(),
                                  np.asarray(ref.n_samples))
    assert_close(got.y_samples, ref.y_samples)


def test_rec_chunk_changes_nothing():
    """rec_chunk=3 (many drains) equals one chunk bit for bit, and each
    configuration's solver is built once (the LRU solver cache)."""
    y0 = y0s()
    it.batch._ENSEMBLE_CACHE.clear()
    kw = dict(dense_output=True, device="cpu", **TOL)
    a = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 2.0), y0, "DOP853", **kw)
    b = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 2.0), y0, "DOP853",
                              rec_chunk=3, **kw)
    it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 2.0), y0, "DOP853", **kw)
    assert len(it.batch._ENSEMBLE_CACHE) == 2
    for f in it.EnsembleResult._fields[:-1]:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f
    q = np.linspace(0.0, 2.0, 11)
    assert torch.equal(a.sol(q), b.sol(q))


def test_query_blocks_change_nothing(monkeypatch):
    """``sol`` answered in blocks of two query times equals one block, on a
    shared and on per-lane grids."""
    y0 = y0s()
    res = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 2.0), y0, "DOP853",
                                dense_output=True, device="cpu", **TOL)
    shared = np.linspace(-0.1, 2.1, 11)
    lanes = np.outer(np.linspace(0.1, 0.9, B), np.linspace(0.0, 2.0, 7))
    whole = [res.sol(q) for q in (shared, lanes)]
    C, n = res.sol._conts.shape[2:]
    monkeypatch.setattr(it.batch, "_QUERY_BLOCK_BYTES", 2 * B * C * n * 8)
    for q, w in zip((shared, lanes), whole):
        assert torch.equal(res.sol(q), w)
