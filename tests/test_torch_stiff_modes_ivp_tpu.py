"""The stiff kernels' SAMPLED and RECORD modes against ``ivp_tpu`` on the CPU:
the g++ builds of ``csrc/radau.cu`` and ``csrc/bdf.cu`` of
tests/test_torch_stiff_modes.py, launched on CPU tensors with stream 0, at
B=8 under ``controller_precision="state"``, VdP mu=1000 over [0, 1000].

* SAMPLED against ``ivp_tpu.batch.build_ensemble_solver(..., t_eval=...)``
  on a 51-point grid from t0 to tf: status, nfev, nstep, naccpt, nrejct and
  ``n_samples`` equal on every lane, the samples and the final y within
  tests/test_torch_stiff_cases.py's ``Y_TOL`` (1e-7) of max(1, |y|).
* RECORD with coefficients (``rec_cap=16``, several chunks) against
  ``ivp_tpu.solve_ivp(..., dense_output=True)`` lane by lane: every counter
  equal, the recorded times (with t0, a repeated time once, as solve_ivp
  gives them) within ``Y_TOL`` of the lane's time scale max(1, |t|) (BDF's
  1.6e-9 relative: the host libm's last bits in the step sizes) and the
  states within ``Y_TOL`` of ivp_tpu's ``t`` and ``y``, and the dense solution built from
  the rows (``BatchOdeSolution``) within ``Y_TOL`` of ivp_tpu's ``sol``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_stiff_cases as C  # noqa: E402  (imports ivp_tpu, jax)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from ivp_tpu import solve_ivp as jax_solve_ivp  # noqa: E402
from ivp_tpu.batch import build_ensemble_solver as jax_build  # noqa: E402

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch.methods.interp import get_interp  # noqa: E402
import test_torch_stiff_modes as SM  # noqa: E402

LANES, TF, M = 8, C.SHORT_TF, 51
SO = {"controller_precision": "state"}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel sources as host code")
    return SM.build_libs(tmp_path_factory.mktemp("gxx_stiff_ivp_tpu"))


def vdp_inputs():
    return SM.inputs(it.rhs.vdp, C.stiff_y0(LANES), TF, C.RTOL, C.ATOL,
                     (C.MU,))


@pytest.mark.parametrize("method", SM.METHODS)
def test_sampled_matches_ivp_tpu(libs, method):
    te = np.linspace(0.0, TF, M)
    ref = jax.tree.map(np.asarray, jax_build(
        C.jvdp, method, n=2, args=(C.MU,), t_eval=te, solver_options=SO)(
        jnp.asarray(C.stiff_y0(LANES)), 0.0, TF, C.RTOL, C.ATOL))
    grid = torch.broadcast_to(SM.T(te), (LANES, M))
    got = SM.kernel_sampled(libs[method], method, vdp_inputs(), grid,
                            SM.spec_of(method, "state"))
    for f in C.COUNTERS[:5] + ("n_samples",):
        np.testing.assert_array_equal(got[f].numpy(), getattr(ref, f),
                                      err_msg=f)
    np.testing.assert_allclose(got["y_samples"].numpy(), ref.y_samples,
                               rtol=C.Y_TOL, atol=C.Y_TOL)
    np.testing.assert_allclose(got["y"].numpy(), ref.y, rtol=C.Y_TOL,
                               atol=C.Y_TOL)


@pytest.mark.parametrize("method", SM.METHODS)
def test_record_matches_ivp_tpu_solve_ivp(libs, method):
    a = vdp_inputs()
    got, chunks = SM.kernel_record(libs[method], method, a,
                                   SM.spec_of(method, "state"), 16, True)
    assert chunks > 1
    interp, _ = get_interp(method)
    sol = it.batch.BatchOdeSolution(
        method, interp, got["rec_xold"], got["rec_h"], got["rec_cont"],
        got["rec_t"], got["n_rec"], a[2], a[1])
    q = np.linspace(0.0, TF, 7)
    dense = sol(q).numpy()
    y0 = C.stiff_y0(LANES)
    for i in range(LANES):
        ref = jax_solve_ivp(lambda t, y: C.jvdp(t, y, C.MU), [0.0, TF],
                            y0[i], method=method, rtol=C.RTOL, atol=C.ATOL,
                            dense_output=True, solver_options=SO)
        for f in C.COUNTERS:
            assert int(got[f][i]) == int(ref[f]), (i, f, got[f][i], ref[f])
        # solve_ivp's points: t0 and the rows, a repeated time once.
        k = int(got["n_rec"][i])
        ts, ys = it.solve._dedup(
            [0.0] + list(got["rec_t"][i, :k].numpy()),
            [y0[i]] + list(got["rec_y"][i, :k].numpy()))
        assert len(ts) == len(ref.t)
        rt = np.asarray(ref.t)
        np.testing.assert_allclose(
            ts, rt, rtol=0, atol=C.Y_TOL * max(1.0, np.abs(rt).max()))
        np.testing.assert_allclose(np.stack(ys, axis=1), np.asarray(ref.y),
                                   rtol=C.Y_TOL, atol=C.Y_TOL)
        np.testing.assert_allclose(dense[i], np.asarray(ref.sol(q)),
                                   rtol=C.Y_TOL, atol=C.Y_TOL)
