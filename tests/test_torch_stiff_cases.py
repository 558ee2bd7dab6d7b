"""Shared by tests/test_torch_radau.py, test_torch_bdf.py and
test_torch_resume.py: the stiff tier's inputs through ``ivp_tpu`` on the CPU
and through the port.  Helpers only, and the stiff golden file's writer:
pytest collects no test from it.

``ivp_tpu``'s ensemble result has no njev or nlu; its resumable solver's
carry has them, so the reference solves here run through its
``build_resumable_solver`` (jitted once per method, controller and
Jacobian), as bench.py's stiff rows do, and every counter is compared.

Tolerances: with ``controller_precision="state"`` every counter equals the
reference's on every lane; with the float32 controller a stated share of
lanes agrees (torch's float32 pow, log and exp on the CPU are not XLA's).
y agrees within 1e-7 of max(1, |y|) on lanes whose counters agree: the
step sizes themselves round apart in their last bits (torch's pow, log and
exp on the CPU, float64 ones included, are Sleef's, XLA's are its own), and
over a VdP relaxation jump BDF's D array carries that to 1e-8 (measured
7.8e-9 at worst, float32 controller, B=8 over [0, 1000]).

Rewrite the golden file with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_stiff_cases.py``.
"""
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402,F401  (enables x64)
from ivp_tpu.batch import build_resumable_solver as jax_resumable  # noqa: E402

COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct", "njev", "nlu")
GOLDEN = (Path(__file__).resolve().parent.parent / "ivp_tpu_torch" / "data"
          / "stiff_vdp_golden.npz")
# bench.py's stiff configuration.
MU, TF, RTOL, ATOL = 1000.0, 3000.0, 1e-4, 1e-6
GOLDEN_B = 64
Y_TOL = 1e-7


def jvdp(t, y, mu):
    return jnp.array([y[1], mu * (1.0 - y[0] ** 2) * y[1] - y[0]])


def jrobertson(t, s):
    x, y, z = s
    return jnp.array([-0.04 * x + 1e4 * y * z,
                      0.04 * x - 1e4 * y * z - 3e7 * y * y, 3e7 * y * y])


JFUNS = {"vdp": jvdp, "robertson": jrobertson}


def stiff_y0(lanes):
    """bench.py's stiff y0: [2, 0] + 0.02 N(0, 1) from seed 0 (the first
    ``lanes`` lanes of any B)."""
    rng = np.random.default_rng(0)
    return np.array([2.0, 0.0]) + 0.02 * rng.standard_normal((lanes, 2))


def robertson_y0(lanes):
    rng = np.random.default_rng(4)
    y0 = np.zeros((lanes, 3))
    y0[:, 0] = 1e4 * (1.0 + 1e-3 * rng.standard_normal(lanes))
    return y0


@functools.lru_cache(maxsize=None)
def _jax_solver(method, fun, controller, chunk, args):
    so = None if controller is None else {"controller_precision": controller}
    return jax_resumable(JFUNS[fun], method, n=3 if fun == "robertson" else 2,
                         args=args, chunk_steps=chunk, solver_options=so)


def jax_stiff(method, fun, y0, t0, tf, rtol, atol, controller=None,
              chunk=4096, args=None):
    """``ivp_tpu``'s resumable solve to the end: a dict of numpy arrays (t,
    y and the seven counters of the final carry)."""
    if args is None:
        args = (MU,) if fun == "vdp" else ()
    start, resume, _ = _jax_solver(method, fun, controller, chunk, args)
    carry, ra = start(y0, t0, tf, rtol, atol)
    while not bool(np.all(np.asarray(carry.done))):
        carry = resume(carry, ra)
    c = jax.tree.map(np.asarray, carry)
    return {f: getattr(c, f) for f in ("t", "y") + COUNTERS}


def port_dict(res):
    """A port EnsembleResult as jax_stiff's dict."""
    return {f: getattr(res, f).detach().cpu().numpy()
            for f in ("t", "y") + COUNTERS}


def assert_stiff_matches(got, ref, share=1.0, y_tol=Y_TOL):
    """Status and every counter equal on at least ``share`` of the lanes
    (on all of them when ``share`` is 1), y within ``y_tol`` of max(1, |y|)
    on those lanes; returns the share."""
    same = np.ones(len(ref["status"]), bool)
    for f in COUNTERS:
        same &= np.asarray(got[f]) == np.asarray(ref[f])
    frac = float(np.mean(same))
    assert frac >= share, (frac, {f: (got[f], ref[f]) for f in COUNTERS})
    dy = (np.abs(np.asarray(got["y"]) - ref["y"]).max(axis=1)
          / np.maximum(1.0, np.abs(ref["y"]).max(axis=1)))
    assert np.all(dy[same] <= y_tol), dy[same].max()
    np.testing.assert_allclose(np.asarray(got["t"])[same], ref["t"][same],
                               rtol=1e-9)
    return frac


# ---------------------------------------------------------------------------
# The test bodies of tests/test_torch_radau.py and test_torch_bdf.py, each
# taking the method ("RADAU" or "BDF").
# ---------------------------------------------------------------------------

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu import solve_ivp as jax_solve_ivp  # noqa: E402
from ivp_tpu.batch import build_ensemble_solver as jax_build  # noqa: E402

SHORT_TF = 1000.0   # a span with VdP's first relaxation jump
LANES = 8
# The least share of lanes whose counters all equal ivp_tpu's under the
# float32 controller (torch's float32 pow, log and exp on the CPU round apart
# from XLA's on some inputs; 8 of 8 lanes agreed when this was written).
F32_SHARE = 0.75
NJEV_BUDGET = {"RADAU": 200, "BDF": 600}


def tvdp(t, y, mu=MU):
    """VdP as a plain batched torch function (no Jacobian of its own: the
    port differentiates it with torch.func)."""
    return torch.stack([y[:, 1], mu * (1.0 - y[:, 0] * y[:, 0]) * y[:, 1]
                        - y[:, 0]], dim=-1)


def port_ensemble(method, fun, y0, tf, controller=None, **kw):
    so = None if controller is None else {"controller_precision": controller}
    args = kw.pop("args", (MU,))
    return it.build_ensemble_solver(fun, method, n=y0.shape[1], args=args,
                                    solver_options=so, **kw)(
        y0, 0.0, tf, RTOL, ATOL, device="cpu")


def check_vdp(method, controller):
    """VdP mu=1000 at B=8 over [0, 1000] with the CudaRHS's Jacobian."""
    y0 = stiff_y0(LANES)
    ref = jax_stiff(method, "vdp", y0, 0.0, SHORT_TF, RTOL, ATOL, controller)
    got = port_dict(port_ensemble(method, it.rhs.vdp, y0, SHORT_TF,
                                  controller))
    share = 1.0 if controller == "state" else F32_SHARE
    return assert_stiff_matches(got, ref, share)


def check_jacfwd(method):
    """``jac=None`` on a plain torch RHS: torch.func's forward-mode
    Jacobian against ivp_tpu's jax.jacfwd."""
    y0 = stiff_y0(LANES)
    ref = jax_stiff(method, "vdp", y0, 0.0, SHORT_TF, RTOL, ATOL, "state")
    got = port_dict(port_ensemble(method, tvdp, y0, SHORT_TF, "state"))
    assert_stiff_matches(got, ref)


def check_callable_jac(method):
    """A callable ``jac`` (batched in the port, per lane in ivp_tpu)."""
    def jjac(t, y, mu):
        return jnp.array([[0.0, 1.0],
                          [mu * (-(y[0] + y[0])) * y[1] - 1.0,
                           mu * (1.0 - y[0] * y[0])]])

    def tjac(t, y, mu):
        return it.rhs.vdp.jacobian(t, y, mu)

    y0 = stiff_y0(LANES)
    js = jax_resumable(jvdp, method, n=2, args=(MU,), jac=jjac,
                       chunk_steps=4096,
                       solver_options={"controller_precision": "state"})
    carry, ra = js[0](y0, 0.0, SHORT_TF, RTOL, ATOL)
    while not bool(np.all(np.asarray(carry.done))):
        carry = js[1](carry, ra)
    c = jax.tree.map(np.asarray, carry)
    ref = {f: getattr(c, f) for f in ("t", "y") + COUNTERS}
    got = port_dict(port_ensemble(method, tvdp, y0, SHORT_TF, "state",
                                  jac=tjac))
    assert_stiff_matches(got, ref)


def check_robertson(method):
    """Robertson over [0, 1e8] with its budgets (tests/test_stiff.py):
    every counter equal to ivp_tpu's ("state"), nfev < 5000, njev within
    the budget and x + y + z conserved to 1e-5."""
    y0 = robertson_y0(2)
    ref = jax_stiff(method, "robertson", y0, 0.0, 1e8, 1e-6, 1e-6, "state")
    res = it.build_ensemble_solver(
        it.rhs.robertson, method, n=3,
        solver_options={"controller_precision": "state"})(
        y0, 0.0, 1e8, 1e-6, 1e-6, device="cpu")
    got = port_dict(res)
    assert_stiff_matches(got, ref, y_tol=1e-7)
    assert np.all(got["status"] == 0)
    assert got["nfev"].max() < 5000 and got["njev"].max() < NJEV_BUDGET[method]
    np.testing.assert_allclose(got["y"].sum(axis=1), y0.sum(axis=1),
                               rtol=1e-5)


def fun_linear(t, y):
    return torch.stack([-y[0] - 5 * y[1], y[0] + y[1]])


def jfun_linear(t, y):
    return jnp.array([-y[0] - 5 * y[1], y[0] + y[1]])


JAC_LINEAR = np.array([[-1.0, -5.0], [1.0, 1.0]])


def check_constant_jac(method):
    """The constant-Jacobian linear system (tests/test_stiff.py:39-51):
    njev 0, the error against the exact solution, and every counter equal
    to ivp_tpu's solve_ivp."""
    kw = dict(rtol=1e-3, atol=1e-6, method=method, dense_output=True,
              jac=JAC_LINEAR)
    res = it.solve_ivp(fun_linear, [0, 2], [0.0, 2.0], device="cpu", **kw)
    ref = jax_solve_ivp(jfun_linear, [0, 2], [0.0, 2.0], **kw)
    assert res.success and res.status == 0 and res.t[0] == 0
    assert res.nfev < 100 and res.njev == 0
    for f in ("nfev", "njev", "nlu", "nstep", "naccpt", "nrejct", "status"):
        assert res[f] == ref[f], f
    y_true = np.vstack((-5 * np.sin(2 * res.t),
                        2 * np.cos(2 * res.t) + np.sin(2 * res.t)))
    e = (res.y - y_true) / (1e-6 + 1e-3 * np.abs(y_true))
    assert np.all(np.linalg.norm(e, axis=0) / np.sqrt(2) < 10)
    # With the float32 controller the step sizes round apart in their last
    # float32 bits (torch's and XLA's float32 pow), so the states, at rtol
    # 1e-3, agree to 1e-6 (measured 2.5e-7 for Radau, 0 for BDF).
    np.testing.assert_allclose(res.y, np.asarray(ref.y), rtol=1e-6,
                               atol=1e-9)


# The singular retry: y' = y with J = I and a first step at which the first
# decomposition is exactly singular (Radau: U1/h = 1 makes E1 = 0; BDF:
# h/alpha[1] = 1 makes I - cJ = 0); then a Jacobian of NaNs, singular at
# every attempt.
FIRST_SINGULAR = {"RADAU": float(ivp_tpu.tableaus.RADAU_U1),
                  "BDF": float(ivp_tpu.tableaus.BDF_ALPHA[1])}


def check_singular(method):
    """A singular decomposition retries at half the step without counting a
    step (Radau) or fails its Newton (BDF), as ivp_tpu's; a Jacobian
    singular at every attempt ends the lane as ivp_tpu's does (Radau:
    SINGULAR_MATRIX after more than 5 in a row)."""
    grow = lambda t, y: y                                   # noqa: E731
    for jac, fs, tf in ((np.eye(2), FIRST_SINGULAR[method], 30.0),
                        (np.full((2, 2), np.nan), 0.01, 1.0)):
        kw = dict(method=method, rtol=1e-6, atol=1e-9, jac=jac,
                  first_step=fs)
        res = it.solve_ivp(grow, [0.0, tf], [1.0, 0.5], device="cpu", **kw)
        ref = jax_solve_ivp(lambda t, y: y, [0.0, tf], [1.0, 0.5], **kw)
        for f in ("nfev", "njev", "nlu", "nstep", "naccpt", "nrejct",
                  "status", "raw_status"):
            assert res[f] == ref[f], (f, res[f], ref[f])
        if np.isfinite(jac).all():
            assert res.success
            if method == "RADAU":   # a retry is no step: more decompositions
                assert res.nlu > 2 * res.nstep
            np.testing.assert_allclose(res.y[:, -1], np.asarray(ref.y)[:, -1],
                                       rtol=1e-9)
        else:
            assert res.raw_status == (5 if method == "RADAU" else 3)


def check_t_eval(method):
    """In-loop samples on a t_eval grid (the plain driver's sample mode)."""
    y0 = stiff_y0(4)
    te = np.linspace(0.0, 500.0, 6)
    so = {"controller_precision": "state"}
    ref = jax.tree.map(np.asarray, jax_build(
        jvdp, method, n=2, args=(MU,), t_eval=te, solver_options=so)(
        jnp.asarray(y0), 0.0, 500.0, RTOL, ATOL))
    got = it.build_ensemble_solver(it.rhs.vdp, method, n=2, args=(MU,),
                                   t_eval=te, solver_options=so)(
        y0, 0.0, 500.0, RTOL, ATOL, device="cpu")
    for f in COUNTERS[:5]:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(ref, f), err_msg=f)
    np.testing.assert_array_equal(got.n_samples.numpy(), ref.n_samples)
    np.testing.assert_allclose(got.y_samples.numpy(), ref.y_samples,
                               rtol=1e-9, atol=1e-9)


def check_event(method):
    """A terminal event (y0 crossing 1.5 downwards) through the plain
    driver's events."""
    def ev(t, y, mu):
        return y[:, 0] - 1.5

    def jev(t, y, mu):
        return y[0] - 1.5

    for e in (ev, jev):
        e.terminal, e.direction = True, -1
    y0 = stiff_y0(4)
    so = {"controller_precision": "state"}
    ref = jax.tree.map(np.asarray, jax_build(
        jvdp, method, n=2, args=(MU,), events=[jev], solver_options=so)(
        jnp.asarray(y0), 0.0, 2000.0, RTOL, ATOL))
    got = it.build_ensemble_solver(it.rhs.vdp, method, n=2, args=(MU,),
                                   events=[ev], solver_options=so)(
        y0, 0.0, 2000.0, RTOL, ATOL, device="cpu")
    for f in COUNTERS[:5]:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(ref, f), err_msg=f)
    assert set(got.status.tolist()) == {1}
    np.testing.assert_array_equal(got.n_events.numpy(), ref.n_events)
    np.testing.assert_allclose(got.t_events.numpy(), ref.t_events, rtol=1e-9)


def check_solve_ivp(method):
    """solve_ivp of one VdP lane with dense output, against ivp_tpu's."""
    y0 = stiff_y0(1)[0]
    so = {"controller_precision": "state"}
    kw = dict(method=method, rtol=RTOL, atol=ATOL, dense_output=True,
              solver_options=so)
    res = it.solve_ivp(it.rhs.vdp, [0.0, SHORT_TF], y0, args=(MU,),
                       device="cpu", **kw)
    ref = jax_solve_ivp(lambda t, y: jvdp(t, y, MU), [0.0, SHORT_TF], y0,
                        **kw)
    for f in ("nfev", "njev", "nlu", "nstep", "naccpt", "nrejct", "status"):
        assert res[f] == ref[f], (f, res[f], ref[f])
    np.testing.assert_allclose(res.t, np.asarray(ref.t), rtol=1e-9)
    np.testing.assert_allclose(res.y, np.asarray(ref.y), rtol=Y_TOL,
                               atol=Y_TOL)
    q = np.linspace(0.0, SHORT_TF, 7)
    np.testing.assert_allclose(res.sol(q), np.asarray(ref.sol(q)), rtol=Y_TOL,
                               atol=Y_TOL)


def check_recording(method):
    """dense_output through the recording ensemble: the records' last row is
    the final state and the dense solution passes through every recorded
    step."""
    y0 = stiff_y0(3)
    res = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 200.0), y0, method,
                                args=(MU,), rtol=RTOL, atol=ATOL,
                                dense_output=True, rec_chunk=16,
                                device="cpu")
    plain = port_ensemble(method, it.rhs.vdp, y0, 200.0)
    for f in COUNTERS:
        assert torch.equal(getattr(res, f), getattr(plain, f)), f
    assert torch.equal(res.y, plain.y)
    k = res.n_steps_rec.to(torch.int64)
    last = res.ys[torch.arange(3), k - 1]
    assert torch.equal(last, res.y)
    torch.testing.assert_close(res.sol(res.ts[0, :5])[0].T, res.ys[0, :5],
                               rtol=1e-12, atol=1e-12)


def write_golden(path=GOLDEN):
    """ivp_tpu's numbers for the stiff main path's first 64 lanes, Radau
    and BDF with the default (float32) controller, over [0, 3000]."""
    y0 = stiff_y0(GOLDEN_B)
    out = {"y0": y0}
    for method in ("Radau", "BDF"):
        r = jax_stiff(method.upper(), "vdp", y0, 0.0, TF, RTOL, ATOL)
        out.update({f"{method.lower()}_{k}": v for k, v in r.items()})
    np.savez_compressed(path, **out)
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    g = write_golden()
    print({k: np.asarray(v).shape for k, v in g.items()})
