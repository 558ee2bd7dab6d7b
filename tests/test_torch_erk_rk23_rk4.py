"""The port's RK23 and RK4 against ivp_tpu, on the CPU: one attempt, the
interpolants, the lean ensembles and ``solver_options``.

Same inputs (made with numpy from a seed) through ``ivp_tpu`` and through
``ivp_tpu_torch`` with ``device="cpu"``, float64.  Bounds: status, nfev,
nstep, naccpt and nrejct equal on every lane; final y and t within 1e-9
(measured: RK23 2.0e-11 on Lorenz to t=3 and 5.2e-13 on VdP to t=10; RK4
4.3e-14 and 9.4e-15).  RK23's controller is a float32 ``pow``, approximate in
XLA and in PyTorch alike, so a lane that stops mid-span agrees in t only to
the controller's float32 resolution (stated where it applies).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import test_torch_erk_cases as cases  # noqa: E402
from test_torch_erk_cases import B, assert_matches, jax_build, jax_vdp  # noqa: E402
import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch.core.common import safe_pow  # noqa: E402


@pytest.mark.parametrize("method", ["RK23", "RK4"])
def test_one_attempt_matches_ivp_tpu(method):
    ref, got = cases.one_attempt_both(method)
    # RK4 accepts every attempt; RK23 rejects the lanes with the large step
    # (and, at this tolerance, one with the small step).
    acc = got.accepted.numpy()
    assert acc.all() if method == "RK4" else (acc[0] and not acc[1::2].any())
    assert got.nfev_inc == (3 if method == "RK23" else 4)
    assert tuple(got.cont.shape) == (8, 4, 2)
    cases.assert_proposal_matches(ref, got)


@pytest.mark.parametrize("method", ["RK23", "RK4"])
def test_interp_matches_ivp_tpu(method):
    ref, got = cases.interp_both(method)
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14)


def test_safe_pow_matches_ivp_tpu():
    from ivp_tpu.core.common import safe_pow as jax_safe_pow

    x = np.array([0.0, 1e-30, 0.5, 1.0, 7.0, np.inf, -np.inf, np.nan],
                 np.float32)
    for p in (-1.0 / 3.0, 0.25):
        ref = np.asarray(jax_safe_pow(x, p))
        got = safe_pow(torch.as_tensor(x), p).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, equal_nan=True)
        assert got.dtype == np.float32


def _vdp_case(name):
    rng = np.random.default_rng(1)
    y0 = cases.vdp_y0()
    if name == "tf20":
        return dict(call=(y0, 0.0, 20.0, 1e-5, 1e-7)), dict(
            t0=0.0, tf=20.0, rtol=1e-5, atol=1e-7)
    if name == "per_lane":
        # Per-lane spans (one zero, every third backward and short), (B,)
        # rtol, (B, n) atol and per-lane mu at once.
        t0 = rng.uniform(-1.0, 1.0, B)
        span = rng.uniform(0.5, 3.0, B) * np.where(np.arange(B) % 3 == 1,
                                                   -0.3, 1)
        span[0] = 0.0
        rtol = np.logspace(-7, -4, B)
        atol = 10.0 ** rng.uniform(-9, -6, (B, 2))
        mu = rng.uniform(0.2, 5.0, B)
        return (dict(call=(y0, t0, t0 + span, rtol, atol), args=(mu,),
                     args_batched=True),
                dict(t0=t0, tf=t0 + span, rtol=rtol, atol=atol, mu=mu))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["tf20", "per_lane"])
@pytest.mark.parametrize("method", ["RK23", "RK4"])
def test_vdp_lanes_match_ivp_tpu(method, name):
    port, ref = _vdp_case(name)
    j = jax_vdp(method, port["call"][0], ref["t0"], ref["tf"],
                ref.get("rtol", 1e-6), ref.get("atol", 1e-8),
                ref.get("mu", 1.0))
    got = it.build_ensemble_solver(
        it.rhs.vdp, method, n=2, args=port.get("args", ()),
        args_batched=port.get("args_batched", False),
        **cases.build_options(method))(*port["call"], device="cpu")
    assert_matches(j, got)
    if name == "per_lane":
        assert int(got.nstep[0]) == 0 and int(got.status[0]) == 0
        # first_step (RK4) skips hinit's probe.
        assert int(got.nfev[0]) == (1 if method == "RK4" else 2)
    if method == "RK4":
        # Fixed steps: 4 evaluations each, none rejected, and the last one
        # may overshoot tf.
        np.testing.assert_array_equal(got.nfev.numpy(),
                                      1 + 4 * got.nstep.numpy())
        assert not got.nrejct.any()
        tf = torch.as_tensor(cases.full(port["call"][2], (B,)))
        t0 = torch.as_tensor(cases.full(port["call"][1], (B,)))
        assert bool(((got.t - tf) * torch.sign(tf - t0) > -1e-9).all())


@pytest.mark.parametrize("method", ["RK23", "RK4"])
def test_lorenz_and_decay_match_ivp_tpu(method):
    kw = cases.build_options(method)
    y0 = cases.lorenz_y0()
    j = jax.jit(jax_build(cases.jlorenz, method, n=3, **kw))(
        y0, 0.0, 3.0, 1e-6, 1e-8)
    got = it.build_ensemble_solver(it.rhs.lorenz, method, n=3, **kw)(
        y0, 0.0, 3.0, 1e-6, 1e-8, device="cpu")
    assert_matches(j, got)
    y0 = np.random.default_rng(2).uniform(0.5, 2.0, (B, 1))
    j = jax.jit(jax_build(cases.jdecay, method, n=1, **kw))(
        y0, 0.0, 5.0, 1e-6, 1e-8)
    got = it.build_ensemble_solver(it.rhs.decay, method, n=1, args=(0.7,),
                                   **kw)(y0, 0.0, 5.0, 1e-6, 1e-8,
                                         device="cpu")
    assert_matches(j, got)
    np.testing.assert_allclose(got.y.numpy()[:, 0],
                               y0[:, 0] * np.exp(-0.7 * 5.0), rtol=1e-4)


def test_rk4_without_first_step_takes_hinit():
    """No first_step: erk_init gives RK4 hinit's step with order 5, and the
    probe counts (nfev = 2 + 4 nstep)."""
    y0 = cases.vdp_y0(3)
    j = jax.jit(jax_build(cases.jvdp_mu, "RK4", n=2, args=(1.0,)))(
        y0, 0.0, 0.5, 1e-1, 1e-2)
    got = it.build_ensemble_solver(it.rhs.vdp, "RK4", n=2)(
        y0, 0.0, 0.5, 1e-1, 1e-2, device="cpu")
    assert_matches(j, got)
    np.testing.assert_array_equal(got.nfev.numpy(), 2 + 4 * got.nstep.numpy())
    assert len(set(got.nstep.tolist())) > 1     # hinit's step is per lane


def test_rk23_blow_up_gives_step_size_too_small():
    """y' = y^2, y(0) = 1 blows up at t = 1: every lane ends with
    STEP_SIZE_TOO_SMALL.  The end point is compared as t and 1/y (1/y + t
    is the solution's invariant), to 1e-6: each step size carries the
    float32 ``pow`` of the controller."""
    y0 = np.ones((4, 1))
    j = jax.jit(jax_build(lambda t, y: y ** 2, "RK23", n=1))(
        y0, 0.0, 2.0, 1e-6, 1e-8)
    got = it.build_ensemble_solver(lambda t, y: y * y, "RK23", n=1)(
        y0, 0.0, 2.0, 1e-6, 1e-8, device="cpu")
    assert set(got.status.tolist()) == {it.Status.STEP_SIZE_TOO_SMALL}
    for f in cases.COUNTERS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(j.t), rtol=1e-6)
    np.testing.assert_allclose(1.0 / got.y.numpy(), 1.0 / np.asarray(j.y),
                               rtol=1e-6, atol=1e-6)


RK23_OPTIONS = dict(uround=1e-6, safety=0.8, scale_min=0.5, scale_max=3.0,
                    iord=2)
FAR = dict(t0=1.0e4, tf=1.0e4 + 3.0, rtol=1e-6, atol=1e-8)


def _rk23_run(so, lanes, **kw):
    return it.build_ensemble_solver(it.rhs.vdp, "RK23", n=2,
                                    solver_options=so, **kw)(
        cases.vdp_y0(5)[:lanes], FAR["t0"], FAR["tf"], FAR["rtol"],
        FAR["atol"], device="cpu")


def test_rk23_solver_options_match_ivp_tpu():
    """Every option RK23 reads, at once (one JAX compile).  uround stops the
    lanes mid-span, so t and y are held to the float32 controller's 1e-6."""
    j = jax_vdp("RK23", cases.vdp_y0(5), FAR["t0"], FAR["tf"], FAR["rtol"],
                FAR["atol"], solver_options=RK23_OPTIONS)
    got = _rk23_run(RK23_OPTIONS, B)
    assert set(got.status.tolist()) == {it.Status.STEP_SIZE_TOO_SMALL}
    assert_matches(j, got, tol=1e-6)


@pytest.mark.parametrize("key", sorted(RK23_OPTIONS))
def test_each_rk23_option_moves_the_counters(key):
    # scale_min bounds how far a rejected step shrinks: start far too large.
    kw = dict(first_step=1.0) if key == "scale_min" else {}
    base = _rk23_run(None, 2, **kw)
    got = _rk23_run({key: RK23_OPTIONS[key]}, 2, **kw)
    assert any(not torch.equal(getattr(base, f), getattr(got, f))
               for f in cases.COUNTERS), key


@pytest.mark.parametrize("method", ["RK23", "RK4"])
def test_unknown_solver_option_raises_type_error(method):
    with pytest.raises(TypeError, match="newton_tol"):
        it.build_ensemble_solver(it.rhs.vdp, method, n=2,
                                 solver_options={"newton_tol": 1e-3})
