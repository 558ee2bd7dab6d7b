"""The port's DOP853 against ivp_tpu, on the CPU: one attempt, the
interpolant, the lean ensemble and ``solver_options``.

Same inputs (made with numpy from a seed) through ``ivp_tpu`` and through
``ivp_tpu_torch`` with ``device="cpu"``, float64.  Bounds: status, nfev,
nstep, naccpt and nrejct equal on every lane; final y and t within 1e-9
(measured: 7.5e-11 on Lorenz to t=3, 1.5e-11 on VdP to t=10; the rest is
FMA contraction and summation order).  The default controller (beta = 0) is
square roots and divisions only, correctly rounded in both packages: after
one attempt the next step size agrees to the last bit.  What remains is
XLA's ``fac * (1 / safety)`` for ``fac / safety``, a float32 ulp of a step
size now and then.  VdP to t=20 at rtol 1e-6 rejects 28% of DOP853's
attempts and shows that ulp as 3.9e-8 in y on one lane of 32 (7.5e-10 with
the port's division swapped for XLA's product, every counter equal either
way), so that case runs at rtol 1e-8, where it stays under 1e-9.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import test_torch_erk_cases as cases  # noqa: E402
from test_torch_erk_cases import B, assert_matches, jax_build, jax_vdp  # noqa: E402
import ivp_tpu_torch as it  # noqa: E402

METHOD = "DOP853"


def test_one_attempt_matches_ivp_tpu():
    ref, got = cases.one_attempt_both(METHOD)
    # Lanes with the small first step are accepted, the others rejected, and
    # nfev says so: 11 + 4 (f_new and the three dense stages) against 11.
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.arange(8) % 2 == 0)
    np.testing.assert_array_equal(got.nfev_inc.numpy(),
                                  np.where(np.arange(8) % 2 == 0, 15, 11))
    assert tuple(got.cont.shape) == (8, 8, 2)
    cases.assert_proposal_matches(ref, got)


def test_lean_attempt_counts_one_evaluation_on_accept():
    ref, got = cases.one_attempt_both(METHOD, need_cont=False)
    np.testing.assert_array_equal(got.nfev_inc.numpy(),
                                  np.where(np.arange(8) % 2 == 0, 12, 11))
    assert got.cont is None
    cases.assert_proposal_matches(ref, got)


def test_interp_matches_ivp_tpu():
    ref, got = cases.interp_both(METHOD)
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14)


def _vdp_case(name):
    rng = np.random.default_rng(1)
    y0 = cases.vdp_y0()
    if name == "tf20":
        return (dict(call=(y0, 0.0, 20.0, 1e-8, 1e-10)),
                dict(t0=0.0, tf=20.0, rtol=1e-8, atol=1e-10))
    if name == "per_lane":
        # Per-lane spans (one zero, every third backward and short: VdP
        # blows up backward in time), (B,) rtol, (B, n) atol and per-lane mu
        # at once.
        t0 = rng.uniform(-1.0, 1.0, B)
        span = rng.uniform(0.5, 3.0, B) * np.where(np.arange(B) % 3 == 1,
                                                   -0.3, 1)
        span[0] = 0.0
        rtol = np.logspace(-10, -5, B)
        atol = 10.0 ** rng.uniform(-11, -7, (B, 2))
        mu = rng.uniform(0.2, 5.0, B)
        return (dict(call=(y0, t0, t0 + span, rtol, atol), args=(mu,),
                     args_batched=True),
                dict(t0=t0, tf=t0 + span, rtol=rtol, atol=atol, mu=mu))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["tf20", "per_lane"])
def test_vdp_lanes_match_ivp_tpu(name):
    port, ref = _vdp_case(name)
    j = jax_vdp(METHOD, port["call"][0], ref["t0"], ref["tf"],
                ref.get("rtol", 1e-6), ref.get("atol", 1e-8),
                ref.get("mu", 1.0))
    got = it.build_ensemble_solver(
        it.rhs.vdp, METHOD, n=2, args=port.get("args", ()),
        args_batched=port.get("args_batched", False))(*port["call"],
                                                      device="cpu")
    assert_matches(j, got)
    if name == "per_lane":
        assert int(got.nstep[0]) == 0 and int(got.nfev[0]) == 2
        assert int(got.status[0]) == it.Status.SUCCESS


def test_stiff_vdp_gives_probably_stiff():
    """mu=1000 over [0, 3000]: the stiffness detector (on f_new - k12 and
    ynew - y12) ends every lane with PROBABLY_STIFF, as in ivp_tpu."""
    y0 = np.tile([2.0, 0.0], (B, 1))
    j = jax_vdp(METHOD, y0, 0.0, 3000.0, 1e-6, 1e-8, mu=1000.0)
    got = it.build_ensemble_solver(it.rhs.vdp, METHOD, n=2, args=(1000.0,))(
        y0[:4], 0.0, 3000.0, 1e-6, 1e-8, device="cpu")
    assert set(got.status.tolist()) == {it.Status.PROBABLY_STIFF}
    assert_matches(type(j)(*(None if x is None else np.asarray(x)[:4]
                             for x in j)), got)


def test_lorenz_and_decay_match_ivp_tpu():
    y0 = cases.lorenz_y0()
    j = jax.jit(jax_build(cases.jlorenz, METHOD, n=3))(y0, 0.0, 5.0, 1e-8,
                                                       1e-10)
    got = it.build_ensemble_solver(it.rhs.lorenz, METHOD, n=3)(
        y0, 0.0, 5.0, 1e-8, 1e-10, device="cpu")
    assert_matches(j, got)
    y0 = np.random.default_rng(2).uniform(0.5, 2.0, (B, 1))
    j = jax.jit(jax_build(cases.jdecay, METHOD, n=1))(y0, 0.0, 5.0, 1e-8,
                                                      1e-10)
    got = it.build_ensemble_solver(it.rhs.decay, METHOD, n=1, args=(0.7,))(
        y0, 0.0, 5.0, 1e-8, 1e-10, device="cpu")
    assert_matches(j, got)
    np.testing.assert_allclose(got.y.numpy()[:, 0],
                               y0[:, 0] * np.exp(-0.7 * 5.0), rtol=1e-7)


# Every numeric option at once against ivp_tpu (each set is one more JAX
# compile, so they share one); beta != 0 takes DOP853 off its square-root
# chain onto DOPRI5's log/exp controller.  Then each option alone must move
# the port's counters, on a problem where it can: none is read and dropped.
OPTIONS = dict(uround=1e-6, safety=0.8, scale_min=0.6, scale_max=4.0,
               beta=0.08, stiff_test=5, stiff_threshold=0.5, iord=2)
# VdP mu=3 at a tight tolerance far from t = 0, where uround's test
# 0.1 |h| <= |t| uround can stop a lane.
FAR = dict(t0=1.0e4, tf=1.0e4 + 6.0, rtol=1e-9, atol=1e-11, mu=3.0)
# Stiff VdP: the detector's period and threshold decide when a lane fails.
STIFF = dict(t0=0.0, tf=3000.0, rtol=1e-6, atol=1e-8, mu=1000.0)


def _port_run(problem, so, lanes, **kw):
    y0 = cases.vdp_y0(5)[:lanes]
    return it.build_ensemble_solver(
        it.rhs.vdp, METHOD, n=2, args=(problem["mu"],), solver_options=so,
        **kw)(y0, problem["t0"], problem["tf"], problem["rtol"],
              problem["atol"], device="cpu")


def test_solver_options_match_ivp_tpu():
    j = jax_vdp(METHOD, cases.vdp_y0(5), FAR["t0"], FAR["tf"], FAR["rtol"],
                FAR["atol"], mu=FAR["mu"], solver_options=OPTIONS)
    got = _port_run(FAR, OPTIONS, B)
    assert set(got.status.tolist()) <= {it.Status.STEP_SIZE_TOO_SMALL,
                                        it.Status.PROBABLY_STIFF}
    # The lanes end mid-span: their t carries the float32 log/exp
    # controller's last bits (see test_torch_dopri5.py), so t and y are held
    # to 1e-6 there and the counters exactly.
    assert_matches(j, got, tol=1e-6)


@pytest.mark.parametrize("key, problem, kw", [
    ("uround", FAR, {}), ("safety", FAR, {}), ("scale_min", FAR, {}),
    ("scale_max", FAR, {}), ("beta", FAR, {}), ("iord", FAR, {}),
    # Tested every 5th accepted step, a stiff lane fails after ~20 steps
    # and not after ~1015.
    ("stiff_test", STIFF, dict(max_steps=100)),
    # With the threshold out of reach the lane runs into its step budget.
    ("stiff_threshold", STIFF, dict(max_steps=1050)),
])
def test_each_solver_option_moves_the_counters(key, problem, kw):
    value = 1.0e3 if key == "stiff_threshold" else OPTIONS[key]
    base = _port_run(problem, None, 2, **kw)
    got = _port_run(problem, {key: value}, 2, **kw)
    assert any(not torch.equal(getattr(base, f), getattr(got, f))
               for f in cases.COUNTERS), key


def test_controller_precision_state_matches_ivp_tpu():
    so = dict(controller_precision="state")
    y0 = cases.vdp_y0(6)
    j = jax_vdp(METHOD, y0, 0.0, 5.0, 1e-7, 1e-9, solver_options=so)
    got = it.build_ensemble_solver(it.rhs.vdp, METHOD, n=2,
                                   solver_options=so)(
        y0, 0.0, 5.0, 1e-7, 1e-9, device="cpu")
    assert_matches(j, got)
    f32 = it.build_ensemble_solver(it.rhs.vdp, METHOD, n=2)(
        y0, 0.0, 5.0, 1e-7, 1e-9, device="cpu")
    torch.testing.assert_close(got.y, f32.y, rtol=1e-5, atol=1e-5)


def test_unknown_solver_option_raises_type_error():
    with pytest.raises(TypeError, match="newton_tol"):
        it.build_ensemble_solver(it.rhs.vdp, METHOD, n=2,
                                 solver_options={"newton_tol": 1e-3})
