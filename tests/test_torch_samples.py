"""In-loop ``t_eval`` samples and DOPRI5's dense output in the port, against
ivp_tpu on the CPU.

Per method one jitted ivp_tpu solver takes a per-lane ``(B, M)`` grid at the
call; the port gets the grid in the shape the case is about: shared ``(M,)``
at build time, per-lane ``(B, M)`` at build time, or ``t_grid`` at the
call.  Bounds: status, the four counters and ``n_samples`` equal on every
lane; final y and ``y_samples`` within 1e-9 (measured: 1.5e-10 on Lorenz
DOP853 samples to t=3, 9.2e-11 DOPRI5, 2.0e-11 RK23, 4.6e-14 RK4); sample
rows past a lane's ``n_samples`` are zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import test_torch_erk_cases as cases  # noqa: E402
from test_torch_erk_cases import B, M, assert_matches, jax_build, jax_vdp  # noqa: E402
import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import convert  # noqa: E402
from ivp_tpu_torch.core.driver import DriverConfig, make_driver, run_args  # noqa: E402
from ivp_tpu_torch.methods import get_engine  # noqa: E402

METHODS = ["RK45", "DOP853", "RK23", "RK4"]
TOL = (1e-6, 1e-8)
# One step budget per method for every VdP case here (it is part of ivp_tpu's
# compile key): enough for spans up to 4, far too few for a span of 60.
MAX_STEPS = {"RK45": 150, "DOP853": 60, "RK23": 900, "RK4": 1000}


def _port(method, grid, y0, t0, tf, at_call=False, **kw):
    kw = cases.build_options(method, **kw)
    if at_call:     # the length is fixed at build time, the call brings the grid
        solver = it.build_ensemble_solver(it.rhs.vdp, method, n=2,
                                          t_eval=np.zeros(M), **kw)
        return solver(y0, t0, tf, *TOL, t_grid=grid, device="cpu")
    return it.build_ensemble_solver(it.rhs.vdp, method, n=2, t_eval=grid,
                                    **kw)(y0, t0, tf, *TOL, device="cpu")


@pytest.mark.parametrize("method, kind", [
    *(pytest.param(m, "even", id=m) for m in METHODS),
    pytest.param("RK45", "clustered", id="RK45-clustered")])
def test_shared_grid_matches_ivp_tpu(method, kind):
    """A shared (M,) grid from t0 to tf, both ends on the grid; "clustered"
    puts the M - 2 inner times within 1e-3 of t = 1.7, so that one step
    covers several of them and emits them together."""
    y0 = cases.vdp_y0()
    grid = np.linspace(0.0, 4.0, M)
    if kind == "clustered":
        grid[1:-1] = np.linspace(1.7, 1.701, M - 2)
    if method == "RK4":
        grid[-1] = 3.99     # the fixed steps may end a hair short of tf
    j = jax_vdp(method, y0, 0.0, 4.0, *TOL, grid=grid,
                max_steps=MAX_STEPS[method])
    got = _port(method, grid, y0, 0.0, 4.0, max_steps=MAX_STEPS[method])
    assert_matches(j, got)
    assert set(got.status.tolist()) == {it.Status.SUCCESS}
    assert set(got.n_samples.tolist()) == {M}
    # The sample at t0 is y0 (theta = 0 on the first accepted segment).
    np.testing.assert_allclose(got.y_samples[:, 0].numpy(), y0, rtol=1e-14)
    if method != "RK4":
        np.testing.assert_allclose(got.y_samples[:, -1].numpy(),
                                   got.y.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("at_call", [False, True], ids=["t_eval", "t_grid"])
@pytest.mark.parametrize("method", METHODS)
def test_per_lane_grid_forward_and_backward(method, at_call):
    """Per-lane spans (every third backward and short, one zero) with a
    per-lane (B, M) grid from each lane's t0 to its tf; lane 1 runs 30 times
    as far as max_steps allows and stops mid-grid."""
    rng = np.random.default_rng(7)
    y0 = cases.vdp_y0(1)
    t0 = rng.uniform(-1.0, 1.0, B)
    span = rng.uniform(1.0, 2.0, B) * np.where(np.arange(B) % 3 == 2, -0.3, 1)
    span[0] = 0.0
    max_steps = MAX_STEPS[method]
    span[1] = 60.0
    u = np.sort(rng.uniform(0.0, 1.0, (B, M)), axis=1)
    u[:, 0], u[:, -1] = 0.0, (0.995 if method == "RK4" else 1.0)
    grid = t0[:, None] + span[:, None] * u
    j = jax_vdp(method, y0, t0, t0 + span, *TOL, grid=grid,
                max_steps=max_steps)
    got = _port(method, grid, y0, t0, t0 + span, at_call=at_call,
                max_steps=max_steps)
    ns = got.n_samples.numpy()
    assert int(got.status[1]) == it.Status.NEED_LARGER_NMAX and 0 < ns[1] < M
    assert ns[0] == 0 and int(got.status[0]) == it.Status.SUCCESS
    assert (np.delete(ns, [0, 1]) == M).all()
    assert set(np.delete(got.status.numpy(), 1)) == {it.Status.SUCCESS}
    # Lane 1 stops mid-span: its t and y carry the float32 controller's
    # last bits (test_torch_dopri5.py), its samples lie in covered ground.
    keep = np.arange(B) != 1
    pick = lambda r: type(r)(*(None if x is None else np.asarray(x)[keep]
                               for x in r))
    assert_matches(pick(j), pick(convert.result_to_numpy(got)))
    for f in cases.COUNTERS + ("n_samples",):
        assert int(getattr(got, f)[1]) == int(np.asarray(getattr(j, f))[1]), f
    np.testing.assert_allclose(got.y_samples[1].numpy(),
                               np.asarray(j.y_samples)[1], rtol=1e-6,
                               atol=1e-6)
    assert not got.y_samples[1, ns[1]:].any()


def test_lorenz_samples_match_ivp_tpu():
    y0 = cases.lorenz_y0()
    grid = np.linspace(0.0, 3.0, M)
    j = jax.jit(jax_build(cases.jlorenz, "RK45", n=3, t_eval=grid))(
        y0, 0.0, 3.0, *TOL)
    got = it.build_ensemble_solver(it.rhs.lorenz, "RK45", n=3, t_eval=grid)(
        y0, 0.0, 3.0, *TOL, device="cpu")
    assert_matches(j, got)


def test_dopri5_attempt_with_dense_output_matches_ivp_tpu():
    ref, got = cases.one_attempt_both("DOPRI5")
    np.testing.assert_array_equal(got.accepted.numpy(), np.arange(8) % 2 == 0)
    assert tuple(got.cont.shape) == (8, 5, 2) and got.nfev_inc == 6
    cases.assert_proposal_matches(ref, got)


def test_dopri5_interp_matches_ivp_tpu():
    ref, got = cases.interp_both("DOPRI5")
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14)


def test_dopri5_solver_options_match_ivp_tpu():
    """Every numeric option at once (one JAX compile), with samples."""
    so = dict(uround=1e-15, safety=0.8, scale_min=0.3, scale_max=4.0,
              beta=0.08, stiff_test=5, stiff_threshold=2.0, iord=3)
    y0 = cases.vdp_y0(4)
    grid = np.linspace(0.0, 4.0, M)
    j = jax_vdp("RK45", y0, 0.0, 4.0, *TOL, grid=grid, solver_options=so)
    got = _port("RK45", grid, y0, 0.0, 4.0, solver_options=so)
    assert_matches(j, got)
    base = _port("RK45", grid, y0, 0.0, 4.0)
    assert not torch.equal(got.nstep, base.nstep)


def test_carry_handoff_mid_grid_from_ivp_tpu():
    """ivp_tpu's sample-mode carry after 12 attempts (segment, cursor and
    the samples so far) goes through convert.py; the port finishes the solve
    and ends where ivp_tpu does."""
    from ivp_tpu.batch import build_resumable_solver

    y0 = cases.vdp_y0(6)[:8]
    grid = np.linspace(0.0, 6.0, M)
    start, resume, extract = build_resumable_solver(
        cases.jvdp_mu, "DOP853", n=2, args=(1.0,), chunk_steps=12,
        t_eval=grid)
    carry, ra = start(y0, 0.0, 6.0, *TOL)
    carry = resume(carry, ra)
    half = jax.tree.map(np.asarray, carry)
    assert not half.done.any() and 0 < half.s_cursor.min() < M
    while not bool(np.all(np.asarray(carry.done))):
        carry = resume(carry, ra)
    ref = extract(carry)

    c = convert.carry_from_numpy(half)
    assert tuple(c.seg_cont.shape) == (8, 8, 2) and bool(c.seg_valid.all())
    assert tuple(c.sample_y.shape) == (8, M, 2)
    engine, p = get_engine("DOP853", need_cont=True)
    _, run_chunk, run_bounded = make_driver(
        engine, p, DriverConfig(unroll=3, sample_cap=M), it.rhs.vdp)
    y0t = torch.as_tensor(y0)
    ra_t = run_args(6.0, *TOL, 6.0, 0.0, 100_000, y0t, t_grid=grid)
    c = run_bounded(c, ra_t, 5)       # a bounded piece, then to the end
    assert not bool(c.done.all())
    c = run_chunk(c, ra_t)
    assert_matches(ref, it.EnsembleResult(
        c.t, c.y, c.status, c.nfev, c.nstep, c.naccpt, c.nrejct,
        y_samples=c.sample_y, n_samples=c.s_cursor))


def test_grid_validation():
    build = lambda **kw: it.build_ensemble_solver(it.rhs.vdp, "RK45", n=2, **kw)
    with pytest.raises(ValueError, match="sorted"):
        build(t_eval=[0.0, 2.0, 1.0])
    with pytest.raises(ValueError, match="1-D .* or 2-D"):
        build(t_eval=np.zeros((2, 2, 2)))
    y0 = np.ones((4, 2))
    with pytest.raises(ValueError, match="t_eval length 3"):
        build(t_eval=[0.0, 0.5, 1.0])(y0, 0.0, 1.0, *TOL, device="cpu",
                                     t_grid=np.zeros(5))
    with pytest.raises(ValueError, match="t_eval length 0"):
        build()(y0, 0.0, 1.0, *TOL, device="cpu", t_grid=np.zeros(3))
    with pytest.raises(ValueError, match="4 rows"):
        build(t_eval=np.zeros((3, 2)))(y0, 0.0, 1.0, *TOL, device="cpu")
    # A descending grid serves a backward solve.
    res = build(t_eval=[1.0, 0.5, 0.0])(y0, 1.0, 0.0, *TOL, device="cpu")
    assert set(res.n_samples.tolist()) == {3}


# ---------------------------------------------------------------------------
# The kernels' bounds (kernels/erk_ensemble.py::solve_bound)
# ---------------------------------------------------------------------------

def _terms(table):
    items = table.values() if isinstance(table, dict) else table
    return sum(1 for v in items if float(v) != 0.0)


def _hand_count(method):
    """float64 operations per state component of one attempt, of the dense
    output of an accepted attempt and of one sample, counted from the
    tableaus: a sum of k terms is k multiplications and k - 1 additions; a
    stage state y + h * (sum) adds 2; a nested multiply-add 2."""
    from ivp_tpu_torch import tableaus as tab

    dot = lambda t: 2 * _terms(t) - 1
    if method == "DOPRI5":
        attempt = (sum(dot(r) + 2 for r in tab.DOPRI5_A)      # stages, ynew
                   + dot(tab.DOPRI5_E) + 1)                   # h * (E . k)
        dense = 1 + 2 + 3 + dot(tab.DOPRI5_D) + 1
        return attempt, dense, 4 * 2
    if method == "DOP853":
        attempt = (sum(dot(r) + 2 for r in tab.DOP853_A)
                   + dot(tab.DOP853_B) + 2                    # b . k, ynew
                   + 2 * 3                                    # err2
                   + dot(tab.DOP853_ER))
        dense = (sum(dot(getattr(tab, f"DOP853_A{q}")) + 2 for q in (14, 15, 16))
                 + 1 + 2 + 3
                 + sum(dot(tab.DOP853_D[r]) + 1 for r in range(4, 8)))
        return attempt, dense, 7 * 2
    if method == "RK23":
        attempt = 2 + 2 + dot(tab.RK23_B) + 2 + dot(tab.RK23_E) + 1
        return attempt, dot(tab.RK23_D2) + dot(tab.RK23_D3), 1 + 2 + 3 + 2 + 2
    attempt = 2 + 2 + 2 + dot(tab.RK4_B) + 2
    return attempt, 0, 4 + 3


@pytest.mark.parametrize("method", ["DOPRI5", "DOP853", "RK23", "RK4"])
def test_flops_and_bound_match_the_hand_count(method):
    from ivp_tpu_torch.kernels import erk_ensemble as K

    f = K.FLOPS[method]
    assert (f.attempt_n, f.dense_n, f.sample_n) == _hand_count(method)
    fun, n, r = it.rhs.lorenz, 3, K.RHS_FLOPS["lorenz"]
    nstep = torch.tensor([1000, 1200, 0, 7]).repeat(1024)
    naccpt = torch.tensor([900, 1000, 0, 7]).repeat(1024)
    lean = (1024 * 2207 * (n * f.attempt_n + f.attempt + r * f.rhs_attempt)
            + 1024 * 1907 * r * f.rhs_accept)
    assert K.solve_flops(method, fun, nstep, naccpt) == lean
    ms, by = K.solve_bound(method, fun, nstep, naccpt)
    assert by == "operations" and ms == pytest.approx(1e3 * lean / 34e12)
    # Sampled: the dense rows on the steps that emit, min(naccpt, n_samples)
    # a lane (or on every accepted attempt, as dense_steps=naccpt asks), each
    # emitted sample, and per lane 8 m bytes of grid read, 8 m n + 4 of
    # samples written.
    ns = torch.full((4096,), 100)
    row = n * f.dense_n + r * f.rhs_dense
    samples = 4096 * 100 * (n * f.sample_n + f.sample)
    assert (K.solve_flops(method, fun, nstep, naccpt, ns)
            == lean + 1024 * (100 + 100 + 0 + 7) * row + samples)
    assert (K.solve_flops(method, fun, nstep, naccpt, ns, dense_steps=naccpt)
            == lean + 1024 * 1907 * row + samples)
    zero = torch.zeros(4096, dtype=torch.int32)
    ms, by = K.solve_bound(method, fun, zero, zero, ns * 0, m=100)
    lane = 8 * (3 * n + 4 + 3) + 8 * (1 + n) + 20 + 8 * 100 + 8 * 100 * n + 4
    assert by == "bytes" and ms == pytest.approx(1e3 * 4096 * lane / 3.35e12)


def test_kernel_options_are_the_constants_of_the_plain_version():
    from ivp_tpu_torch.kernels import erk_ensemble as K

    _, p = get_engine("DOP853", need_cont=False)
    o = K.kernel_options(p)
    assert o.sqrt_chain == 1 and o.iord == 8 and o.stiff_test == 1000
    assert o.facc1 == 1.0 / 0.333 and o.facc2 == 1.0 / 6.0
    assert o.stiff_threshold == 6.1 and o.uround == 2.3e-16
    assert o.state_precision == 0
    _, p = get_engine("DOP853", need_cont=True, beta=0.08)
    o = K.kernel_options(p)
    assert o.sqrt_chain == 0 and o.expo1 == 0.125 - 0.08 * 0.2
    _, p = get_engine("DOPRI5", need_cont=True)
    o = K.kernel_options(p)
    assert o.expo1 == 0.2 - 0.04 * 0.75 and o.sqrt_chain == 0
    assert K.is_default(p) and not K.is_default(
        get_engine("DOPRI5", need_cont=True, safety=0.8)[1])
    # "state" selects the kernels' double controller, and is not a default.
    _, p = get_engine("RK23", need_cont=False, controller_precision="state")
    assert K.kernel_options(p).state_precision == 1 and not K.is_default(p)
    # The struct's layout is csrc/erk_common.cuh::ErkOptions: 9 doubles, 4
    # ints.
    import ctypes
    assert ctypes.sizeof(K.KernelOptions) == 9 * 8 + 4 * 4
