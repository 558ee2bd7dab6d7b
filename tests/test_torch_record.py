"""The driver's record mode in the port (core/driver.py, ``rec_cap`` and
``record_cont``) and its plain route (kernels/erk_record.py), against
ivp_tpu's driver in record mode (``rec_scan=False``) on the CPU.

The same VdP lanes go through ivp_tpu's vmapped record-mode chunk loop and
the port's, at ``rec_cap=7``, so every lane crosses several chunks.  Bounds:

* status, every counter and each chunk's ``n_rec`` equal on every lane;
* the rows as points of one trajectory: ``y`` within 1e-10 scaled by
  max(1, |y|) after moving ivp_tpu's row along f by the two rows' time
  difference, and each step's dense interpolant, evaluated at the middle of
  ivp_tpu's step, within 1e-10 of ivp_tpu's.  The raw ``t``, ``xold`` and
  ``h`` of a row are held within 1e-5 relative (1e-6 absolute): under the
  default float32 controller XLA's float32 log/exp and its FMAs round the
  next step size apart in its last float32 bits (ROADMAP §3 faults 1-2),
  which shifts each step's end by up to ~1e-6 (measured 1.6e-6 on DOP853,
  2.2e-7 on RK23, 3e-15 on RK4's fixed steps) while the points stay on one
  trajectory (measured 4e-12 after the shift);
* the port chunked at ``rec_cap=7`` against ``rec_cap=4096``: every output
  and every row bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402,F401  (enables x64)
from ivp_tpu.core.driver import DriverConfig as JaxDriverConfig  # noqa: E402
from ivp_tpu.core.driver import make_driver as jax_make_driver  # noqa: E402
from ivp_tpu.core.driver import run_args as jax_run_args  # noqa: E402
from ivp_tpu.methods import get_engine as jax_get_engine  # noqa: E402

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import convert  # noqa: E402
from ivp_tpu_torch.core.driver import (DriverConfig, make_driver,  # noqa: E402
                                       reset_records, run_args)
from ivp_tpu_torch.kernels import erk_record as R  # noqa: E402
from ivp_tpu_torch.methods import get_engine  # noqa: E402

METHODS = ["DOPRI5", "DOP853", "RK23", "RK4"]
B, CAP, TF, TOL = 4, 7, 3.0, (1e-6, 1e-8)
RK4_STEP = 0.05
COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct")


def jvdp(t, y):
    return jnp.array([y[1], (1.0 - y[0] ** 2) * y[1] - y[0]])


def vdp_np(y):
    return np.stack([y[..., 1], (1.0 - y[..., 0] ** 2) * y[..., 1] - y[..., 0]],
                    axis=-1)


def y0s():
    rng = np.random.default_rng(7)
    return np.array([2.0, 0.0]) + 0.05 * rng.standard_normal((B, 2))


def jax_chunks(method, cont):
    """ivp_tpu's vmapped record-mode run: the numpy carry after each chunk."""
    je, jp = jax_get_engine(method, need_cont=cont)
    cfg = JaxDriverConfig(rec_cap=CAP, record_cont=cont, ncoeff=je.ncoeff)
    init, run, reset, _ = jax_make_driver(je, jp, cfg, jvdp)
    ra = jax_run_args(TF, jnp.full(2, TOL[0]), jnp.full(2, TOL[1]), TF, 0.0,
                      10_000, jnp.float64)
    fs = jnp.asarray(RK4_STEP) if method == "RK4" else None
    c = jax.jit(jax.vmap(lambda y: init(0.0, y, fs, ra)))(y0s())
    vrun = jax.jit(jax.vmap(lambda c: run(c, ra)))
    vreset = jax.jit(jax.vmap(reset))
    out = []
    while True:
        c = vrun(c)
        out.append(jax.tree.map(np.asarray, c))
        if out[-1].done.all():
            return out
        c = vreset(c)


def port_args(method):
    y = torch.as_tensor(y0s())
    lane = lambda v: torch.full((B,), v, dtype=torch.float64)
    return (y, lane(0.0), lane(TF), lane(TF),
            lane(RK4_STEP) if method == "RK4" else None,
            torch.full((B, 2), TOL[0], dtype=torch.float64),
            torch.full((B, 2), TOL[1], dtype=torch.float64), (), 10_000)


def assert_rows_match(method, cont, tr, yr, xr, hr, cr, t, y, x, h, c):
    """One lane's rows against ivp_tpu's (bounds in the module docstring)."""
    if not len(tr):
        return
    for name, a, b in (("t", t, tr), ("xold", x, xr), ("h", h, hr)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    scale = np.maximum(1.0, np.abs(yr).max())
    shifted = yr + vdp_np(y) * (t - tr)[:, None]
    assert np.abs(shifted - y).max() <= 1e-10 * scale
    if cont:
        engine, _ = get_engine(method, need_cont=True)
        mid = xr + 0.5 * hr
        T = lambda a: torch.as_tensor(np.array(a))
        got = engine.interp(T(c), T(x), T(h), T(mid)).numpy()
        ref = engine.interp(T(cr), T(xr), T(hr), T(mid)).numpy()
        assert np.abs(got - ref).max() <= 1e-10 * scale


@pytest.mark.parametrize("cont", [False, True], ids=["steps", "cont"])
@pytest.mark.parametrize("method", METHODS)
def test_record_mode_matches_ivp_tpu(method, cont):
    ref = jax_chunks(method, cont)
    engine, p = get_engine(method, need_cont=cont)
    init_carry, run_chunk, _ = make_driver(
        engine, p, DriverConfig(unroll=3, rec_cap=CAP, record_cont=cont),
        it.rhs.vdp)
    y, t0, tf, hmax, fs, rtol, atol, _, max_steps = port_args(method)
    ra = run_args(tf, rtol, atol, hmax, 0.0, max_steps, y)
    c = init_carry(t0, y, fs, ra)
    for k, jr in enumerate(ref):
        if k:
            c = reset_records(c)
        c = run_chunk(c, ra)
        np.testing.assert_array_equal(c.n_rec.numpy(), jr.n_rec)
        assert tuple(c.rec_cont.shape) == (B, CAP, engine.ncoeff * 2 * cont)
        for i in range(B):
            n = int(jr.n_rec[i])
            cr = jr.rec_cont[i, :n].reshape(n, -1, 2) if cont else None
            cg = c.rec_cont[i, :n].reshape(n, -1, 2).numpy() if cont else None
            assert_rows_match(
                method, cont, jr.rec_t[i, :n], jr.rec_y[i, :n],
                jr.rec_xold[i, :n], jr.rec_h[i, :n], cr,
                c.rec_t[i, :n].numpy(), c.rec_y[i, :n].numpy(),
                c.rec_xold[i, :n].numpy(), c.rec_h[i, :n].numpy(), cg)
    assert bool(c.done.all())
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(c, f).numpy(),
                                      getattr(ref[-1], f), err_msg=f)
    np.testing.assert_allclose(c.y.numpy(), ref[-1].y, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("grid", [False, True], ids=["no_grid", "grid"])
@pytest.mark.parametrize("cont", [False, True], ids=["steps", "cont"])
@pytest.mark.parametrize("method", METHODS)
def test_chunked_equals_unchunked_bit_for_bit(method, cont, grid):
    """The plain route at rec_cap 7 (several chunks a lane) and 4096 (one):
    every output, sample and row bit for bit; rows past a lane's count are
    zero; the counts are naccpt (every accepted step advances here)."""
    a = port_args(method)
    g = (torch.broadcast_to(torch.linspace(0.0, TF if method != "RK4" else 2.9,
                                           5, dtype=torch.float64), (B, 5))
         if grid else None)
    kw = dict(record_cont=cont)
    small = R.erk_record_torch(method, it.rhs.vdp, *a, t_grid=g, rec_cap=CAP,
                               **kw)
    big = R.erk_record_torch(method, it.rhs.vdp, *a, t_grid=g, rec_cap=4096,
                             **kw)
    assert small.chunks >= 2 and big.chunks == 1
    for f in R.RecordResult._fields[:-1]:
        x, y = getattr(small, f), getattr(big, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f
    assert torch.equal(small.n_rec, small.naccpt.to(torch.int64))
    S = small.rec_t.shape[1]
    assert S == int(small.n_rec.max())
    past = torch.arange(S)[None, :] >= small.n_rec[:, None]
    assert not bool(small.rec_t[past].any()) and not bool(small.rec_y[past].any())
    if cont:
        C = it.types.NCOEFF[method]
        assert tuple(small.rec_cont.shape) == (B, S, C, 2)
    else:
        assert small.rec_cont is None
    if grid:
        assert tuple(small.y_samples.shape) == (B, 5, 2)


def test_carry_from_ivp_tpu_single_ivp_resumes_in_the_port():
    """ivp_tpu's single-IVP record-mode carry after its first chunk (record
    cursor and buffers, flat (cap, C*n) coefficient rows) comes across
    through convert.py as one lane; the port's plain driver records the
    remaining rows, and they are ivp_tpu's."""
    je, jp = jax_get_engine("DOP853", need_cont=True)
    cfg = JaxDriverConfig(rec_cap=CAP, record_cont=True, ncoeff=je.ncoeff)
    init, run, reset, _ = jax_make_driver(je, jp, cfg, jvdp)
    ra = jax_run_args(TF, jnp.full(2, 1e-8), jnp.full(2, 1e-10), TF, 0.0,
                      10_000, jnp.float64)
    run = jax.jit(run)
    c = run(jax.jit(lambda y: init(0.0, y, None, ra))(y0s()[0]), ra)
    first = jax.tree.map(np.asarray, c)
    rest = []
    while not bool(c.done):
        c = run(reset(c), ra)
        rest.append(jax.tree.map(np.asarray, c))
    assert int(first.n_rec) == CAP and rest

    pc = convert.carry_from_numpy(first)
    assert tuple(pc.rec_cont.shape) == (1, CAP, 16)
    assert int(pc.n_rec[0]) == CAP and tuple(pc.y.shape) == (1, 2)
    assert torch.equal(pc.rec_t[0], torch.as_tensor(np.array(first.rec_t)))
    engine, p = get_engine("DOP853", need_cont=True)
    _, run_chunk, _ = make_driver(
        engine, p, DriverConfig(unroll=2, rec_cap=CAP, record_cont=True),
        it.rhs.vdp)
    y = pc.y
    ra_t = run_args(TF, 1e-8, 1e-10, TF, 0.0, 10_000, y)
    for jr in rest:
        pc = run_chunk(reset_records(pc), ra_t)
        n = int(jr.n_rec)
        assert int(pc.n_rec[0]) == n
        assert_rows_match(
            "DOP853", True, jr.rec_t[:n], jr.rec_y[:n], jr.rec_xold[:n],
            jr.rec_h[:n], jr.rec_cont[:n].reshape(n, -1, 2),
            pc.rec_t[0, :n].numpy(), pc.rec_y[0, :n].numpy(),
            pc.rec_xold[0, :n].numpy(), pc.rec_h[0, :n].numpy(),
            pc.rec_cont[0, :n].reshape(n, -1, 2).numpy())
    for f in COUNTERS:
        assert int(getattr(pc, f)[0]) == int(getattr(rest[-1], f)), f


def test_record_bound_counts_rows_and_dense_work():
    """record_bound: the lean work, the dense rows on every recorded step
    with coefficients (on none without, and no grid), and each row's
    3 + n + C n doubles written once."""
    from ivp_tpu_torch.kernels import erk_ensemble as K

    fun, n = it.rhs.lorenz, 3
    nstep = torch.full((4096,), 1000)
    naccpt = torch.full((4096,), 900)
    n_rec = naccpt.clone()
    f, r = K.FLOPS["DOP853"], K.RHS_FLOPS["lorenz"]
    lean = K.solve_flops("DOP853", fun, nstep, naccpt)
    dense = 4096 * 900 * (n * f.dense_n + r * f.rhs_dense)
    assert K.solve_flops("DOP853", fun, nstep, naccpt,
                         dense_steps=n_rec) == lean + dense
    for cont, C in ((False, 0), (True, 8)):
        ms, by = R.record_bound("DOP853", fun, nstep, naccpt, n_rec, cont,
                                rate=1.0, peak=1.0)
        lane = 8 * (3 * n + 4 + 3) + 8 * (1 + n) + 20
        nbytes = 4096 * lane + 8 * 4096 * 900 * (3 + n + C * n)
        flops = lean + (dense if cont else 0)
        assert ms == pytest.approx(1e3 * max(nbytes, flops))
