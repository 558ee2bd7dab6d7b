"""The port's main path as a whole, against ivp_tpu on the CPU.

Bounds as in test_torch_dopri5.py: counters exactly equal, final y and t
within 1e-9.  Running this file as a script rewrites the golden file
``ivp_tpu_torch/data/vdp_golden.npz`` from ivp_tpu (chip_smoke.py holds the
CUDA kernel against it); ``test_golden_file_is_current`` keeps it from going
stale.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402  (enables x64)
from ivp_tpu.batch import build_ensemble_solver as jax_build  # noqa: E402
from ivp_tpu.batch import build_resumable_solver as jax_resumable  # noqa: E402
from ivp_tpu.methods import get_engine as jax_get_engine  # noqa: E402
import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import convert  # noqa: E402
from ivp_tpu_torch.core.driver import DriverConfig, make_driver, run_args  # noqa: E402
from ivp_tpu_torch.kernels import dopri5_ensemble as kmod  # noqa: E402
from ivp_tpu_torch.methods import get_engine  # noqa: E402
from ivp_tpu_torch.methods.ddtier import resolve_auto_dtype  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "ivp_tpu_torch" / "data" / "vdp_golden.npz"
COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct")
TOL = dict(rtol=1e-6, atol=1e-8)


def jvdp(t, y):
    return jnp.array([y[1], (1.0 - y[0] ** 2) * y[1] - y[0]])


def assert_matches(ref, got):
    got = convert.result_to_numpy(got)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_allclose(got.y, np.asarray(ref.y), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.t, np.asarray(ref.t), rtol=1e-9, atol=1e-9)


@functools.lru_cache(maxsize=None)
def make_golden():
    """ivp_tpu's CPU result for the bench configuration cut to B=256:
    VdP mu=1, y0 = [2, 0] + 0.05 N(0, 1) (seed 0), t in [0, 100], DOPRI5,
    rtol 1e-6, atol 1e-8, float64."""
    rng = np.random.default_rng(0)
    y0 = np.array([2.0, 0.0]) + 0.05 * rng.standard_normal((256, 2))
    res = jax.jit(jax_build(jvdp, "RK45", n=2))(y0, 0.0, 100.0, 1e-6, 1e-8)
    out = dict(y0=y0, t0=np.float64(0.0), tf=np.float64(100.0),
               rtol=np.float64(1e-6), atol=np.float64(1e-8))
    out.update({f: np.asarray(getattr(res, f)) for f in ("t", "y") + COUNTERS})
    return out


def test_golden_file_is_current():
    ref = make_golden()
    with np.load(GOLDEN) as g:
        assert sorted(g.files) == sorted(ref)
        for f in COUNTERS:
            np.testing.assert_array_equal(g[f], ref[f], err_msg=f)
        for f in ("y0", "t0", "tf", "rtol", "atol"):
            np.testing.assert_array_equal(g[f], ref[f], err_msg=f)
        np.testing.assert_allclose(g["y"], ref["y"], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g["t"], ref["t"], rtol=1e-12, atol=1e-12)


def test_build_ensemble_solver_matches_ivp_tpu():
    ref = make_golden()
    got = it.build_ensemble_solver(it.rhs.vdp, "RK45", n=2)(
        ref["y0"], 0.0, 100.0, 1e-6, 1e-8, device="cpu")
    assert isinstance(got, it.EnsembleResult)
    assert_matches(type(got)(**{f: ref[f] for f in got._fields}), got)
    assert got.y.dtype == torch.float64 and got.status.dtype == torch.int32


def test_solve_ivp_ensemble_matches_ivp_tpu():
    rng = np.random.default_rng(5)
    y0 = np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((32, 2))
    ref = ivp_tpu.solve_ivp_ensemble(jvdp, (0.0, 7.0), y0, method="RK45",
                                     lane_chunk=None, **TOL)
    got = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 7.0), y0, method="RK45",
                                device="cpu", **TOL)
    assert_matches(ref, got)


def test_carry_handoff_from_ivp_tpu():
    """Run ivp_tpu's init_carry + run_bounded for 50 attempts, carry the
    state across, finish in the port: same end as ivp_tpu run to the end."""
    rng = np.random.default_rng(6)
    y0 = np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((16, 2))
    start, resume, extract = jax_resumable(jvdp, "RK45", n=2, chunk_steps=50)
    carry, _ = start(y0, 0.0, 10.0, 1e-6, 1e-8)
    carry = resume(carry, _)
    half = jax.tree.map(np.asarray, carry)
    assert not half.done.all() and (half.nstep >= 50).all()
    while not bool(np.all(np.asarray(carry.done))):
        carry = resume(carry, _)
    ref = extract(carry)

    c = convert.carry_from_numpy(half, torch.device("cpu"))
    assert c.ms.facold.dtype == torch.float32 and c.y.dtype == torch.float64
    y0t = torch.as_tensor(y0)
    engine, p = get_engine("DOPRI5", need_cont=False)
    # Params carried across from ivp_tpu are the port's defaults.
    assert convert.erk_params_from_jax(
        jax_get_engine("DOPRI5", need_cont=False)[1]) == p
    _, run_chunk, _ = make_driver(engine, p, DriverConfig(), it.rhs.vdp)
    ra = run_args(10.0, 1e-6, 1e-8, 10.0, 0.0, 100_000, y0t)
    c = run_chunk(c, ra)
    assert_matches(ref, it.EnsembleResult(c.t, c.y, c.status, c.nfev, c.nstep,
                                          c.naccpt, c.nrejct))


def test_run_bounded_and_unroll_keep_results():
    """The port's run_bounded in pieces, with unroll 1 and 3, ends where one
    run_chunk does."""
    rng = np.random.default_rng(7)
    y0 = torch.as_tensor(np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((8, 2)))
    engine, p = get_engine("DOPRI5", need_cont=False)
    ra = run_args(5.0, 1e-6, 1e-8, 5.0, 0.0, 100_000, y0)
    t0 = torch.zeros(8, dtype=torch.float64)
    ends = []
    for unroll, bounded in ((1, False), (1, True), (3, True)):
        init, run_chunk, run_bounded = make_driver(
            engine, p, DriverConfig(unroll=unroll), it.rhs.vdp)
        c = init(t0, y0, None, ra)
        if bounded:
            c = run_bounded(c, ra, 7)
            assert bool((c.nstep <= 7 + unroll - 1).all())
            while not bool(c.done.all()):
                c = run_bounded(c, ra, 7)
        else:
            c = run_chunk(c, ra)
        ends.append(c)
    for c in ends[1:]:
        for f in ("t", "y", "status", "nfev", "nstep", "naccpt", "nrejct"):
            assert torch.equal(getattr(c, f), getattr(ends[0], f)), f


def test_cpu_tensors_take_the_plain_version():
    before = kmod.LAUNCHES
    y0 = torch.tensor([[2.0, 0.0], [1.0, 0.5]], dtype=torch.float64)
    res = it.build_ensemble_solver(it.rhs.vdp, "RK45", n=2)(y0, 0.0, 1.0, 1e-6, 1e-8)
    assert res.y.device.type == "cpu" and kmod.LAUNCHES == before
    assert set(res.status.tolist()) == {0}


@pytest.mark.parametrize("entry", ["solver", "solve_ivp_ensemble"])
def test_device_cpu_takes_the_plain_version_with_numpy(entry):
    before = kmod.LAUNCHES
    y0 = np.array([[2.0, 0.0], [1.0, 0.5]])
    if entry == "solver":
        res = it.build_ensemble_solver(it.rhs.vdp, "RK45", n=2)(
            y0, 0.0, 1.0, 1e-6, 1e-8, device="cpu")
    else:
        res = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 1.0), y0, rtol=1e-6,
                                    atol=1e-8, device="cpu")
    assert res.y.device.type == "cpu" and kmod.LAUNCHES == before
    assert set(res.status.tolist()) == {0}


@pytest.mark.parametrize("entry", ["solver", "solve_ivp_ensemble"])
def test_non_tensor_input_goes_to_the_card(entry):
    """A numpy y0_batch without ``device`` runs on the card; with no CUDA
    device that raises, naming the argument, and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py checks this path")
    before = kmod.LAUNCHES
    y0 = np.ones((4, 2))
    with pytest.raises(RuntimeError, match="y0_batch.*device='cpu'"):
        if entry == "solver":
            it.build_ensemble_solver(it.rhs.vdp, "RK45", n=2)(
                y0, 0.0, 1.0, 1e-6, 1e-8)
        else:
            it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 1.0), y0)
    assert kmod.LAUNCHES == before


@pytest.mark.parametrize("entry", ["solver", "solve_ivp_ensemble"])
@pytest.mark.parametrize("device", ["cuda", "cuda:1", "meta"])
def test_device_conflicting_with_a_tensor_raises(entry, device):
    """An explicit ``device`` that is not the tensor's own raises, naming
    both, before anything runs: the tensor is neither moved nor solved where
    it lies.  ``"cpu"`` (and None) with a CPU tensor is the plain route."""
    before = kmod.LAUNCHES
    y0 = torch.tensor([[2.0, 0.0], [1.0, 0.5]], dtype=torch.float64)
    with pytest.raises(ValueError, match=f"on cpu and device='{device}'"):
        if entry == "solver":
            it.build_ensemble_solver(it.rhs.vdp, "RK45", n=2)(
                y0, 0.0, 1.0, 1e-6, 1e-8, device=device)
        else:
            it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 1.0), y0, device=device)
    res = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 1.0), y0, rtol=1e-6,
                                atol=1e-8, device="cpu")
    assert res.y.device.type == "cpu" and kmod.LAUNCHES == before


@pytest.mark.parametrize("device", [None, "cuda"])
def test_unported_option_raises_before_any_device(device, monkeypatch):
    """The options are checked before y0_batch is placed: an unported one
    raises NotImplementedError even where the card is asked for and the
    placement would fail."""
    def no_placement(*a, **k):
        raise AssertionError("y0_batch was placed before the options were "
                             "checked")
    monkeypatch.setattr(it.batch, "_place", no_placement)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 1.0), np.ones((4, 2)),
                              t_eval=[0.5], device=device)


def test_no_route_for_other_devices():
    y0 = torch.zeros((4, 2), dtype=torch.float64, device="meta")
    with pytest.raises(NotImplementedError):
        it.build_ensemble_solver(it.rhs.vdp, "RK45", n=2)(y0, 0.0, 1.0, 1e-6, 1e-8)


@pytest.mark.parametrize("opts", [
    dict(events=[lambda t, y: y[:, 0]]),
    dict(t_eval=np.linspace(0.0, 1.0, 5)),
    dict(dense_output=True),
    dict(record_trajectories=True),
    dict(max_restarts=2),
    dict(time_dtype=torch.float64),
    dict(jac=lambda t, y: None),
    dict(jac_sparsity=np.ones((2, 2))),
    dict(solver_options={"safety": 0.8}),
    dict(lane_chunk=16),
    dict(method="auto"),
    dict(method="Radau"),
    dict(method="BDF"),
    dict(method="DOP853"),
    dict(method="RK23"),
    dict(method="RK4"),
], ids=lambda d: "-".join(d))
def test_unported_options_raise(opts):
    kw = dict(method="RK45")
    kw.update(opts)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 1.0), np.ones((4, 2)), **kw)


@pytest.mark.parametrize("dtype", [None, "auto", "dd"])
def test_f64_class_dtypes_resolve_to_float64(dtype):
    assert resolve_auto_dtype(dtype) == torch.float64
    res = it.solve_ivp_ensemble(it.rhs.decay, (0.0, 1.0), np.ones((2, 1)),
                                dtype=dtype, device="cpu")
    assert res.y.dtype == torch.float64


def test_port_imports_no_jax():
    code = ("import sys, ivp_tpu_torch, ivp_tpu_torch.convert, "
            "ivp_tpu_torch.kernels.build; "
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "or m == 'ivp_tpu' or m.startswith('ivp_tpu.') "
            "for m in sys.modules), sorted(sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez(GOLDEN, **make_golden())
    print(f"wrote {GOLDEN}")
