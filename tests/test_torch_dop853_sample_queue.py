"""The sampled DOP853 kernel's deferred samples on the CPU: a g++ build of
``csrc/erk_dop853.cu`` (gxx.py), launched through
``kernels/erk_ensemble.py::ensemble_launch`` on CPU tensors, against the
plain version and against ivp_tpu.

The kernel queues each step that covers a grid time and rebuilds the queued
steps, rows and all, when some lane's slots are full and after its loop
(``erk_common.cuh``'s DEFER_SAMPLES).  In a g++ build each lane runs alone,
so a lane resolves its queue when its own slots are full.  The cases: a
shared grid, a per-lane grid denser than the steps (a step emits several
samples and the slots fill every few steps), backward per-lane grids with
points at t0 and tf, and lanes stopped by ``max_steps`` mid-span.  Bounds:
status, every counter and ``n_samples`` equal on every lane; y and
``y_samples`` within 1e-10 of max(1, |y|), but for the final t and y of
lanes stopped mid-span, which chip_smoke.py does not hold either: each step
there carries the float32 controller's last bits (ROADMAP §3 faults 1-2),
and after 12 steps t differed from the plain version's by 6e-9 and y by
2e-6, with or without the queue; their samples are held.  Against
ivp_tpu, ``tests/test_torch_samples.py``'s 1e-9.  Skipped without g++.
"""
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import test_torch_erk_cases as cases  # noqa: E402
from test_torch_erk_cases import assert_matches, jax_build  # noqa: E402
import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch.kernels import build  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as K  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B = 37          # lanes: no whole block of the kernel's 64 threads
TOL = 1e-10
F64 = torch.float64


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """This tree's erk_dop853.cu built with g++ (about 20 s)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel source as host code")
    spec = importlib.util.spec_from_file_location("gxx", ROOT / "gxx.py")
    gxx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gxx)
    out = tmp_path_factory.mktemp("gxx_dop853")
    return build.load(gxx.build_all(build.SRC_DIR, out, ["erk_dop853"])
                      ["erk_dop853"])


def T(a):
    return torch.tensor(np.asarray(a, dtype=float), dtype=F64)


def lorenz_inputs(seed, tf):
    y0 = cases.lorenz_y0(seed, lanes=B)
    return (it.rhs.lorenz, T(y0), T(np.zeros(B)), T(np.full(B, tf)),
            T(np.full(B, tf)), None, T(np.full((B, 3), 1e-8)),
            T(np.full((B, 3), 1e-10)), ())


def shared_grid():
    a = lorenz_inputs(0, 2.0)
    grid = torch.broadcast_to(torch.linspace(0.0, 2.0, 100, dtype=F64),
                              (B, 100))
    return a, grid, 200_000


def dense_per_lane_grid():
    a = lorenz_inputs(1, 1.0)
    rng = np.random.default_rng(11)
    return a, T(np.sort(rng.uniform(0.0, 1.0, (B, 400)), axis=1)), 200_000


def backward_per_lane_grid():
    rng = np.random.default_rng(12)
    t0 = rng.uniform(-1.0, 1.0, B)
    span = rng.uniform(2.0, 5.0, B) * np.where(np.arange(B) % 2, -1.0, 1.0)
    u = np.sort(rng.uniform(0.0, 1.0, (B, 64)), axis=1)
    u[:, 0], u[:, -1] = 0.0, 1.0
    a = (it.rhs.decay, T(rng.uniform(0.5, 2.0, (B, 1))), T(t0), T(t0 + span),
         T(np.abs(span)), None, T(np.full((B, 1), 1e-8)),
         T(np.full((B, 1), 1e-10)), (0.7,))
    return a, T(t0[:, None] + span[:, None] * u), 200_000


def max_steps_mid_span():
    a, grid, _ = shared_grid()
    return a, grid, 12


CASES = {"shared_grid": shared_grid,
         "dense_per_lane_grid": dense_per_lane_grid,
         "backward_per_lane_grid": backward_per_lane_grid,
         "max_steps_mid_span": max_steps_mid_span}


def kernel(lib, a, grid, max_steps):
    return K.ensemble_launch("DOP853", *a, max_steps, grid, None, lib, 0)


def assert_close(got, ref, final=True):
    """Status, counters and n_samples equal on every lane; the samples, and
    where ``final`` y, within TOL of max(1, |y|)."""
    for name, g, r in zip(("status", "nfev", "nstep", "naccpt", "nrejct"),
                          got[2:7], ref[2:7]):
        assert torch.equal(g, r.to(g.dtype)), name
    assert torch.equal(got[8], ref[8].to(got[8].dtype)), "n_samples"
    held = (("y", got[1], ref[1]),) if final else ()
    for name, g, r in (*held, ("y_samples", got[7], ref[7])):
        err = ((g - r).abs() / r.abs().clamp(min=1.0)).max()
        assert float(err) <= TOL, (name, float(err))


@pytest.mark.parametrize("case", list(CASES))
def test_deferred_samples_match_plain(lib, case):
    a, grid, max_steps = CASES[case]()
    got = kernel(lib, a, grid, max_steps)
    ref = K.erk_ensemble_torch("DOP853", *a, max_steps, grid)
    assert_close(got, ref, final=case != "max_steps_mid_span")
    m = grid.shape[-1]
    if case == "max_steps_mid_span":
        assert set(got[2].tolist()) == {it.Status.NEED_LARGER_NMAX}
        assert 0 < int(got[8].max()) < m
    else:
        assert set(got[2].tolist()) == {it.Status.SUCCESS}
        assert bool((got[8] == m).all())
    # Rows past a lane's count stay zero.
    past = torch.arange(m)[None, :] >= got[8][:, None].long()
    assert not bool(got[7][past].any())


def test_dense_grid_fills_the_slots(lib):
    """The dense grid's steps each cover several grid times, and a lane
    queues more steps than its 8 slots hold: the queue is resolved inside
    the loop, not only after it."""
    a, grid, max_steps = dense_per_lane_grid()
    got = kernel(lib, a, grid, max_steps)
    naccpt = got[5].double()
    assert float((400 / naccpt).min()) > 2.0
    assert int(naccpt.min()) > 8


def test_deferred_samples_match_ivp_tpu(lib):
    """Lorenz, 8 lanes, a 25-point grid on t in [0, 2]: the kernel against
    ivp_tpu's sampled ensemble on the CPU."""
    lanes = 8
    y0 = cases.lorenz_y0(3, lanes=lanes)
    grid = np.linspace(0.0, 2.0, 25)
    j = jax.jit(jax_build(cases.jlorenz, "DOP853", n=3, t_eval=grid))(
        y0, 0.0, 2.0, 1e-8, 1e-10)
    full = lambda v, shape: T(np.broadcast_to(v, shape))
    out = K.ensemble_launch(
        "DOP853", it.rhs.lorenz, T(y0), full(0.0, (lanes,)),
        full(2.0, (lanes,)), full(2.0, (lanes,)), None,
        full(1e-8, (lanes, 3)), full(1e-10, (lanes, 3)), (), 100_000,
        full(grid, (lanes, 25)), None, lib, 0)
    assert_matches(j, it.EnsembleResult(*out[:7], y_samples=out[7],
                                        n_samples=out[8]))
