"""The lean DOP853 kernel on the CPU: a g++ build of ``csrc/erk_dop853.cu``
(gxx.py; the VdP and Lorenz entries only, about 10 s), launched through
``kernels/erk_ensemble.py::ensemble_launch`` and
``kernels/resumable.py::CardSolve`` on CPU tensors, against the plain
version and against ivp_tpu.

The attempt counts down to its periodic stiffness test (``Lane::stiff_in``,
as DOPRI5 does) where the reference takes ``(naccpt + 1) % stiff_test``;
evaluates f(ynew) on every attempt and counts it on an accepted one only;
and runs the error norm and the controller on the fast paths of their
divisions and square roots, then once more through the library's operations
on a lane where an input leaves their range (``FastCtl``).  A g++ build
starts those fast paths from reciprocals an ulp off (the card's are no
finer), so the corrections run here too.  The cases: Lorenz and VdP;
``stiff_test`` 1, 3 and the default on VdP mu=1000, where lanes end
PROBABLY_STIFF; rejected attempts from a large first step; a step budget
mid-span; a backward span; VdP lanes from near the origin, whose float32
error components start below the fast path's range (2^-62) and grow into
it; VdP at rest, whose errors are all 0; the resumable mode in chunks of 1 and 7 attempts against one unbounded
launch, bit for bit, so that the countdown is derived from ``naccpt`` at
every chunk boundary.  Bounds against the plain version: status, every
counter and ``iasti`` (the resumable carry's, against the plain driver's)
equal on every lane; y within 1e-10 of max(1, |y|) on every lane but those
the step budget stops mid-span, whose final t and y carry the float32
controller's last bits (ROADMAP §3 fault 1; y 7e-8 from the plain version
here, with or without this design, as in test_torch_dop853_sample_queue.py).
Against ivp_tpu, ``tests/test_torch_samples.py``'s 1e-9.  Skipped without
g++.
"""
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_erk_cases as cases  # noqa: E402
from test_torch_erk_cases import assert_matches  # noqa: E402
import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch.core.driver import run_args  # noqa: E402
from ivp_tpu_torch.kernels import build  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as K  # noqa: E402
from ivp_tpu_torch.kernels import resumable as RES  # noqa: E402
from ivp_tpu_torch.methods import get_engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B = 37          # lanes: no whole block of the kernel's 64 threads
TOL = 1e-10
F64 = torch.float64
ENTRIES = ("vdp", "lorenz")   # the functors whose entries the build keeps


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """This tree's erk_dop853.cu built with g++, its ``ENTRIES`` only."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel source as host code")
    spec = importlib.util.spec_from_file_location("gxx", ROOT / "gxx.py")
    gxx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gxx)
    src = tmp_path_factory.mktemp("dop853_src") / "csrc"
    shutil.copytree(build.SRC_DIR, src)
    cu = src / "erk_dop853.cu"
    keep = tuple(f"IVP_ERK_ENTRY(dop853, {e}," for e in ENTRIES)
    cu.write_text("".join(
        ln for ln in cu.read_text().splitlines(keepends=True)
        if not ln.startswith("IVP_ERK_") or ln.startswith(keep)
        or ln.startswith("IVP_ERK_LIBRARY")))
    out = tmp_path_factory.mktemp("gxx_dop853_lean")
    return build.load(gxx.build_all(src, out, ["erk_dop853"])["erk_dop853"])


def T(a):
    return torch.tensor(np.asarray(a, dtype=float), dtype=F64)


def lanes(v):
    return T(np.broadcast_to(np.asarray(v, float), (B,)))


def inputs(fun, y0, t0, tf, rtol, atol, args=(), first_step=None):
    """ensemble_launch's arguments from the functor to ``args``."""
    n = fun.n
    return (fun, T(y0), lanes(t0), lanes(tf), lanes(np.abs(tf - t0)),
            None if first_step is None else lanes(first_step),
            T(np.full((B, n), rtol)), T(np.full((B, n), atol)), args)


def lorenz(**kw):
    return inputs(it.rhs.lorenz, cases.lorenz_y0(5, lanes=B), 0.0, 2.0,
                  1e-8, 1e-10, **kw)


def vdp(t0=0.0, tf=10.0, scale=1.0, **kw):
    return inputs(it.rhs.vdp, scale * cases.vdp_y0(6, lanes=B), t0, tf, 1e-8,
                  1e-10, (1.0,), **kw)


def stiff_vdp():
    y0 = cases.vdp_y0(7, lanes=B)
    return inputs(it.rhs.vdp, y0, 0.0, 3000.0, 1e-6, 1e-8, (1000.0,))


def near_origin():
    """VdP lanes from [s, 0], s from 1e-33 down to 1e-36: |k| <= 2|y|, so
    every float32 error component of the first attempts is below 2^-100,
    far outside the fast path's range (2^-62; the library's repeat runs),
    until y has grown by about e^20 over t in [0, 40] and the errors with
    it."""
    s = 10.0 ** -np.linspace(33.0, 36.0, B)
    y0 = np.stack([s, np.zeros(B)], axis=1)
    return inputs(it.rhs.vdp, y0, 0.0, 40.0, 1e-8, 1e-10, (1.0,))


def at_rest():
    """VdP at its rest point: every error and err are 0 on every attempt;
    the divisions take the zeros on their fast path, the square root of
    err = 0 leaves its range, and the library's repeat runs."""
    return inputs(it.rhs.vdp, np.zeros((B, 2)), 0.0, 10.0, 1e-8, 1e-10,
                  (1.0,))


def params(**kw):
    return get_engine("DOP853", need_cont=False, **kw)[1] if kw else None


# name: (inputs, max_steps, params)
CASES = {
    "lorenz": lambda: (lorenz(), 100_000, None),
    "vdp": lambda: (vdp(), 100_000, None),
    "stiff_test_1": lambda: (stiff_vdp(), 100_000, params(stiff_test=1)),
    "stiff_test_3": lambda: (stiff_vdp(), 100_000, params(stiff_test=3)),
    "stiff_test_default": lambda: (stiff_vdp(), 100_000, None),
    "rejects": lambda: (lorenz(first_step=0.5), 100_000, None),
    "max_steps": lambda: (lorenz(), 12, None),
    # Inside the limit cycle, which repels backward: toward the origin.
    "backward": lambda: (vdp(t0=1.0, tf=-5.0, scale=0.25), 100_000, None),
    "slow_path": lambda: (near_origin(), 100_000, None),
    "at_rest": lambda: (at_rest(), 100_000, None),
}


def plain(a, max_steps, p):
    """The plain driver's final carry."""
    fun, y0, t0, tf, hmax, fs, rtol, atol, args = a
    init_carry, run_chunk = K.plain_driver("DOP853", fun, y0, args, 0, p,
                                           None)
    ra = run_args(tf, rtol, atol, hmax, 0.0, max_steps, y0)
    return run_chunk(init_carry(t0, y0, fs, ra), ra)


def resumable(lib, a, max_steps, p, chunk=None):
    """The resumable kernel's carry after one unbounded launch, or after
    launches of ``chunk`` counted attempts until every lane is done."""
    fun, y0, t0, tf, hmax, fs, rtol, atol, args = a
    p = p or get_engine("DOP853", need_cont=False)[1]
    ra = run_args(tf, rtol, atol, hmax, 0.0, max_steps, y0)
    card = RES.CardSolve("DOP853", fun, args, p, lib)
    c = card.start(y0, t0, fs, ra, stream=0)
    while not bool(c.done.all()):
        c = card.resume(c, ra, chunk or 2 ** 30, stream=0)
    return c


@pytest.mark.parametrize("case", list(CASES))
def test_lean_matches_plain(lib, case):
    a, max_steps, p = CASES[case]()
    got = K.ensemble_launch("DOP853", *a, max_steps, None, p, lib, 0)
    ref = plain(a, max_steps, p)
    res = resumable(lib, a, max_steps, p)
    for name, g, r in zip(cases.COUNTERS, got[2:7],
                          (ref.status, ref.nfev, ref.nstep, ref.naccpt,
                           ref.nrejct)):
        assert torch.equal(g, r.to(g.dtype)), name
        assert torch.equal(getattr(res, name).to(g.dtype), g), name
    assert torch.equal(res.ms.iasti.to(torch.int32),
                       ref.ms.iasti.to(torch.int32)), "iasti"
    held = got[2] != it.Status.NEED_LARGER_NMAX
    err = ((got[1] - ref.y).abs() / ref.y.abs().clamp(min=1.0)).amax(dim=1)
    assert float(torch.where(held, err, 0.0).max()) <= TOL, float(err.max())
    status = set(got[2].tolist())
    if case == "max_steps":
        assert status == {it.Status.NEED_LARGER_NMAX}
    elif case.startswith("stiff_test"):
        assert it.Status.PROBABLY_STIFF in status
    else:
        assert status == {it.Status.SUCCESS}


def test_rejected_attempts_count_eleven(lib):
    """f(ynew) runs on every attempt but counts on an accepted one only: a
    lane's nfev is its first RHS call, 12 an accepted attempt and 11 a
    rejected one, and the large first step is rejected on every lane."""
    a, max_steps, p = CASES["rejects"]()
    got = K.ensemble_launch("DOP853", *a, max_steps, None, p, lib, 0)
    nfev, nstep, naccpt = (got[k].long() for k in (3, 4, 5))
    rejected = nfev - 1 - 12 * naccpt
    assert bool((rejected % 11 == 0).all())
    assert bool((rejected // 11 == nstep - naccpt).all())
    assert bool((rejected > 0).all())


@pytest.mark.parametrize("chunk", [1, 7])
def test_resumable_chunks_match_one_launch(lib, chunk):
    """stiff_test=3 on VdP mu=1000 in chunks: the countdown is derived from
    naccpt at every chunk boundary, and the carry ends as one unbounded
    launch leaves it, field by field."""
    a, max_steps, p = CASES["stiff_test_3"]()
    one = resumable(lib, a, max_steps, p)
    got = resumable(lib, a, max_steps, p, chunk=chunk)
    assert it.Status.PROBABLY_STIFF in set(one.status.tolist())
    for f in ("t", "y", "status", "done", "nfev", "nstep", "naccpt",
              "nrejct"):
        assert torch.equal(getattr(got, f), getattr(one, f)), f
    for f in one.ms._fields:
        assert torch.equal(getattr(got.ms, f), getattr(one.ms, f)), f


def test_lean_matches_ivp_tpu(lib):
    """VdP over ``cases.B`` lanes, t in [0, 10]: the kernel against
    ivp_tpu's lean ensemble on the CPU."""
    n = cases.B
    y0 = cases.vdp_y0(8, lanes=n)
    ref = cases.jax_vdp("DOP853", y0, 0.0, 10.0, 1e-8, 1e-10)
    full = lambda v, shape: T(np.broadcast_to(v, shape))
    out = K.ensemble_launch(
        "DOP853", it.rhs.vdp, T(y0), full(0.0, (n,)), full(10.0, (n,)),
        full(10.0, (n,)), None, full(1e-8, (n, 2)), full(1e-10, (n, 2)),
        (1.0,), 100_000, None, None, lib, 0)
    assert_matches(ref, it.EnsembleResult(*out[:7]))
