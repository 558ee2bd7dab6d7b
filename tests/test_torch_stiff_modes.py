"""The stiff kernels' SAMPLED and RECORD modes on the CPU: g++ builds of
``csrc/radau.cu`` and ``csrc/bdf.cu`` (gxx.py; the VdP and Robertson entries
only) launched through ``kernels/stiff_ensemble.py::stiff_ensemble_cuda``
(``t_grid``) and ``kernels/erk_record.py::stiff_record_launches`` on CPU
tensors with stream 0, against the plain version (the driver's sample and
record modes) and against the g++ build's own LEAN mode.

The cases: VdP mu=1000, B=37 (no whole block of the kernels' 128 threads),
t in [0, 1000] (one relaxation jump near t = 807), rtol 1e-4, atol 1e-6; a
shared 51-point grid with points at t0 and at tf, and a per-lane one; a
``max_steps`` that stops some lanes mid-span, whose samples past their end
stay unwritten (zero), as the plain version's; the record mode with and
without coefficients in chunks of ``rec_cap=7``, and against one chunk bit
for bit; Robertson (n = 3) sampled on a log-spaced grid.

Bounds against the plain version (``TOL``; a row's t, xold and h on its
lane's time scale, max(1, |t|), its y and coefficients, the samples and the
final y on max(1, |y|)): status, every counter, ``n_samples`` and ``n_rec``
equal on every lane, or for BDF under the default float32 controller on at
least ``BDF_F32_SHARE`` of them (its float32 log and exp in the order
selection round apart between the host's libm and torch's, ROADMAP §3
fault 1: 37 of 37 lanes here when this was written, 84-89% over [0,
3000]).  Under ``controller_precision="state"`` everything within 1e-7
(measured: BDF's rows 1.7e-8, its D array carrying the host libm's last
bits over the jump; Radau's 1.0e-9).  Under float32 the step sizes follow
the float32 controller, whose pow, log and exp round apart between the
host's libm and torch's (fault 1), so the rows lie at times a float32 drift
apart: Radau's final y and samples within 1e-7 (measured 1.4e-10), its rows
within 1e-5 (1.0e-6); BDF's final y and samples within 1e-6 (1.4e-7), its
rows within 1e-3 (8.6e-5).  On the card, where both routes take the card's
libm, chip_smoke.py holds every mode to 1e-8.  Against the LEAN mode of the
same build, every mode's final t, y, status and counters are equal bit for
bit: samples and records change no step.  Skipped without g++.
"""
import functools
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import Status  # noqa: E402
from ivp_tpu_torch.kernels import build  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as E  # noqa: E402
from ivp_tpu_torch.kernels import erk_record as R  # noqa: E402
from ivp_tpu_torch.kernels import stiff_ensemble as S  # noqa: E402
from ivp_tpu_torch.methods.jacobian import stiff_spec  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, MU, TF, M = 37, 1000.0, 1000.0, 51
RTOL, ATOL = 1e-4, 1e-6
BDF_F32_SHARE = 0.75
# (method, controller) -> (final y and samples, rows): the module's bounds.
TOL = {("RADAU", "state"): (1e-7, 1e-7), ("BDF", "state"): (1e-7, 1e-7),
       ("RADAU", "float32"): (1e-7, 1e-5), ("BDF", "float32"): (1e-6, 1e-3)}
F64 = torch.float64
ENTRIES = ("vdp", "robertson")   # the functors whose entries the build keeps
METHODS = ("RADAU", "BDF")
CONTROLLERS = ("state", "float32")
COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct", "njev", "nlu")
FINAL = ("t", "y") + COUNTERS
ROWS = ("rec_t", "rec_y", "rec_xold", "rec_h", "rec_cont")
TIMES = ("t", "rec_t", "rec_xold", "rec_h")   # held on the time scale


def build_libs(tmp_dir: Path) -> dict:
    """This tree's radau.cu and bdf.cu built with g++ into ``tmp_dir``, their
    ``ENTRIES`` only: ``{method: library}``."""
    spec = importlib.util.spec_from_file_location("gxx", ROOT / "gxx.py")
    gxx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gxx)
    src = tmp_dir / "csrc"
    shutil.copytree(build.SRC_DIR, src)
    for name, macro in (("radau", "IVP_RADAU_ENTRY("),
                        ("bdf", "IVP_BDF_ENTRY(")):
        cu = src / f"{name}.cu"
        keep = tuple(f"{macro}{e}," for e in ENTRIES)
        cu.write_text("".join(
            ln for ln in cu.read_text().splitlines(keepends=True)
            if not ln.startswith(macro) or ln.startswith(keep)))
    paths = gxx.build_all(src, tmp_dir / "out", ["radau", "bdf"])
    return {m: build.load(paths[m.lower()]) for m in METHODS}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel sources as host code")
    return build_libs(tmp_path_factory.mktemp("gxx_stiff_modes"))


def T(a):
    return torch.tensor(np.asarray(a, dtype=float), dtype=F64)


def stiff_y0(lanes):
    """bench.py's stiff y0: [2, 0] + 0.02 N(0, 1) from seed 0."""
    rng = np.random.default_rng(0)
    return np.array([2.0, 0.0]) + 0.02 * rng.standard_normal((lanes, 2))


def robertson_y0(lanes):
    rng = np.random.default_rng(4)
    y0 = np.zeros((lanes, 3))
    y0[:, 0] = 1e4 * (1.0 + 1e-3 * rng.standard_normal(lanes))
    return y0


def inputs(fun, y0, tf, rtol, atol, args, max_steps=100_000):
    """The per-lane arguments of every route, from the functor to
    ``max_steps``."""
    n = y0.shape[0]
    lanes = lambda v: torch.full((n,), float(v), dtype=F64)  # noqa: E731
    return (fun, T(y0), lanes(0.0), lanes(tf), lanes(tf), None,
            torch.full((n, fun.n), rtol, dtype=F64),
            torch.full((n, fun.n), atol, dtype=F64), args, max_steps)


def vdp(max_steps=100_000):
    return inputs(it.rhs.vdp, stiff_y0(B), TF, RTOL, ATOL, (MU,), max_steps)


def spec_of(method, controller, n=2):
    return stiff_spec(method, n, None, {"controller_precision": controller})


def shared_grid(tf=TF, lanes=B):
    """``M`` points from t0 to tf, as a shared grid's expanded view."""
    return torch.broadcast_to(torch.linspace(0.0, tf, M, dtype=F64),
                              (lanes, M))


def as_dict(out, names):
    return dict(zip(names, out))


def plain_sampled(method, a, grid, spec):
    out = E.erk_ensemble_torch(method, *a, grid, spec, None, counters=True)
    d = as_dict(out[:9], FINAL[:7] + ("y_samples", "n_samples"))
    d.update(njev=out[-1][0], nlu=out[-1][1])
    return d


def kernel_sampled(lib, method, a, grid, spec):
    c = S.stiff_ensemble_cuda(method, *a, spec.params(),
                              torch.zeros(a[1].shape[0], dtype=F64), lib=lib,
                              stream=0, t_grid=grid)
    d = {f: getattr(c, f) for f in FINAL}
    d.update(y_samples=c.sample_y, n_samples=c.s_cursor)
    return d


def kernel_lean(lib, method, a, spec):
    c = S.stiff_ensemble_cuda(method, *a, spec.params(),
                              torch.zeros(a[1].shape[0], dtype=F64), lib=lib,
                              stream=0)
    return {f: getattr(c, f) for f in FINAL}


def record_dict(r):
    return {f: getattr(r, f) for f in FINAL + ROWS
            + ("n_rec", "y_samples", "n_samples")}


def kernel_record(lib, method, a, spec, cap, cont, grid=None):
    r = R.stiff_record_launches(method, *a, grid, spec, cap, cont, 0.0, lib,
                                0)
    return record_dict(r), r.chunks


def plain_record(method, a, spec, cap, cont, grid=None):
    r = R.erk_record_torch(method, *a, grid, spec, rec_cap=cap,
                           record_cont=cont)
    return record_dict(r), r.chunks


# The plain version of each case, once per module run.
@functools.lru_cache(maxsize=None)
def plain_vdp_sampled(method, controller):
    return plain_sampled(method, vdp(), shared_grid(),
                         spec_of(method, controller))


@functools.lru_cache(maxsize=None)
def plain_vdp_record(method, controller):
    return plain_record(method, vdp(), spec_of(method, controller), 7, True)


def scaled_err(got, ref, scale=None):
    """Per lane: max |got - ref| over the lane's entries, over max(1, the
    lane's largest |scale|) (default: |ref|)."""
    g = got.reshape(got.shape[0], -1).numpy()
    r = ref.reshape(ref.shape[0], -1).numpy()
    if g.shape[1] == 0:
        return np.zeros(g.shape[0])
    sc = r if scale is None else scale.reshape(scale.shape[0], -1).numpy()
    return (np.abs(g - r).max(axis=1)
            / np.maximum(1.0, np.abs(sc).max(axis=1)))


def assert_matches(got, ref, share=1.0, counts=(), arrays=("y",),
                   tol=(1e-7, 1e-7), lanes=None):
    """Status, every counter and the ``counts`` equal on at least ``share``
    of the lanes (every lane when 1); on those lanes (and in ``lanes`` if
    given) each of ``arrays`` within ``tol`` (final y and samples, rows) of
    max(1, |ref|), the time fields of max(1, |t|) of the lane's times.
    Returns the share."""
    same = np.ones(got["status"].shape[0], bool)
    for f in COUNTERS + tuple(counts):
        same &= (got[f] == ref[f]).numpy()
    frac = float(np.mean(same))
    assert frac >= share, (frac, {f: (got[f], ref[f])
                                  for f in COUNTERS + tuple(counts)})
    on = same if lanes is None else same & lanes
    for f in arrays:
        assert got[f].shape == ref[f].shape, (f, got[f].shape, ref[f].shape)
        times = ref["rec_t"] if f.startswith("rec_") else ref["t"]
        err = scaled_err(got[f], ref[f], times if f in TIMES else None)[on]
        bound = tol[1] if f.startswith("rec_") else tol[0]
        assert np.all(err <= bound), (f, err.max())
    return frac


def assert_bitwise(got, ref, fields):
    for f in fields:
        a, b = got[f], ref[f]
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.shape == b.shape and torch.equal(a, b), f


def share_of(method, controller):
    return BDF_F32_SHARE if (method, controller) == ("BDF", "float32") \
        else 1.0


# ---------------------------------------------------------------------------
# SAMPLED
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("method", METHODS)
def test_sampled_matches_plain(libs, method, controller):
    """A shared grid from t0 to tf: every sample against the plain
    version's, and the final state against the LEAN mode's bit for bit."""
    spec = spec_of(method, controller)
    got = kernel_sampled(libs[method], method, vdp(), shared_grid(), spec)
    ref = plain_vdp_sampled(method, controller)
    assert_matches(got, ref, share_of(method, controller), ("n_samples",),
                   ("y", "y_samples"), TOL[method, controller])
    assert bool((got["n_samples"] == M).all())
    assert_bitwise(got, kernel_lean(libs[method], method, vdp(), spec), FINAL)


@pytest.mark.parametrize("method", METHODS)
def test_per_lane_grid(libs, method):
    """Each lane its own grid, ending before, at and (clipped) at tf, and
    sparser than the steps on some lanes and denser on others."""
    rng = np.random.default_rng(3)
    ends = TF * rng.uniform(0.5, 1.0, B)
    ends[:3] = TF
    grid = T(np.stack([np.sort(np.concatenate(
        [[0.0], rng.uniform(0.0, e, M - 2), [e]])) for e in ends]))
    spec = spec_of(method, "state")
    got = kernel_sampled(libs[method], method, vdp(), grid, spec)
    ref = plain_sampled(method, vdp(), grid, spec)
    assert_matches(got, ref, 1.0, ("n_samples",), ("y", "y_samples"))


# Step budgets that stop about half the lanes mid-span (nstep over [0, 1000]:
# Radau 142-151, BDF 322-370).
BUDGET = {"RADAU": 147, "BDF": 340}


@pytest.mark.parametrize("method", METHODS)
def test_step_budget_mid_span(libs, method):
    """A ``max_steps`` that stops some lanes mid-span: their status, their
    count of samples (below the grid's), the samples and the unwritten rows
    past them (zero) are the plain version's.  A stopped lane's final t is
    held on its time scale and its y not at all: it ends wherever its last
    step did, which the host's libm moves by the last bits of the step
    sizes (on the relaxation jump, 1e-7 in y)."""
    a = vdp(max_steps=BUDGET[method])
    spec = spec_of(method, "state")
    got = kernel_sampled(libs[method], method, a, shared_grid(), spec)
    ref = plain_sampled(method, a, shared_grid(), spec)
    stopped = got["status"] == Status.NEED_LARGER_NMAX
    assert_matches(got, ref, 1.0, ("n_samples",), ("t", "y_samples"))
    assert_matches(got, ref, 1.0, ("n_samples",), ("y",),
                   lanes=~stopped.numpy())
    assert 0 < int(stopped.sum()) < B
    assert bool((got["n_samples"][stopped] < M).all())
    past = (torch.arange(M)[None, :] >= got["n_samples"][:, None])
    assert bool((got["y_samples"][past] == 0.0).all())


@pytest.mark.parametrize("method", METHODS)
def test_robertson_log_grid(libs, method):
    """Robertson (n = 3) over [0, 1e8] sampled at 0 and on 40 log-spaced
    times, with its conservation law."""
    lanes = 8
    a = inputs(it.rhs.robertson, robertson_y0(lanes), 1e8, 1e-6, 1e-6, ())
    grid = torch.broadcast_to(T(np.concatenate(
        [[0.0], np.logspace(-6, 8, 40)])), (lanes, 41))
    spec = spec_of(method, "state", n=3)
    got = kernel_sampled(libs[method], method, a, grid, spec)
    ref = plain_sampled(method, a, grid, spec)
    assert_matches(got, ref, 1.0, ("n_samples",), ("y", "y_samples"))
    assert bool((got["status"] == Status.SUCCESS).all())
    assert bool((got["n_samples"] == 41).all())
    s0 = a[1].sum(dim=1)[:, None]
    np.testing.assert_allclose(got["y_samples"].sum(dim=2).numpy(),
                               torch.broadcast_to(s0, (lanes, 41)).numpy(),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# RECORD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("method", METHODS)
def test_record_matches_plain(libs, method, controller):
    """Chunks of ``rec_cap=7`` with and without coefficients against the
    plain version's record mode (the same chunks), and the final state
    against the LEAN mode's bit for bit."""
    spec = spec_of(method, controller)
    ref, ref_chunks = plain_vdp_record(method, controller)
    share = share_of(method, controller)
    lean = kernel_lean(libs[method], method, vdp(), spec)
    for cont in (True, False):
        got, chunks = kernel_record(libs[method], method, vdp(), spec, 7,
                                    cont)
        rows = ROWS if cont else ROWS[:-1]
        frac = assert_matches(got, ref, share, ("n_rec",), ("y",) + rows,
                              TOL[method, controller])
        if frac == 1.0:
            assert chunks == ref_chunks
        assert (got["rec_cont"] is None) == (not cont)
        assert_bitwise(got, lean, FINAL)
        # The last row of each lane is its final state.
        k = got["n_rec"] - 1
        assert torch.equal(got["rec_y"][torch.arange(B), k], got["y"])


@pytest.mark.parametrize("method", METHODS)
def test_record_chunks_bitwise(libs, method):
    """Chunks of 7 rows against one chunk: every row, every sample of a
    grid recorded with them (the cursor continues across launches) and the
    final state bit for bit, and the samples those of the SAMPLED mode."""
    spec = spec_of(method, "float32")
    one, n1 = kernel_record(libs[method], method, vdp(), spec, 4096, True,
                            shared_grid())
    many, n7 = kernel_record(libs[method], method, vdp(), spec, 7, True,
                             shared_grid())
    assert n1 == 1 and n7 > 10
    assert_bitwise(many, one, FINAL + ROWS + ("n_rec", "y_samples",
                                              "n_samples"))
    sampled = kernel_sampled(libs[method], method, vdp(), shared_grid(), spec)
    assert_bitwise(many, sampled, FINAL + ("y_samples", "n_samples"))
