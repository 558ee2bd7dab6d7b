"""The stiff kernels' fast-path units on the CPU: g++ builds of
``csrc/radau.cu`` and ``csrc/bdf.cu`` (gxx.py; the VdP and decay entries
only) launched through ``kernels/stiff_ensemble.py::stiff_ensemble_cuda``
and ``kernels/erk_record.py::stiff_record_launches`` on CPU tensors with
stream 0.

Each attempt runs its divisions, square roots and powers in units on
FastCtl's fast paths, then, on a lane where an operand left their range,
on the wide paths (zeros, infinities, NaNs and operands below a range by
selects and scalings), then through the library's operations where those
left theirs too (``FastOps`` / ``WideOps`` / ``LibOps``, ``run_unit`` in
``csrc/stiff_common.cuh``).  The lanes here reach every level: decay from
y0 = 1e200 (the inverse scale's divisor leaves every range: Radau's head,
BDF's head and tail), from a first step of 4e-308 (h as a divisor: Radau's
decomposition and head), at rate 1e300 (the decomposition's entries), at a
NaN rate (BDF's iteration matrix), under newton_tol 1e-25 (held within the
build only), and float32 lanes whose norms underflow or overflow (the wide
paths); beside them the singular lanes of measure_kernel.py's
``stiff_cases`` (an exactly singular first decomposition), y0 = 0 (every
increment, error and rate exactly 0: the zero selects), ordinary decay
lanes (per-lane t0, spans, some backward, and tolerances), VdP mu=1000
lanes and a lane that grows from 1e200 backward (``growth_case``).

Held: (1) every lane against the plain version, with
tests/test_torch_stiff_modes.py's bounds and shares (``TOL``,
``BDF_F32_SHARE``); (2) each mode's final t, y, status and counters against
the same build's LEAN mode bit for bit; (3) the build against a copy whose
every unit takes its wide path after its fast one, and one whose every unit
takes the library's, bit for bit on every output and sample (the three
paths of every unit compute the same function);
(4) the y0 = 0 lanes' outputs equal to the plain version's.  Skipped
without g++.
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
from ivp_tpu_torch import Status, tableaus  # noqa: E402
from ivp_tpu_torch.kernels import build  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as E  # noqa: E402
from ivp_tpu_torch.kernels import erk_record as R  # noqa: E402
from ivp_tpu_torch.kernels import stiff_ensemble as S  # noqa: E402
from ivp_tpu_torch.methods.jacobian import stiff_spec  # noqa: E402

from test_torch_stiff_modes import TOL, T, share_of  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64
METHODS = ("RADAU", "BDF")
CONTROLLERS = ("state", "float32")
COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct", "njev", "nlu")
FINAL = ("t", "y") + COUNTERS
ENTRIES = ("vdp", "decay")
M = 9            # grid points a lane
REC_CAP = 7      # rows a record chunk


# A copy's path past the fast paths: "wide" makes every unit's fast paths
# report an operand out of range, so it runs its wide paths (and the
# library's where those report one too); "library" makes every fast and
# wide path report one, so every unit runs the library's.
PATHS = {
    "wide": ("stiff_common.cuh",
             "bool ok() const { return c.ok && d.ok; }",
             "bool ok() const {\n    return std::is_same_v<F<CT>, WideCtl<CT>> && c.ok && d.ok;\n  }"),
    "library": ("erk_common.cuh", "  bool ok = true;\n",
                "  bool ok = false;\n"),
}


def build_libs(tmp_dir: Path, path: str = None) -> dict:
    """This tree's radau.cu and bdf.cu built with g++ into ``tmp_dir``, the
    ``ENTRIES`` only; with ``path`` (``PATHS``) every unit runs its wide or
    library path after its fast one (whose outputs then stand).
    ``{method: library}``."""
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
    if path is not None:
        name, old, new = PATHS[path]
        text = (src / name).read_text()
        assert old in text, (path, name)
        (src / name).write_text(text.replace(old, new))
    paths = gxx.build_all(src, tmp_dir / "out", ["radau", "bdf"])
    return {m: build.load(paths[m.lower()]) for m in METHODS}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel sources as host code")
    return build_libs(tmp_path_factory.mktemp("gxx_stiff_fast"))


@pytest.fixture(scope="module", params=sorted(PATHS))
def path_libs(request, tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel sources as host code")
    return build_libs(tmp_path_factory.mktemp(f"gxx_stiff_{request.param}"),
                      request.param)


def decay_lanes(rate, y0, t0, dt, first=None, rtol=None, atol=None):
    """Decay lanes at a shared ``rate``, each with its own y0, t0, span
    (``dt``, negative backward) and, if given, first step and tolerances
    (default 1e-6 and 1e-9)."""
    B = len(y0)
    rtol = np.full(B, 1e-6) if rtol is None else rtol
    atol = np.full(B, 1e-9) if atol is None else atol
    t0, dt = np.asarray(t0, float), np.asarray(dt, float)
    return (it.rhs.decay, T(np.asarray(y0, float)[:, None]), T(t0),
            T(t0 + dt), T(np.abs(dt)), None if first is None else T(first),
            T(rtol[:, None]), T(atol[:, None]), (rate,), 100_000)


def ordinary(rng, B):
    """y0, t0, spans (every third backward) and tolerances of ``B``
    ordinary lanes."""
    dt = 5.0 * rng.uniform(0.5, 1.0, B)
    dt[1::3] *= -1.0
    return (rng.uniform(0.5, 2.0, B), rng.uniform(-1.0, 1.0, B), dt,
            10.0 ** rng.uniform(-8, -4, B), 10.0 ** rng.uniform(-10, -6, B))


def decay_case(method):
    """y0 = 1e200 (two lanes), y0 = 0 (two), then ordinary lanes; the
    method picks the first step."""
    y0, t0, dt, rt, at = ordinary(np.random.default_rng(17), 6)
    k = 4
    a = decay_lanes(20.0, [1e200, 1e200, 0.0, 0.0, *y0],
                    [0.0, -1.0, 0.0, 2.0, *t0], [5.0, 5.0, 5.0, 5.0, *dt],
                    None, np.r_[np.full(k, 1e-6), rt],
                    np.r_[np.full(k, 1e-9), at])
    return a, np.arange(10) < k, np.isin(np.arange(10), (2, 3))


def first_step_case(method):
    """A first step of 4e-308 (two lanes), then ordinary lanes from given
    first steps."""
    rng = np.random.default_rng(18)
    y0, t0, dt, rt, at = ordinary(rng, 4)
    first = np.r_[4e-308, 4e-308, 10.0 ** rng.uniform(-6, -3, 4)]
    a = decay_lanes(20.0, [1.0, 1.0, *y0], [0.0, 0.0, *t0],
                    [5.0, -5.0, *dt], first, np.r_[1e-6, 1e-6, rt],
                    np.r_[1e-9, 1e-9, at])
    return a, np.arange(6) < 2, np.zeros(6, bool)


def singular_case(method):
    """Rate -1 from a first step whose first decomposition is exactly
    singular (U1 for Radau, alpha_1 for BDF), over [0, 30], and from
    0.01."""
    first = (tableaus.RADAU_U1 if method == "RADAU"
             else float(tableaus.BDF_ALPHA[1]))
    a = decay_lanes(-1.0, [1.0, 1.0], [0.0, 0.0], [30.0, 30.0],
                    [first, 0.01])
    return a, np.ones(2, bool), np.zeros(2, bool)


def nan_rate_case(method):
    """A NaN rate over [0, 1] (singular at every attempt), forward and
    backward."""
    a = decay_lanes(float("nan"), [1.0, 1.0], [0.0, 0.0], [1.0, -1.0],
                    [0.01, 0.01])
    return a, np.ones(2, bool), np.zeros(2, bool)


def growth_case(method):
    """y0 = 1e200 integrated backward over [-1, -6] at rate 20, where it
    grows to 1e243.  Held to the plain version: the two routes parted at
    Radau's 53rd attempt under the state controller (nfev 2452 against
    2455) while the plain version took torch's CPU square root, which is
    not correctly rounded (sqrt(sqrt(err)) one ulp apart); it takes
    core/common.py::sqrt_rn since, the kernels' sqrt.rn."""
    a = decay_lanes(20.0, [1e200], [-1.0], [-5.0])
    return a, np.ones(1, bool), np.zeros(1, bool)


def newton_tol_case(method):
    """Under newton_tol 1e-25 (``CASE_OPTIONS``), forward over [0, 1] and
    [0, 0.5].  No iteration converges, the step shrinks and grows over
    thousands of attempts, and the plain version on the CPU takes minutes
    for them, so these lanes are held within the build only."""
    a = decay_lanes(20.0, [1.0, 2.0], [0.0, 0.0], [1.0, 0.5])
    return a, np.ones(2, bool), np.zeros(2, bool)


def huge_rate_case(method):
    """Rate 1e300 over [0, 5] and [0, 1]."""
    a = decay_lanes(1e300, [1.0, 1.0], [0.0, 0.0], [5.0, 1.0])
    return a, np.ones(2, bool), np.zeros(2, bool)


def vdp_lanes():
    """VdP mu=1000 from [2, 0] + 0.02 N(0, 1) over [0, 30]; no edge
    lanes."""
    rng = np.random.default_rng(0)
    y0 = np.array([2.0, 0.0]) + 0.02 * rng.standard_normal((6, 2))
    n = y0.shape[0]
    lanes = lambda v: torch.full((n,), float(v), dtype=F64)  # noqa: E731
    a = (it.rhs.vdp, T(y0), lanes(0.0), lanes(30.0), lanes(30.0), None,
         torch.full((n, 2), 1e-4, dtype=F64),
         torch.full((n, 2), 1e-6, dtype=F64), (1000.0,), 100_000)
    return a, np.zeros(n, bool), np.zeros(n, bool)


# case -> (arguments from the functor to max_steps, the edge lanes, which
# must end as the plain version's, the y0 = 0 lanes).
CASES = {"decay": decay_case, "first_step": first_step_case,
         "singular": singular_case, "nan_rate": nan_rate_case,
         "huge_rate": huge_rate_case, "vdp": lambda m: vdp_lanes(),
         "growth": growth_case}
# The solver options of a case besides the controller type.
CASE_OPTIONS = {"newton_tol": {"newton_tol": 1e-25}}
# Held within the build only (newton_tol_case).
BUILD_CASES = dict(CASES, newton_tol=newton_tol_case)


def spec_of(method, controller, case):
    n = 2 if case == "vdp" else 1
    return stiff_spec(method, n, None, {"controller_precision": controller,
                                        **CASE_OPTIONS.get(case, {})})


def lane_grid(a):
    """``M`` points from each lane's t0 to its tf, a per-lane grid."""
    t0, tf = a[2], a[3]
    return t0[:, None] + (tf - t0)[:, None] * torch.linspace(0.0, 1.0, M,
                                                             dtype=F64)


def kernel(lib, method, a, spec, grid=None):
    c = S.stiff_ensemble_cuda(method, *a, spec.params(),
                              torch.zeros(a[1].shape[0], dtype=F64), lib=lib,
                              stream=0, t_grid=grid)
    d = {f: getattr(c, f) for f in FINAL}
    if grid is not None:
        d.update(y_samples=c.sample_y, n_samples=c.s_cursor)
    return d


def kernel_record(lib, method, a, spec, cont):
    r = R.stiff_record_launches(method, *a, lane_grid(a), spec, REC_CAP,
                                cont, 0.0, lib, 0)
    return {f: getattr(r, f) for f in FINAL + ("y_samples", "n_samples",
                                               "n_rec", "rec_t", "rec_y")}


@functools.lru_cache(maxsize=None)
def plain(method, controller, case):
    a = CASES[case](method)[0]
    out = E.erk_ensemble_torch(method, *a, lane_grid(a),
                               spec_of(method, controller, case), None,
                               counters=True)
    d = dict(zip(FINAL[:7] + ("y_samples", "n_samples"), out[:9]))
    d.update(njev=out[-1][0], nlu=out[-1][1])
    return d


def scaled_err(got, ref):
    g = got.reshape(got.shape[0], -1).numpy()
    r = ref.reshape(ref.shape[0], -1).numpy()
    if g.shape[1] == 0:
        return np.zeros(g.shape[0])
    diff = np.where(np.isnan(g) & np.isnan(r), 0.0, np.abs(g - r))
    return diff.max(axis=1) / np.maximum(1.0, np.nan_to_num(
        np.abs(r), nan=1.0).max(axis=1))


def assert_bitwise(got, ref, fields):
    for f in fields:
        a, b = got[f], ref[f]
        assert a.shape == b.shape, f
        if a.is_floating_point():
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            same &= torch.signbit(a) == torch.signbit(b)
            assert bool(same.all()), f
        else:
            assert torch.equal(a, b), f


@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("method", METHODS)
def test_edge_lanes_match_plain(libs, method, controller):
    """Every case's lanes, sampled on their own grids, against the plain
    version: status, every counter and n_samples equal on every lane (BDF
    under float32: on BDF_F32_SHARE of them), final y and samples within
    TOL; the edge lanes end as the plain version's."""
    for case in CASES:
        a, edge, _ = CASES[case](method)
        spec = spec_of(method, controller, case)
        got = kernel(libs[method], method, a, spec, lane_grid(a))
        ref = plain(method, controller, case)
        same = np.ones(a[1].shape[0], bool)
        for f in COUNTERS + ("n_samples",):
            same &= (got[f] == ref[f]).numpy()
        assert np.mean(same) >= share_of(method, controller), (case, same)
        assert same[edge].all(), (case, got["status"], ref["status"])
        for f in ("y", "y_samples"):
            err = scaled_err(got[f], ref[f])[same]
            assert np.all(err <= TOL[method, controller][0]), (case, f, err)


@pytest.mark.parametrize("mode", ("sampled", "record", "record_cont"))
@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("method", METHODS)
def test_modes_match_lean(libs, method, controller, mode):
    """Each mode's final t, y, status and counters bit for bit with the
    same build's LEAN mode on every case (the emission changes no step)."""
    for case in BUILD_CASES:
        a = BUILD_CASES[case](method)[0]
        spec = spec_of(method, controller, case)
        lean = kernel(libs[method], method, a, spec)
        got = (kernel(libs[method], method, a, spec, lane_grid(a))
               if mode == "sampled" else
               kernel_record(libs[method], method, a, spec,
                             mode == "record_cont"))
        assert_bitwise(got, lean, FINAL)


@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("method", METHODS)
def test_paths_same_bits(libs, path_libs, method, controller):
    """The build against a copy in which every unit runs its wide path, and
    one in which it runs the library's, after its fast one (``PATHS``):
    every final field, sample and row bit for bit on every case, lean,
    sampled and recorded."""
    for case in BUILD_CASES:
        a = BUILD_CASES[case](method)[0]
        spec = spec_of(method, controller, case)
        fast = kernel(libs[method], method, a, spec, lane_grid(a))
        lib = kernel(path_libs[method], method, a, spec, lane_grid(a))
        assert_bitwise(fast, lib, FINAL + ("y_samples", "n_samples"))
        fast = kernel_record(libs[method], method, a, spec, True)
        lib = kernel_record(path_libs[method], method, a, spec, True)
        assert_bitwise(fast, lib, tuple(fast))


@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("method", METHODS)
def test_zero_error_lanes(libs, method, controller):
    """The y0 = 0 lanes (every increment, error and rate exactly 0) end as
    the plain version's: SUCCESS at tf, y and every sample 0, every counter
    equal."""
    a, _, zero = CASES["decay"](method)
    spec = spec_of(method, controller, "decay")
    got = kernel(libs[method], method, a, spec, lane_grid(a))
    ref = plain(method, controller, "decay")
    z = torch.as_tensor(zero)
    assert bool((got["status"][z] == Status.SUCCESS).all())
    assert torch.equal(got["t"][z], a[3][z])
    for f in FINAL + ("y_samples", "n_samples"):
        assert torch.equal(got[f][z], ref[f][z]), f
    assert bool((got["y_samples"][z] == 0.0).all())
