"""The stiff kernels' event modes on the CPU: g++ builds (gxx.py) of
``csrc/radau_ev.cu`` and ``csrc/bdf_ev.cu`` launched on CPU tensors with
stream 0 through ``kernels/stiff_ensemble.py::stiff_ensemble_cuda`` (LEAN,
SAMPLED) and ``kernels/erk_record.py::stiff_record_launches`` (RECORD, with
coefficients and without, in chunks of 5 rows), against the plain version
(the driver with events, core/driver.py, core/events.py), under
``controller_precision="state"``.

The cases, on the two stiff event sets (ivp_tpu_torch/events.py):

* ``overflow``: VdP at mu in [80, 120] over [0, 300] with ``crossing``
  (two downward crossings a lane) and an event capacity of 1;
* ``terminal``: the same with ``crossing`` terminal at its second
  occurrence, which stops each lane before tend;
* ``replenish``: decay at k in [40, 90] over ten periods at k = 50, refilled
  to 1 at y = 0.5 (terminal, restarted, ``max_restarts=20``): on BDF each
  restart counts one Jacobian (njev + 1, the driver's init_njev);
* ``budget``: the same with ``max_restarts=3``, whose fourth crossing ends
  the lane before tend.

Held, on every lane and in every mode: status, nfev, nstep, naccpt,
nrejct, njev, nlu, ``n_events``, ``n_restarts``, the overflow flags,
``n_samples`` and ``n_rec`` equal; Radau's t, y, event times and states,
samples, rows and Brent's evaluations bit for bit; BDF's (whose step
sizes round apart in the host libm's last bits, as in
tests/test_torch_stiff_modes.py) event times within 1e-9 and the rest
within that file's ``TOL`` (1e-7) of their scale (max(1, the lane's
largest |x|), and for times max(1, |t|) of the lane's end).

Two copies of ``bdf.cuh`` with a fault each must fail these checks: one
whose events and emission read the interpolant after ``change_d`` has
rescaled D, one whose restart drops its Jacobian count.  Skipped without
g++.
"""
import importlib.util
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import Status  # noqa: E402
from ivp_tpu_torch import events as EV  # noqa: E402
from ivp_tpu_torch.events import event_args  # noqa: E402
from ivp_tpu_torch.kernels import build  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as E  # noqa: E402
from ivp_tpu_torch.kernels import erk_record as R  # noqa: E402
from ivp_tpu_torch.kernels import stiff_ensemble as S  # noqa: E402
from ivp_tpu_torch.methods.jacobian import stiff_spec  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64
METHODS = ("RADAU", "BDF")
MODES = ("lean", "sampled", "record", "record_cont")
COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct", "njev", "nlu",
            "n_events", "n_restarts", "event_overflow", "n_samples", "n_rec")
FLOATS = ("t", "y", "t_events", "y_events", "y_samples", "rec_t", "rec_y",
          "rec_xold", "rec_h", "rec_cont")
M, REC_CAP = 9, 5
T_TOL, Y_TOL = 1e-9, 1e-7
PERIOD = np.log(2.0) / 50.0

# A fault each in a copy of bdf.cuh: (the text, its replacement).
FAULTS = {
    # change_d before the events and the emission read D (a factor of 1
    # left for the loop's own call, which then returns at once).
    "interp_after_change_d": (
        "    const Slots<T> D = s.at(K::D);\n    const auto interp",
        "    change_d<N, T>(s.at(K::D), L.order, factor);\n"
        "    factor = 1.0;\n"
        "    const Slots<T> D = s.at(K::D);\n    const auto interp"),
    # the restart's Jacobian not counted.
    "restart_njev_dropped": ("        je += o.const_jac ? 0 : 1;\n", ""),
}


def T(a):
    return torch.tensor(np.asarray(a, dtype=float), dtype=F64)


def build_libs(tmp_dir: Path, fault: str = None) -> dict:
    """This tree's radau_ev.cu and bdf_ev.cu built with g++ (a copy of
    ``csrc`` with ``FAULTS[fault]`` in bdf.cuh, bdf_ev.cu alone, where
    given): ``{method: library}``."""
    spec = importlib.util.spec_from_file_location("gxx", ROOT / "gxx.py")
    gxx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gxx)
    src = build.SRC_DIR
    names = ["radau_ev", "bdf_ev"]
    if fault is not None:
        src = tmp_dir / "csrc"
        shutil.copytree(build.SRC_DIR, src)
        old, new = FAULTS[fault]
        text = (src / "bdf.cuh").read_text()
        assert text.count(old) == 1, fault
        (src / "bdf.cuh").write_text(text.replace(old, new))
        names = ["bdf_ev"]
    paths = gxx.build_all(src, tmp_dir / "out", names)
    return {m: build.load(paths[f"{m.lower()}_ev"]) for m in METHODS
            if f"{m.lower()}_ev" in paths}


def need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel sources as host code")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    need_gxx()
    return build_libs(tmp_path_factory.mktemp("gxx_stiff_ev"))


@pytest.fixture(scope="module")
def fault_libs(tmp_path_factory):
    need_gxx()
    with ThreadPoolExecutor(len(FAULTS)) as ex:
        futs = {f: ex.submit(build_libs, tmp_path_factory.mktemp(f), f)
                for f in FAULTS}
        return {f: fut.result()["BDF"] for f, fut in futs.items()}


def vdp_case(events, cap):
    B = 6
    rng = np.random.default_rng(3)
    y0 = np.array([2.0, 0.0]) + 0.02 * rng.standard_normal((B, 2))
    mu = np.linspace(80.0, 120.0, B)
    lanes = lambda v: torch.full((B,), float(v), dtype=F64)  # noqa: E731
    a = (it.rhs.vdp, T(y0), lanes(0.0), lanes(300.0), lanes(300.0), None,
         torch.full((B, 2), 1e-4, dtype=F64),
         torch.full((B, 2), 1e-6, dtype=F64), (T(mu),), 100_000)
    return a, event_args(events, cap, 0)


def decay_case(max_restarts):
    B = 5
    k = np.linspace(40.0, 90.0, B)
    tf = 10 * PERIOD * 1.01
    lanes = lambda v: torch.full((B,), float(v), dtype=F64)  # noqa: E731
    a = (it.rhs.decay, T(np.ones((B, 1))), lanes(0.0), lanes(tf), lanes(tf),
         None, torch.full((B, 1), 1e-8, dtype=F64),
         torch.full((B, 1), 1e-10, dtype=F64), (T(k),), 100_000)
    return a, event_args([EV.replenish], 16, max_restarts)


CASES = {
    "overflow": lambda: vdp_case([EV.vdp_crossing], 1),
    "terminal": lambda: vdp_case([EV.vdp_crossing.replace(terminal=2)], 4),
    "replenish": lambda: decay_case(20),
    "budget": lambda: decay_case(3),
}


def spec_of(method, n):
    return stiff_spec(method, n, None, {"controller_precision": "state"})


def lane_grid(a):
    t0, tf = a[2], a[3]
    return t0[:, None] + (tf - t0)[:, None] * torch.linspace(0.0, 1.0, M,
                                                             dtype=F64)


def events_dict(ev):
    return dict(zip(("t_events", "y_events", "n_events", "event_overflow",
                     "n_restarts", "n_brent"), ev))


def kernel(lib, method, case, mode):
    a, ev = CASES[case]()
    spec = spec_of(method, a[0].n)
    grid = None if mode == "lean" else lane_grid(a)
    if mode in ("lean", "sampled"):
        c = S.stiff_ensemble_cuda(method, *a, spec.params(),
                                  torch.zeros(a[1].shape[0], dtype=F64),
                                  lib=lib, stream=0, t_grid=grid, events=ev)
        d = {f: getattr(c, f) for f in ("t", "y", "status", "nfev", "nstep",
                                        "naccpt", "nrejct", "njev", "nlu")}
        if grid is not None:
            d.update(y_samples=c.sample_y, n_samples=c.s_cursor)
        d.update(events_dict(c.ev))
        return d
    r = R.stiff_record_launches(method, *a, grid, spec, REC_CAP,
                                mode == "record_cont", 0.0, lib, 0,
                                events=ev)
    return record_dict(r)


def record_dict(r):
    d = {f: getattr(r, f) for f in ("t", "y", "status", "nfev", "nstep",
                                    "naccpt", "nrejct", "njev", "nlu",
                                    "y_samples", "n_samples", "n_rec",
                                    "rec_t", "rec_y", "rec_xold", "rec_h",
                                    "rec_cont") if getattr(r, f) is not None}
    d.update(events_dict(r.events))
    return d


_PLAIN = {}


def plain(method, case, mode):
    """The plain version's outputs of a mode: one sampled ensemble solve
    gives LEAN's too (its samples left out), one recording solve with
    coefficients RECORD's (its coefficients left out); the sample mode and
    the coefficients change no step."""
    base = "sampled" if mode in ("lean", "sampled") else "record_cont"
    key = (method, case, base)
    if key not in _PLAIN:
        a, ev = CASES[case]()
        spec = spec_of(method, a[0].n)
        grid = lane_grid(a)
        if base == "sampled":
            out = E.erk_ensemble_torch(method, *a, grid, spec, ev,
                                       counters=True)
            d = dict(zip(("t", "y", "status", "nfev", "nstep", "naccpt",
                          "nrejct", "y_samples", "n_samples"), out[:9]))
            d.update(events_dict(out[9]), njev=out[-1][0], nlu=out[-1][1])
        else:
            d = record_dict(R.erk_record_torch(method, *a, grid, spec,
                                               REC_CAP, True, ev))
        _PLAIN[key] = d
    d = dict(_PLAIN[key])
    for f in {"lean": ("y_samples", "n_samples"),
              "record": ("rec_cont",)}.get(mode, ()):
        del d[f]
    return d


# Held on the lane's time scale (tests/test_torch_stiff_modes.py's TIMES).
TIMES = ("t", "t_events", "rec_t", "rec_xold", "rec_h")


def scaled(got, ref, scale=None):
    """Per lane, |got - ref| over max(1, the lane's largest |ref|), or over
    max(1, the lane's ``scale`` ``(B,)``), as test_torch_stiff_modes.py's
    scaled_err."""
    g = got.reshape(got.shape[0], -1).numpy()
    r = ref.reshape(ref.shape[0], -1).numpy()
    if g.shape[1] == 0:
        return np.zeros(g.shape)
    s = (np.abs(r).max(axis=1) if scale is None
         else np.abs(scale.numpy()))[:, None]
    return np.abs(g - r) / np.maximum(1.0, s)


def check(method, got, ref):
    """AssertionError unless ``got`` holds ``ref``'s counters on every lane
    and its floats bit for bit (Radau) or within their bounds (BDF)."""
    assert set(got) == set(ref), (set(got) ^ set(ref))
    for f in COUNTERS:
        if f in ref:
            assert torch.equal(got[f], ref[f]), (f, got[f], ref[f])
    for f in FLOATS:
        if f not in ref:
            continue
        g, r = got[f], ref[f]
        assert g.shape == r.shape, f
        if method == "RADAU":
            same = (g == r) | (torch.isnan(g) & torch.isnan(r))
            assert bool(same.all()), f
        else:
            err = scaled(g, r, ref["t"] if f in TIMES else None)
            assert np.all(err <= (T_TOL if f == "t_events" else Y_TOL)), (
                f, err.max())
    if method == "RADAU":
        assert torch.equal(got["n_brent"], ref["n_brent"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", METHODS)
def test_event_modes_match_plain(libs, method, case, mode):
    ref = plain(method, case, mode)
    check(method, kernel(libs[method], method, case, mode), ref)
    # What each case is there for.
    n_ev, st = ref["n_events"][:, 0], ref["status"]
    if case == "overflow":
        assert bool(ref["event_overflow"].all()) and bool((n_ev == 1).all())
    elif case == "terminal":
        assert bool((st == Status.USER_INTERRUPT).all())
        assert bool((n_ev == 2).all()) and bool((ref["t"] < 300.0).all())
    elif case == "replenish":
        assert bool((st == Status.SUCCESS).all())
        assert bool((ref["n_restarts"] >= 8).all())
        if method == "BDF":
            # Each restart's init counts its Jacobian.
            lean = ref["njev"] - ref["n_restarts"]
            assert bool((lean >= 0).all()) and bool((ref["njev"] > lean).all())
    else:
        assert bool((st == Status.USER_INTERRUPT).all())
        assert bool((ref["n_restarts"] == 3).all()) and bool((n_ev == 4).all())


@pytest.mark.parametrize("fault, case, mode", [
    ("interp_after_change_d", "overflow", "sampled"),
    ("interp_after_change_d", "replenish", "lean"),
    ("restart_njev_dropped", "replenish", "lean"),
])
def test_faulty_copies_fail(fault_libs, fault, case, mode):
    """A copy of bdf.cuh with a fault fails the checks above."""
    got = kernel(fault_libs[fault], "BDF", case, mode)
    with pytest.raises(AssertionError):
        check("BDF", got, plain("BDF", case, mode))
