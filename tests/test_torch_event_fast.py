"""Brent's divisions on their fast paths and RK23's deferred crossings, on
the CPU: g++ builds (gxx.py) of the event entries of ``csrc/erk_rk23.cu``
and ``csrc/erk_dopri5.cu``, launched through
``kernels/erk_ensemble.py::ensemble_launch`` and
``kernels/erk_record.py::record_launches`` on CPU tensors, against the
plain version and against ivp_tpu.

Brent's iteration (``erk_common.cuh``'s ``ev_brent``) runs its quotients
and the interpolant's time ratio straight-line on ``FastCtl<double>``
(``brent_step``, each method's ``interp_at``) and takes the library's
divisions, on the same operands, where one leaves the fast path's range.
Each build here counts the iterations that take the library's path; a
second build of each source takes it on every iteration, with one queue
slot a lane, and every case holds the two bit for bit.  RK23's event attempt runs the
fast-path chain with its rows written out operation for operation, and its
crossings on the Lorenz section queue and are resolved by the warp (here
one lane at a time, when the lane's own slots are full and after the loop).

The cases: the Lorenz section by RK23 over a span whose crossings fill a
lane's queue several times, with every crossing, the third terminal
(queued, and the lane moved back to it), both directions, and a buffer of
2 (overflow); the ball with its restarts by RK23 and DOPRI5, lean and
recorded with coefficients in chunks of 7 rows; the ball scaled by 1e160,
whose event values lie beyond the fast paths' 2^500, so that most Brent
iterations take the library's divisions; and the ball thrown up from
the ground with both directions, whose event value is an exact zero at the
first step's start: Brent returns that end at once (an exact zero never
reaches an iteration, so it cannot send one to the library's path).
Bounds, per lane (tests/test_torch_events_lorenz.py's): status,
``n_events``, ``n_restarts``, the overflow flags and every counter equal;
event times within 1e-10 scaled by max(1, |t|); event, final and recorded
states within 1e-8 scaled by max(1, |y|) (the scaled ball's by its state's
largest component).  Skipped without g++.
"""
import ctypes
import functools
import importlib.util
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402,F401  (enables x64)
from ivp_tpu.batch import build_ensemble_solver as jax_build  # noqa: E402

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import events as E  # noqa: E402
from ivp_tpu_torch.events import EventArgs  # noqa: E402
from ivp_tpu_torch.kernels import build  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as K  # noqa: E402
from ivp_tpu_torch.kernels import erk_record as R  # noqa: E402
from ivp_tpu_torch.methods.erk import make_engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B = 13          # lanes: no whole block of the kernels' 64 threads
T_EV, Y_EV = 1e-10, 1e-8
F64 = torch.float64
SOURCES = ("erk_rk23", "erk_dopri5")
# Brent's branch to the library's divisions, and what the builds make of it.
SLOW = "    if (!fast.ok) {\n      Ctl<double> lib;\n"
COUNTED = ("    if (!fast.ok) {\n      ++ivp_brent_library_runs;\n"
           "      Ctl<double> lib;\n")
FORCED = "    if (true) {\n      Ctl<double> lib;\n"
# The deferred crossings' slot budget, and one that leaves a lane one slot
# (every crossing resolved by the warp at once, in the loop).
QUEUE = "constexpr int EVQ_BYTES = 200 * 1024;\n"
QUEUE_ONE = "constexpr int EVQ_BYTES = 1;\n"
COUNTER = ("long long ivp_brent_library_runs = 0;\n"
           "namespace ivp {\n")
COUNTER_ENTRY = ('extern "C" long long ivp_brent_runs() {\n'
                 "  const long long n = ivp_brent_library_runs;\n"
                 "  ivp_brent_library_runs = 0;\n  return n;\n}\n")
LORENZ_ARGS = (10.0, 28.0, 8.0 / 3.0)
SECTION_TOL = (1e-6, 1e-8)     # chip_smoke.py's EVENT_LORENZ for RK23
SECTION_TF = 6.0
BALL_TOL = 1e-9
COR = 0.8


def _copy(src, dst, old, new, queue=None):
    """A copy of the csrc tree ``src`` whose erk_common.cuh has ``new`` for
    Brent's branch ``old`` (and ``queue`` for the deferred crossings' slot
    budget, if given), with the counter, and only the event entries of the
    two sources."""
    shutil.copytree(src, dst)
    common = dst / "erk_common.cuh"
    text = common.read_text()
    assert text.count(old) == 1 and text.count("namespace ivp {\n") == 1
    text = text.replace(old, new).replace("namespace ivp {\n", COUNTER)
    if queue is not None:
        assert text.count(QUEUE) == 1
        text = text.replace(QUEUE, queue)
    common.write_text(text)
    for name in SOURCES:
        cu = dst / f"{name}.cu"
        cu.write_text("".join(
            ln for ln in cu.read_text().splitlines(keepends=True)
            if not ln.startswith("IVP_ERK_")
            or ln.startswith(("IVP_ERK_EVENT_ENTRY", "IVP_ERK_LIBRARY")))
            + COUNTER_ENTRY)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """``{"fast": {method: lib}, "library": {method: lib}}``: this tree's
    two sources built with g++ as they are (Brent's library path counted)
    and with that path taken on every iteration."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel sources as host code")
    spec = importlib.util.spec_from_file_location("gxx", ROOT / "gxx.py")
    gxx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gxx)
    kinds = {"fast": (COUNTED, None), "library": (FORCED, QUEUE_ONE)}
    dirs = {}
    for kind, (new, queue) in kinds.items():
        dirs[kind] = tmp_path_factory.mktemp(f"ev_{kind}") / "csrc"
        _copy(build.SRC_DIR, dirs[kind], SLOW, new, queue)
    with ThreadPoolExecutor(len(kinds)) as ex:
        built = dict(zip(kinds, ex.map(
            lambda k: gxx.build_all(dirs[k], dirs[k].parent / "gxx",
                                    list(SOURCES)), kinds)))
    out = {}
    for kind, paths in built.items():
        out[kind] = {m: build.load(paths[name]) for m, name in
                     (("RK23", "erk_rk23"), ("DOPRI5", "erk_dopri5"))}
        for lib in out[kind].values():
            lib.ivp_brent_runs.restype = ctypes.c_longlong
    return out


def solve_args(y0, tf):
    T = lambda v: torch.full((y0.shape[0],), v, dtype=F64)
    return (y0, T(0.0), T(tf), T(tf), None)


def tols(y0, rtol, atol):
    return (torch.full(y0.shape, rtol, dtype=F64),
            torch.full(y0.shape, atol, dtype=F64))


def lorenz_y0(seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.array([1.0, 1.0, 1.0])
                           + rng.standard_normal((B, 3)))


def ball_y0(h0=2.0, h1=20.0, v0=0.0):
    return torch.as_tensor(np.stack([np.linspace(h0, h1, B),
                                     np.full(B, v0)], axis=1))


def case_args(fun, y0, tf, rtol, atol):
    y0t, t0, tft, hmax, first = solve_args(y0, tf)
    rt, at = tols(y0, rtol, atol)
    return (fun, y0t, t0, tft, hmax, first, rt, at)


def lean(lib, method, a, ev, params=None, args=()):
    """One event-mode launch through ``lib`` on CPU tensors: ``(the nine
    outputs, EventOut)``."""
    out = K.ensemble_launch(method, *a, args, 200_000, None, params, lib, 0,
                            ev)
    return out[:9], out[9]


def plain(method, a, ev, params=None, args=()):
    out = K.erk_ensemble_torch(method, *a, args, 200_000, None, params, ev)
    return out[:9], out[9]


def fields(res):
    """Every output and event buffer of a ``lean`` result, by name."""
    out, ev = res
    names = ("t", "y", "status", "nfev", "nstep", "naccpt", "nrejct")
    return {**dict(zip(names, out[:7])), **ev._asdict()}


def same_bits(a, b):
    for f, x in a.items():
        y = b[f]
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        eq = x == y
        if x.is_floating_point():
            eq |= torch.isnan(x) & torch.isnan(y)
        assert bool(eq.all()), f


def assert_close(got, ref, per_state=False, brent=False):
    """Counters, statuses, event counts and flags equal on every lane (with
    ``brent``, Brent's evaluations too); the event times within T_EV and
    the states within Y_EV, each element scaled by max(1, its magnitude),
    or with ``per_state`` by max(1, the largest magnitude of its state), as
    chip_smoke.py scales them (a ball at 1e160 meets the ground at a height
    that is rounding noise of its scale)."""
    g, r = fields(got), fields(ref)
    for f in ("status", "nfev", "nstep", "naccpt", "nrejct", "n_events",
              "n_restarts", "event_overflow") + (("n_brent",) if brent else ()):
        if r[f] is None:   # ivp_tpu's without restarts
            continue
        assert torch.equal(g[f].to(torch.int64), r[f].to(torch.int64)), f
    for f, tol in (("t_events", T_EV), ("y_events", Y_EV), ("t", T_EV),
                   ("y", Y_EV)):
        x, y = g[f], r[f].to(F64)
        mag = y.abs()
        if per_state and f in ("y_events", "y"):
            mag = mag.amax(-1, keepdim=True)
        err = (x - y).abs() / torch.clamp_min(mag, 1.0)
        assert float(err.max()) <= tol, (f, float(err.max()))


def run_both(libs, method, a, ev, params=None, args=()):
    """The fast build's result, held bit for bit to the forced library
    build's (one queue slot a lane), and the fast build's count of Brent
    iterations on the library's path."""
    fast = libs["fast"][method]
    fast.ivp_brent_runs()
    got = lean(fast, method, a, ev, params, args)
    runs = fast.ivp_brent_runs()
    same_bits(fields(got), fields(lean(libs["library"][method], method, a,
                                       ev, params, args)))
    return got, runs


SECTION_CASES = {
    "every": (E.lorenz_section, 64),
    "terminal3": (E.lorenz_section.replace(terminal=3), 64),
    "both_directions": (E.lorenz_section.replace(direction=0), 64),
    "overflow": (E.lorenz_section, 2),
}


@functools.lru_cache(maxsize=None)
def section_plain(case):
    """The plain version's solve of a section case (the overflow case's is
    the every-crossing one's, its buffers cut to 2: the same steps)."""
    event, cap = SECTION_CASES["every" if case == "overflow" else case]
    a = case_args(it.rhs.lorenz, lorenz_y0(), SECTION_TF, *SECTION_TOL)
    out, ev = plain("RK23", a, EventArgs((event,), cap, 0))
    if case == "overflow":
        n = ev.n_events
        ev = ev._replace(t_events=ev.t_events[:, :, :2],
                         y_events=ev.y_events[:, :, :2],
                         n_events=torch.clamp_max(n, 2),
                         event_overflow=n > 2)
    return out, ev


@pytest.mark.parametrize("case", sorted(SECTION_CASES))
def test_rk23_section(libs, case):
    """RK23 on the Lorenz section, its crossings queued (a lane's 4 slots
    fill twice over the span; the forced build's one slot on every
    crossing) and resolved by the warp, against the plain version; no
    iteration leaves the fast paths."""
    event, cap = SECTION_CASES[case]
    a = case_args(it.rhs.lorenz, lorenz_y0(), SECTION_TF, *SECTION_TOL)
    ev = EventArgs((event,), cap, 0)
    got, runs = run_both(libs, "RK23", a, ev)
    assert_close(got, section_plain(case))
    assert runs == 0
    n = got[1].n_events[:, 0]
    if case == "terminal3":
        assert bool((got[0][2] == it.Status.USER_INTERRUPT).all())
        assert bool((n == 3).all())
    elif case == "overflow":
        assert bool(got[1].event_overflow.any()) and int(n.max()) == 2
    else:
        assert int(n.min()) >= 9


def jlorenz(t, y, sigma, rho, beta):
    return jnp.array([sigma * (y[1] - y[0]), y[0] * (rho - y[2]) - y[1],
                      y[0] * y[1] - beta * y[2]])


def jsection(t, y, sigma, rho, beta):
    return y[2] - (rho - 1.0)


jsection.direction = -1


@functools.lru_cache(maxsize=None)
def jax_section():
    return jax.jit(jax_build(jlorenz, "RK23", n=3, args=LORENZ_ARGS,
                             events=[jsection], event_capacity=64))


def test_rk23_section_against_ivp_tpu(libs):
    """Every crossing of the section by RK23 against ivp_tpu's."""
    y0 = lorenz_y0(1)
    a = case_args(it.rhs.lorenz, y0, SECTION_TF, *SECTION_TOL)
    got, _ = run_both(libs, "RK23", a, EventArgs((E.lorenz_section,), 64, 0))
    ref = jax_section()(y0.numpy(), 0.0, SECTION_TF, *SECTION_TOL)
    assert_close(got, (tuple(torch.as_tensor(np.asarray(getattr(ref, f)))
                             for f in ("t", "y", "status", "nfev", "nstep",
                                       "naccpt", "nrejct")),
                       K.EventOut(*(torch.as_tensor(np.asarray(x))
                                    if x is not None else None
                                    for x in (ref.t_events, ref.y_events,
                                              ref.n_events,
                                              ref.event_overflow,
                                              ref.n_restarts, None)))))


def jball(t, y, g):
    return jnp.array([y[1], -g])


def jground(t, y, g):
    return y[0]


jground.terminal = True
jground.direction = -1
jground.restart = lambda t, y: jnp.array([0.0, -COR * y[1]])


@functools.lru_cache(maxsize=None)
def jax_ball(method):
    return jax.jit(jax_build(jball, method, n=2, args=(9.81,),
                             events=[jground], event_capacity=16,
                             max_restarts=8))


# (y0, tf, atol, g): the ball at rtol = atol = 1e-9 (examples/bouncing_ball.py),
# and one scaled by 1e160 (heights, gravity and atol; the times are the
# ball's), whose event values lie beyond the fast paths' 2^500.
BALLS = {"ball": (ball_y0(), 8.0, BALL_TOL, 9.81),
         "huge": (ball_y0(2e160, 2e161), 8.0, 1e150, 9.81e160)}


@pytest.mark.parametrize("method", ["RK23", "DOPRI5"])
@pytest.mark.parametrize("ball", sorted(BALLS))
def test_ball_restarts(libs, method, ball):
    """The ball with its restarts (8, the ninth bounce ends a lane), lean,
    against the plain version and ivp_tpu.  Scaled by 1e160, most Brent
    iterations take the library's divisions (those whose bracket's event
    values still lie beyond 2^500), against the plain version only."""
    y0, tf, atol, g = BALLS[ball]
    a = case_args(it.rhs.ball, y0, tf, BALL_TOL, atol)
    ev = EventArgs((E.ground,), 16, 8)
    # 1e160 overflows the float32 controller: the state's runs there.
    params = (make_engine(method, True, controller_precision="state")[1]
              if ball == "huge" else None)
    got, runs = run_both(libs, method, a, ev, params, (g,))
    ref = plain(method, a, ev, params, (g,))
    # DOPRI5's g++ build rounds every operation as torch's do (no FMA in
    # either), so its Brent takes the plain version's evaluations; RK23's
    # rows are fused multiply-adds and may part an evaluation's last bits.
    assert_close(got, ref, per_state=ball == "huge",
                 brent=(method, ball) == ("DOPRI5", "ball"))
    assert int(got[1].n_restarts.max()) == 8
    if ball == "huge":
        assert 0 < int(got[1].n_brent.sum()) // 2 < runs
        return
    assert runs == 0
    j = jax_ball("RK45" if method == "DOPRI5" else method)(
        y0.numpy(), 0.0, tf, BALL_TOL, BALL_TOL)
    jt = lambda f: torch.as_tensor(np.asarray(getattr(j, f)))
    assert_close(got, ((jt("t"), jt("y"), jt("status"), jt("nfev"),
                        jt("nstep"), jt("naccpt"), jt("nrejct")),
                       K.EventOut(jt("t_events"), jt("y_events"),
                                  jt("n_events"), jt("event_overflow"),
                                  jt("n_restarts"), None)))


@pytest.mark.parametrize("method", ["RK23", "DOPRI5"])
def test_ball_recorded(libs, method):
    """The recording ball (coefficient rows, chunks of 7) through the
    record-event entry against the plain version's record mode: counters,
    rows and events; the fast build bit for bit with the forced one."""
    y0 = ball_y0()
    a = case_args(it.rhs.ball, y0, 8.0, BALL_TOL, BALL_TOL)[1:]
    ev = EventArgs((E.ground,), 16, 4)
    runs = lambda lib: R.record_launches(
        method, it.rhs.ball, *a, (), 200_000, None, None, 7, True, lib, 0,
        events=ev)
    got, forced = runs(libs["fast"][method]), runs(libs["library"][method])
    ref = R.erk_record_torch(method, it.rhs.ball, *a, (), 200_000, None,
                             rec_cap=7, record_cont=True, events=ev)
    assert got.chunks >= 2
    for f in ("status", "nfev", "nstep", "naccpt", "nrejct", "n_rec"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
        assert torch.equal(getattr(got, f), getattr(forced, f)), f
    for x, y in zip(got.events, forced.events):
        assert x is None or bool(((x == y) | (x != x) & (y != y)).all())
    for f in ("rec_t", "rec_y", "rec_cont", "t_events", "y_events"):
        x = getattr(got, f) if hasattr(got, f) else getattr(got.events, f)
        y = getattr(ref, f) if hasattr(ref, f) else getattr(ref.events, f)
        x, y = torch.nan_to_num(x), torch.nan_to_num(y)
        err = (x - y).abs() / torch.clamp_min(y.abs(), 1.0)
        assert float(err.max()) <= (T_EV if f in ("rec_t", "t_events")
                                    else Y_EV), f


@pytest.mark.parametrize("method", ["RK23", "DOPRI5"])
def test_ball_zero_at_step_start(libs, method):
    """The ball thrown up from the ground (height exactly 0) with both
    directions and no restart: the first step crosses from the exact zero
    at its start, and Brent returns that end at once, a terminal event at
    t = 0, as the plain version does."""
    y0 = ball_y0(0.0, 0.0, 5.0)
    a = case_args(it.rhs.ball, y0, 3.0, BALL_TOL, BALL_TOL)
    ev = EventArgs((E.ground.replace(direction=0),), 4, 0)
    got, runs = run_both(libs, method, a, ev)
    assert_close(got, plain(method, a, ev))
    assert runs == 0
    assert bool((got[1].t_events[:, 0, 0] == 0.0).all())
    assert bool((got[0][2] == it.Status.USER_INTERRUPT).all())
