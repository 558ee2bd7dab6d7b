"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives ivp_tpu_torch's main paths on cuda:0 through its hand-written CUDA
kernels: the lean DOPRI5 ensemble solve (VdP, B=524288, csrc/
dopri5_ensemble.cu), the rest of the explicit tier (Lorenz, B=16384:
DOP853 to the final state and with 100 in-loop samples, RK23, RK4 and DOPRI5
with samples; csrc/erk_*.cu) and the record mode of those kernels:
``solve_ivp`` on the Arenstorf orbit (CR3BP, DOP853, rtol 1e-12, dense
output) and the recording Lorenz ensemble at B=16384 (``dense_output`` and
``record_trajectories``, every method); then the event modes of those
kernels (ivp_tpu_torch/events.py's sets): the bouncing-ball ensemble at
B=524288 (RK45, 8 in-loop restarts a lane), the Lorenz Poincaré section at
B=16384 (DOP853, every crossing to t = 20, and the fifth terminal),
``solve_ivp`` with restarts, the host-loop bouncing ball against SciPy and
the recording ball ensemble; then the stiff tier (csrc/radau.cu,
csrc/bdf.cu): bench.py's stiff row uncut (VdP mu=1000, B=131072, Radau and
BDF through ``build_resumable_solver``), Robertson's budgets, the stiff
kernels' event modes (csrc/radau_ev.cu, csrc/bdf_ev.cu: VdP mu=1000 at
B=131072 with its downward crossings, lean and sampled, the replenished
decay's sawtooth at B=131072 with 10 restarts a lane, and ``solve_ivp``
with events and dense output), and the explicit resumable solver
(``erk_kernel``'s resumable mode) at B=16384.
Every kernel is built from the
sources here and held against its plain PyTorch version (on short spans at
B=4096 over every mode and option, record modes over several chunks, and
at each main path's own shapes), against ivp_tpu's own numbers
(ivp_tpu_torch/data/*.npz) and against SciPy.  A numpy y0 with no ``device``
must run the kernels on cuda:0.  Imports neither jax nor ivp_tpu.  Prints
its phases one per line, then a JSON line with every kernel's launches,
error, times and bound, then the card, and last ``{"ok": true, "device":
{...}}``.  Any failure raises: the exit code is not 0 and no result line is
printed.  Needs one CUDA device; fails without one.
"""
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RTOL, ATOL = 1e-6, 1e-8
# Bounds, kernel against a reference solve of the same problem: status equal
# on every lane; nstep/naccpt/nfev equal on every lane (the kernel keeps the
# float32 controller's IEEE operations and adds no FMA to it, so the
# reference's step sequence is followed); final y within 1e-8 where nstep is
# equal and within 1e-3 everywhere (VdP to t=100 against SciPy at rtol 1e-13
# differs by 4.5e-5).
COUNT_FRACTION, Y_EQUAL_STEPS, Y_ALL = 1.0, 1e-8, 1e-3
# bench.py's headline batch size.
MAIN_B = 524288
# Lanes of each comparison of a kernel with its plain version.
CHECK_B = 4096
# With beta != 0 and a lower scale_max the controller's factor is not clamped
# on the first, tiny steps after hinit, where the error estimate (a sum that
# cancels to rounding noise at such h) differs between nvcc's FMAs and
# torch's separate operations by its whole size.  The next step sizes then
# differ by 1e-4 to 1e-3 (measured on an H100 after 2 attempts), every such
# step is accepted by both, and later a marginal attempt is accepted by one
# and rejected by the other on a few lanes: DOP853 on Lorenz, B=4096, 0.7% of
# lanes (DOPRI5, RK23 and RK4: none).  With the default options the factor is
# clamped there and every lane agrees.  So the solver_options case asks for
# equal status on every lane, equal counters on 98% of them, and y within
# the loosest rtol of the case (1e-5) where the steps are equal, since the
# two step sequences are then different discretisations of the same solve.
OPTIONS_FRACTION, Y_OPTIONS = 0.98, 1e-5
# bench.py's Lorenz configuration: DOP853, B=16384, t in [0, 100], rtol 1e-8,
# atol 1e-10, with and without a 100-point grid.
LORENZ_B, LORENZ_TF, LORENZ_M = 16384, 100.0, 100
LORENZ_TOL = (1e-8, 1e-10)
# Lorenz lanes are held to each other only up to t = 5: beyond, a last-bit
# difference (nvcc contracts the f64 stage sums into FMAs, torch does not)
# grows like exp(0.9 t).  So every kernel of the Lorenz main path is held to
# its plain version lane by lane at the path's shapes on t in [0, 5] (DOP853)
# or [0, 2], and at t = 100 the ensemble is held: success fraction 1.0, mean
# nstep within 1%, every sample emitted.
LORENZ_T_LANES, MEAN_NSTEP = 5.0, 0.01


def phase(name, **kv):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def vdp_y0(B, seed=0):
    rng = np.random.default_rng(seed)
    return np.array([2.0, 0.0]) + 0.05 * rng.standard_normal((B, 2))


def compare(name, got, ref, scaled=False, count_fraction=COUNT_FRACTION,
            y_equal=Y_EQUAL_STEPS):
    """Hold a kernel result against a reference (both tuples t, y, status,
    nfev, nstep, naccpt, nrejct[, y_samples, n_samples]; torch or numpy).
    Samples, where both have them: n_samples equal on every lane, y_samples
    within the bound of y on lanes with equal steps.  ``scaled``: errors are
    taken relative to max(1, |y|) of the lane (Lorenz states reach 50 and
    DOP853's stage sums cancel terms 40 times their size, so the FMAs nvcc
    makes and torch does not show at 1e-9 of |y|; on an H100, B=4096, the
    worst lane differed by 2.8e-8 at |y| ~ 40).  ``count_fraction``: the
    share of lanes on which every counter must be equal; ``y_equal``: the
    bound on y where nstep is equal."""
    a = [np.asarray(x.cpu()) if torch.is_tensor(x) else x for x in got]
    b = [np.asarray(x.cpu()) if torch.is_tensor(x) else x for x in ref]
    t, y, status, nfev, nstep, naccpt, nrejct = a[:7]
    rt, ry, rstatus, rnfev, rnstep, rnaccpt, rnrejct = b[:7]
    if not np.array_equal(status, rstatus):
        raise AssertionError(f"{name}: status differs on "
                             f"{int(np.sum(status != rstatus))} lanes")
    counters = [("nstep", nstep, rnstep), ("naccpt", naccpt, rnaccpt),
                ("nfev", nfev, rnfev), ("nrejct", nrejct, rnrejct)]
    same = nstep == rnstep
    dy = np.abs(y - ry).max(axis=1)
    if len(a) > 7 and a[7] is not None and len(b) > 7 and b[7] is not None:
        counters.append(("n_samples", a[8], b[8]))
        dy = np.maximum(dy, np.abs(a[7] - b[7]).max(axis=(1, 2)))
    if scaled:
        dy = dy / np.maximum(1.0, np.abs(ry).max(axis=1))
    frac = {k: float(np.mean(u == v)) for k, u, v in counters}
    err_same = float(dy[same].max()) if same.any() else 0.0
    err_all = float(dy.max())
    phase(name, lanes=len(status), **{f"{k}_equal": v for k, v in frac.items()},
          max_abs_err_equal_steps=err_same, max_abs_err=err_all,
          max_abs_err_t=float(np.abs(t - rt).max()))
    if min(frac.values()) < count_fraction:
        raise AssertionError(f"{name}: counters equal on only {frac}")
    if err_same > y_equal or err_all > Y_ALL or not np.isfinite(y).all():
        raise AssertionError(f"{name}: final y differs by {err_same} "
                             f"(equal steps) / {err_all} (all lanes)")
    return err_all


def outputs(res):
    """An EnsembleResult as compare() takes it: t, y, status, nfev, nstep,
    naccpt, nrejct, y_samples, n_samples (the result's own order puts the
    event fields between them)."""
    return (res.t, res.y, res.status, res.nfev, res.nstep, res.naccpt,
            res.nrejct, res.y_samples, res.n_samples)


def lanes(B, v, dev):
    return torch.full((B,), float(v), dtype=torch.float64, device=dev)


def edge_cases(B, dev):
    """VdP lanes off the common path, each held to every counter and status:
    ``(name, kernel args after fun, keyword args, statuses every run must
    show)``.  ``vdp_stiff``: mu=1000 over [0, 3000], where the stiffness
    detector ends every lane with PROBABLY_STIFF after ~1015 attempts.
    ``vdp_limits``: max_steps=20 and a per-lane first_step; by lane mod 4,
    a span of 100 with first_step = max_step = 0.01 (NEED_LARGER_NMAX at
    t=0.21), a span of 0.5 with max_step 0.05, t0=1e6 with a first step of
    1e-12 (STEP_SIZE_TOO_SMALL on the first attempt), and spans of 0.05-1.
    A lane that stops mid-span ends at a t that carries the float32
    controller's last bit on each step, where the plain version on the card
    (torch's float32 kernels) and the kernel can round one step's factor
    differently (on an H100, t differed by up to 6e-7 after 21 steps); so
    the one such lane set here takes steps that max_step pins, as
    tests/test_torch_dopri5.py does."""
    from ivp_tpu_torch import Status

    def T(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev).contiguous()

    rng = np.random.default_rng(4)
    y0 = vdp_y0(B, seed=4)
    tol = (T(np.full((B, 2), RTOL)), T(np.full((B, 2), ATOL)))
    stiff = ((T(y0), lanes(B, 0.0, dev), lanes(B, 3000.0, dev),
              lanes(B, 3000.0, dev), None, *tol), dict(args=(1000.0,)))
    lane = np.arange(B) % 4
    t0 = np.where(lane == 2, 1e6, 0.0)
    span = np.select([lane == 1, lane == 3], [0.5, rng.uniform(0.05, 1.0, B)],
                     100.0)
    hmax = np.select([lane == 0, lane == 1], [0.01, 0.05], span)
    first = np.select([lane == 0, lane == 2], [0.01, 1e-12],
                      10.0 ** rng.uniform(-4, -2, B))
    limits = ((T(y0), T(t0), T(t0 + span), T(hmax), T(first), *tol),
              dict(max_steps=20))
    return [("vdp_stiff", *stiff, {Status.PROBABLY_STIFF}),
            ("vdp_limits", *limits, {Status.SUCCESS, Status.NEED_LARGER_NMAX,
                                     Status.STEP_SIZE_TOO_SMALL})]


def lorenz_y0(B, seed=0):
    rng = np.random.default_rng(seed)
    return np.array([1.0, 1.0, 1.0]) + 1e-3 * rng.standard_normal((B, 3))


def timed_solves(solver, y0s, *call, **kw):
    """Run ``solver(y0, *call, **kw)`` for each y0 (the first warms up):
    ``(last result, walls in s, device ms)``.  Each result is freed before
    the next solve: while it is held, the allocator has to cudaMalloc new
    outputs, and the event time includes that wait."""
    walls, ev_ms, res = [], [], None
    for i, y in enumerate(y0s):
        del res
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        e0.record()
        res = solver(y, *call, **kw)
        e1.record()
        torch.cuda.synchronize()
        if i:
            walls.append(time.perf_counter() - t)
            ev_ms.append(e0.elapsed_time(e1))
    return res, walls, ev_ms


def erk_kernels_vs_plain(dev):
    """Kernels dop853, rk23, rk4 and dopri5_sampled against the plain version
    on the card at B=4096 on short spans: lean and sampled (a per-lane grid
    that starts at t0 and ends at tf), per-lane spans (one zero, backward
    for decay), per-component tolerances and per-lane mu; non-default
    solver_options and the controller in double (controller_precision=
    "state") once per method.  ``{kernel: max_abs_err}``."""
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.methods import get_engine

    Bc = CHECK_B

    def T(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev).contiguous()

    errs = {}
    # The plain version on the card takes 2-9 ms an attempt (a launch per
    # torch operation), and the low-order methods need many: at the tightest
    # tolerance of these cases RK23 takes ~800 attempts per unit of t on VdP,
    # RK4 200.  Their spans are cut so that each method's cases take seconds.
    shorter = {"RK23": 0.1, "RK4": 0.25}
    for method, (kernel, _) in K.KERNELS.items():
        rng = np.random.default_rng(5)
        worst = 0.0
        t_method = time.perf_counter()
        for name, fun, y0n, span, backward, fargs in (
                ("vdp_per_lane_mu", rhs.vdp, vdp_y0(Bc, seed=2), 6.0, False,
                 (T(rng.uniform(0.2, 5.0, Bc)),)),
                ("decay", rhs.decay, rng.uniform(0.5, 2.0, (Bc, 1)), 5.0, True,
                 (0.7,)),
                ("lorenz", rhs.lorenz, 1.0 + rng.standard_normal((Bc, 3)), 2.0,
                 False, ())):
            t0 = rng.uniform(-1.0, 1.0, Bc)
            dt = span * shorter.get(method, 1.0) * rng.uniform(0.5, 1.0, Bc)
            if backward:
                dt[1::4] *= -1.0
            dt[0] = 0.0
            n = fun.n
            first = T(np.full(Bc, 5e-3)) if method == "RK4" else None
            a = (T(y0n), T(t0), T(t0 + dt), T(np.abs(dt)), first,
                 T(10.0 ** rng.uniform(-8, -5, (Bc, n))),
                 T(10.0 ** rng.uniform(-10, -7, (Bc, n))), fargs)
            u = np.sort(rng.uniform(0.0, 1.0, (Bc, 8)), axis=1)
            u[:, 0], u[:, -1] = 0.0, 1.0
            grid = T(t0[:, None] + dt[:, None] * u)
            modes = [("sampled", dict(t_grid=grid))]
            if method != "DOPRI5":     # lean DOPRI5 is the other kernel
                modes.append(("lean", {}))
            if name == "lorenz":
                so = dict(safety=0.8, scale_min=0.3, scale_max=5.0,
                          stiff_test=7, iord=4)
                if method in ("DOPRI5", "DOP853"):
                    so.update(beta=0.08, stiff_threshold=2.0)
                modes.append(("options", dict(params=get_engine(
                    method, need_cont=False, **so)[1])))
                modes.append(("state_precision", dict(params=get_engine(
                    method, need_cont=False,
                    controller_precision="state")[1])))
            for mode, kw in modes:
                got = K.erk_ensemble_cuda(method, fun, *a, **kw)
                ref = K.erk_ensemble_torch(method, fun, *a, **kw)
                torch.cuda.synchronize()
                gate = (dict(count_fraction=OPTIONS_FRACTION, y_equal=Y_OPTIONS)
                        if mode == "options" else {})
                err = compare(f"{kernel}_vs_plain_{name}_{mode}_B{Bc}", got,
                              ref, scaled=True, **gate)
                if mode != "options":
                    worst = max(worst, err)
        # The step budget mid-grid: 12 attempts, fewer samples than asked.
        a = (T(lorenz_y0(Bc)), lanes(Bc, 0.0, dev), lanes(Bc, 2.0, dev),
             lanes(Bc, 2.0, dev),
             lanes(Bc, 5e-3, dev) if method == "RK4" else None,
             torch.full((Bc, 3), 1e-8, dtype=torch.float64, device=dev),
             torch.full((Bc, 3), 1e-10, dtype=torch.float64, device=dev))
        kw = dict(max_steps=12, t_grid=torch.broadcast_to(
            T(np.linspace(0.0, 2.0, 9)), (Bc, 9)))
        got = K.erk_ensemble_cuda(method, rhs.lorenz, *a, **kw)
        ref = K.erk_ensemble_torch(method, rhs.lorenz, *a, **kw)
        torch.cuda.synchronize()
        if int(got[8].max()) >= 9 or set(got[2].cpu().tolist()) != {2}:
            raise AssertionError(f"{kernel}: max_steps=12 did not stop the "
                                 f"lanes mid-grid")
        # These lanes stop mid-span: t and y carry the float32 controller's
        # last bits (see edge_cases), so the counters and samples are held.
        for f, u, v in zip(("status", "nfev", "nstep", "naccpt", "nrejct"),
                           got[2:7], ref[2:7]):
            if not torch.equal(u, v):
                raise AssertionError(f"{kernel} max_steps: {f} differs")
        if not torch.equal(got[8], ref[8]):
            raise AssertionError(f"{kernel} max_steps: n_samples differs")
        phase(f"{kernel}_vs_plain_max_steps_B{Bc}", n_samples_max=int(got[8].max()),
              max_abs_err_samples=float((got[7] - ref[7]).abs().max()),
              max_abs_err_t=float((got[0] - ref[0]).abs().max()),
              seconds_for_method=round(time.perf_counter() - t_method, 3))
        if method == "DOP853":
            worst = max(worst, dense_grid_vs_plain(dev))
        errs[kernel] = worst
    return errs


def dense_grid_vs_plain(dev):
    """The deferred samples' queue of the sampled DOP853 kernel (erk_common.
    cuh's DEFER_SAMPLES) against the plain version at B=4096: Lorenz on t in
    [0, 1] with a per-lane grid of 400 sorted times, denser than the steps,
    so that each step emits several samples and every lane's slots fill
    (and the warp resolves its queue) every few steps.  Status, counters and
    n_samples equal on every lane, y and y_samples within 1e-8 of max(1,
    |y|).  The max_abs_err."""
    from ivp_tpu_torch import Status, rhs
    from ivp_tpu_torch.kernels import erk_ensemble as K

    Bc, m = CHECK_B, 400
    rng = np.random.default_rng(6)
    T = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    a = (T(1.0 + rng.standard_normal((Bc, 3))), lanes(Bc, 0.0, dev),
         lanes(Bc, 1.0, dev), lanes(Bc, 1.0, dev), None,
         T(np.full((Bc, 3), 1e-8)), T(np.full((Bc, 3), 1e-10)))
    kw = dict(t_grid=T(np.sort(rng.uniform(0.0, 1.0, (Bc, m)), axis=1)))
    got = K.erk_ensemble_cuda("DOP853", rhs.lorenz, *a, **kw)
    ref = K.erk_ensemble_torch("DOP853", rhs.lorenz, *a, **kw)
    torch.cuda.synchronize()
    err = compare(f"dop853_vs_plain_dense_grid_B{Bc}", got, ref, scaled=True)
    naccpt = got[5].double()
    if (set(got[2].cpu().tolist()) != {Status.SUCCESS}
            or not bool((got[8] == m).all()) or float(naccpt.min()) <= 8
            or float((m / naccpt).min()) <= 2.0):
        raise AssertionError("dense grid: a lane did not emit every sample "
                             "from more than 8 steps of several samples each")
    return err


def erk_golden_and_scipy(dev):
    """The DOP853 kernel against ivp_tpu's own numbers (Lorenz to t=5 with
    samples, lane by lane) and against SciPy's DOP853 at rtol 1e-13."""
    from scipy.integrate import solve_ivp

    from ivp_tpu_torch import Status, build_ensemble_solver, rhs

    with np.load(ROOT / "ivp_tpu_torch" / "data" / "lorenz_golden.npz") as g:
        gold = {f: g[f] for f in g.files}
    res = build_ensemble_solver(rhs.lorenz, "DOP853", n=3, max_steps=200_000,
                                t_eval=gold["t_eval"])(
        gold["y0"], 0.0, float(gold["tf"]), float(gold["rtol"]),
        float(gold["atol"]))
    torch.cuda.synchronize()
    names = ("t", "y", "status", "nfev", "nstep", "naccpt", "nrejct",
             "y_samples", "n_samples")
    compare(f"dop853_vs_ivp_tpu_golden_B{len(gold['y0'])}", outputs(res),
            [gold[f] for f in names], scaled=True)

    y8 = vdp_y0(8, seed=1)
    res = build_ensemble_solver(rhs.vdp, "DOP853", n=2)(y8, 0.0, 100.0, 1e-9,
                                                        1e-11)
    ys = np.stack([solve_ivp(lambda t, y: [y[1], (1 - y[0] ** 2) * y[1] - y[0]],
                             (0.0, 100.0), y8[i], method="DOP853", rtol=1e-13,
                             atol=1e-14).y[:, -1] for i in range(8)])
    err = float(np.abs(res.y.cpu().numpy() - ys).max())
    phase("dop853_vs_scipy_dop853_B8", max_abs_err=err,
          status=sorted(set(res.status.cpu().tolist())))
    # VdP to t=100 at rtol 1e-9 against SciPy at 1e-13: 1e-5 bounds the
    # global error of the looser solve.
    if err > 1e-5 or set(res.status.cpu().tolist()) != {Status.SUCCESS}:
        raise AssertionError(f"dop853 kernel vs SciPy: {err}")
    return gold


# The lean DOP853 main path's median solve ms (CUDA events) on an H100 80GB
# HBM3 at 700 W before its attempt's chain was shortened (PERF.md §6).
DOP853_LEAN_BEFORE_MS = 4.670
# The RK23 main paths' median solve ms (CUDA events), lean and sampled, on
# the same card before their attempt's chain was shortened and the sampled
# rows built only where a step covers a grid time (PERF.md §6).
RK23_BEFORE_MS = {"lean": 3.212, "sampled": 4.326}


def erk_main_path(dev, gold):
    """The explicit tier's main path at full width: Lorenz, B=16384, numpy
    y0 and no ``device``, through build_ensemble_solver.  bench.py's two
    DOP853 configurations (t in [0, 100], lean and with 100 samples), and
    RK23, RK4 and sampled DOPRI5 with the depth cut to t in [0, 20]: one
    warm-up and three timed solves each.  Then each configuration's kernel
    is held to its plain version lane by lane at the same shapes (B=16384,
    100 samples) on a span short enough for Lorenz lanes to stay together,
    and both are timed there; the plain version solves t in [0, 100] once,
    DOP853 on 4096 of the lanes, for the ensemble gate.  ``{kernel: row}``
    with the launches of the main path's run, the times and bound of the
    short span (same inputs for kernel, plain version and bound) and the
    main path's own time and bound."""
    from ivp_tpu_torch import Status, build_ensemble_solver, rhs
    from ivp_tpu_torch.kernels import erk_ensemble as K

    B, m = LORENZ_B, LORENZ_M
    y0s = [lorenz_y0(B, seed=s) for s in range(4)]
    configs = [   # method, kernel, tf, short tf, (rtol, atol), options, sampled
        ("DOP853", "dop853", LORENZ_TF, LORENZ_T_LANES, LORENZ_TOL, {}, False),
        ("DOP853", "dop853", LORENZ_TF, LORENZ_T_LANES, LORENZ_TOL, {}, True),
        ("RK23", "rk23", 20.0, 2.0, (1e-6, 1e-8), {}, False),
        ("RK23", "rk23", 20.0, 2.0, (1e-6, 1e-8), {}, True),
        ("RK4", "rk4", 20.0, 2.0, (1e-6, 1e-8), dict(first_step=2e-3), False),
        ("RK4", "rk4", 20.0, 2.0, (1e-6, 1e-8), dict(first_step=2e-3), True),
        ("RK45", "dopri5_sampled", 20.0, 2.0, (1e-6, 1e-8), {}, True),
    ]

    def grid_of(method, tf, sampled):
        # RK4's fixed steps sum to tf only up to rounding, and its last
        # step may end a hair short of tf: its grid stops before tf.
        return (np.linspace(0.0, tf, m, endpoint=method != "RK4")
                if sampled else None)

    for kname in K.LAUNCHES:
        K.LAUNCHES[kname] = 0
    runs = []
    for method, kernel, tf, short, (rtol, atol), opts, sampled in configs:
        solver = build_ensemble_solver(
            rhs.lorenz, method, n=3, max_steps=200_000,
            t_eval=grid_of(method, tf, sampled), **opts)
        before = K.LAUNCHES[kernel]
        res, walls, ev_ms = timed_solves(solver, y0s, 0.0, tf, rtol, atol)
        runs.append((res, walls, ev_ms, K.LAUNCHES[kernel] - before, solver))
    launches = dict(K.LAUNCHES)

    def kernel_args(y0, tf, rtol, atol, first):
        Bk = y0.shape[0]
        T = lambda v: torch.full((Bk,), v, dtype=torch.float64, device=dev)
        return (y0, T(0.0), T(tf), T(tf), None if first is None else T(first),
                torch.full((Bk, 3), rtol, dtype=torch.float64, device=dev),
                torch.full((Bk, 3), atol, dtype=torch.float64, device=dev))

    def event_ms(fn):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        return out, e0.elapsed_time(e1)

    # The plain version over the whole span, once: DOP853 to t = 100 on the
    # first CHECK_B lanes of the last y0 (its time does not fall with B: it
    # waits on the host, one launch per torch operation).
    y_last = torch.as_tensor(y0s[-1], device=dev)
    plain_long, plain_long_ms = event_ms(lambda: K.erk_ensemble_torch(
        "DOP853", rhs.lorenz, *kernel_args(y_last[:CHECK_B], LORENZ_TF,
                                           *LORENZ_TOL, None), (), 200_000))
    pn = plain_long[4].cpu().numpy()
    phase(f"plain_dop853_lean_lorenz_B{CHECK_B}_tf{LORENZ_TF:g}",
          event_ms=round(plain_long_ms, 3), mean_nstep=float(pn.mean()),
          success_fraction=float((plain_long[2] == 0).double().mean()))
    if not bool((plain_long[2] == 0).all()):
        raise AssertionError("plain DOP853 to t=100: not every lane succeeded")

    rows = {}
    for (method, kernel, tf, short, (rtol, atol), opts, sampled), (
            res, walls, ev_ms, n_launch, solver) in zip(configs, runs):
        tag = f"{kernel}_{'sampled' if sampled else 'lean'}_lorenz_B{B}"
        ms = float(np.median(ev_ms))
        status = res.status.cpu().numpy()
        nstep = res.nstep.cpu().numpy()
        canon = "DOPRI5" if method == "RK45" else method
        bound_ms, bound_by = K.solve_bound(
            canon, rhs.lorenz, res.nstep, res.naccpt,
            res.n_samples if sampled else None, m if sampled else 0)
        # The bound with dense rows on every accepted step, as before they
        # were counted on the emitting steps only.
        every = (K.solve_bound(canon, rhs.lorenz, res.nstep, res.naccpt,
                               res.n_samples, m, dense_steps=res.naccpt)[0]
                 if sampled else bound_ms)
        phase(f"main_path_{tag}", launches=n_launch,
              success_fraction=float(np.mean(status == Status.SUCCESS)),
              ivps_per_sec=B / float(np.median(walls)),
              mean_nstep=float(nstep.mean()), max_nstep=int(nstep.max()),
              n_samples=(sorted(set(res.n_samples.cpu().tolist()))
                         if sampled else None),
              walls_s=[round(w, 6) for w in walls],
              event_ms=[round(x, 3) for x in ev_ms], bound_ms=bound_ms,
              bound_by=bound_by, bound_share=bound_ms / ms,
              bound_ms_rows_every_accept=every,
              finite=bool(torch.isfinite(res.y).all()))
        if kernel == "dop853" and not sampled:
            phase("dop853_lean_main_path", ms=ms,
                  before_redesign_ms=DOP853_LEAN_BEFORE_MS,
                  over_before=ms / DOP853_LEAN_BEFORE_MS)
        if kernel == "rk23":
            # The kernel's device ms of one more main-path solve, beside the
            # solve's own and the one before the redesign.
            mode = "sampled" if sampled else "lean"
            _, main_k_ms, _ = kernel_device_ms(
                lambda: solver(y0s[0], 0.0, tf, rtol, atol))
            phase(f"rk23_{mode}_main_path", ms=ms, kernel_ms=main_k_ms,
                  before_redesign_ms=RK23_BEFORE_MS[mode],
                  over_before=ms / RK23_BEFORE_MS[mode])
        if n_launch != 4:
            raise AssertionError(f"{tag}: {n_launch} launches in 4 solves")
        if not np.all(status == Status.SUCCESS) or not bool(
                torch.isfinite(res.y).all()):
            raise AssertionError(f"{tag}: not every lane succeeded")
        if tuple(res.y.shape) != (B, 3) or res.y.device != dev:
            raise AssertionError(f"{tag}: y {tuple(res.y.shape)} on "
                                 f"{res.y.device}")
        if sampled and (tuple(res.y_samples.shape) != (B, m, 3)
                        or not bool((res.n_samples == m).all())
                        or not bool(torch.isfinite(res.y_samples).all())):
            raise AssertionError(f"{tag}: samples missing")

        # Lanes diverge over t in [0, 100] (chaos): there the ensemble is
        # held, against the plain version on the same lanes and ivp_tpu's
        # own mean.
        if method == "DOP853":
            gap = abs(float(nstep[:CHECK_B].mean()) / float(pn.mean()) - 1.0)
            gm = float(gold["long_nstep"].mean())
            ggap = abs(float(nstep.mean()) / gm - 1.0)
            phase(f"ensemble_{tag}", plain_mean_nstep=float(pn.mean()),
                  mean_nstep_gap=gap, golden_mean_nstep=gm,
                  golden_mean_nstep_gap=ggap)
            if gap > MEAN_NSTEP or ggap > MEAN_NSTEP:
                raise AssertionError(
                    f"{tag}: mean nstep {nstep.mean()} against the plain "
                    f"version's {pn.mean()} and ivp_tpu's {gm}")

        # This instantiation against its plain version, lane by lane, at
        # the main path's shapes on the short span; both timed there.
        g = grid_of(method, short, sampled)
        a = (*kernel_args(y_last, short, rtol, atol, opts.get("first_step")),
             (), 200_000,
             None if g is None else torch.broadcast_to(
                 torch.as_tensor(g, device=dev), (B, m)))
        short_ms = []
        for i in range(4):
            got = None
            got, t_ms = event_ms(
                lambda: K.erk_ensemble_cuda(canon, rhs.lorenz, *a))
            if i:
                short_ms.append(t_ms)
        ref, plain_ms = event_ms(
            lambda: K.erk_ensemble_torch(canon, rhs.lorenz, *a))
        err = compare(f"{tag}_vs_plain_tf{short:g}", got, ref, scaled=True)
        if set(got[2].cpu().tolist()) != {Status.SUCCESS} or (
                sampled and not bool((got[8] == m).all())):
            raise AssertionError(f"{tag}: the short span did not succeed "
                                 f"with every sample")
        k_ms = float(np.median(short_ms))
        s_bound, s_by = K.solve_bound(canon, rhs.lorenz, got[4], got[5],
                                      got[8] if sampled else None,
                                      m if sampled else 0)
        phase(f"short_span_{tag}", tf=short, kernel_ms=[round(x, 4)
                                                        for x in short_ms],
              plain_ms=round(plain_ms, 3), kernel_speedup=plain_ms / k_ms,
              mean_nstep=float(got[4].double().mean()), bound_ms=s_bound,
              bound_by=s_by, bound_share=s_bound / k_ms)
        row = rows.setdefault(kernel, {
            "launches": launches[kernel], "max_abs_err": 0.0,
            "inputs": f"Lorenz B={B}, {m} samples where sampled; ms, "
                      f"plain_ms, bound_ms and max_abs_err on t in [0, "
                      f"{short:g}], main_path_* on t in [0, {tf:g}]"})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        key = "sampled_" if sampled and kernel != "dopri5_sampled" else ""
        row.update({f"{key}ms": k_ms, f"{key}plain_ms": plain_ms,
                    f"{key}bound_ms": s_bound, f"{key}bound_by": s_by,
                    f"{key}bound_share": s_bound / k_ms,
                    f"{key}main_path_ms": ms,
                    f"{key}main_path_bound_ms": bound_ms,
                    f"{key}main_path_bound_share": bound_ms / ms})
    return rows


# ---- The record mode (kernels/erk_record.py) ----
# Rows a lane records per chunk in the checks: every lane crosses chunks.
REC_CAP_CHECK = 37
# The Arenstorf orbit (tests/test_gates.py): CR3BP, DOP853, rtol 1e-12.
MU = 0.012277471
ARENSTORF = np.array([0.994, 0, 0, 0, -2.00158510637908252240537862224, 0])
PERIOD = 17.0652165601579625588917206249
# Each record configuration on Lorenz: method, tf of the B=4096 check, tf of
# the B=16384 main path (bench.py's DOP853 span cut to t in [0, 20]; the
# others shorter, as the erk main path cuts them), tolerances, options.
RECORD_CONFIGS = [
    ("DOPRI5", 1.0, 5.0, (1e-8, 1e-10), {}),
    ("DOP853", 5.0, 20.0, LORENZ_TOL, {}),
    ("RK23", 1.0, 5.0, (1e-6, 1e-8), {}),
    ("RK4", 1.0, 2.0, (1e-6, 1e-8), dict(first_step=5e-3)),
]


def lorenz_f(y):
    """The Lorenz RHS on (..., 3) arrays (numpy or torch)."""
    x, yy, z = y[..., 0], y[..., 1], y[..., 2]
    st = torch.stack if torch.is_tensor(y) else np.stack
    return st([10.0 * (yy - x), x * (28.0 - z) - yy, x * yy - (8.0 / 3.0) * z],
              -1)


# A record row's time and left edge against the plain version's, relative
# to max(1, |t|), and its step size relative to |h|.  Both routes take the
# same steps (every counter is held equal), but the step sizes part in their
# last bits on the first, tiny steps after hinit, where the error estimate is
# a cancelling sum's rounding noise (ROADMAP §3 fault 2) that nvcc's FMAs and
# torch's separate operations make of different sizes.  Every later step's
# edges then move with them: on an H100 the edges moved by up to 3.4e-8
# (DOPRI5, B=4096, rtol 1e-8).  A lane's last step is cut to end on tf, so
# its h = tf - xold carries its left edge's move whole, which is large
# against a short last step (up to 2.9e-5 of |h|).  Every other step's h
# is held to |h| within T_STEP: the error estimate's rounding noise moves
# each step's size by up to 8.5e-7 of |h| (DOPRI5 at B=16384, rtol 1e-8),
# step to step, while the edges, their sums, move 40 times less.  Each
# route's rows also satisfy t = xold + h within T_SUM, so no row's h can be
# wrong while its edges are right.  PERF.md gives the readings on the H100
# of every record instantiation, from which the limits are set.  The
# rows stay points of one trajectory, which the y rows are held to (after
# moving the plain version's row along f by the rows' time difference:
# measured 1.2e-14) and the coefficients are, through the step's dense
# interpolant at the middle of the plain version's step.
T_REC = 1e-6
T_STEP = 1e-5
T_SUM = 2.0 ** -52


def record_errors(got, ref, method, f=lorenz_f):
    """Two RecordResults of the same inputs: ``(counters, errs)``.
    ``counters``: the share of lanes on which status, nfev, nstep, naccpt,
    nrejct, n_rec (and n_samples) are equal.  ``errs``: ``raw``, the largest
    difference of any recorded value, sample or final t, y of a lane,
    scaled by max(1, |y|) of the lane; ``time``, of the rows' t and xold,
    scaled by max(1, |t|); ``step``, of the rows' h but each lane's last,
    relative to |h|, and ``step_last``, of the last; ``sum``, the largest
    |t - (xold + h)| of either route's rows, scaled by max(1, |t|);
    ``shifted``, of the y rows after moving the plain version's row along f
    by the two rows' time difference; ``dense``, of each step's interpolant
    at the middle of the plain version's step; ``final``, of the samples
    and the final t and y (the last four scaled as ``raw``)."""
    from ivp_tpu_torch.methods.interp import get_interp

    counters = {}
    for name in ("status", "nfev", "nstep", "naccpt", "nrejct", "n_rec",
                 "n_samples"):
        a, b = getattr(got, name), getattr(ref, name)
        if a is not None:
            counters[name] = float((a.long() == b.long()).double().mean())
    B = ref.y.shape[0]
    scale = torch.clamp_min(ref.y.abs().amax(1), 1.0)
    if ref.rec_y.shape[1]:
        scale = torch.maximum(scale, ref.rec_y.abs().amax(dim=(1, 2)))

    def worst(a, b, sc=scale):
        if a is None or not a.numel():
            return 0.0
        return float(((a - b).abs().reshape(B, -1).amax(1) / sc).max())

    errs = dict(raw=0.0, time=0.0, step=0.0, step_last=0.0, sum=0.0,
                shifted=0.0, dense=0.0, final=0.0)
    for name in ("t", "y", "rec_t", "rec_xold", "rec_h", "rec_y", "rec_cont",
                 "y_samples"):
        errs["raw"] = max(errs["raw"], worst(getattr(got, name),
                                             getattr(ref, name)))
    for name in ("t", "y", "y_samples"):
        errs["final"] = max(errs["final"], worst(getattr(got, name),
                                                 getattr(ref, name)))
    if ref.rec_t.numel():
        row = torch.arange(ref.rec_t.shape[1], device=ref.rec_t.device)[None]
        valid = row < ref.n_rec[:, None]
        last = row == ref.n_rec[:, None] - 1
        tscale = torch.clamp_min(ref.rec_t.abs().amax(1), 1.0)
        errs["time"] = max(worst(getattr(got, n), getattr(ref, n), tscale)
                           for n in ("rec_t", "rec_xold"))
        rel_h = ((got.rec_h - ref.rec_h).abs()
                 / torch.clamp_min(ref.rec_h.abs(),
                                   torch.finfo(torch.float64).tiny))
        errs["step"] = float(torch.where(valid & ~last, rel_h, 0.0).max())
        errs["step_last"] = float(torch.where(last, rel_h, 0.0).max())
        errs["sum"] = max(float(torch.where(
            valid, (r.rec_t - (r.rec_xold + r.rec_h)).abs()
            / torch.clamp_min(r.rec_t.abs(), 1.0), 0.0).max())
            for r in (got, ref))
        moved = ref.rec_y + f(got.rec_y) * (got.rec_t - ref.rec_t)[..., None]
        errs["shifted"] = worst(moved, got.rec_y)
        if ref.rec_cont is not None:
            interp, _ = get_interp(method)
            C, n = ref.rec_cont.shape[2:]
            mid = (ref.rec_xold + 0.5 * ref.rec_h).reshape(-1)
            at = lambda r: interp(r.rec_cont.reshape(-1, C, n),
                                  r.rec_xold.reshape(-1),
                                  r.rec_h.reshape(-1), mid)
            d = torch.where(valid.reshape(-1, 1), at(got) - at(ref), 0.0)
            errs["dense"] = worst(d, torch.zeros_like(d))
    return counters, errs


def check_record(name, counters, errs):
    """The record gates: every counter equal on every lane; rows' times and
    step sizes within T_REC and T_STEP, t = xold + h within T_SUM, y rows (shifted),
    dense evaluations, samples and final states within Y_EQUAL_STEPS."""
    if min(counters.values()) < 1.0:
        raise AssertionError(f"{name}: counters equal on only {counters}")
    if (errs["time"] > T_REC or errs["step"] > T_STEP or errs["sum"] > T_SUM
            or max(errs["shifted"], errs["dense"], errs["final"])
            > Y_EQUAL_STEPS):
        raise AssertionError(f"{name}: rows differ: {errs}")


def launches_of(fn):
    """``(fn(), {kernel: launches})``: every kernel's count set to 0 just
    before ``fn`` and the lean DOPRI5 kernel's, the erk kernels', the record
    kernels' and the stiff kernels' read just after it (only kernels it
    launched).  Around
    ``kernel_device_ms``, the counts of its measured call."""
    from ivp_tpu_torch.kernels import dopri5_ensemble as k
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.kernels import stiff_ensemble as S

    zero_counts()
    out = fn()
    torch.cuda.synchronize()
    seen = {n: v for d in (K.LAUNCHES, R.LAUNCHES, S.LAUNCHES)
            for n, v in d.items() if v}
    if k.LAUNCHES:
        seen["dopri5_ensemble"] = k.LAUNCHES
    return out, seen


def solve_args(y0, tf, rtol, atol, first, dev):
    """The kernel wrappers' per-lane arguments for ``y0 (B, n)`` on t in
    [0, tf] (hmax tf), with ``first`` the first step or None."""
    Bk, n = y0.shape
    T = lambda v: torch.full((Bk,), v, dtype=torch.float64, device=dev)
    return (y0, T(0.0), T(tf), T(tf), None if first is None else T(first),
            torch.full((Bk, n), rtol, dtype=torch.float64, device=dev),
            torch.full((Bk, n), atol, dtype=torch.float64, device=dev))


def record_modes():
    """(name, record_cont, sampled) of the four record modes."""
    return [("steps", False, False), ("cont", True, False),
            ("steps_samples", False, True), ("cont_samples", True, True)]


def event_call(fn):
    """``(fn(), device ms between events around it)``."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def record_vs_plain(dev):
    """Every record instantiation on Lorenz at B=4096 against the plain
    version on the card (the ported driver in record mode), with
    rec_cap=37, so that every lane crosses several chunks: every counter
    and n_steps_rec equal on every lane, every recorded row as
    check_record holds it.  ``{kernel name: row}``: the worst error over
    its modes (shifted y rows, dense evaluations, samples and final states,
    scaled by max(1, |y|)) and, from its mode without samples, both routes' times
    (CUDA events around the whole chunked call, drains included) and the
    bound on those inputs."""
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import erk_record as R

    Bc = CHECK_B
    y0 = torch.as_tensor(lorenz_y0(Bc, seed=6), device=dev)
    rows = {}
    for method, tf, _, (rtol, atol), opts in RECORD_CONFIGS:
        a = solve_args(y0, tf, rtol, atol, opts.get("first_step"),
                               dev)
        grid = torch.broadcast_to(torch.linspace(
            0.0, tf * (0.99 if method == "RK4" else 1.0), 9,
            dtype=torch.float64, device=dev), (Bc, 9))
        t_m = time.perf_counter()
        for mode, cont, sampled in record_modes():
            kw = dict(rec_cap=REC_CAP_CHECK, record_cont=cont)
            g = grid if sampled else None
            R.erk_record_cuda(method, rhs.lorenz, *a, (), 200_000, g, **kw)
            got, k_ms = event_call(lambda: R.erk_record_cuda(
                method, rhs.lorenz, *a, (), 200_000, g, **kw))
            ref, p_ms = event_call(lambda: R.erk_record_torch(
                method, rhs.lorenz, *a, (), 200_000, g, **kw))
            counters, errs = record_errors(got, ref, method)
            name = R.record_kernel(method, cont)
            b_ms, b_by = R.record_bound(method, rhs.lorenz, got.nstep,
                                        got.naccpt, got.n_rec, cont,
                                        got.n_samples, 9 if sampled else 0)
            phase(f"record_vs_plain_{name}_{mode}_B{Bc}", tf=tf,
                  chunks=got.chunks, mean_rows=float(got.n_rec.double().mean()),
                  **{f"{k}_equal": v for k, v in counters.items()},
                  **{f"max_err_{k}": v for k, v in errs.items()},
                  kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
            check_record(f"{name} {mode}", counters, errs)
            if got.chunks < 3:
                raise AssertionError(f"{name} {mode}: {got.chunks} chunks")
            err = max(errs["shifted"], errs["dense"], errs["final"])
            row = rows.setdefault(name, {"max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if not sampled:
                row.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, bound_share=b_ms / k_ms,
                           inputs=f"Lorenz B={Bc}, t in [0, {tf:g}], "
                                  f"rec_cap={REC_CAP_CHECK}")
        phase(f"record_vs_plain_{method}", seconds=round(
            time.perf_counter() - t_m, 3))
    return rows


def record_chunking_bitwise(dev):
    """Every record instantiation at rec_cap=37 against rec_cap=4096 on the
    same inputs (B=4096): the lanes that differ in any output or row (NaN
    equal to NaN), which must be 0."""
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import erk_record as R

    Bc = CHECK_B
    y0 = torch.as_tensor(lorenz_y0(Bc, seed=7), device=dev)
    for method, tf, _, (rtol, atol), opts in RECORD_CONFIGS:
        a = solve_args(y0, tf, rtol, atol, opts.get("first_step"),
                               dev)
        grid = torch.broadcast_to(torch.linspace(
            0.0, tf * 0.99, 9, dtype=torch.float64, device=dev), (Bc, 9))
        for mode, cont, sampled in record_modes():
            g = grid if sampled else None
            small, big = (R.erk_record_cuda(
                method, rhs.lorenz, *a, (), 200_000, g, rec_cap=cap,
                record_cont=cont) for cap in (REC_CAP_CHECK, 4096))
            torch.cuda.synchronize()
            differ = torch.zeros(Bc, dtype=torch.bool, device=dev)
            for name in R.RecordResult._fields[:-1]:
                x, y = getattr(small, name), getattr(big, name)
                if x is None:
                    continue
                if x.shape != y.shape:
                    raise AssertionError(f"{method} {mode}: {name} shapes "
                                         f"{tuple(x.shape)} {tuple(y.shape)}")
                same = (x == y) | (torch.isnan(x) & torch.isnan(y)) if \
                    x.is_floating_point() else x == y
                differ |= ~same.reshape(Bc, -1).all(1)
            n = int(differ.sum())
            phase(f"record_chunking_bitwise_{R.record_kernel(method, cont)}"
                  f"_{mode}_B{Bc}", chunks=(small.chunks, big.chunks),
                  lanes_differing=n)
            if n or big.chunks != 1 or small.chunks < 3:
                raise AssertionError(f"{method} {mode}: {n} lanes differ")


# How long a profile waits after it starts, between its warm-up and the
# call it measures, and after that call.  On an H100 a trace lost kernels
# at both ends: the first launches of a chunked solve soon after the
# profile started, and, about one profile in ten in the smoke, some of the
# kernels of the call just before the profile stopped (none in 216 profiles
# that ran a tiny kernel after the measured call).  So each profile runs its
# work once before the call it measures and a tiny kernel after it.
PROFILE_SETTLE_S = 0.02
# The record_function range of the measured call: a profile counts the
# device events that start inside it.
PROFILE_WINDOW = "chip_smoke.measured"


@contextlib.contextmanager
def settled_profile():
    """torch.profiler over CPU and CUDA, entered, the card idle and
    ``PROFILE_SETTLE_S`` gone by before the body runs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        yield prof


def window_profile(warm, run):
    """``(run(), window events, device events, start)``: one settled
    profile in which ``warm()`` runs first, then, ``PROFILE_SETTLE_S``
    later, ``run()`` inside the ``PROFILE_WINDOW`` range, then,
    ``PROFILE_SETTLE_S`` later, a one-element fill.  The device events
    (kernels, copies, fills) of the whole profile, the window events among
    them (those that started inside the range), and the range's start (µs,
    the events' clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    with settled_profile() as prof:
        warm()
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        with record_function(PROFILE_WINDOW):
            out = run()
            torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    events = prof.events()
    window = [e for e in events if e.name == PROFILE_WINDOW
              and e.device_type == DeviceType.CPU]
    if len(window) != 1:
        raise AssertionError(f"the profile held {len(window)} "
                             f"{PROFILE_WINDOW} ranges")
    begin, end = window[0].time_range.start, window[0].time_range.end
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != PROFILE_WINDOW]
    return (out, [e for e in device if begin <= e.time_range.start <= end],
            device, begin)


def zero_counts():
    """Set every kernel's launch count to 0."""
    from ivp_tpu_torch.kernels import dopri5_ensemble as k
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.kernels import resumable as RES
    from ivp_tpu_torch.kernels import stiff_ensemble as S

    k.LAUNCHES = 0
    for d in (K.LAUNCHES, R.LAUNCHES, RES.LAUNCHES, S.LAUNCHES):
        for name in d:
            d[name] = 0


def launch_total(match):
    """The launches this process has counted of the kernels whose device
    name holds ``match``: ``erk_kernel`` (the lean, recording, event and
    resumable entries of csrc/erk_*.cu) or a stiff kernel."""
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.kernels import resumable as RES
    from ivp_tpu_torch.kernels import stiff_ensemble as S

    if match == "erk_kernel":
        return sum(sum(d.values()) for d in (K.LAUNCHES, R.LAUNCHES,
                                             RES.LAUNCHES))
    # A stiff kernel's every mode (its lean, sampled and record entries
    # launch one kernel template).
    stem = match.removesuffix("_kernel")
    return sum(v for k, v in S.LAUNCHES.items() if k.split("_")[0] == stem)


def kernel_device_ms(fn, match="erk_kernel", attempts=5):
    """``(result, device ms of the kernels whose name holds ``match``,
    device ms of every kernel)`` of one call of ``fn``, from
    torch.profiler (``window_profile``: ``fn`` runs once more before it
    inside the profile).  Every launch count is set to 0 just before the
    measured call, so a caller reads that call's counts after this returns.
    The profile must hold one kernel event for each launch the call counted
    (``launch_total``); one that holds fewer or more is printed and taken
    again, and after ``attempts`` it raises."""
    for attempt in range(attempts):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def run():
            zero_counts()
            e0.record()
            out = fn()
            e1.record()
            torch.cuda.synchronize()
            return out, launch_total(match)

        (out, launched), events, device, begin = window_profile(fn, run)
        mine = [e for e in events if match in e.name]
        k_ms = sum(e.time_range.elapsed_us() for e in mine) / 1e3
        all_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
        phase("kernel_device_ms", match=match, attempt=attempt,
              kernel_events=len(mine), launches=launched, kernel_ms=k_ms)
        if len(mine) == launched and launched > 0:
            return out, k_ms, all_ms
        phase("profiler_missed_launches", match=match, attempt=attempt,
              kernel_events=len(mine), launches=launched,
              device_ms_seen=all_ms, events_around_ms=e0.elapsed_time(e1),
              device_events_in_profile=len(device),
              match_starts_ms_from_window=[
                  round((e.time_range.start - begin) / 1e3, 3)
                  for e in device if match in e.name])
        del out
    raise AssertionError(f"torch.profiler held {len(mine)} {match} events "
                         f"for {launched} launches in the last of "
                         f"{attempts} profiles")


def solve_ivp_cr3bp(dev):
    """The single-IVP facade on the card: the Arenstorf orbit (CR3BP,
    DOP853, rtol 1e-12, atol 1e-14, dense output) through
    ``ivp_tpu_torch.solve_ivp`` with a numpy state0 and no device.  Gates:
    success, periodicity within 1e-6, the Jacobi constant within 1e-8 on 200
    dense points (tests/test_gates.py); counters against the plain version
    on the card (stated below); chunk_steps=64 bit for bit against the
    default.  Returns the kernel row's numbers."""
    from ivp_tpu_torch import rhs, solve_ivp
    from ivp_tpu_torch.kernels import erk_record as R

    kw = dict(method="DOP853", args=(MU,), rtol=1e-12, atol=1e-14,
              dense_output=True)
    solve = lambda: solve_ivp(rhs.cr3bp, (0, PERIOD), ARENSTORF, **kw)
    solve()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        solve()
        walls.append(time.perf_counter() - t)
    # The main path's run: the counts set to 0 just before, read just after.
    res, launches = launches_of(solve)
    if set(launches) != {"dop853_record_cont"}:
        raise AssertionError(f"solve_ivp_cr3bp launched {launches}")
    final = res.y[:, -1]
    ts = np.linspace(0, PERIOD, 200)
    traj = res.sol(ts)

    def jacobi(s):
        x, y, z, vx, vy, vz = s
        r1 = np.sqrt((x + MU) ** 2 + y ** 2 + z ** 2)
        r2 = np.sqrt((x - 1 + MU) ** 2 + y ** 2 + z ** 2)
        return (2 * (0.5 * (x ** 2 + y ** 2) + (1 - MU) / r1 + MU / r2)
                - (vx ** 2 + vy ** 2 + vz ** 2))

    jac = float(np.max(np.abs(jacobi(traj) - jacobi(ARENSTORF))))
    period_err = float(max(abs(final[0] - ARENSTORF[0]),
                           abs(final[1] - ARENSTORF[1])))
    res64 = solve_ivp(rhs.cr3bp, (0, PERIOD), ARENSTORF, chunk_steps=64, **kw)
    same64 = (all(np.array_equal(res[f], res64[f])
                  for f in ("t", "y", "nfev", "nstep", "naccpt", "nrejct"))
              and np.array_equal(res.sol(ts), res64.sol(ts)))

    # The kernel and the plain version on the card, on solve_ivp's one lane.
    y0 = torch.as_tensor(ARENSTORF, device=dev).reshape(1, 6)
    one = lambda v: torch.full((1,), v, dtype=torch.float64, device=dev)
    a = (y0, one(0.0), one(PERIOD), one(PERIOD), None,
         torch.full((1, 6), 1e-12, dtype=torch.float64, device=dev),
         torch.full((1, 6), 1e-14, dtype=torch.float64, device=dev), (MU,),
         2**31 - 2)
    got, k_ms, dev_ms = kernel_device_ms(lambda: R.erk_record_cuda(
        "DOP853", rhs.cr3bp, *a, rec_cap=4096, record_cont=True))
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    ref = R.erk_record_torch("DOP853", rhs.cr3bp, *a, rec_cap=4096,
                             record_cont=True)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    f = lambda s: rhs.cr3bp(torch.zeros(s.shape[:-1], dtype=s.dtype,
                                        device=s.device).reshape(-1),
                            s.reshape(-1, 6), MU).reshape(s.shape)
    counters, errs = record_errors(got, ref, "DOP853", f)
    steps = {k: int(getattr(got, k)[0]) for k in ("nstep", "naccpt",
                                                  "nrejct", "nfev")}
    plain_steps = {k: int(getattr(ref, k)[0]) for k in steps}
    bound_ms, bound_by = R.record_bound("DOP853", rhs.cr3bp, got.nstep,
                                        got.naccpt, got.n_rec, True)
    phase("solve_ivp_cr3bp", success=bool(res.success), status=res.status,
          launches=launches, period_err=period_err, jacobi_err=jac,
          chunk_steps64_bitwise=same64,
          solve_ms=[round(1e3 * w, 3) for w in walls], kernel_ms=k_ms,
          device_ms=dev_ms, plain_ms=plain_ms, steps=steps,
          plain_steps=plain_steps, counters_equal=counters,
          **{f"max_err_{k}": v for k, v in errs.items()},
          bound_ms=bound_ms, bound_by=bound_by)
    if not res.success or period_err > 1e-6 or jac > 1e-8 or not same64:
        raise AssertionError("solve_ivp_cr3bp: gate failed")
    # The kernel against the plain version: on the first, tiny steps after
    # hinit the error estimate is a cancelling sum's rounding noise (ROADMAP
    # §3 fault 2), which nvcc's FMAs and torch's separate operations make of
    # different sizes, so the two step sequences may part there.  Held: the
    # same status, nstep within 1% and the final state within 1e-8 (the
    # periodicity gate's 1e-6 with room).
    if (int(got.status[0]) != int(ref.status[0])
            or abs(steps["nstep"] - plain_steps["nstep"])
            > max(2, 0.01 * plain_steps["nstep"])
            or float((got.y - ref.y).abs().max()) > 1e-8):
        raise AssertionError("solve_ivp_cr3bp: kernel and plain version "
                             "part")
    return dict(launches=launches["dop853_record_cont"], ms=k_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=errs["final"], steps=steps,
                plain_steps=plain_steps)


def record_main_paths(dev):
    """The recording ensemble at full width (Lorenz, B=16384, numpy y0, no
    device) through ``solve_ivp_ensemble(dense_output=True)`` and
    ``(record_trajectories=True)``, every method (the spans of
    RECORD_CONFIGS), DOP853 on bench.py's configuration cut to t in [0, 20]
    with rec_chunk=1024: success on every lane and n_steps_rec == naccpt,
    timed end to end, with the kernel's device time, the launches (chunks)
    of one solve (the counts set to 0 just before it, read just after),
    the bytes recorded and their rate, the bound, and the kernel's staging
    of the rows (row stride, staged rows a lane, shared memory a block,
    blocks resident an SM; kernels/erk_record.py::record_layout).  DOP853
    dense: ``sol``
    at each lane's recorded t against ``ys`` (1e-12) and on a 100-point grid
    in [0, 5] against the sampled dop853 kernel solving t in [0, 20] with
    that grid (1e-9 scaled).  ``{kernel: row}``."""
    from ivp_tpu_torch import Status, build_ensemble_solver, rhs
    from ivp_tpu_torch import solve_ivp_ensemble
    from ivp_tpu_torch.kernels import erk_record as R

    B = LORENZ_B
    y0n = lorenz_y0(B, seed=8)
    rows = {}
    for method, _, tf, (rtol, atol), opts in RECORD_CONFIGS:
        for cont in (True, False):
            name = R.record_kernel(method, cont)
            kw = dict(rtol=rtol, atol=atol, max_steps=200_000,
                      dense_output=cont, record_trajectories=not cont, **opts)
            solve = lambda: solve_ivp_ensemble(rhs.lorenz, (0.0, tf), y0n,
                                               method, **kw)
            solve()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            del res
            # The main path's run: the counts set to 0 just before, read
            # just after.
            (res, k_ms, dev_ms), launches = launches_of(
                lambda: kernel_device_ms(solve))
            if set(launches) != {name}:
                raise AssertionError(f"{name}: the solve launched {launches}")
            chunks = launches[name]
            W = R.record_width(method, 3, cont)
            nbytes = 8.0 * W * float(res.n_steps_rec.double().sum())
            # The kernel's staging of these rows (csrc/erk_common.cuh).
            lay = R.record_layout(method, rhs.lorenz, cont)
            layout = dict(row_stride_bytes=8 * lay["row_stride"],
                          staged_rows=lay["staged_rows"],
                          smem_bytes_per_block=lay["smem_bytes_per_block"],
                          blocks_per_sm=lay["blocks_per_sm"])
            bound_ms, bound_by = R.record_bound(
                method, rhs.lorenz, res.nstep, res.naccpt, res.n_steps_rec,
                cont)
            ok = bool((res.status == Status.SUCCESS).all())
            counted = bool(torch.equal(res.n_steps_rec,
                                       res.naccpt.to(torch.int64)))
            phase(f"record_main_path_{name}_lorenz_B{B}", tf=tf,
                  success_fraction=float((res.status == 0).double().mean()),
                  n_steps_rec_is_naccpt=counted, wall_ms=1e3 * wall,
                  kernel_ms=k_ms, device_ms=dev_ms, chunks=chunks,
                  mean_rows=float(res.n_steps_rec.double().mean()),
                  max_rows=int(res.n_steps_rec.max()), bytes_recorded=nbytes,
                  gbytes_per_s=nbytes / (k_ms * 1e6), bound_ms=bound_ms,
                  bound_by=bound_by, bound_share=bound_ms / k_ms, **layout)
            if not ok or not counted or chunks < 1:
                raise AssertionError(f"{name}: not every lane recorded")
            if method == "DOP853" and cont:
                check_dense_lorenz(dev, res, y0n, tf, rtol, atol)
            rows[name] = dict(launches=chunks, wall_ms=1e3 * wall,
                              kernel_ms=k_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              bound_share=bound_ms / k_ms, chunks=chunks,
                              bytes_recorded=nbytes,
                              gbytes_per_s=nbytes / (k_ms * 1e6),
                              layout=layout)
            del res
    return rows


def check_dense_lorenz(dev, res, y0n, tf, rtol, atol):
    """``sol`` of the B=16384 DOP853 dense solve at each lane's recorded t
    against ``ys`` (1e-12 scaled) and on a 100-point grid in [0, 5] against
    y_samples of the sampled dop853 kernel on the same lanes and span."""
    from ivp_tpu_torch import build_ensemble_solver, rhs

    S = res.ts.shape[1]
    worst_rec = 0.0
    for j in range(0, S, 128):
        ts = res.ts[:, j:j + 128]
        valid = (torch.arange(j, j + ts.shape[1], device=dev)[None, :]
                 < res.n_steps_rec[:, None])
        got = res.sol(ts).permute(0, 2, 1)
        d = ((got - res.ys[:, j:j + 128]).abs().amax(-1)
             / torch.clamp_min(res.ys[:, j:j + 128].abs().amax(-1), 1.0))
        worst_rec = max(worst_rec, float(torch.where(valid, d, 0.0).max()))
    grid = np.linspace(0.0, 5.0, LORENZ_M)
    sampled = build_ensemble_solver(rhs.lorenz, "DOP853", n=3,
                                    max_steps=200_000, t_eval=grid)(
        y0n, 0.0, tf, rtol, atol)
    dense = res.sol(grid).permute(0, 2, 1)
    worst_grid = float(((dense - sampled.y_samples).abs().amax(-1)
                        / torch.clamp_min(sampled.y_samples.abs().amax(-1),
                                          1.0)).max())
    same_steps = float((sampled.nstep == res.nstep).double().mean())
    phase("ensemble_dense_lorenz_B16384_sol", sol_at_records_err=worst_rec,
          sol_vs_sampled_kernel_err=worst_grid,
          nstep_equal_to_sampled=same_steps)
    if worst_rec > 1e-12 or worst_grid > 1e-9:
        raise AssertionError("dense Lorenz: sol disagrees")


def record_short_span_vs_plain(dev):
    """Every record instantiation of the recording Lorenz main path at its
    shape (B=16384, rec_cap=1024, each method's tolerances and options) lane
    by lane against the plain version on the card, on the main path's span
    cut to t in [0, 5] (Lorenz lanes stay together that long), both timed
    there (CUDA events around the whole call, one chunk).  ``{kernel:
    row}``."""
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import erk_record as R

    B = LORENZ_B
    y0 = torch.as_tensor(lorenz_y0(B, seed=8), device=dev)
    out = {}
    for method, _, tf_main, (rtol, atol), opts in RECORD_CONFIGS:
        tf = min(tf_main, LORENZ_T_LANES)
        a = solve_args(y0, tf, rtol, atol, opts.get("first_step"),
                               dev)
        for cont in (True, False):
            kw = dict(rec_cap=1024, record_cont=cont)
            run = lambda: R.erk_record_cuda(method, rhs.lorenz, *a, (),
                                            200_000, **kw)
            run()
            got, k_ms = event_call(run)
            ref, p_ms = event_call(lambda: R.erk_record_torch(
                method, rhs.lorenz, *a, (), 200_000, **kw))
            counters, errs = record_errors(got, ref, method)
            name = R.record_kernel(method, cont)
            b_ms, b_by = R.record_bound(method, rhs.lorenz, got.nstep,
                                        got.naccpt, got.n_rec, cont)
            phase(f"record_short_span_{name}_lorenz_B{B}_tf{tf:g}",
                  chunks=got.chunks,
                  mean_rows=float(got.n_rec.double().mean()),
                  **{f"{k}_equal": v for k, v in counters.items()},
                  **{f"max_err_{k}": v for k, v in errs.items()},
                  kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
            check_record(f"{name} at B={B}", counters, errs)
            err = max(errs["shifted"], errs["dense"], errs["final"])
            out[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, bound_share=b_ms / k_ms,
                             max_abs_err=err,
                             inputs=f"Lorenz B={B}, t in [0, {tf:g}], "
                                    f"rec_cap=1024")
    return out


def facade_host_time(dev):
    """ROADMAP §1 item 13: the host's share of one sampled Lorenz DOP853
    solve at B=16384 (t in [0, 5], 100 samples) through solve_ivp_ensemble
    from a numpy y0: the wall time to the result, with the facade's caches
    warm and with them cleared before each call (what every call cost
    before they existed), against the kernel's device time (torch.profiler);
    and the parts of one call on the host, each timed alone."""
    from ivp_tpu_torch import batch, build_ensemble_solver, rhs
    from ivp_tpu_torch import solve_ivp_ensemble
    from ivp_tpu_torch.kernels import build
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.methods import get_engine

    B, m = LORENZ_B, LORENZ_M
    y0n = lorenz_y0(B, seed=9)
    grid = np.linspace(0.0, 5.0, m)
    kw = dict(rtol=LORENZ_TOL[0], atol=LORENZ_TOL[1], max_steps=200_000,
              t_eval=grid)
    solve = lambda: solve_ivp_ensemble(rhs.lorenz, (0.0, 5.0), y0n, "DOP853",
                                       **kw)

    def clear():
        batch._ENSEMBLE_CACHE.clear()
        K._default_params.cache_clear()
        K._FUNCTOR_SHAPES.clear()

    def wall_ms(cold, n=10):
        walls = []
        for i in range(n + 1):
            if cold:
                clear()
            t = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            if i:
                walls.append(1e3 * (time.perf_counter() - t))
            del res
        return float(np.median(walls)), walls

    _, k_ms, dev_ms = kernel_device_ms(solve)
    cold, cold_all = wall_ms(True)
    warm, warm_all = wall_ms(False)
    # The caches change no output: a call after clearing them and a call
    # through them, bit for bit.
    clear()
    a = solve()
    b = solve()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(a, b)
               if torch.is_tensor(x))
    del a, b

    def host_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / n

    lib = build.library("erk_dop853")
    parts = dict(
        y0_to_card=host_ms(lambda: torch.as_tensor(y0n, device=dev)),
        tolerances_and_lanes=host_ms(lambda: (
            batch._norm_tol(1e-8, B, 3, torch.float64, dev, "rtol"),
            batch._norm_tol(1e-10, B, 3, torch.float64, dev, "atol"),
            batch._lanes(0.0, B, torch.float64, dev),
            batch._lanes(5.0, B, torch.float64, dev))),
        grid_to_card=host_ms(lambda: torch.as_tensor(grid, device=dev)),
        functor_shape_ctypes=host_ms(lambda: tuple(
            build.entry(f"ivp_rhs_{q}_lorenz", [], lib=lib)()
            for q in ("n", "nargs"))),
        default_params_build=host_ms(lambda: get_engine("DOP853",
                                                        need_cont=True)),
        solver_build=host_ms(lambda: build_ensemble_solver(
            rhs.lorenz, "DOP853", n=3, max_steps=200_000, t_eval=grid)))
    phase("facade_host_B16384", cached_equals_cold=same, kernel_ms=k_ms,
          device_ms=dev_ms,
          cold_wall_ms=cold, warm_wall_ms=warm,
          cold_host_share=(cold - k_ms) / cold,
          warm_host_share=(warm - k_ms) / warm,
          cold_walls_ms=[round(x, 4) for x in cold_all],
          warm_walls_ms=[round(x, 4) for x in warm_all],
          **{f"{k}_ms": round(v, 4) for k, v in parts.items()})
    if not same:
        raise AssertionError("the facade's caches changed an output")


def record_phase(dev):
    """Every record instantiation against its plain version and chunked
    against unchunked; then its main paths (solve_ivp on CR3BP, the
    recording Lorenz ensemble), each solve's launches counted from 0 around
    it alone; then the facade's host time.  The JSON rows of the record
    kernels."""
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import erk_record as R

    t = time.perf_counter()
    rec_checks = record_vs_plain(dev)
    record_chunking_bitwise(dev)
    short = record_short_span_vs_plain(dev)
    phase("record_checks", seconds=round(time.perf_counter() - t, 3))
    t = time.perf_counter()
    cr3bp_row = solve_ivp_cr3bp(dev)
    rec_rows = record_main_paths(dev)
    per_solve = {name: {"ensemble_lorenz_B16384": row["launches"]}
                 for name, row in rec_rows.items()}
    per_solve["dop853_record_cont"]["solve_ivp_cr3bp"] = \
        cr3bp_row["launches"]
    phase("record_main_paths", seconds=round(time.perf_counter() - t, 3),
          launches_per_solve=per_solve)
    facade_host_time(dev)
    rows = []
    for method, *_ in RECORD_CONFIGS:
        for cont in (False, True):
            name = R.record_kernel(method, cont)
            # Its own shapes first (B=16384, rec_cap=1024), then B=4096 with
            # rec_cap=37 over every mode; the error is the worse of the two.
            same_inputs = dict(rec_checks[name])
            err = max(same_inputs["max_abs_err"], short[name]["max_abs_err"])
            same_inputs.update(short[name], max_abs_err=err)
            main = {f"main_path_{k}": v for k, v in rec_rows[name].items()
                    if k not in ("launches", "layout")}
            row = {"name": name, "route": "cuda",
                   "source": f"ivp_tpu_torch/csrc/{K.KERNELS[method][1]}.cu",
                   "replaces": "ivp_tpu/core/driver.py:286",
                   "launches": sum(per_solve[name].values()),
                   "launches_per_solve": per_solve[name], "library_ms": None,
                   **same_inputs, **main, **rec_rows[name]["layout"]}
            if name == "dop853_record_cont":
                row["solve_ivp_cr3bp"] = cr3bp_row
            rows.append(row)
    return rows


# =============================================================================
# Events and in-loop restarts: the event modes of the erk kernels
# =============================================================================

# The bouncing-ball main path (examples/bouncing_ball.py::main_in_device at
# the headline's B): RK45, rtol = atol = 1e-9, t in [0, 15], heights 2..20 m,
# the ground event with its restart, 16 occurrences a lane, 8 restarts.
BALL_TOL, BALL_TF, BALL_CAP, BALL_RESTARTS = 1e-9, 15.0, 16, 8
G, COR = 9.81, 0.8
# The Lorenz section main path: DOP853 at bench.py's Lorenz tolerances,
# B=16384, t in [0, 20], 64 occurrences a lane; lanes held one by one on
# t in [0, 5], the ensemble (mean crossings) on [0, 20].
SECTION_TF, SECTION_CAP = 20.0, 64
# The B=4096 checks of every method and mode: per method its tolerances on
# the Lorenz section (on t in [0, 2]) and RK4's fixed steps.
EVENT_LORENZ = {"DOPRI5": (1e-8, 1e-10, None), "DOP853": (*LORENZ_TOL, None),
                "RK23": (1e-6, 1e-8, None), "RK4": (1e-6, 1e-8, 5e-3)}
EVENT_CHECK_TF = 2.0
# The RK23 section main path is held lane by lane against the plain version
# on t in [0, RK23_T_LANES] at its B and y0, and its own crossings up to
# RK23_T_LANES on the first CHECK_B lanes against the plain version's mean.
RK23_T_LANES = 2.0
RK4_BALL_STEP = 0.1
# The ball's B=4096 checks run to t = 8, where the shortest lanes have made
# their 8 restarts and the tallest 3: a depth cut from the main path's 15
# that keeps the smoke near 300 s beside the stiff phases.
BALL_CHECK_TF = 8.0
# Event times against the plain version, relative to max(1, |t|): both
# refine a root of the same step's interpolant to Brent's xtol (2e-12), and
# the interpolants differ in their last bits (nvcc's FMAs).
T_EVENT = 1e-9
# DOP853 on the ball, whose parabola every Runge-Kutta step integrates
# exactly: the error estimate is rounding noise, unclamped by DOP853's
# controller (it clamps below err 2.6e-7, DOPRI5's below 6e-6, RK23's below
# 7e-4), so nvcc's FMAs and torch's separate operations pick other step
# sizes (ROADMAP §3 fault 2; ivp_tpu and the plain version part the same way
# on the CPU).  Its counters are held equal on DOP853_BALL_FRACTION of the
# lanes: on an H100 (B=4096) they were equal on 85.7% (lean, record) and
# 95.0% (sampled), so the gate is that low end less a margin; status,
# n_events, n_restarts and the event times are held on every lane.  Its
# record rows are not held: a lane whose steps part has other rows.
DOP853_BALL_FRACTION = 0.8


def ball_y0(B):
    return np.stack([np.linspace(2.0, 20.0, B), np.zeros(B)], axis=1)


def ball_f(y):
    """The ball's RHS on (..., 2) arrays (torch)."""
    return torch.stack([y[..., 1], torch.zeros_like(y[..., 1]) - G], -1)


def event_cases(dev):
    """The B=4096 checks: ``(set, method, mode, fun, kernel args, grid,
    EventArgs, f)``, ``set`` the name of events.SETS.  The ball: the main path's configuration (heights
    2..20, 8 restarts), sampled with 2 restarts (so the third bounce ends
    each lane and the grid runs on past it); the Lorenz section on t in
    [0, 2]: every crossing, sampled with the third crossing terminal."""
    from ivp_tpu_torch import events as E
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.events import EventArgs

    Bc = CHECK_B
    T = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    yb = T(ball_y0(Bc))
    yl = T(lorenz_y0(Bc, seed=11))
    ball_grid = torch.broadcast_to(T(np.linspace(0.0, BALL_CHECK_TF, 31)),
                                   (Bc, 31))
    sec_grid = torch.broadcast_to(T(np.linspace(0.0, EVENT_CHECK_TF, 21)),
                                  (Bc, 21))
    out = []
    for method, (rtol, atol, h) in EVENT_LORENZ.items():
        ab = solve_args(yb, BALL_CHECK_TF, BALL_TOL, BALL_TOL,
                               RK4_BALL_STEP if method == "RK4" else None, dev)
        al = solve_args(yl, EVENT_CHECK_TF, rtol, atol, h, dev)
        full = EventArgs((E.ground,), BALL_CAP, BALL_RESTARTS)
        out += [("ground", method, "lean", rhs.ball, ab, None, full, ball_f),
                ("ground", method, "sampled", rhs.ball, ab, ball_grid,
                 EventArgs((E.ground,), BALL_CAP, 2), ball_f),
                ("ground", method, "record", rhs.ball, ab, None, full,
                 ball_f)]
        every = EventArgs((E.lorenz_section,), SECTION_CAP, 0)
        out += [("section", method, "lean", rhs.lorenz, al, None, every,
                 lorenz_f),
                ("section", method, "sampled", rhs.lorenz, al, sec_grid,
                 EventArgs((E.lorenz_section.replace(terminal=3),),
                           SECTION_CAP, 0), lorenz_f),
                ("section", method, "record", rhs.lorenz, al, None, every,
                 lorenz_f)]
    return out


def event_errors(got, ref):
    """``(shares, errs)`` of two EventOuts: the share of lanes on which
    n_events, n_restarts and the overflow flags are equal; the largest
    difference of an event time (relative to max(1, |t|)) and state
    (relative to max(1, |y|) of its lane)."""
    shares = {}
    for f in ("n_events", "n_restarts", "event_overflow"):
        a, b = getattr(got, f), getattr(ref, f)
        shares[f] = float((a == b).reshape(a.shape[0], -1).all(1)
                          .double().mean())
    dt = ((got.t_events - ref.t_events).abs()
          / torch.clamp_min(ref.t_events.abs(), 1.0))
    dy = ((got.y_events - ref.y_events).abs().amax(-1)
          / torch.clamp_min(ref.y_events.abs().amax(-1), 1.0))
    return shares, dict(t_events=float(dt.max()) if dt.numel() else 0.0,
                        y_events=float(dy.max()) if dy.numel() else 0.0)


def uncut(r):
    """``(B, S)``: the rows of a record-event RecordResult that no event
    cut (their time is not one of the lane's event times)."""
    S = r.rec_t.shape[1]
    valid = torch.arange(S, device=r.rec_t.device)[None] < r.n_rec[:, None]
    ev = r.events.t_events.reshape(r.rec_t.shape[0], 1, -1)
    return valid & ~(r.rec_t[:, :, None] == ev).any(-1)


def uncut_sum_err(r):
    """record_errors' ``sum`` over the rows that no event cut."""
    if not r.rec_t.shape[1]:
        return 0.0
    d = ((r.rec_t - (r.rec_xold + r.rec_h)).abs()
         / torch.clamp_min(r.rec_t.abs(), 1.0))
    return float(torch.where(uncut(r), d, 0.0).max())


def uncut_step_err(got, ref):
    """record_errors' ``step`` (each lane's rows but its last, relative to
    |h|) over the rows that no event cut on either route.  A row an event
    cut keeps its step's h, and on the ball that h is sized from rounding
    noise (DOP853_BALL_FRACTION); the event time it ends at is held."""
    S = ref.rec_t.shape[1]
    if not S:
        return 0.0
    last = (torch.arange(S, device=ref.rec_t.device)[None]
            == ref.n_rec[:, None] - 1)
    rel_h = ((got.rec_h - ref.rec_h).abs()
             / torch.clamp_min(ref.rec_h.abs(),
                               torch.finfo(torch.float64).tiny))
    return float(torch.where(uncut(got) & uncut(ref) & ~last, rel_h,
                             0.0).max())


def same_bits(x, y):
    """``x`` and ``y`` equal element for element (NaN equal to NaN)."""
    if x.shape != y.shape:
        return False
    eq = x == y
    if x.is_floating_point():
        eq |= torch.isnan(x) & torch.isnan(y)
    return bool(eq.all())


def record_outputs(r):
    """A RecordResult as compare() takes it."""
    return (r.t, r.y, r.status, r.nfev, r.nstep, r.naccpt, r.nrejct,
            r.y_samples, r.n_samples)


def check_record_events(tag, got, ref, method, f):
    """Two record-event RecordResults of the same inputs: every counter
    equal on every lane and the rows as check_record holds them, with
    ``sum`` and ``step`` taken over the rows no event cut (a row an event
    cut ends at the event, short of xold + h).  ``(counters, errs)``."""
    counters, rerrs = record_errors(got, ref, method, f)
    rerrs["sum"] = max(uncut_sum_err(r) for r in (got, ref))
    rerrs["step_uncut"] = uncut_step_err(got, ref)
    phase(tag + "_rows", chunks=got.chunks,
          **{f"{k}_equal": v for k, v in counters.items()},
          **{f"max_err_{k}": v for k, v in rerrs.items()})
    check_record(tag, counters, dict(rerrs, step=rerrs["step_uncut"]))
    return counters, rerrs


def check_events(name, shares, errs):
    if min(shares.values()) < 1.0:
        raise AssertionError(f"{name}: event counts equal on only {shares}")
    if errs["t_events"] > T_EVENT or errs["y_events"] > Y_EQUAL_STEPS:
        raise AssertionError(f"{name}: events differ: {errs}")


def events_vs_plain(dev):
    """Every event instantiation against the plain version on the card at
    B=4096 (``event_cases``): lean, sampled, and the record mode with
    coefficients at rec_cap=37 (the event state crosses launches).  Status,
    n_events, n_restarts, the overflow flags and every counter equal on
    every lane (DOP853 on the ball: its counters on DOP853_BALL_FRACTION
    of the lanes, its rows not held); event times within T_EVENT, event states, final
    states, samples and rows as compare() and check_record() hold them.
    ``{kernel: row}`` (each mode's worst error, the times and bound of the
    lean ball and of the record ball)."""
    from ivp_tpu_torch.events import SETS
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import erk_record as R

    rows = {}
    for set_name, method, mode, fun, a, grid, ev, f in event_cases(dev):
        gate = (DOP853_BALL_FRACTION
                if (method, set_name) == ("DOP853", "ground")
                else COUNT_FRACTION)
        tag = f"events_vs_plain_{set_name}_{method}_{mode}_B{CHECK_B}"
        kw = dict(events=ev)
        if mode == "record":
            run = lambda: R.erk_record_cuda(method, fun, *a, (), 200_000,
                                            grid, rec_cap=REC_CAP_CHECK,
                                            record_cont=True, **kw)
            plain = lambda: R.erk_record_torch(method, fun, *a, (), 200_000,
                                               grid, rec_cap=REC_CAP_CHECK,
                                               record_cont=True, **kw)
            name = R.record_kernel(method, True, True)
        else:
            run = lambda: K.erk_ensemble_cuda(method, fun, *a, (), 200_000,
                                              grid, events=ev)
            plain = lambda: K.erk_ensemble_torch(method, fun, *a, (), 200_000,
                                                 grid, None, ev)
            name = f"{K.KERNELS[method][0]}_ev"
        run()
        got, k_ms = event_call(run)
        ref, p_ms = event_call(plain)
        if mode == "record":
            g_ev, r_ev = got.events, ref.events
            err = compare(tag, record_outputs(got), record_outputs(ref),
                          scaled=True, count_fraction=gate)
            if gate == COUNT_FRACTION:
                # On the ball every step is exact and the error estimate is
                # rounding noise, which nvcc's FMAs and torch's operations
                # make of different sizes: the controller sizes some steps
                # apart from it (by up to 18% on an H100 at B=4096), steps
                # that a bounce then cuts at the same event time, so the
                # counters, times, states and dense output stay equal while
                # those rows' h differ.  Every other row's h is held.
                _, rerrs = check_record_events(tag, got, ref, method, f)
                err = max(err, rerrs["shifted"], rerrs["dense"])
                if got.chunks < 2:
                    raise AssertionError(f"{tag}: {got.chunks} chunks")
            b_ms, b_by = R.record_bound(method, fun, got.nstep, got.naccpt,
                                        got.n_rec, True,
                                        events=(SETS[set_name], g_ev))
            b_every = b_ms   # coefficient records: rows on every step
        else:
            g_ev, r_ev = got[9], ref[9]
            err = compare(tag, got[:9], ref[:9], scaled=True,
                          count_fraction=gate)
            m = 0 if grid is None else grid.shape[1]
            b_ms, b_by, b_every = K.event_bound(
                method, fun, SETS[set_name], got[4], got[5], g_ev, got[8], m)
        shares, eerrs = event_errors(g_ev, r_ev)
        phase(tag + "_events", **{f"{k}_equal": v for k, v in shares.items()},
              **{f"max_err_{k}": v for k, v in eerrs.items()},
              brent_kernel=int(g_ev.n_brent.sum()),
              brent_plain=int(r_ev.n_brent.sum()),
              mean_events=float(g_ev.n_events.double().mean()),
              kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
              bound_ms_rows_every_accept=b_every)
        check_events(tag, shares, eerrs)
        err = max(err, eerrs["y_events"])
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if set_name == "ground" and mode != "sampled":
            row.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                       bound_share=b_ms / k_ms,
                       bound_ms_rows_every_accept=b_every,
                       inputs=f"ball B={CHECK_B}, t in [0, {BALL_CHECK_TF:g}], "
                              f"rtol=atol={BALL_TOL:g}"
                              + (f", rec_cap={REC_CAP_CHECK}"
                                 if mode == "record" else ""))
    return rows


def events_chunking_bitwise(dev):
    """Every record-event instantiation at rec_cap=37 against rec_cap=4096
    on the same inputs (B=4096), both record modes: the lanes that differ in
    any output, row or event buffer (NaN equal to NaN), which must be 0."""
    from ivp_tpu_torch.kernels import erk_record as R

    for set_name, method, mode, fun, a, grid, ev, _ in event_cases(dev):
        if mode != "record":
            continue
        for cont in (False, True):
            small, big = (R.erk_record_cuda(
                method, fun, *a, (), 200_000, grid, rec_cap=cap,
                record_cont=cont, events=ev) for cap in (REC_CAP_CHECK, 4096))
            torch.cuda.synchronize()
            Bc = a[0].shape[0]
            differ = torch.zeros(Bc, dtype=torch.bool, device=dev)
            pairs = [(getattr(small, n), getattr(big, n))
                     for n in R.RecordResult._fields
                     if n not in ("events", "chunks")]
            pairs += list(zip(small.events, big.events))
            for x, y in pairs:
                if x is None:
                    continue
                if x.shape != y.shape:
                    raise AssertionError(f"{method} {set_name}: shapes "
                                         f"{tuple(x.shape)} {tuple(y.shape)}")
                same = ((x == y) | (torch.isnan(x) & torch.isnan(y))
                        if x.is_floating_point() else x == y)
                differ |= ~same.reshape(Bc, -1).all(1)
            n = int(differ.sum())
            phase(f"events_chunking_bitwise_"
                  f"{R.record_kernel(method, cont, True)}_{set_name}_B{Bc}",
                  chunks=(small.chunks, big.chunks), lanes_differing=n)
            if n or big.chunks != 1 or small.chunks < 2:
                raise AssertionError(f"{method} {set_name}: {n} lanes differ")


def ball_main_path(dev):
    """The bouncing-ball ensemble at the headline's B through
    build_ensemble_solver with a numpy y0 and no device: one launch a solve
    (the counts set to 0 just before it, read just after), the kernel's
    device time (torch.profiler) and the solve's wall time; every lane
    succeeds or ends at its ninth bounce, with its first two bounces within
    1e-9 of the closed form.  One more launch on the same inputs, bit for
    bit the main path's result, gives the kernel's Brent count for the
    bound and is held lane by lane against the plain version on the card at
    this B, as events_vs_plain holds the B=4096 checks.  The main path's
    row."""
    from ivp_tpu_torch import Status, build_ensemble_solver, rhs
    from ivp_tpu_torch import events as E
    from ivp_tpu_torch.events import SETS, EventArgs
    from ivp_tpu_torch.kernels import erk_ensemble as K

    B = MAIN_B
    solver = build_ensemble_solver(rhs.ball, "RK45", n=2, events=[E.ground],
                                   event_capacity=BALL_CAP,
                                   max_restarts=BALL_RESTARTS)
    y0n = ball_y0(B)
    solve = lambda: solver(y0n, 0.0, BALL_TF, BALL_TOL, BALL_TOL)
    solve()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        del res
    (res, k_ms, dev_ms), launches = launches_of(
        lambda: kernel_device_ms(solve))
    if launches != {"dopri5_sampled_ev": 1}:
        raise AssertionError(f"ball main path launched {launches}")
    status = res.status
    nb, nr = res.n_events[:, 0], res.n_restarts
    h = torch.as_tensor(y0n[:, 0], device=dev)
    t1 = torch.sqrt(2.0 * h / G)
    t2 = t1 + 2.0 * COR * torch.sqrt(2.0 * G * h) / G
    err1 = float((res.t_events[:, 0, 0] - t1).abs().max())
    two = nb >= 2
    err2 = float((res.t_events[:, 0, 1] - t2).abs()[two].max())
    ev_bytes = sum(x.numel() * x.element_size() for x in (
        res.t_events, res.y_events, res.n_events, res.event_overflow,
        res.n_restarts))
    # The kernel's Brent evaluations, for the bound, and the kernel against
    # the plain version lane by lane.
    a = solve_args(torch.as_tensor(y0n, device=dev), BALL_TF, BALL_TOL,
                   BALL_TOL, None, dev)
    ev = EventArgs((E.ground,), BALL_CAP, BALL_RESTARTS)
    out = K.erk_ensemble_cuda("DOPRI5", rhs.ball, *a, (), 100_000,
                              events=ev)
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in zip(
        out[:7], (res.t, res.y, res.status, res.nfev, res.nstep, res.naccpt,
                  res.nrejct)))
    tag = f"ball_main_path_vs_plain_B{B}"
    ref, plain_ms = event_call(lambda: K.erk_ensemble_torch(
        "DOPRI5", rhs.ball, *a, (), 100_000, None, None, ev))
    err = compare(tag, out[:9], ref[:9], scaled=True)
    shares, eerrs = event_errors(out[9], ref[9])
    phase(tag + "_events", **{f"{k}_equal": v for k, v in shares.items()},
          **{f"max_err_{k}": v for k, v in eerrs.items()},
          brent_kernel=int(out[9].n_brent.sum()),
          brent_plain=int(ref[9].n_brent.sum()), plain_ms=plain_ms)
    check_events(tag, shares, eerrs)
    del ref
    bound_ms, bound_by, bound_every = K.event_bound(
        "DOPRI5", rhs.ball, SETS["ground"], res.nstep, res.naccpt, out[9])
    ok_status = bool(((status == Status.SUCCESS)
                      | (status == Status.USER_INTERRUPT)).all())
    stopped = status == Status.USER_INTERRUPT
    phase(f"ball_main_path_B{B}", launches=launches,
          success_share=float((status == Status.SUCCESS).double().mean()),
          interrupt_share=float(stopped.double().mean()),
          bounces=(int(nb.min()), int(nb.max())),
          restarts=(int(nr.min()), int(nr.max())),
          mean_nstep=float(res.nstep.double().mean()),
          max_nstep=int(res.nstep.max()),
          brent_evals_per_lane=float(out[9].n_brent.double().mean()),
          first_bounce_err=err1, second_bounce_err=err2,
          kernel_ms=k_ms, device_ms=dev_ms,
          walls_ms=[round(1e3 * w, 3) for w in walls],
          event_buffer_bytes=ev_bytes, bound_ms=bound_ms, bound_by=bound_by,
          bound_share=bound_ms / k_ms,
          bound_ms_rows_every_accept=bound_every, rerun_bitwise=same)
    if (not ok_status or not bool((nr[stopped] == BALL_RESTARTS).all())
            or not bool((nr <= BALL_RESTARTS).all()) or err1 > 1e-9
            or err2 > 1e-9 or not bool(torch.isfinite(res.y).all())
            or tuple(res.t_events.shape) != (B, 1, BALL_CAP) or not same
            or bool(res.event_overflow.any())):
        raise AssertionError("ball main path: gate failed")
    return dict(launches=1, kernel_ms=k_ms, device_ms=dev_ms,
                wall_ms=1e3 * float(np.median(walls)), plain_ms=plain_ms,
                max_abs_err=max(err, eerrs["y_events"]), bound_ms=bound_ms,
                bound_by=bound_by, bound_share=bound_ms / k_ms,
                bound_ms_rows_every_accept=bound_every,
                event_buffer_bytes=ev_bytes)


def section_main_path(dev):
    """The Lorenz section at B=16384 (DOP853, bench.py's tolerances, t in
    [0, 20], every crossing) through build_ensemble_solver, and its
    terminal=5 variant: one launch each.  Lane by lane against the plain
    version on t in [0, 5] (both timed there); on [0, 20] the mean crossings
    of the first 4096 lanes within 1% of the plain version's on them; the
    terminal variant lane by lane against the plain version on the first
    4096 lanes.  The main path's row."""
    from ivp_tpu_torch import Status, build_ensemble_solver, rhs
    from ivp_tpu_torch import events as E
    from ivp_tpu_torch.events import SETS, EventArgs
    from ivp_tpu_torch.kernels import erk_ensemble as K

    B, Bc = LORENZ_B, CHECK_B
    y0n = lorenz_y0(B, seed=9)
    every = E.lorenz_section
    stop5 = E.lorenz_section.replace(terminal=5)
    solvers = {name: build_ensemble_solver(
        rhs.lorenz, "DOP853", n=3, events=[e], event_capacity=SECTION_CAP,
        max_steps=200_000) for name, e in (("every", every), ("stop5", stop5))}
    rtol, atol = LORENZ_TOL
    res = {}
    launches = {}
    for name, solver in solvers.items():
        solve = lambda: solver(y0n, 0.0, SECTION_TF, rtol, atol)
        solve()
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        del r
        (r, k_ms, dev_ms), seen = launches_of(
            lambda: kernel_device_ms(solve))
        if seen != {"dop853_ev": 1}:
            raise AssertionError(f"section main path {name} launched {seen}")
        launches[name] = 1
        res[name] = (r, k_ms, dev_ms, wall)
    r, k_ms, dev_ms, wall = res["every"]
    y0 = torch.as_tensor(y0n, device=dev)
    # The plain version on the first 4096 lanes, t in [0, 20]: the mean.
    a = solve_args(y0[:Bc].contiguous(), SECTION_TF, rtol, atol, None,
                          dev)
    ev = EventArgs((every,), SECTION_CAP, 0)
    plain_20, plain20_ms = event_call(lambda: K.erk_ensemble_torch(
        "DOP853", rhs.lorenz, *a, (), 200_000, None, None, ev))
    mean_k = float(r.n_events[:Bc, 0].double().mean())
    mean_p = float(plain_20[9].n_events[:, 0].double().mean())
    gap = abs(mean_k / mean_p - 1.0)
    # Lane by lane on [0, 5], at the main path's B.
    a5 = solve_args(y0, LORENZ_T_LANES, rtol, atol, None, dev)
    run = lambda: K.erk_ensemble_cuda("DOP853", rhs.lorenz, *a5, (), 200_000,
                                      events=ev)
    run()
    got, lane_ms = event_call(run)
    ref, lane_plain_ms = event_call(lambda: K.erk_ensemble_torch(
        "DOP853", rhs.lorenz, *a5, (), 200_000, None, None, ev))
    tag = f"section_vs_plain_B{B}_tf{LORENZ_T_LANES:g}"
    err = compare(tag, got[:9], ref[:9], scaled=True)
    shares, eerrs = event_errors(got[9], ref[9])
    b5_ms, b5_by, b5_every = K.event_bound(
        "DOP853", rhs.lorenz, SETS["section"], got[4], got[5], got[9])
    phase(tag + "_events", **{f"{k}_equal": v for k, v in shares.items()},
          **{f"max_err_{k}": v for k, v in eerrs.items()},
          brent_kernel=int(got[9].n_brent.sum()),
          brent_plain=int(ref[9].n_brent.sum()), kernel_ms=lane_ms,
          plain_ms=lane_plain_ms, bound_ms=b5_ms, bound_by=b5_by,
          bound_ms_rows_every_accept=b5_every)
    check_events(tag, shares, eerrs)
    # The terminal variant, lane by lane on the first 4096 lanes.
    rs = res["stop5"][0]
    ev5 = EventArgs((stop5,), SECTION_CAP, 0)
    got5 = K.erk_ensemble_cuda("DOP853", rhs.lorenz, *a, (), 200_000,
                               events=ev5)
    ref5 = K.erk_ensemble_torch("DOP853", rhs.lorenz, *a, (), 200_000, None,
                                None, ev5)
    torch.cuda.synchronize()
    compare(f"section_stop5_vs_plain_B{Bc}", got5[:9], ref5[:9], scaled=True)
    shares5, eerrs5 = event_errors(got5[9], ref5[9])
    check_events("section_stop5", shares5, eerrs5)
    # The main path's bound, from one more launch's Brent count.
    a20 = solve_args(y0, SECTION_TF, rtol, atol, None, dev)
    out = K.erk_ensemble_cuda("DOP853", rhs.lorenz, *a20, (), 200_000,
                              events=ev)
    torch.cuda.synchronize()
    bound_ms, bound_by, bound_every = K.event_bound(
        "DOP853", rhs.lorenz, SETS["section"], r.nstep, r.naccpt, out[9])
    phase(f"section_main_path_B{B}", launches=launches,
          success_share=float((r.status == Status.SUCCESS).double().mean()),
          crossings=(int(r.n_events.min()), int(r.n_events.max())),
          mean_crossings=float(r.n_events.double().mean()),
          mean_crossings_gap_B4096=gap, plain_mean_crossings_B4096=mean_p,
          plain_ms_B4096_tf20=plain20_ms, overflow=bool(r.event_overflow.any()),
          mean_nstep=float(r.nstep.double().mean()), kernel_ms=k_ms,
          device_ms=dev_ms, wall_ms=1e3 * wall,
          brent_evals_per_lane=float(out[9].n_brent.double().mean()),
          bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / k_ms,
          bound_ms_rows_every_accept=bound_every,
          stop5_interrupt_share=float(
              (rs.status == Status.USER_INTERRUPT).double().mean()),
          stop5_kernel_ms=res["stop5"][1],
          stop5_t_max=float(rs.t.max()))
    if (gap > MEAN_NSTEP or not bool((r.status == Status.SUCCESS).all())
            or bool(r.event_overflow.any())
            or not bool((rs.status == Status.USER_INTERRUPT).all())
            or not bool((rs.n_events[:, 0] == 5).all())):
        raise AssertionError("section main path: gate failed")
    return dict(launches=sum(launches.values()), ms=lane_ms,
                plain_ms=lane_plain_ms, bound_ms=b5_ms, bound_by=b5_by,
                bound_share=b5_ms / lane_ms,
                bound_ms_rows_every_accept=b5_every, max_abs_err=max(
                    err, eerrs["y_events"]),
                inputs=f"Lorenz B={B}, t in [0, {LORENZ_T_LANES:g}]",
                main_path_kernel_ms=k_ms, main_path_wall_ms=1e3 * wall,
                main_path_bound_ms=bound_ms,
                main_path_bound_share=bound_ms / k_ms)


def rk23_section_main_path(dev):
    """The Lorenz section by RK23 at B=16384 (bench.py's Lorenz tolerances,
    t in [0, 20], every crossing, SECTION_CAP occurrences a lane) through
    build_ensemble_solver with a numpy y0: one launch, the counts set to 0
    just before the solve and read just after, the kernel's device time by
    torch.profiler and the solve's wall time; every lane succeeds without
    overflow.  One more launch on the same inputs, bit for bit the main
    path's result, gives the kernel's Brent count for the bound
    (erk_ensemble.event_bound).  At the main path's B and y0 the kernel is
    held lane by lane against the plain version on the card on t in [0,
    RK23_T_LANES] (both timed there; compare() and event_errors() at the
    events' bounds), and the main path's own crossings up to RK23_T_LANES on
    its first 4096 lanes lie within 1% of the plain version's on them: the
    plain RK23 takes about 6.6 ms a step on an H100 (about 24100 steps to
    t = 20 at rtol 1e-8, 2.6 minutes), so the plain version's depth is
    cut.  The row's fields: the main path's kernel ms by profiler and its
    bound; the plain version's ms and the kernel's (lane_ms) on the lane
    check's inputs."""
    from ivp_tpu_torch import Status, build_ensemble_solver, rhs
    from ivp_tpu_torch import events as E
    from ivp_tpu_torch.events import SETS, EventArgs
    from ivp_tpu_torch.kernels import erk_ensemble as K

    B, Bc = LORENZ_B, CHECK_B
    y0n = lorenz_y0(B, seed=9)
    rtol, atol = LORENZ_TOL
    solver = build_ensemble_solver(
        rhs.lorenz, "RK23", n=3, events=[E.lorenz_section],
        event_capacity=SECTION_CAP, max_steps=200_000)
    solve = lambda: solver(y0n, 0.0, SECTION_TF, rtol, atol)
    solve()
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    del r
    (r, k_ms, dev_ms), launches = launches_of(lambda: kernel_device_ms(solve))
    if launches != {"rk23_ev": 1}:
        raise AssertionError(f"RK23 section main path launched {launches}")
    y0 = torch.as_tensor(y0n, device=dev)
    ev = EventArgs((E.lorenz_section,), SECTION_CAP, 0)
    a = solve_args(y0, SECTION_TF, rtol, atol, None, dev)
    out = K.erk_ensemble_cuda("RK23", rhs.lorenz, *a, (), 200_000, events=ev)
    torch.cuda.synchronize()
    same = all(torch.equal(u, v) for u, v in zip(
        out[:7], (r.t, r.y, r.status, r.nfev, r.nstep, r.naccpt, r.nrejct)))
    same = same and torch.equal(out[9].t_events, r.t_events)
    # Lane by lane on [0, RK23_T_LANES], at the main path's B and y0.
    al = solve_args(y0, RK23_T_LANES, rtol, atol, None, dev)
    run = lambda: K.erk_ensemble_cuda("RK23", rhs.lorenz, *al, (), 200_000,
                                      events=ev)
    run()
    got, lane_ms = event_call(run)
    ref, lane_plain_ms = event_call(lambda: K.erk_ensemble_torch(
        "RK23", rhs.lorenz, *al, (), 200_000, None, None, ev))
    tag = f"rk23_section_vs_plain_B{B}_tf{RK23_T_LANES:g}"
    err = compare(tag, got[:9], ref[:9], scaled=True)
    shares, eerrs = event_errors(got[9], ref[9])
    lb_ms, lb_by, lb_every = K.event_bound(
        "RK23", rhs.lorenz, SETS["section"], got[4], got[5], got[9])
    phase(tag + "_events", **{f"{k}_equal": v for k, v in shares.items()},
          **{f"max_err_{k}": v for k, v in eerrs.items()},
          brent_kernel=int(got[9].n_brent.sum()),
          brent_plain=int(ref[9].n_brent.sum()), kernel_ms=lane_ms,
          plain_ms=lane_plain_ms, bound_ms=lb_ms, bound_by=lb_by,
          bound_ms_rows_every_accept=lb_every)
    check_events(tag, shares, eerrs)
    # The main path's crossings up to RK23_T_LANES on its first Bc lanes.
    cap = torch.arange(SECTION_CAP, device=dev)
    kept = ((cap < r.n_events[:Bc, :, None])
            & (r.t_events[:Bc] <= RK23_T_LANES))
    mean_k = float(kept.sum((1, 2)).double().mean())
    mean_p = float(ref[9].n_events[:Bc, 0].double().mean())
    gap = abs(mean_k / mean_p - 1.0)
    del got, ref
    bound_ms, bound_by, bound_every = K.event_bound(
        "RK23", rhs.lorenz, SETS["section"], r.nstep, r.naccpt, out[9])
    phase(f"rk23_section_main_path_B{B}", launches=launches,
          success_share=float((r.status == Status.SUCCESS).double().mean()),
          crossings=(int(r.n_events.min()), int(r.n_events.max())),
          mean_crossings=float(r.n_events.double().mean()),
          mean_crossings_B4096_to_t=RK23_T_LANES,
          main_path_mean_crossings_B4096=mean_k,
          plain_mean_crossings_B4096=mean_p, mean_crossings_gap=gap,
          overflow=bool(r.event_overflow.any()),
          mean_nstep=float(r.nstep.double().mean()), kernel_ms=k_ms,
          device_ms=dev_ms, wall_ms=1e3 * wall,
          brent_evals_per_lane=float(out[9].n_brent.double().mean()),
          bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / k_ms,
          bound_ms_rows_every_accept=bound_every, rerun_bitwise=same)
    if (gap > MEAN_NSTEP or not bool((r.status == Status.SUCCESS).all())
            or bool(r.event_overflow.any()) or not same
            or not bool(torch.isfinite(r.y).all())):
        raise AssertionError("RK23 section main path: gate failed")
    return dict(launches=1, ms=k_ms, plain_ms=lane_plain_ms,
                plain_inputs=f"B={B}, t in [0, {RK23_T_LANES:g}]",
                lane_ms=lane_ms, lane_bound_ms=lb_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / k_ms,
                bound_ms_rows_every_accept=bound_every,
                max_abs_err=max(err, eerrs["y_events"]),
                inputs=f"Lorenz B={B}, t in [0, {SECTION_TF:g}], "
                       f"rtol={rtol:g}, atol={atol:g}",
                main_path_wall_ms=1e3 * wall)


def ball_solve_ivp(dev):
    """solve_ivp on the card with the ball's event set: every bounce
    restarted in the record-event kernel (t in [0, 12], 10 restarts, status
    1; the first two bounces within 1e-9 of the closed form; every counter
    equal to the plain version's on the CPU), then examples/bouncing_ball.py
    ::main, the host loop of six terminal bounces, against SciPy's
    solve_ivp with the same event (bounce times and impact speeds within
    1e-8).  Then the recording ensemble of the ball (dense_output, B=16384,
    restarts): every lane's dense solution at its bounces at height 0
    within 1e-8, and one more launch of its kernel on the same inputs, bit
    for bit its result, held lane by lane against the plain version on the
    card (rows, coefficients and event buffers, as events_vs_plain holds
    the record mode).  ``({kernel: launches} of the three, the recording
    ensemble's worst error against the plain version, its plain ms)``."""
    from scipy.integrate import solve_ivp as scipy_solve_ivp

    from ivp_tpu_torch import Status, rhs, solve_ivp, solve_ivp_ensemble
    from ivp_tpu_torch import events as E
    from ivp_tpu_torch.events import EventArgs
    from ivp_tpu_torch.kernels import erk_record as R

    kw = dict(method="RK45", rtol=1e-9, atol=1e-9)
    solve = lambda: solve_ivp(rhs.ball, (0.0, 12.0), [10.0, 0.0],
                              events=[E.ground], max_restarts=10, **kw)
    solve()
    r, launches = launches_of(solve)
    cpu = solve_ivp(rhs.ball, (0.0, 12.0), [10.0, 0.0], events=[E.ground],
                    max_restarts=10, device="cpu", **kw)
    t1, v0 = np.sqrt(2 * 10.0 / G), np.sqrt(2 * G * 10.0)
    tb = r.t_events[0]
    e1, e2 = abs(tb[0] - t1), abs(tb[1] - (t1 + 2 * COR * v0 / G))
    same = all(r[f] == cpu[f] for f in ("status", "nfev", "nstep", "naccpt",
                                        "nrejct", "n_restarts"))
    phase("solve_ivp_ball_restarts", status=r.status, n_restarts=r.n_restarts,
          bounces=len(tb), first_bounce_err=e1, second_bounce_err=e2,
          counters_equal_cpu=same, launches=launches)
    if (r.status != 1 or r.n_restarts != 10 or e1 > 1e-9 or e2 > 1e-9
            or not same):
        raise AssertionError("solve_ivp ball: gate failed")
    total = dict(launches)

    # The host loop, against SciPy.
    def ball_np(t, y):
        return [y[1], -G]

    def ground_np(t, y):
        return y[0]

    ground_np.terminal, ground_np.direction = True, -1
    stop = E.ground.replace(restart=None)
    t0, y, ts = 0.0, [10.0, 0.0], []
    t0s, ys = 0.0, [10.0, 0.0]
    worst_t = worst_v = 0.0
    for _ in range(6):
        (got, seen) = launches_of(lambda: solve_ivp(
            rhs.ball, (t0, t0 + 30.0), y, events=stop, **kw))
        for k_, v in seen.items():
            total[k_] = total.get(k_, 0) + v
        ref = scipy_solve_ivp(ball_np, (t0s, t0s + 30.0), ys,
                              events=ground_np, **kw)
        if got.status != 1 or ref.status != 1:
            raise AssertionError("host loop: a bounce was missed")
        t0 = float(got.t_events[0][0])
        v = float(got.y_events[0][0][1])
        t0s = float(ref.t_events[0][0])
        vs = float(ref.y_events[0][0][1])
        worst_t = max(worst_t, abs(t0 - t0s))
        worst_v = max(worst_v, abs(v - vs) / abs(vs))
        ts.append(t0)
        y, ys = [0.0, -COR * v], [0.0, -COR * vs]
    phase("solve_ivp_ball_host_loop_vs_scipy", bounces=len(ts),
          bounce_times=[round(t, 9) for t in ts], max_time_err=worst_t,
          max_speed_rel_err=worst_v)
    if worst_t > 1e-8 or worst_v > 1e-8:
        raise AssertionError("host loop: differs from SciPy")

    # The recording ensemble with restarts.
    Bm, tf, chunk = LORENZ_B, 8.0, 256
    rec = lambda: solve_ivp_ensemble(
        rhs.ball, (0.0, tf), ball_y0(Bm), events=[E.ground],
        event_capacity=BALL_CAP, max_restarts=BALL_RESTARTS,
        dense_output=True, rec_chunk=chunk, **kw)
    rec()
    res, seen = launches_of(rec)
    for k_, v in seen.items():
        total[k_] = total.get(k_, 0) + v
    nb = res.n_events[:, 0]
    J = int(nb.max())
    cols = torch.arange(J, device=dev)[None, :] < nb[:, None]
    tev = torch.where(cols, res.t_events[:, 0, :J], 0.0)
    heights = res.sol(tev)[:, 0, :]          # per-lane times: (B, n, J)
    worst = float(torch.where(cols, heights.abs(), 0.0).max())
    ok = bool(((res.status == Status.SUCCESS)
               | (res.status == Status.USER_INTERRUPT)).all())
    # The kernel again on the same inputs, against the plain version.
    a = solve_args(torch.as_tensor(ball_y0(Bm), device=dev), tf, kw["rtol"],
                   kw["atol"], None, dev)
    ev = EventArgs((E.ground,), BALL_CAP, BALL_RESTARTS)
    run = lambda f: f("DOPRI5", rhs.ball, *a, (), 100_000, None,
                      rec_cap=chunk, record_cont=True, events=ev)
    got = run(R.erk_record_cuda)
    ref, plain_ms = event_call(lambda: run(R.erk_record_torch))
    same = all(same_bits(u, v) for u, v in zip(
        (got.t, got.y, got.status, got.nstep, got.n_rec, got.rec_t,
         got.events.t_events, got.events.n_events),
        (res.t, res.y, res.status, res.nstep, res.n_steps_rec, res.ts,
         res.t_events, res.n_events)))
    tag = f"ensemble_dense_ball_vs_plain_B{Bm}"
    err = compare(tag, record_outputs(got), record_outputs(ref), scaled=True)
    _, rerrs = check_record_events(tag, got, ref, "DOPRI5", ball_f)
    shares, eerrs = event_errors(got.events, ref.events)
    phase(tag + "_events", **{f"{k}_equal": v for k, v in shares.items()},
          **{f"max_err_{k}": v for k, v in eerrs.items()},
          plain_ms=plain_ms, rerun_bitwise=same)
    check_events(tag, shares, eerrs)
    phase(f"ensemble_dense_ball_B{Bm}", launches=seen,
          mean_rows=float(res.n_steps_rec.double().mean()),
          bounces=(int(nb.min()), int(nb.max())),
          max_height_at_bounces=worst)
    if not ok or worst > 1e-8 or not same:
        raise AssertionError("recording ball: gate failed")
    return total, max(err, rerrs["shifted"], rerrs["dense"],
                      eerrs["y_events"]), plain_ms


def event_phase(dev):
    """The event modes: every instantiation against its plain version and
    chunked against unchunked, then the main paths (the ball at B=524288,
    the Lorenz section at B=16384 by DOP853 and by RK23, solve_ivp and the
    recording ensemble of the ball), each solve's launches counted from 0
    around it alone.  The JSON rows of the four event kernels the main
    paths run."""
    t = time.perf_counter()
    checks = events_vs_plain(dev)
    events_chunking_bitwise(dev)
    phase("event_checks", seconds=round(time.perf_counter() - t, 3))
    t = time.perf_counter()
    ball = ball_main_path(dev)
    section = section_main_path(dev)
    rk23 = rk23_section_main_path(dev)
    facade, dense_err, dense_plain_ms = ball_solve_ivp(dev)
    phase("event_main_paths", seconds=round(time.perf_counter() - t, 3),
          facade_launches=facade)
    src = "ivp_tpu_torch/csrc/erk_{}.cu"
    replaces = "ivp_tpu/core/driver.py:214"
    rows = [dict(name="dopri5_sampled_ev", route="cuda",
                 source=src.format("dopri5"), replaces=replaces,
                 launches=ball["launches"], library_ms=None,
                 **checks["dopri5_sampled_ev"],
                 **{f"main_path_{k}": v for k, v in ball.items()
                    if k != "launches"}),
            dict(name="dop853_ev", route="cuda", source=src.format("dop853"),
                 replaces=replaces, library_ms=None, **section,
                 max_abs_err_B4096=checks["dop853_ev"]["max_abs_err"]),
            dict(name="dopri5_record_cont_ev", route="cuda",
                 source=src.format("dopri5"), replaces=replaces,
                 launches=facade.get("dopri5_record_cont_ev", 0),
                 launches_per_path=facade, library_ms=None,
                 **checks["dopri5_record_cont_ev"],
                 main_path_max_abs_err=dense_err,
                 main_path_plain_ms=dense_plain_ms),
            dict(name="rk23_ev", route="cuda", source=src.format("rk23"),
                 replaces=replaces, library_ms=None, **rk23,
                 max_abs_err_B4096=checks["rk23_ev"]["max_abs_err"])]
    # Each row's error: the worst of its B=4096 checks and its main path's.
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], ball["max_abs_err"])
    rows[2]["max_abs_err"] = max(rows[2]["max_abs_err"], dense_err)
    rows[3]["max_abs_err"] = max(rows[3]["max_abs_err"],
                                 checks["rk23_ev"]["max_abs_err"])
    return rows


# ---------------------------------------------------------------------------
# 12. The stiff tier (Radau, BDF) and 13. the explicit resumable solver
# ---------------------------------------------------------------------------

# bench.py's stiff configuration: VdP mu=1000, B=131072, t in [0, 3000],
# rtol 1e-4, atol 1e-6, y0 = [2, 0] + 0.02 N(0, 1) from seed 0, through
# build_resumable_solver(..., chunk_steps=4096).
STIFF_B, STIFF_TF, STIFF_MU, STIFF_CHUNK = 131072, 3000.0, 1000.0, 4096
STIFF_TOL = (1e-4, 1e-6)
# The lanes of the plain version held at the main path (all of them while it
# takes under 30 s a method).
STIFF_PLAIN_B = 131072
# Each kernel against its plain version (VdP mu=1000 over [0, 3000]): status
# and every counter equal on 100% of lanes, y within 1e-8 of max(1, |y|)
# where they are.  The stiff kernels are built without FMA contraction and
# the card's float and double libm serve both routes, so the float32
# controller is held to the same share as "state".
STIFF_SHARE = {"state": 1.0, "float32": 1.0}
STIFF_Y = 1e-8
# Against ivp_tpu's numbers (XLA's CPU float32 pow, log and exp under the
# default controller): the least share of the 64 golden lanes with every
# counter equal (Radau 64 of 64 and BDF 47 of 64 on an H100, PERF.md §6), and
# y within 1e-5 of max(1, |y|) on them.
GOLDEN_SHARE = {"RADAU": 1.0, "BDF": 0.5}
# Robertson over [0, 1e8], rtol = atol = 1e-6, y0 [1e4, 0, 0] with x moved
# by 1e-3 relative: nfev < 5000, njev < 200 (Radau) / 600 (BDF), the sum
# conserved to 1e-5 (BASELINE.md:17-18).
ROB_B, ROB_TF, ROB_NFEV, ROB_NJEV = 1024, 1e8, 5000, {"RADAU": 200,
                                                      "BDF": 600}


def carry_tensors(c):
    """``{name: tensor}`` of every tensor of a resumable carry, the method
    state's fields (``ms.<field>``, ``lin`` by index) included."""
    out = {}

    def walk(prefix, x):
        if torch.is_tensor(x):
            out[prefix] = x
        elif isinstance(x, tuple):
            names = getattr(x, "_fields", range(len(x)))
            for k, v in zip(names, x):
                walk(f"{prefix}.{k}" if prefix else str(k), v)
    walk("", c)
    return out


def tensors_differing(ta, tb):
    """The names of two ``{name: tensor}`` whose bits differ anywhere."""
    def bits(x):
        if not x.is_floating_point():
            return x
        return x.view({8: torch.int64, 4: torch.int32}[x.element_size()])
    return sorted(k for k in ta.keys() | tb.keys()
                  if k not in ta or k not in tb or ta[k].shape != tb[k].shape
                  or not torch.equal(bits(ta[k]), bits(tb[k])))


def checkpoint_contract(name, start, resume, y0, *run):
    """The resumable solver's checkpoint contract on the card: from the
    carry after one ``resume``, two more resumes of it give bit-equal
    carries, and it equals, field for field, a copy taken before them."""
    c0, ra = start(y0, *run)
    c1 = resume(c0, ra)
    before = {k: v.clone() for k, v in carry_tensors(c1).items()}
    c2, c3 = resume(c1, ra), resume(c1, ra)
    torch.cuda.synchronize()
    given = tensors_differing(carry_tensors(c1), before)
    twice = tensors_differing(carry_tensors(c2), carry_tensors(c3))
    shared = sorted(k for k, v in carry_tensors(c2).items()
                    if v.data_ptr() == carry_tensors(c1)[k].data_ptr()
                    and v.numel())
    phase(f"{name}_checkpoint_contract", given_unchanged=not given,
          given_fields_changed=given, resumed_twice_equal=not twice,
          fields_differing=twice, fields_shared_with_given=shared)
    if given or twice:
        raise AssertionError(f"{name}: the carry given changed in {given}, "
                             f"two resumes of it differ in {twice}")


def stiff_y0(B):
    rng = np.random.default_rng(0)
    return np.array([2.0, 0.0]) + 0.02 * rng.standard_normal((B, 2))


def robertson_y0(B):
    rng = np.random.default_rng(4)
    y0 = np.zeros((B, 3))
    y0[:, 0] = 1e4 * (1.0 + 1e-3 * rng.standard_normal(B))
    return y0


STIFF_COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct", "njev",
                  "nlu")
STIFF_FINAL = ("t", "y") + STIFF_COUNTERS
REC_FIELDS = ("rec_t", "rec_y", "rec_xold", "rec_h", "rec_cont")
# Fields held on a lane's time scale, max(1, |t|), not on max(1, |y|).
TIME_FIELDS = ("t", "rec_t", "rec_xold", "rec_h")


def ens_dict(out):
    """stiff_ensemble's 11 outputs (or the plain version's, with its
    counters unpacked) as a dict."""
    return dict(zip(("t", "y", "status", "nfev", "nstep", "naccpt", "nrejct",
                     "y_samples", "n_samples", "njev", "nlu"), out))


def plain_ens_dict(out):
    return ens_dict((*out[:9], *out[-1]))


def rec_dict(r):
    """A RecordResult's fields as a dict."""
    return {f: getattr(r, f) for f in STIFF_FINAL + REC_FIELDS
            + ("n_rec", "y_samples", "n_samples")}


def lane_err(got, ref, scale):
    """Per lane: max |got - ref| over max(1, the lane's largest |scale|)."""
    g, r = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    if g.shape[1] == 0:
        return torch.zeros(g.shape[0], dtype=torch.float64, device=g.device)
    sc = scale.reshape(scale.shape[0], -1)
    return ((g - r).abs().amax(dim=1)
            / sc.abs().amax(dim=1).clamp_min(1.0))


def stiff_compare(name, got, ref, share, counts=(), arrays=("y",),
                  y_tol=STIFF_Y):
    """Hold a stiff result (a dict: ``ens_dict``, ``rec_dict``) against a
    reference lane by lane: status, every counter and ``counts`` equal on
    at least ``share`` of the lanes, and on those each of ``arrays`` within
    ``y_tol`` of max(1, |ref|) (``TIME_FIELDS`` of max(1, |t|) of the
    lane's times); where some lane differs, each array's error over every
    lane is printed too.  Returns the largest error on the equal lanes."""
    same = torch.ones_like(got["status"], dtype=torch.bool)
    fr, errs, every, finite = {}, {}, {}, True
    for k in STIFF_COUNTERS + tuple(counts):
        # (a count a lane and event, (B, E), equal in every event)
        eq = (got[k] == ref[k]).reshape(same.shape[0], -1).all(dim=1)
        fr[k] = float(eq.double().mean())
        same &= eq
    for f in arrays:
        if got[f].shape != ref[f].shape:
            raise AssertionError(f"{name}: {f} has shape "
                                 f"{tuple(got[f].shape)}, the plain "
                                 f"version's {tuple(ref[f].shape)}")
        times = ref["rec_t"] if f.startswith("rec_") else ref["t"]
        e = lane_err(got[f], ref[f], times if f in TIME_FIELDS else ref[f])
        errs[f] = float(e[same].max()) if bool(same.any()) else 0.0
        every[f] = float(e.max()) if e.numel() else 0.0
        finite = finite and bool(torch.isfinite(got[f]).all())
    frac = float(same.double().mean())
    err = max(errs.values())
    phase(name, lanes=int(same.numel()), lanes_all_equal=frac,
          **{f"{k}_equal": v for k, v in fr.items()},
          **{f"max_scaled_err_{f}": v for f, v in errs.items()},
          **({f"max_scaled_err_{f}_all_lanes": v for f, v in every.items()}
             if frac < 1.0 else {}),
          finite=finite)
    if frac < share or err > y_tol or not finite:
        raise AssertionError(f"{name}: {frac} of lanes equal (at least "
                             f"{share}), errors {errs}, finite {finite}")
    return err


def bitwise(name, got, ref, fields):
    """Raise unless ``got`` and ``ref`` hold the same bits in ``fields``."""
    diff = tensors_differing({f: got[f] for f in fields if got[f] is not None},
                             {f: ref[f] for f in fields if ref[f] is not None})
    phase(name, fields_differing=diff)
    if diff:
        raise AssertionError(f"{name}: {diff} differ")


def stiff_call(method, fun, y0, tf, tol, spec, args, plain=False,
               grid=None):
    """One stiff solve of ``y0`` (on its device), sampled on ``grid`` if
    given, through the kernel wrapper or, with ``plain``, the plain
    version, as an ``ens_dict``."""
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import stiff_ensemble as S

    a = solve_args(y0, tf, tol[0], tol[1], None, y0.device) + (args, 100000)
    if plain:
        return plain_ens_dict(K.erk_ensemble_torch(
            method, fun, *a, grid, spec, None, counters=True))
    return ens_dict(S.stiff_ensemble(method, fun, *a, spec, 0.0, grid))


def sampled_grid(B, dev):
    """The sampled main path's ``t_eval`` (101 points over [0, 3000]) as
    the ``(B, m)`` view the kernels and the plain version read."""
    te = torch.as_tensor(np.linspace(0.0, STIFF_TF, SAMPLED_M), device=dev)
    return torch.broadcast_to(te, (B, SAMPLED_M))


def stiff_vs_plain(dev):
    """Each stiff kernel against its plain version on the card under the
    "state" controller (VdP mu=1000, B=4096, t in [0, 3000]; the float32
    controller's lean kernels stiff_main_path holds over the same span at
    the main path's B), and Robertson with its budgets."""
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    from ivp_tpu_torch.core import linalg
    from ivp_tpu_torch.kernels import stiff_ensemble as S

    # The lane's inverses for every n the kernels take (n = 4..8: LU with
    # the reference's row exchange; no solve instantiates them yet) against
    # core/linalg.py on the card, bit for bit, singular lanes included.
    rng = np.random.default_rng(7)
    for n in range(1, 9):
        a = rng.standard_normal((CHECK_B, n, n)) + 2.0 * np.eye(n)
        a *= 10.0 ** rng.uniform(-3, 9, (CHECK_B, 1, 1))
        a[:, 0, 0] *= rng.uniform(0.0, 1.0, CHECK_B) > 0.1   # pivoting
        a[:4] = 0.0                                          # singular
        ai = a * rng.uniform(-1.0, 1.0, (CHECK_B, n, n))
        at, ait = (torch.as_tensor(x, device=dev) for x in (a, ai))
        got = S.inverses(at, ait)
        wi, ws = linalg.inv(at)
        (wr, wim), wcs = linalg.inv_complex(at, ait)
        torch.cuda.synchronize()
        ok = {k: bool(torch.equal(g, w)) for k, g, w in (
            ("inv", got[0][~ws], wi[~ws]), ("singular", got[1], ws),
            ("br", got[2][0][~wcs], wr[~wcs]),
            ("bi", got[2][1][~wcs], wim[~wcs]), ("csingular", got[3], wcs))}
        phase(f"stiff_inverses_vs_linalg_n{n}_B{CHECK_B}", **ok,
              singular_lanes=int(ws.sum()))
        if not all(ok.values()):
            raise AssertionError(f"the kernels' inverses differ at n={n}: {ok}")

    y0 = torch.as_tensor(stiff_y0(CHECK_B), device=dev)
    for method in ("RADAU", "BDF"):
        spec = stiff_spec(method, 2, None, {"controller_precision": "state"})
        got = stiff_call(method, rhs.vdp, y0, STIFF_TF, STIFF_TOL, spec,
                         (STIFF_MU,))
        ref = stiff_call(method, rhs.vdp, y0, STIFF_TF, STIFF_TOL, spec,
                         (STIFF_MU,), plain=True)
        torch.cuda.synchronize()
        stiff_compare(f"{method.lower()}_state_vs_plain_B{CHECK_B}", got,
                      ref, STIFF_SHARE["state"])
    yr = torch.as_tensor(robertson_y0(ROB_B), device=dev)
    for method in ("RADAU", "BDF"):
        spec = stiff_spec(method, 3, None, None)
        got = stiff_call(method, rhs.robertson, yr, ROB_TF, (1e-6, 1e-6),
                         spec, ())
        ref = stiff_call(method, rhs.robertson, yr, ROB_TF, (1e-6, 1e-6),
                         spec, (), plain=True)
        torch.cuda.synchronize()
        stiff_compare(f"{method.lower()}_robertson_vs_plain_B{ROB_B}", got,
                      ref, STIFF_SHARE["float32"])
        s0 = yr.sum(dim=1)
        cons = float((got["y"].sum(dim=1) - s0).abs().max()
                     / s0.abs().max())
        nfev, njev = int(got["nfev"].max()), int(got["njev"].max())
        success = bool((got["status"] == 0).all())
        phase(f"{method.lower()}_robertson_budgets_B{ROB_B}",
              max_nfev=nfev, max_njev=njev, sum_rel_err=cons,
              success=success)
        if (nfev >= ROB_NFEV or njev >= ROB_NJEV[method] or cons > 1e-5
                or not success):
            raise AssertionError(f"{method} Robertson budgets broken")


def stiff_golden(dev):
    """The kernels against ivp_tpu's own numbers: the first 64 lanes of the
    main path's y0, the default (float32) controller
    (ivp_tpu_torch/data/stiff_vdp_golden.npz).  Status on every lane; the
    share of lanes whose counters all agree is stated."""
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    with np.load(ROOT / "ivp_tpu_torch" / "data" / "stiff_vdp_golden.npz") as g:
        gold = {f: g[f] for f in g.files}
    y0 = torch.as_tensor(gold["y0"], device=dev)
    for method in ("RADAU", "BDF"):
        m = method.lower()
        got = stiff_call(method, rhs.vdp, y0, STIFF_TF, STIFF_TOL,
                         stiff_spec(method, 2, None, None), (STIFF_MU,))
        ref = {f: torch.as_tensor(gold[f"{m}_{f}"], device=dev)
               for f in STIFF_FINAL}
        if not torch.equal(got["status"], ref["status"]):
            raise AssertionError(f"{method} vs ivp_tpu: status differs")
        stiff_compare(f"{m}_vs_ivp_tpu_golden_B64", got, ref,
                      GOLDEN_SHARE[method], y_tol=1e-5)


def stiff_main_path(dev):
    """bench.py's stiff configuration uncut through build_resumable_solver:
    launches a solve, the success share, nstep, kernel ms (torch.profiler)
    and solve ms (CUDA events, the median of 3 after a warm-up, each result
    freed first), wall ms, IVPs/s, the bound; the plain version at the same
    inputs lane by lane, sampled on the sampled main path's 101-point grid
    (sampling changes no step); chunk_steps=64 bit for bit.
    ``(rows, finals, plains)``: the JSON rows of radau and bdf, each
    method's final t, y, status and counters, and the plain run's
    ``ens_dict`` (for the modes' main paths to hold theirs to)."""
    from ivp_tpu_torch import Status, rhs
    from ivp_tpu_torch.batch import build_resumable_solver
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    B = STIFF_B
    rows, finals, plains = {}, {}, {}
    y0 = torch.as_tensor(stiff_y0(B), device=dev)
    for method in ("RADAU", "BDF"):
        m = method.lower()

        host_us = []

        def solver(chunk):
            start, resume, extract = build_resumable_solver(
                rhs.vdp, method, n=2, args=(STIFF_MU,), chunk_steps=chunk)

            def run(y):
                carry, ra = start(y, 0.0, STIFF_TF, *STIFF_TOL)
                while not bool(carry.done.all()):
                    t = time.perf_counter()
                    carry = resume(carry, ra)
                    host_us.append(1e6 * (time.perf_counter() - t))
                return extract(carry)
            return run

        run = solver(STIFF_CHUNK)
        res, walls, ev_ms, launches = None, [], [], []
        for i in range(4):
            del res
            for k in S.LAUNCHES:
                S.LAUNCHES[k] = 0
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            e0.record()
            res = run(y0)
            e1.record()
            torch.cuda.synchronize()
            launches.append(S.LAUNCHES[m])
            if i:
                walls.append(time.perf_counter() - t)
                ev_ms.append(e0.elapsed_time(e1))
        _, kern_ms, _ = kernel_device_ms(lambda: run(y0), match=f"{m}_kernel")
        st = res.status.cpu().numpy()
        ns = res.nstep.cpu().numpy()
        wall = float(np.median(walls))
        bound_ms, bound_by = S.stiff_bound(method, rhs.vdp, res.nstep,
                                           res.naccpt, res.nrejct, res.nfev,
                                           res.njev, res.nlu)
        # The instantiation the main path launched (the default float32
        # controller), as the library reports it.
        lay = S.layout(method, rhs.vdp, "float32", B)
        solve_ms = float(np.median(ev_ms))
        phase(f"{m}_main_path_B{B}", launches_per_solve=launches[-1],
              success_fraction=float(np.mean(st == Status.SUCCESS)),
              mean_nstep=float(ns.mean()), max_nstep=int(ns.max()),
              kernel_ms=kern_ms, solve_event_ms=[round(x, 3) for x in ev_ms],
              solve_ms=solve_ms, solve_less_kernel_ms=solve_ms - kern_ms,
              host_us_per_resume=float(np.mean(host_us)),
              wall_ms=round(1e3 * wall, 3), ivps_per_sec=B / wall,
              bound_ms=bound_ms, bound_by=bound_by,
              bound_share=bound_ms / kern_ms, registers=lay["registers"],
              local_bytes=lay["local_bytes"],
              smem_bytes_per_block=lay["block_bytes"],
              threads=lay["threads"], min_blocks=lay["min_blocks"],
              blocks_per_sm=lay["blocks_per_sm"])
        if lay["blocks_per_sm"] < lay["min_blocks"]:
            raise AssertionError(f"{method}: the card holds fewer blocks an "
                                 f"SM than the launch bounds ask for: {lay}")
        if not np.all(st == Status.SUCCESS) or not bool(
                torch.isfinite(res.y).all()) or min(launches) < 1:
            raise AssertionError(f"{method} main path: not every lane "
                                 f"succeeded")
        # The plain version on the card at the main path's inputs, sampled
        # as the sampled main path samples.
        Bp = STIFF_PLAIN_B
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        e0.record()
        ref = stiff_call(method, rhs.vdp, y0[:Bp], STIFF_TF, STIFF_TOL,
                         stiff_spec(method, 2, None, None), (STIFF_MU,),
                         plain=True, grid=sampled_grid(Bp, dev))
        e1.record()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        err = stiff_compare(f"{m}_main_path_vs_plain_B{Bp}",
                            {f: getattr(res, f)[:Bp] for f in STIFF_FINAL},
                            ref, STIFF_SHARE["float32"])
        plains[m] = ref
        phase(f"{m}_plain_B{Bp}", wall_s=round(plain_s, 3),
              event_ms=e0.elapsed_time(e1))
        # chunk_steps=64: bit for bit against the first run.
        small = solver(64)(y0)
        finals[m] = {f: getattr(res, f) for f in STIFF_FINAL}
        bitwise(f"{m}_chunk64_vs_chunk{STIFF_CHUNK}_bitwise",
                {f: getattr(small, f) for f in STIFF_FINAL}, finals[m],
                STIFF_FINAL)
        start, resume, _ = build_resumable_solver(
            rhs.vdp, method, n=2, args=(STIFF_MU,), chunk_steps=64)
        checkpoint_contract(f"{m}_B{B}", start, resume, y0, 0.0, STIFF_TF,
                            *STIFF_TOL)
        rows[m] = {"launches": launches[-1], "max_abs_err": err,
                   "ms": kern_ms, "plain_ms": e0.elapsed_time(e1),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_share": bound_ms / kern_ms,
                   "registers": lay["registers"],
                   "smem_bytes_per_block": lay["block_bytes"],
                   "blocks_per_sm": lay["blocks_per_sm"],
                   "solve_ms": solve_ms, "wall_ms": 1e3 * wall,
                   "host_us_per_resume": float(np.mean(host_us))}
    return rows, finals, plains


# The stiff kernels' SAMPLED and RECORD modes.  Checked against their plain
# versions on VdP mu=1000 over [0, 1000] (one relaxation jump near t = 807:
# over [0, 3000] the plain version took 10.5-13.9 s a check), at B=4096 with
# a 51-point grid from t0 to tf, records in one chunk of 1024 rows (a lane
# makes about 150 (Radau) and 370 (BDF) steps there) and in chunks of 64.
# One plain run a method and controller type serves every mode: the
# driver's record mode with coefficients and the grid's samples.
MODES_TF, MODES_M, MODES_ONE, MODES_CAP = 1000.0, 51, 1024, 64
# The main paths: bench.py's stiff row with a 101-point grid at B=131072,
# the recording ensemble (dense_output, record_trajectories) at B=16384,
# and examples/van_der_pol.py's solve_ivp (t in [0, 2], rtol = atol = 1e-8,
# dense_output).
SAMPLED_M, RECORD_B, IVP_TF, IVP_TOL = 101, 16384, 2.0, 1e-8
# solve_ivp on the card against device="cpu": every counter equal and y at
# the output points and the dense output on 21 times within IVP_CPU_Y of
# max(1, |y|) (the same steps; measured on an H100: 1.1e-16 (Radau),
# 1.9e-15 (BDF), the CPU's libm and the card's in the last bits).  Against
# SciPy's Radau and BDF at rtol = atol = 1e-10, within IVP_Y (the solve's
# own tolerance is 1e-8: the results differ by the global error).
IVP_CPU_Y, IVP_Y = 1e-13, 1e-6
def stiff_modes_vs_plain(dev):
    """Each stiff kernel's SAMPLED and RECORD modes against their plain
    versions on the card (VdP mu=1000, B=4096, t in [0, 1000], both
    controller types): status, every counter, n_samples and n_rec equal on
    every lane, samples and rows within STIFF_Y; each mode's final state and
    counters bit for bit with the LEAN kernel's; records in chunks of 64 and
    of REC_CAP_CHECK bit for bit with one chunk, a grid's samples with them,
    and those samples bit for bit with the SAMPLED mode's; Robertson
    sampled on a log-spaced grid at ROB_B.  ``{kernel: {"max_abs_err",
    "plain_ms", "check_ms"}}`` (the plain version's ms, the plain record
    run with samples, and the kernel's of the float32 runs, CUDA events)."""
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    B = CHECK_B
    y0 = torch.as_tensor(stiff_y0(B), device=dev)
    a = solve_args(y0, MODES_TF, *STIFF_TOL, None, dev) + ((STIFF_MU,),
                                                           100000)
    grid = torch.broadcast_to(torch.linspace(
        0.0, MODES_TF, MODES_M, dtype=torch.float64, device=dev),
        (B, MODES_M))
    out = {}

    def keep(name, cp, err, plain_ms, check_ms):
        row = out.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if cp == "float32":
            row.update(plain_ms=plain_ms, check_ms=check_ms)

    for method in ("RADAU", "BDF"):
        m = method.lower()
        for cp in ("state", "float32"):
            spec = stiff_spec(method, 2, None, {"controller_precision": cp})
            lean = ens_dict(S.stiff_ensemble(method, rhs.vdp, *a, spec))
            ref, p_ms = event_call(lambda: rec_dict(R.erk_record_torch(
                method, rhs.vdp, *a, grid, spec, rec_cap=MODES_ONE,
                record_cont=True)))
            got, k_ms = event_call(lambda: ens_dict(S.stiff_ensemble(
                method, rhs.vdp, *a, spec, 0.0, grid)))
            name = f"{m}_sampled"
            keep(name, cp, stiff_compare(
                f"{name}_{cp}_vs_plain_B{B}", got, ref, STIFF_SHARE[cp],
                ("n_samples",), ("y", "y_samples")), p_ms, k_ms)
            bitwise(f"{name}_{cp}_vs_lean_B{B}", got, lean, STIFF_FINAL)
            for cont in (True, False):
                got, k_ms = event_call(lambda: rec_dict(R.erk_record(
                    method, rhs.vdp, *a, None, spec, rec_cap=MODES_ONE,
                    record_cont=cont)))
                name = f"{m}_record{'_cont' if cont else ''}"
                rows = REC_FIELDS if cont else REC_FIELDS[:-1]
                keep(name, cp, stiff_compare(
                    f"{name}_{cp}_vs_plain_B{B}", got, ref, STIFF_SHARE[cp],
                    ("n_rec",), ("y",) + rows), p_ms, k_ms)
                bitwise(f"{name}_{cp}_vs_lean_B{B}", got, lean, STIFF_FINAL)
            del got, ref
        # Chunks of 64 and of REC_CAP_CHECK rows (odd: the staged rows
        # leave some lanes mid-run at every chunk's end) against one chunk,
        # with the grid's samples.
        spec = stiff_spec(method, 2, None, None)
        one = R.erk_record(method, rhs.vdp, *a, grid, spec,
                           rec_cap=MODES_ONE, record_cont=True)
        sampled = ens_dict(S.stiff_ensemble(method, rhs.vdp, *a, spec, 0.0,
                                            grid))
        fields = STIFF_FINAL + REC_FIELDS + ("n_rec", "y_samples",
                                             "n_samples")
        for cap in (MODES_CAP, REC_CAP_CHECK):
            many = R.erk_record(method, rhs.vdp, *a, grid, spec,
                                rec_cap=cap, record_cont=True)
            phase(f"{m}_record_chunks{cap}_B{B}", one=one.chunks,
                  many=many.chunks)
            if one.chunks != 1 or many.chunks < 2:
                raise AssertionError(f"{m}: {one.chunks} and {many.chunks} "
                                     f"chunks")
            bitwise(f"{m}_record_cont_chunk{cap}_vs_one_chunk_B{B}",
                    rec_dict(many), rec_dict(one), fields)
            bitwise(f"{m}_record_chunk{cap}_samples_vs_sampled_B{B}",
                    rec_dict(many), sampled,
                    STIFF_FINAL + ("y_samples", "n_samples"))
            del many
        del one, sampled
    # Robertson sampled at 0 and on 40 log-spaced times.
    yr = torch.as_tensor(robertson_y0(ROB_B), device=dev)
    ar = solve_args(yr, ROB_TF, 1e-6, 1e-6, None, dev) + ((), 100000)
    gr = torch.broadcast_to(torch.as_tensor(np.concatenate(
        [[0.0], np.logspace(-6, 8, 40)]), device=dev), (ROB_B, 41))
    for method in ("RADAU", "BDF"):
        spec = stiff_spec(method, 3, None, None)
        got = ens_dict(S.stiff_ensemble(method, rhs.robertson, *ar, spec,
                                        0.0, gr))
        ref = plain_ens_dict(K.erk_ensemble_torch(
            method, rhs.robertson, *ar, gr, spec, None, counters=True))
        name = f"{method.lower()}_sampled"
        keep(name, "state", stiff_compare(
            f"{name}_robertson_vs_plain_B{ROB_B}", got, ref,
            STIFF_SHARE["float32"], ("n_samples",), ("y", "y_samples")),
            None, None)
        if not bool((got["n_samples"] == 41).all()):
            raise AssertionError(f"{method} Robertson: samples missing")
    return out


def stiff_modes_main_paths(dev, finals, plains):
    """The modes' three main paths at full size, the default (float32)
    controller: (1) ``solve_ivp_ensemble(..., t_eval=)`` on bench.py's
    stiff row with a 101-point grid (B=131072, t in [0, 3000]); (2) the
    recording ensemble with ``dense_output`` and ``record_trajectories``
    (B=16384, the same problem); (3) ``solve_ivp`` of
    examples/van_der_pol.py's case, held against ``device="cpu"`` and
    SciPy.  For each: its launches (the counts set to 0 just before the
    measured call and read just after it), kernel ms (torch.profiler), solve
    ms (CUDA events, the median of 3 after a warm-up), device ms besides the
    kernel (the drain of the records), the bound and its share, the
    instantiation's layout; the final t, y, status and counters of (1) and
    (2) bit for bit with the lean main path's (``finals``); (1) on every
    lane against the plain version sampled on the same grid (``plains``),
    and (2) against a plain record run of its 16384 lanes: status, every
    counter, n_samples and n_rec equal, samples and rows within STIFF_Y.
    ``{kernel: row}``, ``max_abs_err`` the largest of those errors."""
    from scipy.integrate import solve_ivp as scipy_solve_ivp

    from ivp_tpu_torch import Status, rhs, solve_ivp, solve_ivp_ensemble
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    rows = {}
    kw = dict(args=(STIFF_MU,), rtol=STIFF_TOL[0], atol=STIFF_TOL[1])

    def measure(name, m, solve, mode, cont=False):
        res, walls, ev_ms = timed_solves(lambda _: solve(), [None] * 4)
        del res
        (res, k_ms, dev_ms), launches = launches_of(
            lambda: kernel_device_ms(solve, match=f"{m}_kernel"))
        if set(launches) != {name}:
            raise AssertionError(f"{name}: the solve launched {launches}")
        lay = S.layout(m, rhs.vdp, "float32", int(res.status.numel()),
                       mode=mode, record_cont=cont)
        solve_ms = float(np.median(ev_ms))
        row = dict(launches=launches[name], kernel_ms=k_ms,
                   solve_ms=solve_ms, drain_ms=dev_ms - k_ms,
                   solve_event_ms=[round(x, 3) for x in ev_ms],
                   wall_ms=1e3 * float(np.median(walls)),
                   registers=lay["registers"],
                   local_bytes=lay["local_bytes"],
                   smem_bytes_per_block=lay["block_bytes"],
                   blocks_per_sm=lay["blocks_per_sm"],
                   min_blocks=lay["min_blocks"],
                   stage_rows=lay["stage_rows"],
                   stage_lane_bytes=lay["stage_lane_bytes"])
        return res, row

    # (1) The sampled ensemble.
    B = STIFF_B
    y0 = torch.as_tensor(stiff_y0(B), device=dev)
    te = np.linspace(0.0, STIFF_TF, SAMPLED_M)
    for method in ("RADAU", "BDF"):
        m = method.lower()
        name = f"{m}_sampled"
        res, row = measure(name, m, lambda: solve_ivp_ensemble(
            rhs.vdp, (0.0, STIFF_TF), y0, method, t_eval=te, **kw),
            S.SAMPLED)
        bound_ms, bound_by = S.stiff_bound(
            method, rhs.vdp, res.nstep, res.naccpt, res.nrejct, res.nfev,
            res.njev, res.nlu, n_samples=res.n_samples, m=SAMPLED_M)
        ok = (bool((res.status == Status.SUCCESS).all())
              and bool((res.n_samples == SAMPLED_M).all())
              and tuple(res.y_samples.shape) == (B, SAMPLED_M, 2)
              and bool(torch.isfinite(res.y_samples).all()))
        phase(f"{name}_main_path_B{B}", ok=ok, **row, bound_ms=bound_ms,
              bound_by=bound_by, bound_share=bound_ms / row["kernel_ms"],
              samples_bytes=8.0 * 2 * float(res.n_samples.double().sum()))
        if not ok:
            raise AssertionError(f"{name} main path: not every lane "
                                 f"succeeded with every sample")
        got = {f: getattr(res, f) for f in STIFF_FINAL
               + ("y_samples", "n_samples")}
        bitwise(f"{name}_main_path_vs_lean_B{B}", got, finals[m],
                STIFF_FINAL)
        err = stiff_compare(f"{name}_main_path_vs_plain_B{B}", got,
                            plains.pop(m), STIFF_SHARE["float32"],
                            ("n_samples",), ("y", "y_samples"))
        rows[name] = dict(row, bound_ms=bound_ms, bound_by=bound_by,
                          bound_share=bound_ms / row["kernel_ms"],
                          max_abs_err=err)
        del res, got

    # (2) The recording ensemble, and one plain record run with
    # coefficients a method to hold both modes' rows to.
    Br = RECORD_B
    yr = torch.as_tensor(stiff_y0(Br), device=dev)
    ar = solve_args(yr, STIFF_TF, *STIFF_TOL, None, dev) + ((STIFF_MU,),
                                                           100000)
    for method in ("RADAU", "BDF"):
        m = method.lower()
        t = time.perf_counter()
        plain = rec_dict(R.erk_record_torch(
            method, rhs.vdp, *ar, None, stiff_spec(method, 2, None, None),
            record_cont=True))
        phase(f"{m}_plain_record_B{Br}",
              wall_s=round(time.perf_counter() - t, 3))
        for cont in (True, False):
            name = f"{m}_record{'_cont' if cont else ''}"
            res, row = measure(name, m, lambda: solve_ivp_ensemble(
                rhs.vdp, (0.0, STIFF_TF), yr, method, dense_output=cont,
                record_trajectories=not cont, **kw), S.RECORD, cont)
            bound_ms, bound_by = S.stiff_bound(
                method, rhs.vdp, res.nstep, res.naccpt, res.nrejct,
                res.nfev, res.njev, res.nlu, n_rec=res.n_steps_rec,
                record_cont=cont)
            nbytes = 8.0 * R.record_width(method, 2, cont) * float(
                res.n_steps_rec.double().sum())
            k = res.n_steps_rec - 1
            last = res.ys[torch.arange(Br, device=dev), k]
            ok = (bool((res.status == Status.SUCCESS).all())
                  and bool(torch.equal(res.n_steps_rec,
                                       res.naccpt.to(torch.int64)))
                  and bool(torch.equal(last, res.y)))
            dense_err = None
            if cont:   # the dense solution through each lane's rows
                q = res.ts[:, :8]
                dense_err = float((res.sol(q).permute(0, 2, 1)
                                   - res.ys[:, :8]).abs().max())
                ok = ok and dense_err <= 1e-9
            phase(f"{name}_main_path_B{Br}", ok=ok, **row,
                  bound_ms=bound_ms, bound_by=bound_by,
                  bound_share=bound_ms / row["kernel_ms"],
                  bytes_recorded=nbytes,
                  gbytes_per_s=nbytes / (row["kernel_ms"] * 1e6),
                  mean_rows=float(res.n_steps_rec.double().mean()),
                  max_rows=int(res.n_steps_rec.max()),
                  dense_err_at_rows=dense_err)
            if not ok:
                raise AssertionError(f"{name} main path: not every lane "
                                     f"recorded its steps")
            got = {f: getattr(res, f) for f in STIFF_FINAL}
            bitwise(f"{name}_main_path_vs_lean_B{Br}", got,
                    {f: v[:Br] for f, v in finals[m].items()}, STIFF_FINAL)
            got.update(rec_t=res.ts, rec_y=res.ys, n_rec=res.n_steps_rec)
            if cont:   # the rows' other fields, as the solution holds them
                got.update(rec_xold=res.sol._xolds, rec_h=res.sol._hs,
                           rec_cont=res.sol._conts)
            err = stiff_compare(
                f"{name}_main_path_vs_plain_B{Br}", got, plain,
                STIFF_SHARE["float32"], ("n_rec",),
                ("y",) + (REC_FIELDS if cont else ("rec_t", "rec_y")))
            rows[name] = dict(row, bound_ms=bound_ms, bound_by=bound_by,
                              bound_share=bound_ms / row["kernel_ms"],
                              bytes_recorded=nbytes, max_abs_err=err)
            del res, last, got
        del plain

    # (3) solve_ivp: examples/van_der_pol.py's case.
    def f_np(t, y):
        return [y[1], STIFF_MU * (1.0 - y[0] ** 2) * y[1] - y[0]]

    def jac_np(t, y):
        return [[0.0, 1.0], [-2.0 * STIFF_MU * y[0] * y[1] - 1.0,
                             STIFF_MU * (1.0 - y[0] ** 2)]]

    q = np.linspace(0.0, IVP_TF, 21)
    for method in ("Radau", "BDF"):
        m = method.lower()
        ivp = dict(method=method, args=(STIFF_MU,), rtol=IVP_TOL,
                   atol=IVP_TOL, dense_output=True)
        call = lambda: solve_ivp(rhs.vdp, (0.0, IVP_TF), [2.0, 0.0], **ivp)
        walls = []
        for i in range(4):
            t = time.perf_counter()
            r = call()
            if i:
                walls.append(time.perf_counter() - t)
        (r, k_ms, _), launches = launches_of(
            lambda: kernel_device_ms(call, match=f"{m}_kernel"))
        cpu = solve_ivp(rhs.vdp, (0.0, IVP_TF), [2.0, 0.0], device="cpu",
                        **ivp)
        sc = scipy_solve_ivp(f_np, (0.0, IVP_TF), [2.0, 0.0], method=method,
                             rtol=1e-10, atol=1e-10, jac=jac_np,
                             dense_output=True)
        scale = max(1.0, float(np.abs(r.y).max()))
        same = {f: r[f] == cpu[f] for f in ("nfev", "njev", "nlu", "nstep",
                                            "naccpt", "nrejct", "status")}
        err_cpu = float(np.abs(r.y[:, -1] - cpu.y[:, -1]).max()) / scale
        err_cpu_dense = float(np.abs(r.sol(q) - cpu.sol(q)).max()) / scale
        err_scipy = float(np.abs(r.y[:, -1] - sc.y[:, -1]).max()) / scale
        err_scipy_dense = float(np.abs(r.sol(q) - sc.sol(q)).max()) / scale
        ok = (r.status == 0 and launches == {f"{m}_record_cont": 1}
              and all(same.values())
              and max(err_cpu, err_cpu_dense) <= IVP_CPU_Y
              and max(err_scipy, err_scipy_dense) <= IVP_Y)
        phase(f"{m}_solve_ivp_vdp", ok=ok, launches=launches,
              kernel_ms=k_ms, wall_ms=1e3 * float(np.median(walls)),
              nstep=r.nstep, naccpt=r.naccpt, counters_equal_cpu=same,
              err_vs_cpu=err_cpu, dense_err_vs_cpu=err_cpu_dense,
              err_vs_scipy=err_scipy, dense_err_vs_scipy=err_scipy_dense,
              scipy_nfev=int(sc.nfev))
        if not ok:
            raise AssertionError(f"solve_ivp {method} on the card: {launches}"
                                 f", counters equal {same}, errors "
                                 f"{err_cpu}, {err_cpu_dense}, {err_scipy}, "
                                 f"{err_scipy_dense}")
    return rows


RESUME_CASES = [
    # (method, functor, y0, tf, rtol, atol): bench.py's Lorenz lanes and
    # tolerances for DOP853; VdP mu=1 for RK45; RK23 and RK4 on Lorenz.
    ("DOP853", "lorenz", 20.0, 1e-8, 1e-10),
    ("DOPRI5", "vdp", 20.0, 1e-6, 1e-8),
    ("RK23", "lorenz", 2.0, 1e-6, 1e-8),
    ("RK4", "lorenz", 2.0, 1e-6, 1e-8),
]
RESUME_B, RESUME_CHUNK = 16384, 256


def resumable_phase(dev):
    """The explicit resumable solver on the card: chunk_steps=256 against
    one unbounded launch bit for bit, counters against the plain version on
    every lane; its launches counted from 0 around the chunked solve, its
    solve ms (CUDA events), kernel ms (torch.profiler) and host µs a
    ``resume``; the checkpoint contract.  The JSON rows of the four
    resumable instantiations (``ms`` the kernels' device time of the
    chunked solve)."""
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.batch import build_resumable_solver
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import resumable as RES

    rows = []
    for method, fname, tf, rt, at in RESUME_CASES:
        fun = getattr(rhs, fname)
        y0 = torch.as_tensor(lorenz_y0(RESUME_B) if fun.n == 3 else
                             vdp_y0(RESUME_B), device=dev)

        def solve(chunk, host=None):
            start, resume, extract = build_resumable_solver(
                fun, method, n=fun.n, chunk_steps=chunk)
            carry, ra = start(y0, 0.0, tf, rt, at)
            while not bool(carry.done.all()):
                t = time.perf_counter()
                carry = resume(carry, ra)
                if host is not None:
                    host.append(1e6 * (time.perf_counter() - t))
            return extract(carry)

        name = f"{K.KERNELS[method][0].replace('_sampled', '')}_resume"
        solve(RESUME_CHUNK)
        torch.cuda.synchronize()
        for k in RES.LAUNCHES:
            RES.LAUNCHES[k] = 0
        host = []
        res, solve_ms = event_call(lambda: solve(RESUME_CHUNK, host))
        launches = RES.LAUNCHES[name]
        _, ms, _ = kernel_device_ms(lambda: solve(RESUME_CHUNK))
        one = solve(2**31 - 1)
        torch.cuda.synchronize()
        diff = [f for f in ("t", "y", "status", "nfev", "nstep", "naccpt",
                            "nrejct") if not torch.equal(getattr(res, f),
                                                         getattr(one, f))]
        phase(f"{name}_chunk{RESUME_CHUNK}_vs_unbounded_bitwise_B{RESUME_B}",
              launches=launches, fields_differing=diff, solve_ms=solve_ms,
              kernel_ms=ms, host_us_per_resume=float(np.mean(host)),
              besides_kernel_ms_per_launch=(solve_ms - ms) / launches)
        if diff or launches < 2:
            raise AssertionError(f"{name}: chunked differs in {diff}")
        start, resume, _ = build_resumable_solver(
            fun, method, n=fun.n, chunk_steps=RESUME_CHUNK)
        checkpoint_contract(f"{name}_B{RESUME_B}", start, resume, y0, 0.0,
                            tf, rt, at)
        a = solve_args(y0, tf, rt, at, None, dev)
        ref, plain_ms = event_call(lambda: K.erk_ensemble_torch(method, fun,
                                                                *a))
        # Lorenz to t = 20: nvcc's FMAs in the stage sums (the explicit
        # kernels contract them; the plain version does not) grow like
        # exp(0.9 t) to ~1e-6 of |y| with every counter equal.
        err = compare(f"{name}_vs_plain_B{RESUME_B}", outputs(res), ref,
                      scaled=True, y_equal=1e-5 if tf > 5.0 else 1e-6)
        bound_ms, bound_by = K.solve_bound(method, fun, res.nstep, res.naccpt)
        rows.append({"name": name, "route": "cuda",
                     "source": f"ivp_tpu_torch/csrc/{K.KERNELS[method][1]}.cu",
                     "replaces": "ivp_tpu/core/driver.py:478",
                     "launches": launches, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_share": bound_ms / ms,
                     "library_ms": None, "solve_ms": solve_ms,
                     "host_us_per_resume": float(np.mean(host))})
    return rows


# The stiff kernels' event modes (csrc/radau_ev.cu, csrc/bdf_ev.cu).  The
# oscillator: VdP mu=1000 at bench.py's stiff row (B=131072, STIFF_TOL,
# t in [0, 3000], stiff_y0) with events.vdp_crossing (two downward
# crossings a lane, in the relaxation jumps near t = 807 and 2421, where the
# steps are smallest), lean and with the 101-point grid.  The restarts:
# events.replenish on decay at B=131072, each lane's rate k from a seed in
# [10, 100] and its span ten of its periods, rtol 1e-8, atol 1e-10.  Held
# lane by lane against the plain version on the card under the "state"
# controller at the main path's B and y0: the oscillator over [0, 1000]
# (each lane's first crossing; over [0, 3000] with Brent's lock-step
# iterations the plain version takes longer than the 30 s a method
# STIFF_PLAIN_B allows), the restarts over their whole spans; under the
# float32 controller at CHECK_B lanes on the same spans, with the record
# entries in chunks of REC_CAP_CHECK rows.
STIFF_EV_CAP, STIFF_EV_PLAIN_TF = 4, 1000.0
REPL_TOL, REPL_K, REPL_PERIODS = (1e-8, 1e-10), (10.0, 100.0), 10
REPL_RESTARTS, REPL_CAP = 20, 16
# solve_ivp's crossing times against SciPy's (Radau or BDF at rtol = atol =
# 1e-10): within IVP_EV_T of the span, the global error of a solve at
# STIFF_TOL's rtol 1e-4 over the relaxation jumps.
IVP_EV_T = 1e-3
EV_COUNTS = ("n_events", "n_restarts", "event_overflow")


def replenish_inputs(B, dev, seed=5):
    """``(y0, k, tf)`` of the restarts' lanes: y0 = 1, k uniform in
    ``REPL_K`` from ``seed``, tf ``REPL_PERIODS`` periods ln 2 / k (1% past
    the last refill)."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(*REPL_K, B)
    tf = REPL_PERIODS * np.log(2.0) / k * 1.01
    T = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    return T(np.ones((B, 1))), T(k), T(tf)


def stiff_ev_inputs(which, B, dev, tf=None, grid_m=0):
    """A stiff event solve's wrapper arguments: ``(fun, a, events, grid,
    set)``, ``a`` from y0 to max_steps (stiff_ensemble's order), events an
    EventArgs, for the oscillator over [0, tf] (default STIFF_TF; with
    ``grid_m`` points from 0 to tf, else no grid) or the restarts."""
    from ivp_tpu_torch import events as EV
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.events import event_args

    if which == "crossing":
        tf = STIFF_TF if tf is None else tf
        y0 = torch.as_tensor(stiff_y0(B), device=dev)
        a = solve_args(y0, tf, *STIFF_TOL, None, dev) + ((STIFF_MU,), 100000)
        ev = event_args([EV.vdp_crossing], STIFF_EV_CAP, 0)
        fun = rhs.vdp
    else:
        y0, k, tfs = replenish_inputs(B, dev)
        z = torch.zeros_like(k)
        a = (y0, z, tfs, tfs, None,
             torch.full((B, 1), REPL_TOL[0], dtype=torch.float64, device=dev),
             torch.full((B, 1), REPL_TOL[1], dtype=torch.float64, device=dev),
             (k,), 100000)
        ev = event_args([EV.replenish], REPL_CAP, REPL_RESTARTS)
        fun = rhs.decay
    grid = None
    if grid_m:   # the oscillator's t_eval, as the solvers are given it
        grid = torch.broadcast_to(torch.as_tensor(
            np.linspace(0.0, tf, grid_m), device=dev), (B, grid_m))
    return fun, a, ev, grid, EV.SETS[which]


def ev_dict(out):
    """stiff_ensemble's outputs with events as a dict, the event buffers'
    fields included."""
    d = ens_dict((*out[:9], *out[-2:]))
    ev = out[9]
    d.update(t_events=ev.t_events, y_events=ev.y_events,
             n_events=ev.n_events, event_overflow=ev.event_overflow,
             n_restarts=ev.n_restarts, n_brent=ev.n_brent)
    return d


def rec_ev_dict(r):
    """A RecordResult with events as a dict: rec_dict's fields and the
    event buffers'."""
    d = rec_dict(r)
    d.update(zip(("t_events", "y_events", "n_events", "event_overflow",
                  "n_restarts", "n_brent"), r.events))
    return d


def ev_compare(name, got, ref, share, arrays=("y", "y_events")):
    """stiff_compare of an event solve: status, every counter, the event
    counts, restarts and overflow flags (and n_samples, n_rec where their
    arrays are held) equal, ``arrays`` within STIFF_Y and the event times
    within T_EVENT of their lane's time scale."""
    counts = EV_COUNTS + (("n_samples",) if "y_samples" in arrays else ()) + (
        ("n_rec",) if "rec_t" in arrays else ())
    err = stiff_compare(name, got, ref, share, counts, arrays)
    stiff_compare(f"{name}_event_times", got, ref, share, counts,
                  ("t_events",), y_tol=T_EVENT)
    return err


def stiff_events_vs_plain(dev, method, which, rows):
    """The kernel's event modes against the plain version on the card.
    Under the "state" controller at the main path's B and y0 (the
    oscillator over [0, STIFF_EV_PLAIN_TF], LEAN and SAMPLED on a 51-point
    grid; the restarts over their spans, LEAN): one plain run (sampled for
    the oscillator, whose sample mode changes no step) holds each mode;
    its ms and the kernel's (CUDA events) go to ``rows`` as ``plain_ms``
    and ``check_ms``.  Under the float32 controller at CHECK_B lanes (the
    oscillator's y0 stiff_y0(CHECK_B) on the same span, the restarts' k
    drawn at that B): one plain record run in chunks of REC_CAP_CHECK rows
    with coefficients (and the oscillator's samples) holds LEAN, SAMPLED
    and both RECORD entries, with and without coefficients, whose lanes
    carry their event values, hit counts and restarts across each chunk's
    end.  Raises ``max_abs_err`` in ``rows``."""
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    m = method.lower()
    osc = which == "crossing"
    modes = ("lean", "sampled") if osc else ("lean",)

    def key(mode):
        return f"{m}{'_sampled' if mode == 'sampled' else ''}_ev" + (
            "" if osc else "_replenish")

    def hold(mode, tag, got, ref, cp, arrays=()):
        g = mode == "sampled" or (osc and mode.startswith("record"))
        r = ref if g else {k: v for k, v in ref.items()
                           if k not in ("y_samples", "n_samples")}
        arrays = ("y", "y_events") + (("y_samples",) if g else ()) + arrays
        err = ev_compare(f"{m}_{which}_{mode}_vs_plain_{tag}_{cp}", got, r,
                         STIFF_SHARE[cp], arrays)
        # (the record entry without coefficients is on no main path: its
        # phase lines hold it)
        if mode != "record":
            row = rows.setdefault(
                f"{m}_record_cont_ev" if mode == "record_cont" else
                key(mode), {})
            row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
            return row

    # "state" at the main path's B.
    cp = "state"
    fun, a, ev, grid, _ = stiff_ev_inputs(
        which, STIFF_B, dev, STIFF_EV_PLAIN_TF if osc else None,
        MODES_M if osc else 0)
    spec = stiff_spec(method, fun.n, None, {"controller_precision": cp})
    t = time.perf_counter()
    out, plain_ms = event_call(lambda: K.erk_ensemble_torch(
        method, fun, *a, grid, spec, ev, counters=True))
    ref = ev_dict((*out[:-1], *out[-1]))
    phase(f"{m}_{which}_plain_B{STIFF_B}_{cp}", event_ms=plain_ms,
          wall_s=round(time.perf_counter() - t, 3))
    del out
    for mode in modes:
        g = grid if mode == "sampled" else None
        out, check_ms = event_call(lambda: S.stiff_ensemble(
            method, fun, *a, spec, 0.0, g, ev))
        hold(mode, f"B{STIFF_B}", ev_dict(out), ref, cp).update(
            plain_ms=plain_ms, check_ms=check_ms)
        del out
    del ref

    # float32 at CHECK_B, the record entries in chunks.
    cp = "float32"
    fun, a, ev, grid, _ = stiff_ev_inputs(
        which, CHECK_B, dev, STIFF_EV_PLAIN_TF if osc else None,
        MODES_M if osc else 0)
    spec = stiff_spec(method, fun.n, None, {"controller_precision": cp})
    t = time.perf_counter()
    plain = R.erk_record_torch(method, fun, *a, grid, spec,
                               rec_cap=REC_CAP_CHECK, record_cont=True,
                               events=ev)
    ref = rec_ev_dict(plain)
    phase(f"{m}_{which}_plain_record_B{CHECK_B}_{cp}", chunks=plain.chunks,
          wall_s=round(time.perf_counter() - t, 3))
    del plain
    tag = f"B{CHECK_B}"
    for mode in modes:
        g = grid if mode == "sampled" else None
        hold(mode, tag, ev_dict(S.stiff_ensemble(
            method, fun, *a, spec, 0.0, g, ev)), ref, cp)
    for cont in (True, False):
        r = R.erk_record(method, fun, *a, grid, spec, rec_cap=REC_CAP_CHECK,
                         record_cont=cont, events=ev)
        mode = "record_cont" if cont else "record"
        phase(f"{m}_{which}_{mode}_chunks_{tag}", chunks=r.chunks)
        if r.chunks < 2:
            raise AssertionError(f"{m} {which} {mode}: {r.chunks} chunk")
        hold(mode, f"{tag}_rec{REC_CAP_CHECK}", rec_ev_dict(r), ref, cp,
             REC_FIELDS[:4] + (REC_FIELDS[4:] if cont else ()))
        del r


def stiff_events_solve_ivp(dev, method, rows):
    """``solve_ivp`` of one oscillator lane with ``events.vdp_crossing`` and
    ``dense_output`` on the card (the RECORD event entry with
    coefficients), against the plain version (``device="cpu"``: every
    counter and the events; its time on the host, ``plain_ms``) and
    SciPy's event times; its row into ``rows`` (``max_abs_err`` the
    largest of its own and the record check's, stiff_events_vs_plain)."""
    from scipy.integrate import solve_ivp as scipy_solve_ivp

    from ivp_tpu_torch import events as EV
    from ivp_tpu_torch import rhs, solve_ivp
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    m = method.lower()
    name = f"{m}_record_cont_ev"
    y1 = stiff_y0(1)[0]
    ivp = dict(method=method, args=(STIFF_MU,), rtol=STIFF_TOL[0],
               atol=STIFF_TOL[1], dense_output=True,
               events=[EV.vdp_crossing], event_capacity=STIFF_EV_CAP)
    call = lambda: solve_ivp(rhs.vdp, (0.0, STIFF_TF), y1, **ivp)
    walls = []
    for i in range(3):
        t = time.perf_counter()
        r = call()
        if i:
            walls.append(time.perf_counter() - t)
    (r, k_ms, _), launches = launches_of(
        lambda: kernel_device_ms(call, match=f"{m}_kernel"))
    t = time.perf_counter()
    cpu = solve_ivp(rhs.vdp, (0.0, STIFF_TF), y1, device="cpu", **ivp)
    plain_ms = 1e3 * (time.perf_counter() - t)
    # The kernel's route again, whose event outputs give Brent's count to
    # the bound.
    fun, a, ev, _, ev_set = stiff_ev_inputs("crossing", 1, dev)
    spec = stiff_spec(method, 2, None, None)
    again = R.erk_record(method, fun, *a, None, spec, record_cont=True,
                         events=ev)

    def down(t, y):
        return y[0]
    down.direction = -1
    sc = scipy_solve_ivp(
        lambda t, y: [y[1], STIFF_MU * (1.0 - y[0] ** 2) * y[1] - y[0]],
        (0.0, STIFF_TF), y1, method={"RADAU": "Radau", "BDF": "BDF"}[method],
        rtol=1e-10, atol=1e-10, events=down)
    same = {f: r[f] == cpu[f] for f in ("nfev", "njev", "nlu", "nstep",
                                        "naccpt", "nrejct", "status",
                                        "n_restarts")}
    t_ev, t_cpu = np.asarray(r.t_events[0]), np.asarray(cpu.t_events[0])
    t_sc = np.asarray(sc.t_events[0])
    scale = max(1.0, float(np.abs(r.y).max()))
    err_cpu = max(float(np.abs(r.y[:, -1] - cpu.y[:, -1]).max()) / scale,
                  float(np.abs(np.asarray(r.y_events[0])
                               - np.asarray(cpu.y_events[0])).max())
                  / scale)
    tev_err = float(np.abs(t_ev - t_cpu).max()) / STIFF_TF
    sc_err = (float(np.abs(t_ev - t_sc).max()) / STIFF_TF
              if t_sc.shape == t_ev.shape else float("inf"))
    bound_ms, bound_by = S.stiff_bound(
        method, rhs.vdp, again.nstep, again.naccpt, again.nrejct,
        again.nfev, again.njev, again.nlu, n_rec=again.n_rec,
        record_cont=True, events=(ev_set, again.events))
    ok = (r.status == 0 and set(launches) == {name} and all(same.values())
          and t_ev.shape == t_cpu.shape and t_ev.size >= 1
          and err_cpu <= STIFF_Y and tev_err <= T_EVENT
          and sc_err <= IVP_EV_T)
    phase(f"{name}_solve_ivp_vdp", ok=ok, launches=launches,
          kernel_ms=k_ms, wall_ms=1e3 * float(np.median(walls)),
          plain_ms=plain_ms, counters_equal_cpu=same, events=t_ev.size,
          err_vs_cpu=err_cpu, event_time_err_vs_cpu=tev_err,
          event_time_err_vs_scipy=sc_err, bound_ms=bound_ms,
          bound_by=bound_by)
    if not ok:
        raise AssertionError(f"solve_ivp {method} with events on the "
                             f"card: {launches}, counters equal {same}, "
                             f"errors {err_cpu}, {tev_err}, {sc_err}")
    row = rows.setdefault(name, {})
    row.update(launches=launches[name], ms=k_ms, plain_ms=plain_ms,
               check_ms=k_ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / k_ms,
               wall_ms=1e3 * float(np.median(walls)),
               max_abs_err=max(row.get("max_abs_err", 0.0), err_cpu,
                               tev_err))


def stiff_events_main_path(dev):
    """The stiff kernels' event modes at full width: the oscillator (lean and
    sampled) and the restarts through ``build_ensemble_solver``, and
    ``solve_ivp`` of one oscillator lane with ``dense_output`` (the RECORD
    event entry), each method.  For each path: its launches (the counts
    set to 0 just before the call and read just after), kernel ms alone
    (torch.profiler), solve ms (CUDA events, the median of 2 after a
    warm-up) and wall ms, the bound with the event work
    (``stiff_bound(..., events=)``) and its share, a second run bit for
    bit with the first (through the wrapper, whose event outputs give
    Brent's count to the bound), every lane succeeded (or, restarting,
    within its budget) with its events found; then each against its plain
    version (``stiff_events_vs_plain``).  ``{row name: row}``."""
    from scipy.integrate import solve_ivp as scipy_solve_ivp

    from ivp_tpu_torch import Status, build_ensemble_solver, solve_ivp
    from ivp_tpu_torch import events as EV
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    rows = {}
    B = STIFF_B
    for method in ("RADAU", "BDF"):
        m = method.lower()
        paths = [("crossing", False), ("crossing", True), ("replenish", False)]
        for which, sampled in paths:
            osc = which == "crossing"
            name = f"{m}{'_sampled' if sampled else ''}_ev" + (
                "" if osc else "_replenish")
            key = f"{m}{'_sampled' if sampled else ''}_ev"
            fun, a, ev, grid, ev_set = stiff_ev_inputs(
                which, B, dev, grid_m=SAMPLED_M if sampled else 0)
            if osc:
                solver = build_ensemble_solver(
                    rhs.vdp, method, n=2, args=(STIFF_MU,),
                    events=list(ev.events), event_capacity=ev.cap,
                    t_eval=(np.linspace(0.0, STIFF_TF, SAMPLED_M)
                            if sampled else None))
                call = lambda: solver(a[0], 0.0, STIFF_TF, *STIFF_TOL)
            else:
                solver = build_ensemble_solver(
                    rhs.decay, method, n=1, args=a[7], args_batched=True,
                    events=list(ev.events), event_capacity=ev.cap,
                    max_restarts=ev.max_restarts)
                call = lambda: solver(a[0], 0.0, a[2], *REPL_TOL)
            res, walls, ev_ms = timed_solves(lambda _: call(), [None] * 3)
            del res
            (res, k_ms, dev_ms), launches = launches_of(
                lambda: kernel_device_ms(call, match=f"{m}_kernel"))
            if set(launches) != {key}:
                raise AssertionError(f"{name}: the solve launched "
                                     f"{launches}")
            # The second run, through the wrapper: bit for bit.
            spec = stiff_spec(method, fun.n, None, None)
            out = S.stiff_ensemble(method, fun, *a, spec, 0.0, grid, ev)
            again = ev_dict(out)
            # (an ensemble without restarts gives no n_restarts, as
            # ivp_tpu's)
            fields = STIFF_FINAL + tuple(
                f for f in EV_COUNTS if not osc or f != "n_restarts"
            ) + ("t_events", "y_events") + (
                ("y_samples", "n_samples") if sampled else ())
            first = {f: getattr(res, f) for f in fields}
            bitwise(f"{name}_main_path_rerun_B{B}", first, again, fields)
            bound_ms, bound_by = S.stiff_bound(
                method, fun, res.nstep, res.naccpt, res.nrejct, res.nfev,
                res.njev, res.nlu, n_samples=res.n_samples if sampled
                else None, m=SAMPLED_M if sampled else 0,
                events=(ev_set, out[9]))
            n_ev = res.n_events[:, 0]
            if osc:
                ok = (bool((res.status == Status.SUCCESS).all())
                      and bool((n_ev >= 1).all()))
            else:
                ok = (bool((res.status == Status.SUCCESS).all())
                      and bool((res.n_restarts >= REPL_PERIODS - 1).all()))
            ok = ok and bool(torch.isfinite(res.y).all()) and bool(
                torch.isfinite(res.t_events).all())
            if sampled:
                ok = ok and bool((res.n_samples == SAMPLED_M).all())
            solve_ms = float(np.median(ev_ms))
            row = dict(launches=launches[key], ms=k_ms, solve_ms=solve_ms,
                       wall_ms=1e3 * float(np.median(walls)),
                       solve_less_kernel_ms=solve_ms - k_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       bound_share=bound_ms / k_ms,
                       mean_nstep=float(res.nstep.double().mean()),
                       mean_events=float(n_ev.double().mean()),
                       mean_restarts=float(res.n_restarts.double().mean())
                       if not osc else 0.0,
                       brent_evals=int(out[9].n_brent.sum()))
            phase(f"{name}_main_path_B{B}", ok=ok, **row)
            if not ok:
                raise AssertionError(f"{name} main path: a lane did not end "
                                     f"as expected")
            rows[name] = row
            del res, out, again, first
        stiff_events_vs_plain(dev, method, "crossing", rows)
        stiff_events_vs_plain(dev, method, "replenish", rows)

        stiff_events_solve_ivp(dev, method, rows)
    return rows


def stiff_phase(dev):
    """The stiff kernels against their plain versions, ivp_tpu's numbers and
    the Robertson budgets, then the stiff main path; then the SAMPLED and
    RECORD modes against their plain versions and on their main paths; the
    JSON rows of radau and bdf and of their modes."""
    t = time.perf_counter()
    stiff_vs_plain(dev)
    stiff_golden(dev)
    phase("stiff_checks", seconds=round(time.perf_counter() - t, 3))
    t = time.perf_counter()
    main, finals, plains = stiff_main_path(dev)
    phase("stiff_main_path", seconds=round(time.perf_counter() - t, 3))
    t = time.perf_counter()
    checks = stiff_modes_vs_plain(dev)
    phase("stiff_modes_checks", seconds=round(time.perf_counter() - t, 3))
    t = time.perf_counter()
    modes = stiff_modes_main_paths(dev, finals, plains)
    phase("stiff_modes_main_paths", seconds=round(time.perf_counter() - t, 3))
    t = time.perf_counter()
    events = stiff_events_main_path(dev)
    phase("stiff_events_main_path", seconds=round(time.perf_counter() - t, 3))
    replaces = {"radau": "ivp_tpu/methods/radau.py:348",
                "bdf": "ivp_tpu/methods/bdf.py:312"}
    rows = [{"name": m, "route": "cuda",
             "source": f"ivp_tpu_torch/csrc/{m}.cu", "replaces": replaces[m],
             "library_ms": None,
             **{k: v for k, v in main[m].items()
                if k not in ("solve_ms", "wall_ms", "host_us_per_resume")}}
            for m in ("radau", "bdf")]
    # No TPU kernel stands behind the modes: they replace ivp_tpu's
    # XLA-fused driver loop in sample mode (core/driver.py:312-434) and
    # record mode (run_chunk :286-310, :448-457); plain_ms and check_ms are
    # the B=4096 check's (t in [0, 1000]), ms the main path's kernel,
    # max_abs_err the largest of the check's and the main path's.
    for name, row in modes.items():
        m = name.split("_")[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"ivp_tpu_torch/csrc/{m}.cu",
            "replaces": ("ivp_tpu/core/driver.py:312" if "sampled" in name
                         else "ivp_tpu/core/driver.py:286"),
            "launches": row["launches"],
            "max_abs_err": max(checks[name]["max_abs_err"],
                               row["max_abs_err"]),
            "ms": row["kernel_ms"], "plain_ms": checks[name]["plain_ms"],
            "check_ms": checks[name]["check_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_share": row["bound_share"], "library_ms": None,
            "solve_ms": row["solve_ms"], "drain_ms": row["drain_ms"],
            "registers": row["registers"],
            "local_bytes": row["local_bytes"],
            "blocks_per_sm": row["blocks_per_sm"],
            "stage_rows": row["stage_rows"],
            "stage_lane_bytes": row["stage_lane_bytes"]})
    # The event modes replace ivp_tpu's XLA-fused driver loop with events
    # and restarts (core/driver.py::step_body :203-280 around
    # core/events.py::process_events); no TPU kernel stands behind them.
    # plain_ms and check_ms are the plain version's and the kernel's at the
    # vs-plain inputs (stiff_events_vs_plain: B=131072, the oscillator over
    # [0, 1000], the "state" controller; solve_ivp's row: its one lane, the
    # plain version on the host's CPU), ms the main path's kernel.
    for name, row in events.items():
        m = name.split("_")[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"ivp_tpu_torch/csrc/{m}_ev.cu",
            "replaces": "ivp_tpu/core/driver.py:203",
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "check_ms": row["check_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "bound_share": row["bound_share"],
            "library_ms": None, "wall_ms": row["wall_ms"]})
    return rows


def main():
    # ---- 1. Device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from ivp_tpu_torch import Status, build_ensemble_solver, rhs
    from ivp_tpu_torch.kernels import build
    from ivp_tpu_torch.kernels import dopri5_ensemble as k

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    phase("device", kind=repr(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=repr(smi))

    # ---- 2. Build ----
    # One nvcc per source, all started together; the lean DOPRI5 library
    # is loaded as soon as it is there.
    t = time.perf_counter()
    nvcc_ran = not all(build.library_path(name=n).is_file()
                       for n in build.names())
    libs = build.build_all()
    for name in libs:
        build.library(name)
    phase("build", seconds=round(time.perf_counter() - t, 3),
          libraries=sorted(p.name for p in libs.values()), nvcc_ran=nvcc_ran)
    for name, path in sorted(libs.items()):
        for fn, regs, st, ld in build.ptxas_report(path):
            print(f"  ptxas [{name}] {fn}: {regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads", flush=True)

    def args_for(y0):
        B = y0.shape[0]
        return (y0, lanes(B, 0.0, dev), lanes(B, 100.0, dev),
                lanes(B, 100.0, dev), None,
                torch.full((B, 2), RTOL, dtype=torch.float64, device=dev),
                torch.full((B, 2), ATOL, dtype=torch.float64, device=dev))

    # ---- 3. Kernel against its plain version on the card ----
    y0 = torch.as_tensor(vdp_y0(4096), device=dev)
    got = k.dopri5_ensemble_cuda(rhs.vdp, *args_for(y0))
    torch.cuda.synchronize()
    ref = k.dopri5_ensemble_torch(rhs.vdp, *args_for(y0))
    torch.cuda.synchronize()
    max_abs_err = compare("kernel_vs_plain_B4096", got, ref)

    # The other RHS functors, per-lane args, per-lane spans (one zero span;
    # backward spans for decay only: VdP and Lorenz blow up backward in
    # time) and per-component tolerances, through the same kernel.
    rng = np.random.default_rng(2)
    Bc = 4096

    def T(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev).contiguous()

    for name, fun, y0n, span, backward, fargs in (
            ("vdp_per_lane_mu", rhs.vdp, vdp_y0(Bc, seed=2), 10.0, False,
             (T(rng.uniform(0.2, 5.0, Bc)),)),
            ("decay", rhs.decay, rng.uniform(0.5, 2.0, (Bc, 1)), 5.0, True,
             (0.7,)),
            ("lorenz", rhs.lorenz, 1.0 + rng.standard_normal((Bc, 3)), 2.0,
             False, ())):
        t0 = rng.uniform(-1.0, 1.0, Bc)
        dt = span * rng.uniform(0.5, 1.0, Bc)
        if backward:
            dt[1::4] *= -1.0
        dt[0] = 0.0
        n = fun.n
        a = (T(y0n), T(t0), T(t0 + dt), T(np.abs(dt)), None,
             T(10.0 ** rng.uniform(-8, -5, (Bc, n))),
             T(10.0 ** rng.uniform(-10, -7, (Bc, n))))
        got = k.dopri5_ensemble_cuda(fun, *a, fargs)
        ref = k.dopri5_ensemble_torch(fun, *a, fargs)
        torch.cuda.synchronize()
        compare(f"kernel_vs_plain_{name}_B{Bc}", got, ref)

    # The stiffness detector, the step budget, a too-small step, first_step
    # and max_step, through the same kernel.
    for name, a, kw, want in edge_cases(Bc, dev):
        got = k.dopri5_ensemble_cuda(rhs.vdp, *a, **kw)
        ref = k.dopri5_ensemble_torch(rhs.vdp, *a, **kw)
        torch.cuda.synchronize()
        compare(f"kernel_vs_plain_{name}_B{Bc}", got, ref)
        seen = set(got[2].cpu().tolist())
        if seen != want:
            raise AssertionError(f"{name}: statuses {sorted(seen)}, expected "
                                 f"{sorted(want)}")

    # ---- 4. Kernel against ivp_tpu's own numbers (golden file) ----
    with np.load(ROOT / "ivp_tpu_torch" / "data" / "vdp_golden.npz") as g:
        gold = {f: g[f] for f in g.files}
    got = k.dopri5_ensemble_cuda(
        rhs.vdp, *args_for(torch.as_tensor(gold["y0"], device=dev)))
    torch.cuda.synchronize()
    compare("kernel_vs_ivp_tpu_golden_B256", got,
            [gold[f] for f in ("t", "y", "status", "nfev", "nstep", "naccpt",
                               "nrejct")])

    # ---- 5. Kernel against SciPy ----
    from scipy.integrate import solve_ivp

    y8 = vdp_y0(8, seed=1)
    got = k.dopri5_ensemble_cuda(rhs.vdp, *args_for(torch.as_tensor(y8, device=dev)))
    yk = got[1].cpu().numpy()
    ys = np.stack([solve_ivp(lambda t, y: [y[1], (1 - y[0] ** 2) * y[1] - y[0]],
                             (0.0, 100.0), y8[i], method="DOP853", rtol=1e-13,
                             atol=1e-14).y[:, -1] for i in range(8)])
    err = float(np.abs(yk - ys).max())
    phase("kernel_vs_scipy_dop853_B8", max_abs_err=err,
          status=sorted(set(got[2].cpu().tolist())))
    if err > Y_ALL or set(got[2].cpu().tolist()) != {Status.SUCCESS}:
        raise AssertionError(f"kernel vs SciPy: {err}")

    # ---- 6. The main path at full size (bench.py's headline config) ----
    B = MAIN_B
    solver = build_ensemble_solver(rhs.vdp, "RK45", n=2)
    y0s = [torch.as_tensor(vdp_y0(B, seed=s), device=dev) for s in range(4)]
    torch.cuda.synchronize()
    k.LAUNCHES = 0
    res, walls, ev_ms = timed_solves(solver, y0s, 0.0, 100.0, RTOL, ATOL)
    launches = k.LAUNCHES
    status = res.status.cpu().numpy()
    nstep = res.nstep.cpu().numpy()
    ms = float(np.median(ev_ms))
    phase(f"main_path_B{B}", launches=launches,
          success_fraction=float(np.mean(status == Status.SUCCESS)),
          ivps_per_sec=B / float(np.median(walls)),
          mean_nstep=float(nstep.mean()), max_nstep=int(nstep.max()),
          walls_s=[round(w, 6) for w in walls], event_ms=[round(m, 3) for m in ev_ms],
          finite=bool(torch.isfinite(res.y).all()))
    if launches != 4:
        raise AssertionError(f"main path launched the kernel {launches} times, "
                             f"expected 4")
    if not np.all(status == Status.SUCCESS) or not bool(torch.isfinite(res.y).all()):
        raise AssertionError("main path: not every lane succeeded")
    if tuple(res.y.shape) != (B, 2) or res.y.device != y0s[-1].device:
        raise AssertionError(f"main path: y has shape {tuple(res.y.shape)}")

    # The plain version on the card at the same B and inputs.
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    e0.record()
    plain = k.dopri5_ensemble_torch(rhs.vdp, *args_for(y0s[-1]))
    e1.record()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t
    plain_ms = e0.elapsed_time(e1)
    phase(f"plain_B{B}", wall_s=round(plain_wall, 6), event_ms=round(plain_ms, 3),
          ivps_per_sec=B / plain_wall, kernel_speedup=plain_ms / ms)
    compare(f"main_path_vs_plain_B{B}", outputs(res), plain)

    # ---- 7. A numpy y0 with no device runs the kernel on the card ----
    from ivp_tpu_torch import solve_ivp_ensemble

    y0n = vdp_y0(4096, seed=3)
    k.LAUNCHES = 0
    res_np = solve_ivp_ensemble(rhs.vdp, (0.0, 100.0), y0n, rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()
    np_launches = k.LAUNCHES
    phase("numpy_y0_default_device_B4096", launches=np_launches,
          device=res_np.y.device)
    if np_launches != 1 or res_np.y.device != dev:
        raise AssertionError(f"a numpy y0 ran {np_launches} kernel launches on "
                             f"{res_np.y.device}, expected 1 on {dev}")
    compare("numpy_y0_vs_plain_B4096", outputs(res_np),
            k.dopri5_ensemble_torch(rhs.vdp, *args_for(
                torch.as_tensor(y0n, device=dev))))

    # ---- 8. No silent fallback ----
    from ivp_tpu_torch import events as EV
    from ivp_tpu_torch import solve_ivp
    from ivp_tpu_torch.batch import build_resumable_solver

    for what, call in (
            ("plain callable on CUDA", lambda: build_ensemble_solver(
                lambda t, y: -y, "RK45", n=2)(y0s[0][:4], 0.0, 1.0, RTOL, ATOL)),
            ("float32 on CUDA", lambda: build_ensemble_solver(
                rhs.vdp, "RK45", n=2, dtype=torch.float32)(
                    vdp_y0(4), 0.0, 1.0, RTOL, ATOL)),
            ("solve_ivp float32 on CUDA", lambda: solve_ivp(
                rhs.vdp, (0.0, 1.0), [2.0, 0.0], dtype=torch.float32)),
            ("solve_ivp plain callable on CUDA", lambda: solve_ivp(
                lambda t, y: -y, (0.0, 1.0), [2.0, 0.0])),
            ("plain callable event on CUDA", lambda: build_ensemble_solver(
                rhs.ball, "RK45", n=2, events=[lambda t, y: y[:, 0]])(
                    y0s[0][:4], 0.0, 1.0, RTOL, ATOL)),
            ("solve_ivp plain callable event on CUDA", lambda: solve_ivp(
                rhs.ball, (0.0, 1.0), [2.0, 0.0], events=lambda t, y: y[0])),
            # The ball's entries exist only with its event set.
            ("ball without events, lean DOPRI5", lambda: build_ensemble_solver(
                rhs.ball, "RK45", n=2)(ball_y0(4), 0.0, 1.0, RTOL, ATOL)),
            ("ball without events, DOP853", lambda: build_ensemble_solver(
                rhs.ball, "DOP853", n=2)(ball_y0(4), 0.0, 1.0, RTOL, ATOL)),
            ("solve_ivp ball without events", lambda: solve_ivp(
                rhs.ball, (0.0, 1.0), [2.0, 0.0])),
            # The stiff kernels run a CudaRHS with a Jacobian, n <= 8, the
            # inverse backend, events of a declared set; the resumable
            # solver the lean solve.
            ("Radau with a plain callable event on CUDA", lambda:
                build_ensemble_solver(
                    rhs.vdp, "Radau", n=2, events=[lambda t, y: y[:, 0]])(
                    vdp_y0(4), 0.0, 1.0, RTOL, ATOL)),
            ("resumable BDF with events on CUDA", lambda:
                build_resumable_solver(rhs.vdp, "BDF", n=2,
                                       events=[EV.vdp_crossing])[0](
                    vdp_y0(4), 0.0, 1.0, RTOL, ATOL)),
            ("resumable Radau with t_eval on CUDA", lambda:
                build_resumable_solver(rhs.vdp, "Radau", n=2,
                                       t_eval=[0.0, 1.0])[0](
                    vdp_y0(4), 0.0, 1.0, RTOL, ATOL)),
            ("BDF with a callable jac on CUDA", lambda: build_ensemble_solver(
                rhs.vdp, "BDF", n=2, jac=lambda t, y: None)(
                    vdp_y0(4), 0.0, 1.0, RTOL, ATOL)),
            ("Radau without a functor Jacobian", lambda: build_ensemble_solver(
                rhs.lorenz, "Radau", n=3)(lorenz_y0(4), 0.0, 1.0, RTOL, ATOL)),
            ("solve_ivp BDF with a plain callable event on CUDA", lambda:
                solve_ivp(rhs.vdp, (0.0, 1.0), [2.0, 0.0], method="BDF",
                          events=lambda t, y: y[0] - 1.0))):
        try:
            call()
        except NotImplementedError as e:
            phase("refused", case=repr(what), error=type(e).__name__)
        else:
            raise AssertionError(f"{what} did not raise")

    # The least time an H100 SXM could take for the last main-path solve.
    bound_ms, bound_by = k.solve_bound(rhs.vdp, res.nstep)
    phase(f"bound_B{B}", bound_ms=bound_ms, bound_by=bound_by,
          flops_per_attempt=k.FLOPS_PER_ATTEMPT["vdp"],
          bound_share=bound_ms / ms)
    kernels = [{
        "name": "dopri5_ensemble", "route": "cuda",
        "source": "ivp_tpu_torch/csrc/dopri5_ensemble.cu",
        "replaces": "attic/pallas_erk.py:205",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_share": bound_ms / ms,
        # No single PyTorch call computes an adaptive ODE solve.
        "library_ms": None}]

    # ---- 9. The rest of the explicit tier: kernels against their plain
    #         versions, ivp_tpu's numbers and SciPy; then the Lorenz main
    #         path at full width ----
    from ivp_tpu_torch.kernels import erk_ensemble as K

    t = time.perf_counter()
    errs = erk_kernels_vs_plain(dev)
    phase("erk_kernels_vs_plain", seconds=round(time.perf_counter() - t, 3))
    gold = erk_golden_and_scipy(dev)
    t = time.perf_counter()
    rows = erk_main_path(dev, gold)
    phase("erk_main_path", seconds=round(time.perf_counter() - t, 3))
    # None has a TPU kernel behind it: each replaces the XLA-fused vmapped
    # driver loop around one engine of ivp_tpu/methods/erk.py.
    replaces = {"dop853": "ivp_tpu/methods/erk.py:224",
                "rk23": "ivp_tpu/methods/erk.py:370",
                "rk4": "ivp_tpu/methods/erk.py:439",
                "dopri5_sampled": "ivp_tpu/core/driver.py:396"}
    for method, (kernel, source) in K.KERNELS.items():
        kernels.append({"name": kernel, "route": "cuda",
                        "source": f"ivp_tpu_torch/csrc/{source}.cu",
                        "replaces": replaces[kernel],
                        "max_abs_err_B4096": errs[kernel],
                        "library_ms": None, **rows[kernel]})

    # ---- 10. The record mode ----
    kernels += record_phase(dev)

    # ---- 11. Events and in-loop restarts ----
    kernels += event_phase(dev)

    # ---- 12. The stiff tier; 13. the explicit resumable solver ----
    kernels += stiff_phase(dev)
    t = time.perf_counter()
    kernels += resumable_phase(dev)
    phase("resumable_phase", seconds=round(time.perf_counter() - t, 3))
    for row in kernels:
        if row["launches"] < 1:
            raise AssertionError(f"the main path never launched {row['name']}")
    phase("total", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
