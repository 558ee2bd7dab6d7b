"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives ivp_tpu_torch's main path, the lean DOPRI5 ensemble solve, on
cuda:0 through the hand-written kernel csrc/dopri5_ensemble.cu, and holds
the kernel against its plain PyTorch version, against ivp_tpu's own numbers
(ivp_tpu_torch/data/vdp_golden.npz) and against SciPy.  Then a numpy y0 with
no ``device`` must run the kernel on cuda:0.  Imports neither jax nor
ivp_tpu.  Prints its phases one per line, then a JSON line with the
kernel's launches, error, times and bound, then the card, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is not 0
and no result line is printed.  Needs one CUDA device; fails without one.
"""
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


def phase(name, **kv):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def vdp_y0(B, seed=0):
    rng = np.random.default_rng(seed)
    return np.array([2.0, 0.0]) + 0.05 * rng.standard_normal((B, 2))


def compare(name, got, ref):
    """Hold a kernel result against a reference (both 7-tuples
    t, y, status, nfev, nstep, naccpt, nrejct; torch or numpy)."""
    a = [np.asarray(x.cpu()) if torch.is_tensor(x) else np.asarray(x) for x in got]
    b = [np.asarray(x.cpu()) if torch.is_tensor(x) else np.asarray(x) for x in ref]
    t, y, status, nfev, nstep, naccpt, _ = a
    rt, ry, rstatus, rnfev, rnstep, rnaccpt, _ = b
    if not np.array_equal(status, rstatus):
        raise AssertionError(f"{name}: status differs on "
                             f"{int(np.sum(status != rstatus))} lanes")
    frac = {k: float(np.mean(u == v)) for k, u, v in
            (("nstep", nstep, rnstep), ("naccpt", naccpt, rnaccpt),
             ("nfev", nfev, rnfev))}
    same = nstep == rnstep
    dy = np.abs(y - ry).max(axis=1)
    err_same = float(dy[same].max()) if same.any() else 0.0
    err_all = float(dy.max())
    phase(name, lanes=len(status), **{f"{k}_equal": v for k, v in frac.items()},
          max_abs_err_equal_steps=err_same, max_abs_err=err_all,
          max_abs_err_t=float(np.abs(t - rt).max()))
    if min(frac.values()) < COUNT_FRACTION:
        raise AssertionError(f"{name}: counters equal on only {frac}")
    if err_same > Y_EQUAL_STEPS or err_all > Y_ALL or not np.isfinite(y).all():
        raise AssertionError(f"{name}: final y differs by {err_same} "
                             f"(equal steps) / {err_all} (all lanes)")
    return err_all


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


def main():
    # ---- 1. Device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from ivp_tpu_torch import Status, build_ensemble_solver, rhs
    from ivp_tpu_torch.kernels import build
    from ivp_tpu_torch.kernels import dopri5_ensemble as k

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    phase("device", kind=repr(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=repr(smi))

    # ---- 2. Build ----
    t = time.perf_counter()
    nvcc_ran = not build.library_path().is_file()
    lib = build.build()
    build.library()
    phase("build", seconds=round(time.perf_counter() - t, 3), library=lib.name,
          nvcc_ran=nvcc_ran)
    functor = "?"
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            functor = next((f for f in ("VdP", "Decay", "Lorenz") if f in line),
                           line.split("'")[1] if "'" in line else "?")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas [{functor}]:", line.split(":", 1)[-1].strip(),
                  flush=True)

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
    walls, ev_ms = [], []
    res = None
    for i, y in enumerate(y0s):
        # Free the last result first: while it is held, the allocator has to
        # cudaMalloc new outputs, and the event time includes that wait.
        del res
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = time.perf_counter()
        e0.record()
        res = solver(y, 0.0, 100.0, RTOL, ATOL)
        e1.record()
        torch.cuda.synchronize()
        if i:   # run 0 warms up
            walls.append(time.perf_counter() - t)
            ev_ms.append(e0.elapsed_time(e1))
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
    compare(f"main_path_vs_plain_B{B}", tuple(res), plain)

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
    compare("numpy_y0_vs_plain_B4096", tuple(res_np),
            k.dopri5_ensemble_torch(rhs.vdp, *args_for(
                torch.as_tensor(y0n, device=dev))))

    # ---- 8. No silent fallback ----
    for what, call in (
            ("plain callable on CUDA", lambda: build_ensemble_solver(
                lambda t, y: -y, "RK45", n=2)(y0s[0][:4], 0.0, 1.0, RTOL, ATOL)),
            ("float32 on CUDA", lambda: k.dopri5_ensemble(
                rhs.vdp, *(None if a is None else a.float()
                           for a in args_for(y0s[0][:4]))))):
        try:
            call()
        except (NotImplementedError, TypeError) as e:
            phase("refused", case=repr(what), error=type(e).__name__)
        else:
            raise AssertionError(f"{what} did not raise")

    # The least time an H100 SXM could take for the last main-path solve.
    bound_ms, bound_by = k.solve_bound(rhs.vdp, res.nstep)
    phase(f"bound_B{B}", bound_ms=bound_ms, bound_by=bound_by,
          flops_per_attempt=k.FLOPS_PER_ATTEMPT["vdp"],
          bound_share=bound_ms / ms)
    print(json.dumps({"kernels": [{
        "name": "dopri5_ensemble", "route": "cuda",
        "source": "ivp_tpu_torch/csrc/dopri5_ensemble.cu",
        "replaces": "attic/pallas_erk.py:205",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_share": bound_ms / ms,
        # No single PyTorch call computes an adaptive ODE solve.
        "library_ms": None}]}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
