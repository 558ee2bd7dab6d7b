"""Measurements of the port's DOPRI5 kernel on one NVIDIA GPU (an H100).

    python3 measure_kernel.py

The problem is bench.py's headline one: VdP mu=1, t in [0, 100],
y0 = [2, 0] + 0.05 N(0,1) (numpy seed 0), DOPRI5, rtol 1e-6, atol 1e-8,
float64.  Prints, one item per line:

* the card and its power limit, as nvidia-smi gives them;
* the build: seconds, and ptxas's registers and spills per instantiation;
* the static SASS instruction mix of each instantiation (cuobjdump);
* ``settle``: 10 back-to-back main-path solves at B=524288, every one
  timed with CUDA events and none discarded, once with each result held
  until the next solve returns and once with it dropped before;
* ``sweep``: the kernel alone over a range of B: 2 untimed launches, then
  5 timed ones, every time printed, with IVPs/s, attempts/s and
  warp efficiency (sum of nstep over 32 x the sum of each warp's largest);
* ``clocks``: SM clock, power draw and temperature, sampled by nvidia-smi
  every 100 ms while the settle runs and the sweep ran;
* ``turns``: kernel, plain, plain, kernel at B=524288 (CUDA events);
* ``profile``: torch.profiler over 3 main-path solves: the kernel's share of
  device time, and device time over wall time.

Imports neither jax nor ivp_tpu.  Needs one CUDA device; exits 1 without one.
"""
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

RTOL, ATOL, TF = 1e-6, 1e-8, 100.0
MAIN_B = 524288
SWEEP_B = (8192, 32768, 131072, 262144, 524288, 1048576, 2097152)
REPEATS = 5    # timed launches per B in the sweep
SETTLE = 10    # back-to-back solves per settle mode
FUNCTORS = ("VdP", "Decay", "Lorenz")


def line(name, **kv):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def vdp_y0(B, seed=0):
    rng = np.random.default_rng(seed)
    return np.array([2.0, 0.0]) + 0.05 * rng.standard_normal((B, 2))


def kernel_args(y0):
    B, dev = y0.shape[0], y0.device
    f64 = torch.float64
    return (y0, torch.zeros(B, dtype=f64, device=dev),
            torch.full((B,), TF, dtype=f64, device=dev),
            torch.full((B,), TF, dtype=f64, device=dev), None,
            torch.full((B, 2), RTOL, dtype=f64, device=dev),
            torch.full((B, 2), ATOL, dtype=f64, device=dev))


def timed(fn):
    """(result, device ms by CUDA events, wall s) of one call."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1), time.perf_counter() - t


def warp_efficiency(nstep):
    ns = nstep.to(torch.int64)
    pad = (-ns.numel()) % 32
    if pad:
        ns = torch.cat([ns, ns.new_zeros(pad)])
    return float(ns.sum()) / (32.0 * float(ns.view(-1, 32).max(dim=1).values.sum()))


def sass_mix(lib):
    """Static instruction counts per kernel instantiation."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0:
        line("sass", error=repr(r.stderr.strip()[-200:]))
        return
    counts, name = {}, None
    for ln in r.stdout.splitlines():
        if "Function :" in ln:
            mangled = ln.split("Function :")[1].strip()
            name = next((f for f in FUNCTORS if f in mangled), mangled)
            counts[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", ln)
        if name and m:
            counts[name][m.group(1).split(".")[0]] += 1
    for name, c in counts.items():
        line("sass", functor=name, instructions=sum(c.values()),
             DFMA=c["DFMA"], DMUL=c["DMUL"], DADD=c["DADD"], MUFU=c["MUFU"],
             FFMA=c["FFMA"], BRA=c["BRA"])


def main():
    if not torch.cuda.is_available():
        print("measure_kernel: no CUDA device", file=sys.stderr)
        return 1
    from ivp_tpu_torch import build_ensemble_solver, rhs
    from ivp_tpu_torch.kernels import build
    from ivp_tpu_torch.kernels import dopri5_ensemble as k

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    line("device", nvidia_smi=repr(smi.splitlines()[0].strip()),
         torch=torch.__version__, cuda=torch.version.cuda)

    t = time.perf_counter()
    lib = build.build()
    build.library()
    line("build", seconds=round(time.perf_counter() - t, 3), library=lib.name)
    functor = "?"
    for ln in build.build_log.splitlines():
        if "Compiling entry function" in ln:
            functor = next((f for f in FUNCTORS if f in ln), "?")
        elif "registers" in ln or "spill" in ln:
            line("ptxas", functor=functor, info=repr(ln.split(":", 1)[-1].strip()))
    sass_mix(lib)

    solver = build_ensemble_solver(rhs.vdp, "RK45", n=2)
    y0 = torch.as_tensor(vdp_y0(MAIN_B), device=dev)
    torch.cuda.synchronize()
    # The clocks are sampled from here to the end of the sweep.
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        # Back-to-back main-path solves, none discarded.  "held": each
        # result lives until the next solve has returned, as in a loop
        # ``res = solver(...)``; "freed": it is dropped before the next.
        for mode in ("held", "freed"):
            runs, res = [], None
            for _ in range(SETTLE):
                if mode == "freed":
                    res = None
                res, m, w = timed(lambda: solver(y0, 0.0, TF, RTOL, ATOL))
                runs.append((m, w))
            del res
            line("settle", mode=mode, B=MAIN_B,
                 event_ms=[round(r[0], 4) for r in runs],
                 wall_ms=[round(1e3 * r[1], 4) for r in runs])

        # The kernel alone over B; each result is dropped before the next
        # launch, so no timed launch waits for a cudaMalloc.
        for B in SWEEP_B:
            args = kernel_args(torch.as_tensor(vdp_y0(B), device=dev))
            for _ in range(2):
                k.dopri5_ensemble_cuda(rhs.vdp, *args)
            torch.cuda.synchronize()
            ms = []
            for _ in range(REPEATS):
                out = None
                out, m, _ = timed(lambda: k.dopri5_ensemble_cuda(rhs.vdp, *args))
                ms.append(m)
            nstep = out[4]
            med = float(np.median(ms))
            attempts = float(nstep.to(torch.int64).sum())
            line("sweep", B=B, ms_median=round(med, 4),
                 ms_all=[round(m, 4) for m in ms],
                 ivps_per_s=round(B / (med * 1e-3), 1),
                 attempts_per_s=f"{attempts / (med * 1e-3):.4e}",
                 mean_nstep=round(float(nstep.double().mean()), 3),
                 max_nstep=int(nstep.max()),
                 warp_eff=round(warp_efficiency(nstep), 5))
    finally:
        sampler.terminate()
        samples = sampler.communicate(timeout=30)[0]
    rows = [[float(v) for v in s.split(",")] for s in samples.splitlines()
            if s.count(",") == 2 and "N/A" not in s]
    if rows:
        r = np.array(rows)
        line("clocks", samples=len(r), sm_mhz_min=r[:, 0].min(),
             sm_mhz_max=r[:, 0].max(), power_w_max=r[:, 1].max(),
             temp_c_max=r[:, 2].max())

    # Kernel and plain version in turns, same inputs.
    args = kernel_args(y0)
    for what in ("kernel", "plain", "plain", "kernel"):
        fn = (k.dopri5_ensemble_cuda if what == "kernel"
              else k.dopri5_ensemble_torch)
        _, m, w = timed(lambda: fn(rhs.vdp, *args))
        line("turns", what=what, B=MAIN_B, event_ms=round(m, 4),
             wall_s=round(w, 6))

    # The profiler over 3 main-path solves.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    y0s = [torch.as_tensor(vdp_y0(MAIN_B, seed=s), device=dev) for s in range(3)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for y in y0s:
            solver(y, 0.0, TF, RTOL, ATOL)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    us = [getattr(e, "self_device_time_total", None)
          or getattr(e, "self_cuda_time_total", 0) for e in dev_events]
    total = float(sum(us))
    kern = float(sum(u for e, u in zip(dev_events, us)
                     if "dopri5_ensemble_kernel" in e.key))
    if total > 0:
        line("profile", solves=3, device_us=round(total, 1),
             kernel_share=round(kern / total, 5),
             other_device_ops=sum(e.count for e in dev_events
                                  if "dopri5_ensemble_kernel" not in e.key),
             wall_us=round(wall_us, 1), busy_share=round(total / wall_us, 4))
    else:
        line("profile", error="'no device time in key_averages()'")
    return 0


if __name__ == "__main__":
    sys.exit(main())
