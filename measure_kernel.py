"""Measurements of the port's DOPRI5 kernel on one NVIDIA GPU (an H100).

    python3 measure_kernel.py [--baseline CSRC_DIR ...] [--phases a,b,...]

The problem is bench.py's headline one: VdP mu=1, t in [0, 100],
y0 = [2, 0] + 0.05 N(0,1) (numpy seed 0), DOPRI5, rtol 1e-6, atol 1e-8,
float64.  Prints, one item per line, the card and its power limit as
nvidia-smi gives them, the build (seconds, ptxas's registers and spills per
instantiation), then the phases (all by default, ``ab`` only with
``--baseline``; in this order):

* ``sass``: the static SASS instruction mix of each instantiation
  (cuobjdump), and ``loop``: the instructions one attempt issues on the
  loop body's fast path, by class (below), with the cycles each pipe needs
  for them;
* ``settle``: 10 back-to-back main-path solves at B=524288, every one timed
  with CUDA events and none discarded, once with each result held until the
  next solve returns and once with it dropped before;
* ``sweep``: the kernel alone over a range of B: 2 untimed launches, then 5
  timed ones, every time printed, with IVPs/s, attempts/s, warp efficiency
  (sum of nstep over 32 x the sum of each warp's largest), the bound
  (kernels/dopri5_ensemble.py::solve_bound) and the share of it reached,
  and the SM cycles per warp-attempt per scheduler;
* ``clocks``: SM clock, power draw and temperature, sampled by nvidia-smi
  every 100 ms while the settle and the sweep ran;
* ``turns``: kernel, plain, plain, kernel at B=524288 (CUDA events);
* ``profile``: torch.profiler over 3 main-path solves: the kernel's share of
  device time, and device time over wall time;
* ``occupancy``: one library per (threads a block, __launch_bounds__ min
  blocks an SM), built in parallel with -DIVP_THREADS/-DIVP_MIN_BLOCKS: its
  registers and spills, and each functor's kernel ms at B=524288 on its own
  problem (``PROBLEMS``), with a check that every lane's counters equal the
  package kernel's.  The settings are timed in turns: one untimed launch
  each, then ``OCC_ROUNDS`` rounds that time every setting once, in
  forward order on even rounds and backward on odd ones; then each
  functor's settings ranked by median;
* ``ab`` (needs ``--baseline``, which may be given more than once): the
  kernel built from another source tree (for example an older commit's
  ``ivp_tpu_torch/csrc``, unpacked into a directory .gitignore lists; its
  label is the directory above ``csrc``) against the package's, at
  B=524288: how many lanes differ in each output (0 everywhere is bit for
  bit equal) on each ``PROBLEMS`` entry and on chip_smoke.py's
  ``edge_cases`` (stiff lanes, the step budget, a too-small step,
  first_step and max_step), then rounds of old, new, new, old (CUDA
  events), and the loop's SASS classes of the old build.

The fast path of the loop is walked from the loop head to its back edge.  A
forward branch whose skipped region calls a subroutine is taken: that skips
the IEEE slow paths of f32/f64 division and sqrt, and the stiffness test
(run on ~1 accepted attempt in 1000), which holds such calls of its own.
Every other conditional branch falls through, so the path is an accepted
attempt's.  The line counts the regions skipped and their instructions.
``hinit`` lies before the loop and is not counted.

Imports neither jax nor ivp_tpu.  Needs one CUDA device; exits 1 without one.
"""
import argparse
import concurrent.futures
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
AB_ROUNDS = 3  # rounds of old, new, new, old
FUNCTORS = ("VdP", "Decay", "Lorenz")
# Occupancy sweep: threads a block x min blocks an SM; a setting above the
# SM's 2048 threads cannot be met and is skipped.
OCC_THREADS, OCC_MIN_BLOCKS = (64, 128, 256), (6, 7, 8, 10, 12)
OCC_ROUNDS = 10
PHASES = ("sass", "settle", "sweep", "turns", "profile", "occupancy", "ab")

# SASS classes of the loop count.
CLASSES = (
    ("f64", {"DFMA", "DMUL", "DADD"}),
    ("f32", {"FFMA", "FMUL", "FADD", "FMNMX", "FCHK"}),
    ("mufu", {"MUFU"}),
    ("conversion", {"F2F", "I2F", "F2I", "F2FP", "FRND", "I2FP", "F2IP"}),
    ("select_predicate", {"SEL", "FSEL", "PLOP3", "ISETP", "FSETP", "DSETP",
                          "P2R", "R2P", "FSET", "ISET"}),
    ("branch", {"BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
                "BREAK", "JMP", "BRX"}),
    ("integer", {"IMAD", "IADD3", "LOP3", "SHF", "LEA", "IMNMX", "IABS",
                 "POPC", "FLO", "IADD", "IMUL", "PRMT", "BMSK", "SGXT"}),
    ("move", {"MOV", "UMOV", "S2R", "CS2R", "S2UR"}),
    ("memory", {"LDG", "STG", "LDL", "STL", "LDC", "ULDC", "LDS", "STS"}),
)
# H100 (compute capability 9.0) results a clock per SM, from the CUDA
# programming guide's throughput table, as cycles a warp instruction holds
# one of the SM's 4 schedulers' pipes: f64 add/mul/fma 64 an SM (2 cycles),
# MUFU 16 (8), conversions from and to 64-bit types 16 (8).
PIPE_CYCLES = {"f64": 2, "mufu": 8, "conversion": 8}

# Each functor's problem for the occupancy sweep and the A/B: (rhs name, y0
# maker, tf, rtol, atol).  VdP is the headline; decay and Lorenz follow
# chip_smoke.py's checks at one span.
PROBLEMS = {
    "vdp": (lambda rng, B: np.array([2.0, 0.0]) + 0.05 * rng.standard_normal((B, 2)),
            TF, RTOL, ATOL),
    "decay": (lambda rng, B: rng.uniform(0.5, 2.0, (B, 1)), 5.0, 1e-8, 1e-10),
    "lorenz": (lambda rng, B: 1.0 + rng.standard_normal((B, 3)), 2.0, 1e-8,
               1e-10),
}


def line(name, **kv):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def vdp_y0(B, seed=0):
    rng = np.random.default_rng(seed)
    return np.array([2.0, 0.0]) + 0.05 * rng.standard_normal((B, 2))


def kernel_args(y0, tf=TF, rtol=RTOL, atol=ATOL):
    B, n, dev = y0.shape[0], y0.shape[1], y0.device
    f64 = torch.float64
    return (y0, torch.zeros(B, dtype=f64, device=dev),
            torch.full((B,), tf, dtype=f64, device=dev),
            torch.full((B,), tf, dtype=f64, device=dev), None,
            torch.full((B, n), rtol, dtype=f64, device=dev),
            torch.full((B, n), atol, dtype=f64, device=dev))


def problem_args(name, B, dev):
    make, tf, rtol, atol = PROBLEMS[name]
    y0 = torch.as_tensor(make(np.random.default_rng(0), B), device=dev)
    return kernel_args(y0, tf, rtol, atol)


def timed(fn):
    """(result, device ms by CUDA events, wall s) of one call."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1), time.perf_counter() - t


def warp_attempts(nstep):
    """Sum over warps of the warp's largest nstep: a warp runs until its
    slowest lane is done."""
    ns = nstep.to(torch.int64)
    pad = (-ns.numel()) % 32
    if pad:
        ns = torch.cat([ns, ns.new_zeros(pad)])
    return float(ns.view(-1, 32).max(dim=1).values.sum())


def ptxas_lines(log):
    """(functor, ptxas info) for each registers/spill line of an nvcc log."""
    out, functor = [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            functor = next((f for f in FUNCTORS if f in ln), "?")
        elif "registers" in ln or "spill" in ln:
            out.append((functor, ln.split(":", 1)[-1].strip()))
    return out


# ---- SASS ----

_INS = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                  r"([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def sass_functions(lib):
    """{functor: [(addr, predicate, opcode, operands)]} from cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {r.stderr.strip()[-300:]}")
    funcs, name = {}, None
    for ln in r.stdout.splitlines():
        if "Function :" in ln:
            mangled = ln.split("Function :")[1].strip()
            name = next((f for f in FUNCTORS if f in mangled), mangled)
            funcs[name] = []
            continue
        m = _INS.match(ln)
        if name and m:
            funcs[name].append((int(m.group(1), 16), (m.group(2) or "").strip(),
                                m.group(3), m.group(4).strip()))
    return funcs


def _target(operands):
    m = re.search(r"0x([0-9a-f]+)", operands)
    return int(m.group(1), 16) if m else None


def _class(op):
    if op.startswith("IMAD.MOV"):
        return "move"
    base = op.split(".")[0]
    if base.startswith("U") and base not in ("UMOV",):
        return "uniform"
    return next((c for c, ops in CLASSES if base in ops), "other")


def loop_fast_path(ins):
    """(opcodes on the loop's fast path, forward branches taken past a
    region with a call, instructions they skip)."""
    at = {a: i for i, (a, *_) in enumerate(ins)}
    back = [(a - t, a, t) for a, _, op, arg in ins
            if op.split(".")[0] == "BRA" and (t := _target(arg)) is not None
            and t < a]
    _, tail, head = max(back)
    path, skipped, skipped_ins = [], 0, 0
    i = at[head]
    while len(path) < 100000:
        a, pred, op, arg = ins[i]
        path.append(op)
        if a == tail:
            break
        if op.split(".")[0] == "BRA" and not op.startswith("BRA.DIV"):
            t = _target(arg)
            if not pred or pred == "@PT":
                i = at[t]
                continue
            region = ins[i + 1:at[t]] if head < t <= tail else []
            if any(o.split(".")[0] == "CALL" for _, _, o, _ in region):
                skipped += 1
                skipped_ins += len(region)
                i = at[t]
                continue
        i += 1
    return path, skipped, skipped_ins


def sass_report(lib, label):
    """Print the static mix and the loop's fast-path classes of each
    instantiation of ``lib``."""
    for name, ins in sass_functions(lib).items():
        c = Counter(op.split(".")[0] for _, _, op, _ in ins)
        line("sass", build=label, functor=name, instructions=len(ins),
             DFMA=c["DFMA"], DMUL=c["DMUL"], DADD=c["DADD"], MUFU=c["MUFU"],
             FFMA=c["FFMA"], BRA=c["BRA"])
        try:
            path, skipped, skipped_ins = loop_fast_path(ins)
        except (ValueError, KeyError) as e:   # no loop found, or a target
            line("loop", build=label, functor=name, error=repr(str(e)))
            continue
        classes = Counter(_class(op) for op in path)
        pipes = {f"{k}_cycles": PIPE_CYCLES[k] * classes[k] for k in PIPE_CYCLES}
        line("loop", build=label, functor=name, issued=len(path),
             **{k: classes[k] for k, _ in CLASSES}, uniform=classes["uniform"],
             other=classes["other"], **pipes, branches_skipped=skipped,
             instructions_skipped=skipped_ins,
             top=repr(dict(Counter(path).most_common(12))))


# ---- phases ----

def settle(solver, y0):
    # "held": each result lives until the next solve has returned, as in a
    # loop ``res = solver(...)``; "freed": it is dropped before the next.
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


def sweep(k, rhs, dev):
    """Print the sweep; return (B, median ms, warp-attempts) per B."""
    # Each result is dropped before the next launch, so no timed launch
    # waits for a cudaMalloc.
    rows = []
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
        wa = warp_attempts(nstep)
        bound, by = k.solve_bound(rhs.vdp, nstep)
        line("sweep", B=B, ms_median=round(med, 4),
             ms_all=[round(m, 4) for m in ms],
             ivps_per_s=round(B / (med * 1e-3), 1),
             attempts_per_s=f"{attempts / (med * 1e-3):.4e}",
             mean_nstep=round(float(nstep.double().mean()), 3),
             max_nstep=int(nstep.max()), warp_eff=round(attempts / (32 * wa), 5),
             bound_ms=round(bound, 4), bound_by=by,
             bound_share=round(bound / med, 4))
        rows.append((B, med, wa))
    return rows


def turns(k, rhs, y0):
    args = kernel_args(y0)
    for what in ("kernel", "plain", "plain", "kernel"):
        fn = (k.dopri5_ensemble_cuda if what == "kernel"
              else k.dopri5_ensemble_torch)
        _, m, w = timed(lambda: fn(rhs.vdp, *args))
        line("turns", what=what, B=MAIN_B, event_ms=round(m, 4),
             wall_s=round(w, 6))


def profile_solves(solver, dev):
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


def same_counters(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[2:], b[2:]))


def occupancy(k, build, rhs, dev):
    settings = [(t, m) for t in OCC_THREADS for m in OCC_MIN_BLOCKS]
    for t, m in settings:
        if t * m > 2048:
            line("occupancy", threads=t, min_blocks=m,
                 skipped="'above 2048 threads an SM'")
    settings = [(t, m) for t, m in settings if t * m <= 2048]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(settings)) as ex:
        futs = {s: ex.submit(build.build, defines=(f"IVP_THREADS={s[0]}",
                                                   f"IVP_MIN_BLOCKS={s[1]}"))
                for s in settings}
        libs = {s: f.result() for s, f in futs.items()}
    line("occupancy_build", libraries=len(libs),
         seconds=round(time.perf_counter() - t0, 3))
    problems = {name: problem_args(name, MAIN_B, dev) for name in PROBLEMS}
    refs = {name: k.dopri5_ensemble_cuda(getattr(rhs, name), *a)
            for name, a in problems.items()}
    loaded, regs, equal = {}, {}, {}
    for s, path in libs.items():
        loaded[s] = build.load(path)
        for functor, info in ptxas_lines(path.with_suffix(".log").read_text()):
            key = (s, functor)
            regs[key] = f"{regs[key]}; {info}" if key in regs else info
        for name, a in problems.items():   # the untimed launch
            out = k.dopri5_ensemble_cuda(getattr(rhs, name), *a, lib=loaded[s])
            equal[s, name] = same_counters(out, refs[name])
    del out, refs
    ms = {(s, name): [] for s in libs for name in problems}
    for r in range(OCC_ROUNDS):
        for s in (settings if r % 2 == 0 else settings[::-1]):
            for name, a in problems.items():
                fun, lib = getattr(rhs, name), loaded[s]
                _, dt, _ = timed(lambda: k.dopri5_ensemble_cuda(fun, *a,
                                                                lib=lib))
                ms[s, name].append(dt)
    names = {"vdp": "VdP", "decay": "Decay", "lorenz": "Lorenz"}
    for s in settings:
        for name in problems:
            functor = names[name]
            line("occupancy", threads=s[0], min_blocks=s[1], functor=functor,
                 ptxas=repr(regs.get((s, functor), "?")),
                 ms_median=round(float(np.median(ms[s, name])), 4),
                 ms_min=round(min(ms[s, name]), 4),
                 ms_max=round(max(ms[s, name]), 4),
                 counters_equal=equal[s, name])
    for name in problems:
        ranked = sorted(settings, key=lambda s: np.median(ms[s, name]))
        first, second = ms[ranked[0], name], ms[ranked[1], name]
        line("occupancy_rank", functor=names[name], rounds=OCC_ROUNDS,
             fastest=[f"{t}x{m}:{np.median(ms[(t, m), name]):.4f}"
                      for t, m in ranked[:5]],
             rounds_first_beat_second=sum(x < y for x, y in zip(first, second)))


def ab(k, build, rhs, dev, baseline):
    label = baseline.parent.name if baseline.name == "csrc" else baseline.name
    t0 = time.perf_counter()
    path = build.build(src_dir=baseline)
    old = build.load(path)
    line("ab_build", old=label, library=path.name,
         seconds=round(time.perf_counter() - t0, 3))
    for functor, info in ptxas_lines(path.with_suffix(".log").read_text()):
        line("ptxas", build=label, functor=functor, info=repr(info))
    sass_report(path, label)
    from chip_smoke import edge_cases

    cases = [(name, getattr(rhs, name), problem_args(name, MAIN_B, dev), {})
             for name in PROBLEMS]
    cases += [(name, rhs.vdp, a, kw)
              for name, a, kw, _ in edge_cases(MAIN_B, dev)]
    for name, fun, a, kw in cases:
        new_out = k.dopri5_ensemble_cuda(fun, *a, **kw)
        old_out = k.dopri5_ensemble_cuda(fun, *a, **kw, lib=old)
        torch.cuda.synchronize()
        diff = {f: int((x != y).reshape(x.shape[0], -1).any(dim=1).sum())
                for f, x, y in zip(("t", "y", "status", "nfev", "nstep",
                                    "naccpt", "nrejct"), new_out, old_out)}
        line("ab_bitwise", old=label, functor=name, B=MAIN_B,
             identical=all(v == 0 for v in diff.values()),
             lanes_differing=repr(diff),
             statuses=repr(dict(Counter(new_out[2].cpu().tolist()))),
             max_abs_dy=float((new_out[1] - old_out[1]).abs().max()))
    a = problem_args("vdp", MAIN_B, dev)
    for r in range(AB_ROUNDS):
        for what in ("old", "new", "new", "old"):
            lib = old if what == "old" else None
            out = None
            out, m, _ = timed(lambda: k.dopri5_ensemble_cuda(rhs.vdp, *a,
                                                             lib=lib))
            line("ab", old=label, round=r, what=what, B=MAIN_B,
                 event_ms=round(m, 4))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="a csrc directory to build and hold against "
                         "(repeatable)")
    ap.add_argument("--phases",
                    help=f"comma-separated subset of {','.join(PHASES)} "
                         "(default: all; ab only with --baseline)")
    opts = ap.parse_args()
    phases = (set(opts.phases.split(",")) if opts.phases else
              set(PHASES) - (set() if opts.baseline else {"ab"}))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
    if "ab" in phases and not opts.baseline:
        ap.error("the ab phase needs --baseline")
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
    for functor, info in ptxas_lines(lib.with_suffix(".log").read_text()):
        line("ptxas", build="new", functor=functor, info=repr(info))
    if "sass" in phases:
        sass_report(lib, "new")

    solver = build_ensemble_solver(rhs.vdp, "RK45", n=2)
    y0 = torch.as_tensor(vdp_y0(MAIN_B), device=dev)
    torch.cuda.synchronize()
    if phases & {"settle", "sweep"}:
        # The clocks are sampled from here to the end of the sweep.
        sampler = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        swept = []
        try:
            if "settle" in phases:
                settle(solver, y0)
            if "sweep" in phases:
                swept = sweep(k, rhs, dev)
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
            # Scheduler cycles per warp-attempt: 132 SMs x 4 schedulers at
            # the median sampled SM clock.
            mhz = float(np.median(r[:, 0]))
            for B, ms, wa in swept:
                line("cycles", B=B, sm_mhz=mhz, per_warp_attempt_per_scheduler=
                     round(ms * 1e-3 * mhz * 1e6 * 132 * 4 / wa, 1))
    if "turns" in phases:
        turns(k, rhs, y0)
    if "profile" in phases:
        profile_solves(solver, dev)
    if "occupancy" in phases:
        occupancy(k, build, rhs, dev)
    if "ab" in phases:
        for baseline in opts.baseline:
            ab(k, build, rhs, dev, baseline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
