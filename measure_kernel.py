"""Measurements of the port's ensemble kernels on one NVIDIA GPU (an H100):
the lean DOPRI5 kernel in depth, the rest of the explicit tier by a sweep,
the stiff kernels alone, against an older build and by launch bounds.

    python3 measure_kernel.py [--baseline CSRC_DIR ...] [--phases a,b,...]

The problem is bench.py's headline one: VdP mu=1, t in [0, 100],
y0 = [2, 0] + 0.05 N(0,1) (numpy seed 0), DOPRI5, rtol 1e-6, atol 1e-8,
float64.  Prints, one item per line, the card and its power limit as
nvidia-smi gives them, the build (seconds, ptxas's registers and spills per
instantiation), then the phases (all by default, ``ab`` only with
``--baseline``; in this order):

* ``sass``: the static SASS instruction mix of each instantiation
  (cuobjdump), and ``loop``: the instructions one attempt issues on the
  loop body's fast path, by class (below; UMOVs apart), with the cycles
  each pipe needs for them; for the lean DOPRI5 library and, of each erk
  library (``ERK_LIBS``), the Lorenz float-controller instantiations and
  the lean VdP one (``Lorenz/f32/lean``: functor, controller type, mode),
  each with its stepping loop's static branches (``loop_body``: ``BRA``,
  ``BSSY``, ``BSYNC``, ``CALL`` and basic blocks);
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
* ``erk``: the kernels of csrc/erk_*.cu (dop853, rk23, rk4, dopri5_sampled)
  alone on chip_smoke.py's Lorenz configurations, lean and with 100 samples,
  over ``ERK_B``: 1 untimed launch, then ``ERK_ROUNDS`` timed ones, with
  the bound (kernels/erk_ensemble.py::solve_bound), the share of it
  reached, warp efficiency and the SM cycles per warp-attempt per
  scheduler at the SM clock nvidia-smi reads right after;
  then lean DOPRI5 with the default options through both of its kernels
  (the tuned one and the generic one that serves ``solver_options``): the
  lanes on which they differ at B=524288 on each ``PROBLEMS`` entry and
  the edge cases, and ``AB_ERK_ROUNDS`` rounds of turns on the headline;
* ``erk_occupancy``: the libraries of ``--occupancy-methods`` built once
  per ``ERK_OCC`` (threads a block, min blocks an SM) setting, in
  parallel; ptxas's registers and spills of each Lorenz and lean VdP
  instantiation; each lean and sampled Lorenz instantiation timed under
  every setting in turns at each of ``AB_ERK_B`` (and lean DOPRI5 on the
  headline at B=524288), its counters held to the package build, and the
  settings ranked;
* ``ab`` (needs ``--baseline``, which may be given more than once; with
  ``ab_record`` alone only its record part): the
  kernels built from another source tree (for example an older commit's
  ``ivp_tpu_torch/csrc``, unpacked into a directory .gitignore lists; its
  label is the directory above ``csrc``) against the package's.  The lean
  DOPRI5 kernel at B=524288: how many lanes differ in each output (0
  everywhere is bit for bit equal) on each ``PROBLEMS`` entry and on
  chip_smoke.py's ``edge_cases`` (stiff lanes, the step budget, a too-small
  step, first_step and max_step), then rounds of old, new, new, old (CUDA
  events), and the loop's SASS classes of the old build.  Then the erk
  kernels at each of ``AB_ERK_B``: the lanes differing in each output of
  every method's ``erk_cases`` (lean and sampled, float and double
  controller, Lorenz, VdP and decay, the edge cases with and without a
  grid; DOP853 also the deferred samples' queue cases, ``queue_cases``),
  then old, new, new, old rounds of each method's Lorenz configurations,
  lean and sampled, with each side's median, cycles and the bound, and the
  new build's registers, spills, static shared memory a block and (sampled
  DOP853) slots a lane.  Then the eight record-mode
  instantiations (``<method>_record`` and ``_record_cont``; an old build
  without the staged stores writes unpadded rows, kernels/erk_record.py's
  ``RecordLaunch``):
  ``ab_record_bitwise``, the lanes differing in every output, count, lane
  carry field and row view, through ``record_launches`` on each main
  path's Lorenz inputs (chip_smoke.py's ``RECORD_CONFIGS``, B=16384,
  ``rec_cap=1024``) and at B=4096 with ``rec_cap=37`` (several chunks a
  lane), with and without samples; then ``ab_record``, old, new, new, old
  rounds of one launch alone (the solve's first chunk, from y0) at each
  of ``AB_RECORD``, and ``ab_record_summary``, one line per kernel and B:
  the medians, GB/s written and the share of ``record_bound`` of each
  side, registers and spills, row stride, staged rows, dynamic shared
  memory a block and blocks resident an SM.
* ``events``: each main-path event instantiation alone (``EVENT_B``): the
  bouncing ball (``dopri5_sampled_ev``) at B=16384 and 524288, the Lorenz
  section (``dop853_ev``) at B=16384 and 262144, and ``rk23_ev`` on both at
  B=16384, on chip_smoke.py's inputs, timed in ``turn_ms`` turns, with the
  bound by both counts (rows on the steps that need them, and on every
  accepted step), its share, warp efficiency, the event work a lane, Brent's
  evaluations and the attempts a crossing, the lean solve over the same span
  (the section), and where the lanes cross (``events_crossings``: the share
  of a lane's steps and of a warp's iterations with a crossing, from a
  record-event run); then ptxas's registers and spills of every event
  instantiation; and the record-event instantiation of the recording ball
  (``dopri5_record_cont_ev``) alone: one launch (the first chunk, from y0)
  at ``EVENT_RECORD``;
* ``stiff``: the stiff kernels (csrc/radau.cu, csrc/bdf.cu) alone on
  chip_smoke.py's stiff main path (bench.py's VdP mu=1000 to t = 3000, both
  controller types) at each of ``STIFF_B``: one launch with no budget from
  a fresh carry, in ``STIFF_ROUNDS`` turns, with the bound
  (kernels/stiff_ensemble.py::stiff_bound, the operations counted from the
  code an attempt, a Newton iteration, a decomposition and an accepted
  step), the share of it reached, warp efficiency, the mean counters;
  ptxas's registers, stack frame and spills of every stiff instantiation
  (``stiff_ptxas``), each entry's layout as the library reports it
  (``stiff_layout``: threads, min blocks, slot bytes a lane and a block,
  blocks an SM, registers, local bytes) and the SASS walk of each stiff
  instantiation (``stiff_sass``, ``stiff_loop``: one pass of the attempt
  loop and of the Newton loop by class, with FP64 cycles); then the
  explicit resumable mode alone on chip_smoke.py's resumable cases
  (B=16384): one launch to the end from a started carry;
* ``stiff_occupancy``: radau and bdf rebuilt under each ``STIFF_OCC``
  (threads a block, min blocks an SM), their registers, frames and spills,
  every field held bit for bit to the package build, and each timed in
  turns on the stiff row at each of ``STIFF_B`` under both controller
  types, ranked;
* ``ab_stiff`` (needs ``--baseline``): radau and bdf built from another
  source tree against the package's: ``ab_stiff_bitwise``, the lanes
  differing in every output and carry field (bits; a NaN equals any NaN)
  of each ``stiff_cases`` case under both controller types (the stiff row
  at B=131072, Robertson, decay, the singular retry, a max_steps budget,
  first_step / max_step lanes, chunk_steps 64 resumably; Robertson and
  decay again at B=65536), then ``ab_stiff``: ``AB_STIFF_ROUNDS`` rounds of
  old, new, new, old ``turn_ms`` on the stiff row at each of ``STIFF_B``
  and on Robertson and decay at ``AB_STIFF_WIDE``, with the bound and each
  side's share, and both sides' ptxas lines and SASS walks (each loop's
  static branches, ``loop_body``); between them the SAMPLED and RECORD
  modes (``ab_stiff_modes``): ``ab_stiff_modes_bitwise`` on every
  ``stiff_mode_cases`` case under both controller types (the sampled main
  path's 101-point grid at B=131072, recording at 16384 with and without
  coefficients in one chunk and in chunks of 64 rows, Robertson's log
  grid, a step budget; every sample, row, count and carry field), then
  turns of the sampled main path, the recording one's first chunk and
  Robertson's recorded with coefficients at 65536 (``AB_STIFF_MODE_ROWS``);
* ``ab_events`` (needs ``--baseline``): every event instantiation built
  from another source tree against the package's: ``ab_events_bitwise``,
  the lanes differing in every output, event buffer and carry field of
  each ``event_ab_cases`` case (B=4096) and of each main path at its
  ``EVENT_B`` lanes, then ``ab_events``: ``AB_EVENTS_ROUNDS`` rounds of
  old, new, new, old ``turn_ms`` of each main path, each side's kernel
  alone by torch.profiler (``kernel_ms``), the bound by both counts and
  each side's share, and both sides' registers and spills.
* ``resume_profile``: chip_smoke.py's resumable solves (its
  ``RESUME_CASES`` and bench.py's stiff row) through
  ``build_resumable_solver``: launches, solve ms, the host µs of a
  ``start``, a ``resume`` and an ``extract``, each kernel's device ms and
  the card's idle µs between them, the host time of ``start`` and
  ``resume`` split by part under torch.profiler and of ``start`` by
  function under cProfile; with ``--baseline`` also the older tree's own
  solver (``side_modules``);
* ``ab_resume`` (needs ``--baseline``, a ``csrc`` inside a copy of an
  older package): ``ab_resume_bitwise``, the lanes differing in every
  carry field at every chunk boundary of each ``resume_ab_cases`` case,
  both trees' own wrappers in step; ``ab_resume`` and
  ``ab_resume_solver``, old, new, new, old whole chunked solves, with the
  kernels' profiler ms, the host µs a ``resume`` and the time besides the
  kernels; both sides' registers of the resumable instantiations;
* ``rehearse`` (alone, needs ``--baseline``, no card): both trees'
  resumable, stiff and erk kernels built with g++ (gxx.py) and held
  field by field on CPU tensors (every ``stiff_mode_cases`` and
  ``erk_cases`` case too);
* ``cover_share``: where the sampled solve of ``--split-method`` (DOP853
  by default, or RK23) covers a grid time: a copy of the sources with a
  warp-vote counter in erk_kernel's loop (``COVER_PATCH``) runs the Lorenz
  main path (B=16384, 100 samples) over each of the method's
  ``COVER_SPANS``: the share of a warp's iterations on which some lane's
  step advances and covers its next grid time (the iterations on which the
  rows run at once, or under ``covers()`` alone), the share of lane
  attempts that do, and the instrumented outputs held bit for bit to the
  package build's; then ``cover_split``: the package build's lean solve,
  its sampled solve on a grid past tf (nothing queued, no rows) and on the
  main path's grid, in turns at each of ``AB_ERK_B``, and the same of each
  ``--baseline``'s build of the method's library.

* ``ab_erk`` (needs ``--baseline``): ``ab``'s erk part alone, for the
  methods of ``--ab-methods`` (default all);
* ``cycle_split`` (needs ``--baseline``: the variant trees to split, never
  the package's own csrc): where an attempt of ``--split-method`` (DOP853
  by default, or RK23) spends its cycles.  A copy of each tree with
  clock64() stamps (``STAMP_COMMON``, ``STAMP_METHOD``) under
  ``_variants/<label>-stamps-<library>/csrc`` runs the Lorenz main path,
  lean and sampled, at each of ``AB_ERK_B``, its outputs held bit for bit
  to the tree's own build: the cycles an attempt of its stages (DOP853's
  2-12; RK23's k2, k3, ynew and k4), of the norm (with DOP853's f(ynew)),
  of the controller through h_next (in a tree that runs the norm and the
  controller as one chain, the norm's part holds both) and of the loop's
  bookkeeping between two attempts (with the drain where sampled), their
  sum, the attempts that took the slow path's branch, and the cycles a
  warp-attempt a scheduler of both builds from ``turn_ms`` (what the
  stamps cost);
* ``fast_paths``: erk_common.cuh's ``FastCtl<float>`` and
  ``FastCtl<double>`` (the controller's divisions, square roots and the
  float ``pow(x, -1/3)`` on their fast paths, behind one branch) held to
  the library's operations on the card: the float square root and the
  float ``pow`` on every float their range tests admit, the divisions (a
  divisor shared by two quotients), the step size over a float factor and
  the double square root on ``FAST_DRAWS`` random operands each; and
  stiff_common.cuh's paths of the stiff units (``FastCtl<float>::pow`` at
  0.8, the division by Radau's constants, the ``WideCtl`` paths);
* ``stiff_split`` (needs ``--baseline``): where an attempt of radau and
  bdf spends its cycles, in the package's csrc and each baseline's: a copy
  with clock64() stamps (``STIFF_STAMPS``) under
  ``_variants/<label>-stiff-stamps/csrc``, VdP on the stiff main path
  (B=131072, float32) lean and sampled, the decay row lean under both
  controller types, and VdP at B=16384 lean and in both RECORD modes (one
  chunk; a row's cycles split again, ``ROW_PARTS``), outputs held bit for
  bit to the tree's build: the
  cycles of each part (``STIFF_PARTS``) a lane-attempt, the runs past a
  unit's fast paths and of its library path, the cycles a warp-attempt a
  scheduler of both builds; and the stamped SASS's instructions, BRA,
  BSSY and CALL between stamps by part (``stiff_regions``).

The A/B, occupancy and two-kernel timings (``ab_stiff`` and
``stiff_occupancy`` too) are turns of ``turn_ms``: five
launches back to back between two CUDA events, so the host's work of a
call stays out of the time.  ``--sass-dir DIR`` writes each SASS listing
read.

The fast path of the stepping loop (``step_loop``) is walked from the loop
head to its back edge.  A forward branch whose skipped region calls a
subroutine is taken: that skips
the IEEE slow paths of f32/f64 division and sqrt, and the stiffness test
(run on ~1 accepted attempt in 1000), which holds such calls of its own.
Every other conditional branch falls through, so the path is an accepted
attempt's.  The line counts the regions skipped and their instructions.
``hinit`` lies before the loop and is not counted.

Imports neither jax nor ivp_tpu.  Needs one CUDA device; exits 1 without one.
"""
import argparse
import concurrent.futures
import contextlib
import cProfile
import pstats
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
FUNCTORS = ("VdP", "Decay", "Lorenz", "Cr3bp")
# Occupancy sweep: threads a block x min blocks an SM; a setting above the
# SM's 2048 threads cannot be met and is skipped.
OCC_THREADS, OCC_MIN_BLOCKS = (64, 128, 256), (6, 7, 8, 10, 12)
OCC_ROUNDS = 10
PHASES = ("sass", "settle", "sweep", "turns", "profile", "occupancy", "erk",
          "erk_occupancy", "ab", "ab_record", "events", "stiff",
          "stiff_occupancy", "ab_stiff", "ab_events", "resume_profile",
          "ab_resume", "rehearse", "cover_share", "ab_erk", "cycle_split",
          "fast_paths", "stiff_split", "event_split", "ab_stiff_events")
# The stiff phase: lanes, turns.
STIFF_B = (16384, 131072)
# stiff_split: lanes, rounds of variant and stamped turns.
STIFF_SPLIT_B = (131072,)
STIFF_SPLIT_ROUNDS = 4
STIFF_ROUNDS = 3
# ab_stiff: each case's lanes (stiff_cases), and rounds of old, new, new, old.
AB_STIFF_B = {"bench": 131072, "robertson": 1024, "decay": 4096,
              "robertson_wide": 65536, "decay_wide": 65536,
              "singular": 256, "max_steps": 4096, "limits": 4096,
              "chunk": 16384}
# ab_stiff's timed rows besides the stiff row at each of STIFF_B: lanes of
# Robertson and decay above B=50688, where BDF takes its (128, 4)
# instantiation (bdf_pick) and Radau Robertson its (128, 3).
AB_STIFF_WIDE = {"robertson": 65536, "decay": 65536}
AB_STIFF_ROUNDS = 5
# ab_stiff_events: the bit-for-bit cases' lanes and record chunk, and the
# rounds of old, new, new, old of each event main path at chip_smoke.py's
# B (STIFF_B).
AB_STIFF_EV_B, AB_STIFF_EV_CAP, AB_STIFF_EV_ROUNDS = 4096, 37, 3
# The recording ball's record-event launch alone: (B, rec_cap).
EVENT_RECORD = (16384, 256)
# The events phase: each main-path event instantiation alone, (kernel, set,
# lane counts): the bouncing ball and the Lorenz section of chip_smoke.py.
EVENT_B = (("DOPRI5", "ground", (16384, 524288)),
           ("DOP853", "section", (16384, 262144)),
           ("RK23", "ground", (16384,)), ("RK23", "section", (16384,)))
EVENT_ROUNDS = 5
# ab_events: the bit-for-bit cases' lanes (event_ab_cases), their record
# chunks, and the rounds of old, new, new, old at EVENT_B.
AB_EVENTS_B = 4096
AB_EVENTS_CAPS = (37, 4096)
AB_EVENTS_ROUNDS = 10
# About 60% of each method's attempts on the section to t = 2.
AB_EVENTS_BUDGET = {"DOPRI5": 120, "DOP853": 36, "RK23": 300, "RK4": 240}
# The erk phase: lanes, and (method, tf, rtol, atol, first_step) on Lorenz
# with y0 = [1, 1, 1] + 1e-3 N(0, 1), as chip_smoke.py's main path.
ERK_B = (4096, 16384, 65536, 262144)
ERK_ROUNDS = 3
# The A/B and launch-bound sweep of the erk kernels: the main path's lane
# count, and one that gives every scheduler several warps.
AB_ERK_B = (16384, 262144)
AB_ERK_ROUNDS = 10  # rounds of old, new, new, old: a 2% step shows in 10
TURN_LAUNCHES = 5   # launches timed back to back in one turn (turn_ms)
# (B, rec_cap) of the record A/B's turns: the main path's, and 16 times the
# lanes with the chunk cut to fit two builds' rows on an 80 GB card.
AB_RECORD = ((16384, 1024), (262144, 256))
ERK_CONFIGS = (("DOP853", 100.0, 1e-8, 1e-10, None),
               ("RK23", 20.0, 1e-6, 1e-8, None),
               ("RK4", 20.0, 1e-6, 1e-8, 2e-3),
               ("DOPRI5", 20.0, 1e-6, 1e-8, None))
ERK_SAMPLES = 100
# cover_share: the Lorenz sampled DOP853 main path's lanes, and its spans.
COVER_B = 16384
COVER_SPANS = {"DOP853": (100.0, 20.0), "RK23": (20.0,)}
# The erk libraries whose registers and loop SASS are printed.
ERK_LIBS = ("erk_dop853", "erk_rk23", "erk_rk4", "erk_dopri5")

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


def turn_ms(fn):
    """Device ms of one launch of ``fn``: ``TURN_LAUNCHES`` launches back to
    back between two events, after an untimed one that the first event
    waits behind.  The
    host enqueues each launch (argument checks, allocation, ctypes) while
    the device runs the one before, so that work stays out of the time;
    around a single launch on an idle device it is in it (0.1-0.3 ms, which
    on an H100 at B=16384 varied one kernel's time by up to 15% between
    turns)."""
    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    outs = [fn() for _ in range(TURN_LAUNCHES)]
    e1.record()
    torch.cuda.synchronize()
    del outs
    return e0.elapsed_time(e1) / TURN_LAUNCHES


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


# An instantiation of csrc/erk_common.cuh's erk_kernel, as mangled: method,
# functor, controller type, SAMPLED, the record mode (absent in builds from
# before it), the event set (absent before the event modes; ivp::NoEvents or
# a set's struct), then threads and min blocks.
_ERK = re.compile(
    r"erk_kernelINS_\d+(\w+?)E\d+(\w+?)([fd])Lb([01])E(?:Li([0-3])E)?"
    r"(?:NS_8NoEventsE|\d+([A-Z]\w*?)(?=Li\d+E))?(?:Li(\d+)ELi(\d+)E)?")


# An instantiation of csrc/radau.cu's radau_kernel or csrc/bdf.cu's
# bdf_kernel: the functor (length-prefixed), the controller type, then
# threads and min blocks (absent in builds from before the launch bounds).
_STIFF = re.compile(r"(radau|bdf)_kernelI(\d+)")


STIFF_MODE_NAMES = ("lean", "sampled", "record")


def stiff_instantiation(mangled):
    """``radau/VdP/f32/128x4/sampled`` for a stiff kernel instantiation (no
    mode in builds from before the modes), else None."""
    m = _STIFF.search(mangled)
    if not m:
        return None
    rest = mangled[m.end():]
    functor, rest = rest[:int(m.group(2))], rest[int(m.group(2)):]
    b = re.match(r"[fd](?:Li(\d+)ELi(\d+)E(?:Li(\d)E)?)?", rest)
    bounds = f"/{b.group(1)}x{b.group(2)}" if b and b.group(1) else ""
    mode = f"/{STIFF_MODE_NAMES[int(b.group(3))]}" if b and b.group(3) else ""
    # An event entry's set (radau_ev.cu, bdf_ev.cu) after the mode.
    ev = re.match(r"(\d+)", rest[b.end():]) if b and b.group(3) else None
    if ev:
        k = b.end() + len(ev.group(1))
        mode += f"/ev:{rest[k:k + int(ev.group(1))]}"
    return (f"{m.group(1)}/{functor}/{'f32' if rest[:1] == 'f' else 'f64'}"
            f"{bounds}{mode}")


def instantiation(mangled):
    """``Lorenz/f32/lean`` for an erk_kernel instantiation (``/record``,
    ``/record_cont`` or ``/resume`` after a record or the resumable mode's,
    ``/ev_<Set>/<threads>x<min blocks>`` after an event mode's),
    ``radau/VdP/f32/128x4`` for a
    stiff one, else the functor the name holds."""
    stiff = stiff_instantiation(mangled)
    if stiff:
        return stiff
    m = _ERK.search(mangled)
    if not m:
        return next((f for f in FUNCTORS if f in mangled), mangled)
    rec = {None: "", "0": "", "1": "/record", "2": "/record_cont",
           "3": "/resume"}[m.group(5)]
    ev = (f"/ev_{m.group(6)}/{m.group(7)}x{m.group(8)}" if m.group(6)
          else "")
    return (f"{m.group(2)}/{'f32' if m.group(3) == 'f' else 'f64'}/"
            f"{'sampled' if m.group(4) == '1' else 'lean'}{rec}{ev}")


# Where sass_functions writes each library's listing (--sass-dir), if set.
SASS_DIR = None


def sass_functions(lib):
    """{instantiation: [(addr, predicate, opcode, operands)]} from
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {r.stderr.strip()[-300:]}")
    if SASS_DIR is not None:
        SASS_DIR.mkdir(parents=True, exist_ok=True)
        (SASS_DIR / f"{Path(lib).stem}.sass").write_text(r.stdout)
    funcs, name = {}, None
    for ln in r.stdout.splitlines():
        if "Function :" in ln:
            name = instantiation(ln.split("Function :")[1].strip())
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


def loops(ins):
    """Every loop of a listing, largest first: ``(size, tail, head)`` of
    each backward branch."""
    return sorted(((a - t, a, t) for a, _, op, arg in ins
                   if op.split(".")[0] == "BRA"
                   and (t := _target(arg)) is not None and t < a),
                  reverse=True)


def step_loop(ins):
    """The stepping loop of an erk instantiation: the largest loop, or, where
    that loop holds two or more disjoint loops of a quarter its size or
    more, the first of them, and so on down.  The deferred samples'
    instantiation holds its stepping loop and the resolution's, about as
    large, in an outer loop (erk_common.cuh's DEFER_SAMPLES); every other
    one's stepping loop is its largest."""
    found = loops(ins)
    within = lambda o, lp: o is not lp and lp[2] <= o[2] and o[1] <= lp[1]
    lp = found[0]
    while True:
        big = [o for o in found if within(o, lp) and 4 * o[0] >= lp[0]]
        tops = [o for o in big if not any(within(o, q) for q in big)]
        if len(tops) < 2:
            return lp
        lp = min(tops, key=lambda o: o[2])


def loop_fast_path(ins, loop=None):
    """(opcodes on the fast path of ``loop`` (default: ``step_loop``),
    forward branches taken past a region with a call, instructions they
    skip)."""
    at = {a: i for i, (a, *_) in enumerate(ins)}
    _, tail, head = loop or step_loop(ins)
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


def loop_body(ins, loop=None):
    """The static branches of ``loop`` (default: ``step_loop``): its
    instructions, ``BRA``, ``BSSY``, ``BSYNC`` and ``CALL`` (``CALL.REL``, a
    slow path's subroutine), and its basic blocks: the leaders are the
    loop head, every branch target inside the loop and every instruction
    after a branch or a predicated exit."""
    _, tail, head = loop or step_loop(ins)
    body = [x for x in ins if head <= x[0] <= tail]
    ops = Counter(op.split(".")[0] for _, _, op, _ in body)
    leaders = {head}
    for k, (a, pred, op, arg) in enumerate(body):
        base = op.split(".")[0]
        if base in ("BRA", "CALL", "RET", "EXIT", "BRX", "JMP"):
            t = _target(arg)
            if t is not None and head <= t <= tail:
                leaders.add(t)
            if k + 1 < len(body):
                leaders.add(body[k + 1][0])
    return dict(body_instructions=len(body), body_BRA=ops["BRA"],
                body_BSSY=ops["BSSY"], body_BSYNC=ops["BSYNC"],
                body_CALL=ops["CALL"], body_blocks=len(leaders))


def loop_line(tag, path, **kv):
    """One line of a fast path's instructions by class and pipe cycles."""
    classes = Counter(_class(op) for op in path)
    pipes = {f"{k}_cycles": PIPE_CYCLES[k] * classes[k] for k in PIPE_CYCLES}
    line(tag, **kv, issued=len(path),
         UMOV=sum(op.split(".")[0] == "UMOV" for op in path),
         path_BRA=sum(op.split(".")[0] == "BRA" for op in path),
         **{k: classes[k] for k, _ in CLASSES}, uniform=classes["uniform"],
         other=classes["other"], **pipes,
         top=repr(dict(Counter(path).most_common(12))))


def sass_report(lib, label, only=None):
    """Print the static mix and the loop's fast-path classes of each
    instantiation of ``lib`` (whose label starts with ``only``, a prefix or
    a tuple of them, if given)."""
    for name, ins in sass_functions(lib).items():
        if only and not name.startswith(only):
            continue
        c = Counter(op.split(".")[0] for _, _, op, _ in ins)
        line("sass", build=label, functor=name, instructions=len(ins),
             DFMA=c["DFMA"], DMUL=c["DMUL"], DADD=c["DADD"], MUFU=c["MUFU"],
             FFMA=c["FFMA"], BRA=c["BRA"])
        try:
            path, skipped, skipped_ins = loop_fast_path(ins)
        except (ValueError, KeyError) as e:   # no loop found, or a target
            line("loop", build=label, functor=name, error=repr(str(e)))
            continue
        loop_line("loop", path, build=label, functor=name,
                  branches_skipped=skipped, instructions_skipped=skipped_ins,
                  **loop_body(ins))


def stiff_sass_report(lib, label):
    """Each stiff instantiation of ``lib``: its static mix, then the fast
    path of one pass of its attempt loop (the largest loop: an attempt whose
    inner loops run once, past every region that calls a division's or a
    square root's slow path; decompositions hold such calls, so the path is
    that of an attempt that reuses them) and of its Newton loop (the largest
    loop inside it), by class, with the FP64 pipe's cycles."""
    for name, ins in sass_functions(lib).items():
        if not name.startswith(("radau/", "bdf/")):
            continue
        c = Counter(op.split(".")[0] for _, _, op, _ in ins)
        line("stiff_sass", build=label, instantiation=name,
             instructions=len(ins), DFMA=c["DFMA"], DMUL=c["DMUL"],
             DADD=c["DADD"], MUFU=c["MUFU"], LDS=c["LDS"], STS=c["STS"],
             LDL=c["LDL"], STL=c["STL"], CALL=c["CALL"])
        found = loops(ins)
        if not found:
            line("stiff_loop", build=label, instantiation=name,
                 error="'no loop'")
            continue
        outer = found[0]
        inner = [lp for lp in found[1:] if outer[2] < lp[2] and lp[1] < outer[1]]
        for what, lp in (("attempt", outer),
                         ("newton", inner[0] if inner else None)):
            if lp is None:
                continue
            try:
                path, skipped, skipped_ins = loop_fast_path(ins, lp)
            except (ValueError, KeyError) as e:
                line("stiff_loop", build=label, instantiation=name, loop=what,
                     error=repr(str(e)))
                continue
            loop_line("stiff_loop", path, build=label, instantiation=name,
                      loop=what, branches_skipped=skipped,
                      instructions_skipped=skipped_ins, **loop_body(ins, lp))


def ptxas_frames(path):
    """``[(function, registers, stack frame bytes, spill store bytes, spill
    load bytes)]`` from the nvcc log beside a built library: every entry and
    every function ptxas kept out of line."""
    out, fn, frame = [], "?", (0, 0, 0)
    for ln in Path(path).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn, frame = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            frame = tuple(int(g) for g in m.groups())
            if not fn.startswith("_ZN3ivp") or "_kernel" not in fn:
                out.append((fn, None, *frame))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append((fn, int(m.group(1)), *frame))
    return out


def stiff_ptxas(label, paths):
    """ptxas's registers, stack frame and spills of every stiff
    instantiation (and out-of-line function) of ``paths``."""
    for lib, path in paths.items():
        for fn, regs, frame, st, ld in ptxas_frames(path):
            line("stiff_ptxas", build=label, library=lib,
                 instantiation=instantiation(fn), registers=regs,
                 stack_frame=frame, spill_stores=st, spill_loads=ld)


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


def lorenz_args(method, B, dev, sampled, tf=None):
    """erk_ensemble_cuda's arguments after ``method`` for an ``ERK_CONFIGS``
    solve of Lorenz over B lanes, lean or with ``ERK_SAMPLES`` samples; its
    span cut to [0, tf] if given."""
    from ivp_tpu_torch import rhs

    _, tf0, rtol, atol, first = next(c for c in ERK_CONFIGS if c[0] == method)
    tf = tf0 if tf is None else tf
    f64 = torch.float64
    rng = np.random.default_rng(0)
    y0 = torch.as_tensor(np.array([1.0, 1.0, 1.0])
                         + 1e-3 * rng.standard_normal((B, 3)), device=dev)
    lane = lambda v: torch.full((B,), v, dtype=f64, device=dev)
    grid = (torch.broadcast_to(torch.linspace(
        0.0, tf * (0.99 if method == "RK4" else 1.0), ERK_SAMPLES,
        dtype=f64, device=dev), (B, ERK_SAMPLES)) if sampled else None)
    return (rhs.lorenz, y0, lane(0.0), lane(tf), lane(tf),
            None if first is None else lane(first),
            torch.full((B, 3), rtol, dtype=f64, device=dev),
            torch.full((B, 3), atol, dtype=f64, device=dev), (), 200_000, grid)


def sm_mhz():
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])


def erk_sweep(rhs, dev):
    """Each erk kernel over ERK_B on Lorenz, lean and sampled."""
    from ivp_tpu_torch.kernels import erk_ensemble as K

    for method, *_ in ERK_CONFIGS:
        kernel = K.KERNELS[method][0]
        for sampled in (False, True):
            # A lean DOPRI5 solve with default options is the other
            # kernel's (the sweep phase): here only its sampled mode.
            if method == "DOPRI5" and not sampled:
                continue
            for B in ERK_B:
                args = lorenz_args(method, B, dev, sampled)
                K.erk_ensemble_cuda(method, *args)
                torch.cuda.synchronize()
                ms = []
                for _ in range(ERK_ROUNDS):
                    out = None
                    out, m, _ = timed(lambda: K.erk_ensemble_cuda(method, *args))
                    ms.append(m)
                mhz = sm_mhz()
                nstep, naccpt = out[4], out[5]
                med = float(np.median(ms))
                attempts = float(nstep.to(torch.int64).sum())
                wa = warp_attempts(nstep)
                bound, by = K.solve_bound(method, rhs.lorenz, nstep, naccpt,
                                          out[8], ERK_SAMPLES if sampled else 0)
                line("erk", kernel=kernel, sampled=sampled, B=B,
                     ms_median=round(med, 4), ms_all=[round(m, 4) for m in ms],
                     ivps_per_s=round(B / (med * 1e-3), 1),
                     mean_nstep=round(float(nstep.double().mean()), 3),
                     success=float((out[2] == 0).double().mean()),
                     warp_eff=round(attempts / (32 * wa), 5),
                     bound_ms=round(bound, 4), bound_by=by,
                     bound_share=round(bound / med, 4), sm_mhz=mhz,
                     cycles_per_warp_attempt_per_scheduler=round(
                         med * 1e-3 * mhz * 1e6 * 132 * 4 / wa, 1))


# cover_share's instrumentation, patched into a copy of csrc: per warp
# iteration of a sampled lean loop, one count from the warp's first active
# lane of the iteration, of it when some lane's step advanced and covers
# its next grid time, and of the warp's active lanes and covering lanes;
# then an entry that reads the counts and zeroes them.
COVER_PATCH = (
    ("erk_common.cuh", "namespace ivp {\n",
     "namespace ivp {\n__device__ unsigned long long ivp_cover_counts[4];\n"),
    ("erk_common.cuh", "    nfev += s.nfev;\n", """    nfev += s.nfev;
    if constexpr (SAMPLED && NE == 0 && REC == REC_NONE) {
      const unsigned am = __activemask();
      const unsigned cv = __ballot_sync(am, s.advance && covers(c, s.t_new));
      if ((threadIdx.x & 31) == __ffs(am) - 1) {
        atomicAdd(&ivp_cover_counts[0], 1ull);
        atomicAdd(&ivp_cover_counts[1], cv ? 1ull : 0ull);
        atomicAdd(&ivp_cover_counts[2], (unsigned long long)__popc(am));
        atomicAdd(&ivp_cover_counts[3], (unsigned long long)__popc(cv));
      }
    }
"""),
    (None, "IVP_ERK_LIBRARY()\n", """IVP_ERK_LIBRARY()
extern "C" int ivp_cover_counts_take(unsigned long long* out) {
  static const unsigned long long zero[4] = {0, 0, 0, 0};
  int err = (int)cudaMemcpyFromSymbol(out, ivp::ivp_cover_counts,
                                      sizeof(zero));
  return err ? err
             : (int)cudaMemcpyToSymbol(ivp::ivp_cover_counts, zero,
                                       sizeof(zero));
}
"""),
)


def cover_share(build, dev, baselines=(), method="DOP853"):
    """Where a sampled solve's lanes cover a grid time (see the module's
    head): ``method``'s Lorenz sampled solve at ``COVER_B`` lanes over each
    of its ``COVER_SPANS`` through an instrumented build (``COVER_PATCH``,
    the entry in ``method``'s source) of this tree's library, its outputs
    held bit for bit to the package build's; then ``cover_split`` of the
    package build and of each of ``baselines`` (csrc directories)."""
    import ctypes

    from ivp_tpu_torch.kernels import erk_ensemble as K

    name = K.KERNELS[method][1]
    src = build.BUILD_DIR / "cover_src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.SRC_DIR, src)
    for file, old, new in COVER_PATCH:
        file = file or f"{name}.cu"
        text = (src / file).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"cover_share: {old!r} is not once in {file}")
        (src / file).write_text(text.replace(old, new))
    t = time.perf_counter()
    lib = build.load(build.build(src_dir=src, name=name))
    line("cover_share_build", method=method,
         seconds=round(time.perf_counter() - t, 3))
    take = lib.ivp_cover_counts_take
    take.argtypes, take.restype = [ctypes.c_void_p], ctypes.c_int
    counts = (ctypes.c_ulonglong * 4)()
    for tf in COVER_SPANS[method]:
        a = lorenz_args(method, COVER_B, dev, True, tf=tf)
        build.check(take(counts), "ivp_cover_counts_take", lib)
        got = K.erk_ensemble_cuda(method, *a[:-1], t_grid=a[-1], lib=lib)
        torch.cuda.synchronize()
        build.check(take(counts), "ivp_cover_counts_take", lib)
        ref = K.erk_ensemble_cuda(method, *a[:-1], t_grid=a[-1])
        torch.cuda.synchronize()
        diff = lanes_differing(got, ref)
        iters, cover, lanes, lane_cover = (int(x) for x in counts)
        line("cover_share", method=method, B=COVER_B, tf=tf,
             samples=ERK_SAMPLES,
             warp_share=round(cover / iters, 5),
             lane_share=round(lane_cover / lanes, 5),
             warp_iterations_per_warp=round(iters / (COVER_B // 32), 2),
             covering_iterations_per_warp=round(cover / (COVER_B // 32), 2),
             mean_nstep=round(float(got[4].double().mean()), 3),
             covering_steps_per_lane=round(lane_cover / COVER_B, 3),
             identical_to_package=all(v == 0 for v in diff.values()),
             lanes_differing=repr({k: v for k, v in diff.items() if v}))
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        libs = [("new", None)] + [
            (baseline_label(b), build.load(f.result())) for b, f in
            [(b, ex.submit(build.build, src_dir=b, name=name))
             for b in baselines]]
    # Where the sampled solve's time goes: the lean solve, the sampled one
    # on a grid past tf (its loop with the covers() test, no step queued,
    # no sample) and on the main path's grid, in rounds of turns (forward,
    # then backward), each build's.
    for B in AB_ERK_B:
        lean = lorenz_args(method, B, dev, False)
        samp = lorenz_args(method, B, dev, True)
        past = torch.broadcast_to(samp[-1][0] + 1000.0, samp[-1].shape)
        for label, lib in libs:
            runs = {"lean": lambda: K.erk_ensemble_cuda(
                        method, *lean, lib=lib),
                    "no_cover": lambda: K.erk_ensemble_cuda(
                        method, *samp[:-1], past, lib=lib),
                    "sampled": lambda: K.erk_ensemble_cuda(
                        method, *samp, lib=lib)}
            ms = {k: [] for k in runs}
            for r in range(AB_ERK_ROUNDS // 2):
                for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                    ms[k].append(turn_ms(runs[k]))
            line("cover_split", build=label, method=method, B=B,
                 rounds=AB_ERK_ROUNDS // 2,
                 **{f"{k}_ms": round(float(np.median(v)), 4)
                    for k, v in ms.items()})


# cycle_split's instrumentation, patched into a copy of a csrc tree's
# erk_common.cuh and the split method's source (``STAMP_METHOD``): clock64()
# stamps at an attempt's start (0), after its stages (1: DOP853's twelfth;
# RK23's k2, k3, ynew and k4), where the norm (with DOP853's f(ynew)) is
# done (2: before the first anchor of the method's norm anchors found, the
# controller's start in the older design or what follows the norm and the
# controller, run together, in the newer one, else stamp 1 again) and at
# its end (3); a lane's loop, lean or sampled (no events, no records), adds
# each attempt's parts and the time from the previous attempt's end to this
# one's start (the loop's bookkeeping, with the drain where sampled), and
# the lane's attempts, to the sums an entry reads and zeroes; where the tree
# has FastCtl's one branch, the attempts that take it (every mode's, an
# atomic each).  A lane's parts are its warp's while it is active (the warp
# runs in step).
STAMP_COMMON = (
    ("erk_common.cuh", "namespace ivp {\n",
     "namespace ivp {\n__device__ unsigned long long ivp_stamp_sums[6];\n"),
    ("erk_common.cuh", "  int status, nfev;\n};",
     "  int status, nfev;\n  long long st[4];\n};"),
    ("erk_common.cuh", "step_on:\n",
     "  unsigned long long stamp_acc[5] = {0, 0, 0, 0, 0};\n"
     "  long long stamp_prev = 0;\nstep_on:\n"),
    ("erk_common.cuh", "    nfev += s.nfev;\n", """    nfev += s.nfev;
    if constexpr (NE == 0 && REC == REC_NONE) {
      if (stamp_prev != 0) stamp_acc[3] += s.st[0] - stamp_prev;
      stamp_acc[0] += s.st[1] - s.st[0];
      stamp_acc[1] += s.st[2] - s.st[1];
      stamp_acc[2] += s.st[3] - s.st[2];
      stamp_acc[4] += 1;
      stamp_prev = s.st[3];
    }
"""),
    ("erk_common.cuh", "  t_out[i] = t;\n", """  if constexpr (NE == 0 && REC == REC_NONE) {
    for (int q = 0; q < 5; ++q) atomicAdd(&ivp_stamp_sums[q], stamp_acc[q]);
  }
  t_out[i] = t;
"""),
)
STAMP_TAKE = """IVP_ERK_LIBRARY()
extern "C" int ivp_stamp_sums_take(unsigned long long* out) {
  static const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  int err = (int)cudaMemcpyFromSymbol(out, ivp::ivp_stamp_sums, sizeof(zero));
  return err ? err
             : (int)cudaMemcpyToSymbol(ivp::ivp_stamp_sums, zero,
                                       sizeof(zero));
}
"""
# The method's own anchors (each a tuple: the first found once is taken), the
# text stamped before or after it, and whether a tree may lack it: the
# attempt's start, the end of its stages, the end of its norm, its end and
# the slow path's branch, each stamped as the head above says.
STAMP_SLOW = ("      if (!fast.ok)\n", "    if (!fast.ok)\n")


def _stamp_method(src, starts, stages_end, norm_end, ends):
    return (
        (src, starts, "    s.st[0] = clock64();\n", "before", False),
        (src, stages_end, "    s.st[1] = clock64();\n    s.st[2] = s.st[1];\n",
         "after", False),
        (src, norm_end, "    s.st[2] = clock64();\n", "before", True),
        (src, ends, "    s.st[3] = clock64();\n", "before", False),
        (src, STAMP_SLOW,
         "if (!fast.ok) atomicAdd(&ivp_stamp_sums[5], 1ull);\n", "before",
         True),
        (src, ("IVP_ERK_LIBRARY()\n",), STAMP_TAKE, "replace", False),
    )


STAMP_METHOD = {
    "DOP853": _stamp_method(
        "erk_dop853.cu", ("    double h = c.h;\n",),
        ("    f(t + C11 * h, ys, k[11], a);\n",),
        ("    // Controller.\n",
         "    bool stiff_fail = false;\n    if (accepted) {\n"),
        ("    s.accepted = accepted;\n",)),
    # The lean and sampled chain (attempt_chain) where the tree has it.
    "RK23": _stamp_method(
        "erk_rk23.cu",
        ("    double h = c.h;\n    const bool too_small = W(TENTH)",
         "    double h = c.h;\n"),
        ("    f(t + h, s.ynew, s.knew, a);   // k4\n\n    // The norm",
         "    f(t + h, s.ynew, s.knew, a);   // k4\n"),
        ("    const bool accepted = ctl.accepted;\n",
         "    const bool accepted = (err <= (CT)1) && !too_small;\n"),
        ("    return h_next;\n#undef W\n", "    s.accepted = accepted;\n")),
}
STAMP_PARTS = ("stages", "norm", "controller", "bookkeeping")


def stamped_copy(src, dst, method="DOP853"):
    """A copy of the csrc tree ``src`` at ``dst`` with ``STAMP_COMMON`` (each
    anchor replaced) and ``method``'s ``STAMP_METHOD`` applied (the first
    anchor found once, the text inserted before it at its indentation or
    after its first line, or in its place; an optional one found nowhere is
    skipped)."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    entries = [(name, (old,), new, "replace", False)
               for name, old, new in STAMP_COMMON] + list(STAMP_METHOD[method])
    for name, anchors, new, where, optional in entries:
        text = (dst / name).read_text()
        old = next((o for o in anchors if text.count(o) == 1), None)
        if old is None:
            if optional:
                continue
            raise RuntimeError(f"cycle_split: none of {anchors!r} is once in "
                               f"{name}")
        indent = old[:len(old) - len(old.lstrip(" "))]
        first = old[:old.index("\n") + 1]   # "after": after its first line
        new = {"before": (new if new.startswith(" ") else indent + new) + old,
               "after": first + new + old[len(first):], "replace": new}[where]
        (dst / name).write_text(text.replace(old, new))


def cycle_split(build, dev, variants, method="DOP853"):
    """Where an attempt of ``method`` (DOP853 or RK23) spends its cycles
    (see the module's head): for each of ``variants`` (csrc
    directories, never the package's own), a copy with ``method``'s stamps
    (``stamped_copy``) under ``_variants/<label>-stamps/csrc`` and the
    variant as it is, both built; the Lorenz main path (B from
    ``AB_ERK_B``), lean and sampled, through each: the stamped build's
    outputs held bit for bit to the variant's, the cycles of each part an
    attempt (``STAMP_PARTS``, the mean over lane-attempts) and their sum,
    beside the variant's cycles a warp-attempt a scheduler from its
    ``turn_ms`` median and the stamped build's (what the stamps cost)."""
    import ctypes

    from ivp_tpu_torch.kernels import erk_ensemble as K

    root = Path(__file__).resolve().parent / "_variants"
    name = K.KERNELS[method][1]
    for variant in variants:
        label = baseline_label(variant)
        stamped = root / f"{label}-stamps-{name}" / "csrc"
        stamped_copy(Path(variant), stamped, method)
        t = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            fs = [ex.submit(build.build, src_dir=d, name=name)
                  for d in (stamped, Path(variant))]
            lib_st, lib_v = (build.load(f.result()) for f in fs)
        line("cycle_split_build", variant=label, method=method,
             seconds=round(time.perf_counter() - t, 3))
        take = lib_st.ivp_stamp_sums_take
        take.argtypes, take.restype = [ctypes.c_void_p], ctypes.c_int
        sums = (ctypes.c_ulonglong * 6)()
        for B in AB_ERK_B:
            for sampled in (False, True):
                a = lorenz_args(method, B, dev, sampled)
                build.check(take(sums), "ivp_stamp_sums_take", lib_st)
                got = K.erk_ensemble_cuda(method, *a, lib=lib_st)
                torch.cuda.synchronize()
                build.check(take(sums), "ivp_stamp_sums_take", lib_st)
                parts = [int(x) for x in sums]
                ref = K.erk_ensemble_cuda(method, *a, lib=lib_v)
                torch.cuda.synchronize()
                diff = lanes_differing(got, ref)
                ms = {"variant": [], "stamped": []}
                for r in range(AB_ERK_ROUNDS // 2):
                    for w in (("variant", "stamped") if r % 2 == 0
                              else ("stamped", "variant")):
                        lib = lib_v if w == "variant" else lib_st
                        ms[w].append(turn_ms(lambda: K.erk_ensemble_cuda(
                            method, *a, lib=lib)))
                mhz, wa = sm_mhz(), warp_attempts(ref[4])
                cyc = {w: round(float(np.median(v)) * 1e-3 * mhz * 1e6 * 132
                                * 4 / wa, 1) for w, v in ms.items()}
                n = max(parts[4], 1)
                split = {p: round(parts[q] / n, 1)
                         for q, p in enumerate(STAMP_PARTS)}
                line("cycle_split", variant=label, method=method, B=B,
                     mode="sampled" if sampled else "lean", **split,
                     sum_of_parts=round(sum(parts[:4]) / n, 1),
                     lane_attempts=parts[4], slow_path_attempts=parts[5],
                     variant_ms=round(float(np.median(ms["variant"])), 4),
                     stamped_ms=round(float(np.median(ms["stamped"])), 4),
                     cycles_variant=cyc["variant"],
                     cycles_stamped=cyc["stamped"], sm_mhz=mhz,
                     identical_to_variant=all(v == 0 for v in diff.values()),
                     lanes_differing=repr({k: v for k, v in diff.items()
                                           if v}))


# event_split's instrumentation of the event modes, patched into a copy of a
# csrc tree's erk_common.cuh as cycle_split's is: each lane's clock64 at the
# bounds of the parts of an event-mode iteration (EV_PARTS), the cycles since
# its last stamp added to the part that just ended, in registers, and at its
# exit to the sums an entry reads and zeroes (ivp_ev_sums_take), beside its
# attempts (tests/test_torch_event_fast.py counts Brent's iterations on
# the library's path, in g++ builds).  The parts: the attempt (with the row
# test of a crossing); the event test (the values at the step's end and the
# crossing test); Brent; the occurrences' times and states written; the
# terminal event's state, the restart map, erk_init and hinit; the record
# row (its staging and its bulk copy, at the exit the partial run and the
# wait); the queue (a deferred crossing's entry, and in the warp's
# resolution each entry's load and rebuilt attempt); the loop's
# bookkeeping (the counters, the status, the carry, the vote and the exit's
# stores).  A lane's parts are its warp's while it waits at a divergent
# branch: a lane that does not cross counts the wait for one that runs
# Brent in the part that ends after it.
EV_PARTS = ("attempt", "test", "brent", "writes", "restart", "row", "queue",
            "book")
_EVS = "IVP_EV_STAMP({});\n"
EV_STAMPS = (
    ("namespace ivp {\n", "after", """__device__ unsigned long long ivp_ev_sums[10];
#define IVP_EV_STAMP(k)                                              \\
  do {                                                               \\
    if constexpr (NE > 0) {                                          \\
      const long long ivp_now_ = clock64();                          \\
      ev_acc[k] += (unsigned long long)(ivp_now_ - ev_last);         \\
      ev_last = ivp_now_;                                            \\
    }                                                                \\
  } while (0)
"""),
    ("  // The rows test of an attempt in event mode:", "before",
     "  unsigned long long ev_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  unsigned long long ev_n = 0;\n  long long ev_last = clock64();\n"),
    ("    Step<N, C> s;\n", "before",
     "    " + _EVS.format(7) + "    if constexpr (NE > 0) ++ev_n;\n"),
    (("            f, a, t, y, k1, c, o, s, want);\n",
      "M::template attempt<F, DENSE, CT>(f, a, t, y, k1, c, o, s, want);\n"),
     "after", "    " + _EVS.format(0)),
    ("        if (crossed) {\n", "before", "        " + _EVS.format(1)),
    ("          ++qn;\n        }\n", "after", "        " + _EVS.format(6)),
    ("          cr[e] = ev_crossed(gp[e], gc[e], ev.direction[e]);\n",
     "after", "          " + _EVS.format(1)),
    ("                          : s.t_new;\n", "after",
     "          " + _EVS.format(2)),
    ("          gp[e] = gc[e];\n        }\n", "after", "        " + _EVS.format(3)),
    ("            ++n_restarts;\n          }\n        }\n", "after",
     "        " + _EVS.format(4)),
    ("        ++run;\n      }\n", "after", "      " + _EVS.format(5)),
    ("        run = 0;\n      }\n    }\n", "after", "    " + _EVS.format(5)),
    ("    rec_wait_all();\n", "after", "    " + _EVS.format(5)),
    ("    if constexpr (DEFER) {\n      double* const qb = queue_smem;\n",
     "before", "    " + _EVS.format(7)),
    ("        if (!s2.advance || s2.t_new != t_end0) __trap();\n"
     "        // ---- core/events.py::process_events, as below ----\n", "after",
     "        " + _EVS.format(6)),
    ("                          : s2.t_new;\n", "after",
     "          " + _EVS.format(2)),
    ("        if (stop) {\n", "before", "        " + _EVS.format(3)),
    ("  if constexpr (NE > 0) {\n#pragma unroll\n    for (int e = 0; e < NE; ++e) {\n"
     "      const size_t q = (size_t)i * NE + e;\n      ev.n_ev[q] = nev[e];",
     "before", "  " + _EVS.format(7) + """  if constexpr (NE > 0) {
    for (int q = 0; q < 8; ++q) atomicAdd(&ivp_ev_sums[q], ev_acc[q]);
    atomicAdd(&ivp_ev_sums[8], ev_n);
  }
"""),
)
EV_TAKE = STAMP_TAKE.replace("ivp_stamp_sums", "ivp_ev_sums").replace(
    "[6]", "[10]").replace("{0, 0, 0, 0, 0, 0}", "{0}")
# The instantiations split, as the main paths run them: (kernel, method,
# set, B); the recording ball is one launch of EVENT_RECORD's.
EV_SPLIT_CASES = (("rk23_ev", "RK23", "section", 16384),
                  ("rk23_ev", "RK23", "ground", 16384),
                  ("dop853_ev", "DOP853", "section", 16384),
                  ("dopri5_sampled_ev", "DOPRI5", "ground", 524288),
                  ("dopri5_record_cont_ev", "DOPRI5", "ground", 16384))
EV_SPLIT_ROUNDS = 3


def ev_stamped_copy(src, dst):
    """A copy of the csrc tree ``src`` at ``dst`` with ``EV_STAMPS`` in its
    erk_common.cuh (the first of each entry's anchors found once) and the
    sums' entry (``EV_TAKE``) in each erk source."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    p = dst / "erk_common.cuh"
    text = p.read_text()
    for olds, where, new in EV_STAMPS:
        olds = (olds,) if isinstance(olds, str) else olds
        old = next((o for o in olds if text.count(o) == 1), None)
        if old is None:
            raise RuntimeError(f"event_split: none of {olds!r} is once in "
                               f"{p}")
        text = text.replace(old, new + old if where == "before" else old + new)
    p.write_text(text)
    for name in ("erk_rk23.cu", "erk_dopri5.cu", "erk_dop853.cu"):
        q = dst / name
        q.write_text(q.read_text().replace("IVP_ERK_LIBRARY()\n", EV_TAKE))


def event_split_run(kernel, method, set_name, B, lib, dev):
    """``(run, outputs)`` of one EV_SPLIT_CASES case through ``lib``."""
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import erk_record as R

    fun, a, ev = event_main_inputs(method, set_name, B, dev)
    if kernel.endswith("_record_cont_ev"):
        r = R.RecordLaunch(method, fun, *a, (), 200_000, None, None,
                           EVENT_RECORD[1], True, lib,
                           torch.cuda.current_stream(dev).cuda_stream, ev)

        def fields():
            out = dict(zip(ENSEMBLE_FIELDS, r.last()))
            out.update(r.ev_out._asdict())
            out["rows"] = written_rows(r)
            out["n_rec"] = r.n_rec
            return out
        return (lambda: r.launch(init=True)), fields, r.ints[2]
    box = {}

    def run():
        box["out"] = K.erk_ensemble_cuda(method, fun, *a, (), 200_000,
                                         lib=lib, events=ev)

    def fields():
        o = box["out"]
        return {**dict(zip(ENSEMBLE_FIELDS, o[:9])), **o[9]._asdict()}
    return run, fields, None


def event_sass(lib, dst):
    """The SASS listing of ``lib``'s event and coefficient record
    instantiations on Lorenz and the ball, to ``dst``: what the rows of
    RK23's event modes are written out from."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                       text=True, timeout=300, check=True)
    keep, out = False, []
    for ln in r.stdout.splitlines():
        if "Function :" in ln:
            name = instantiation(ln.split("Function :")[1].strip())
            keep = (name.startswith(("Lorenz/", "Ball/"))
                    and ("/ev_" in name or name.endswith("record_cont")))
        if keep:
            out.append(ln)
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text("\n".join(out) + "\n")
    line("event_sass", library=Path(lib).name, path=str(dst),
         lines=len(out))


def event_split(build, dev, trees):
    """Where an event-mode iteration spends its cycles (see EV_PARTS), for
    each csrc tree of ``trees`` (``(label, path)``): a stamped copy under
    ``_variants/<label>-ev-stamps/csrc`` and the tree as it is, built; each
    ``EV_SPLIT_CASES`` case through both: the stamped build's outputs held
    bit for bit to the tree's, each part's cycles a lane-attempt and its
    share, and both builds' ``turn_ms`` (what the stamps cost) with the tree's cycles a warp-attempt
    a scheduler."""
    import ctypes

    from ivp_tpu_torch.kernels import erk_ensemble as K

    root = Path(__file__).resolve().parent / "_variants"
    names = sorted({K.KERNELS[m][1] for _, m, _, _ in EV_SPLIT_CASES})
    for label, tree in trees:
        stamped = root / f"{label}-ev-stamps" / "csrc"
        ev_stamped_copy(Path(tree), stamped)
        t = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2 * len(names)) as ex:
            fs = {(d, n): ex.submit(build.build, src_dir=d, name=n)
                  for d in (stamped, Path(tree)) for n in names}
            paths = {k: f.result() for k, f in fs.items()}
            libs = {k: build.load(v) for k, v in paths.items()}
        line("event_split_build", tree=label,
             seconds=round(time.perf_counter() - t, 3))
        if SASS_DIR is not None:
            event_sass(paths[(Path(tree), "erk_rk23")],
                       SASS_DIR / f"{label}-erk_rk23-events.sass")
        sums = (ctypes.c_ulonglong * 10)()
        for kernel, method, set_name, B in EV_SPLIT_CASES:
            name = K.KERNELS[method][1]
            lib_st, lib_v = libs[(stamped, name)], libs[(Path(tree), name)]
            take = lib_st.ivp_ev_sums_take
            take.argtypes, take.restype = [ctypes.c_void_p], ctypes.c_int
            run_st, f_st, nstep_rec = event_split_run(kernel, method,
                                                      set_name, B, lib_st, dev)
            run_v, f_v, _ = event_split_run(kernel, method, set_name, B,
                                            lib_v, dev)
            build.check(take(sums), "ivp_ev_sums_take", lib_st)
            run_st()
            torch.cuda.synchronize()
            build.check(take(sums), "ivp_ev_sums_take", lib_st)
            parts = [int(x) for x in sums]
            got = f_st()
            run_v()
            torch.cuda.synchronize()
            ref = f_v()
            diff = fields_lanes_differing(got, ref)
            nstep = (nstep_rec if nstep_rec is not None else ref["nstep"])
            wa = warp_attempts(nstep)
            ms = {"tree": [], "stamped": []}
            for r in range(EV_SPLIT_ROUNDS):
                for w in (("tree", "stamped") if r % 2 == 0
                          else ("stamped", "tree")):
                    ms[w].append(turn_ms(run_v if w == "tree" else run_st))
            mhz = sm_mhz()
            med = {w: float(np.median(v)) for w, v in ms.items()}
            n = max(parts[8], 1)
            total = max(sum(parts[:8]), 1)
            line("event_split", tree=label, kernel=kernel, set=set_name, B=B,
                 **{p: round(parts[q] / n, 1) for q, p in enumerate(EV_PARTS)},
                 **{f"{p}_share": round(parts[q] / total, 4)
                    for q, p in enumerate(EV_PARTS)},
                 sum_of_parts=round(total / n, 1), lane_attempts=parts[8],
                 n_brent=int(ref["n_brent"].sum()),
                 tree_ms=round(med["tree"], 4),
                 stamped_ms=round(med["stamped"], 4),
                 cycles_tree=round(med["tree"] * 1e-3 * mhz * 1e6 * 132 * 4
                                   / wa, 1), sm_mhz=mhz,
                 identical_to_tree=not any(diff.values()),
                 lanes_differing=repr({k: v for k, v in diff.items() if v}))
            del got, ref, run_st, run_v, f_st, f_v


# stiff_split's instrumentation of radau.cu and bdf.cu, patched into a copy
# of a csrc tree as cycle_split's is: each lane's clock64 at the bounds of
# an attempt's parts (STIFF_PARTS), the cycles since its last stamp added to
# its own slot of a static shared array (no registers held but the last
# stamp's), which each lane adds to the sums an entry reads and zeroes at the
# end; beside them its attempts, the runs past a unit's fast paths (every
# `if (!fast.ok` of the tree, where it has them) and the runs of a unit's
# library path after its wide paths (WideOps).  A stamp is also a marker in
# the SASS: stiff_regions counts the branches between two.  A RECORD row's
# cycles are split again inside StiffOut (STIFF_STAMP_OUT, ROW_PARTS): the
# wait for the stage's last copy, the row's fields (the loads of its
# coefficients from the slots and its stores, to the stage or to global
# memory), the bulk copy of a full run, and at the lane's exit the partial
# run's copy and the wait for every copy; each lane sums them in registers
# and adds them to sums 13-16 at its exit.  Beside the static shared array of
# the stamps, a stamped staged launch plans its stage in what the array
# leaves (a row fewer at one block an SM, for VdP's rows with coefficients).
STIFF_PARTS = ("loop", "jacobian", "decomposition", "head", "newton", "error",
               "controller", "tail", "emission", "change_d")
ROW_PARTS = ("row_wait", "row_fields", "row_copy", "row_exit")
STIFF_STAMP_HEAD = """constexpr int SINGULAR_MATRIX = 5;
__device__ unsigned long long ivp_stamp_sums[17];
__shared__ unsigned long long ivp_stamp_acc[13 * 128];
#define IVP_STAMP(p)                                                         \\
  {                                                                          \\
    const long long now_ = clock64();                                        \\
    ivp_stamp_acc[(p) * 128 + threadIdx.x] +=                                \\
        (unsigned long long)(now_ - L.stamp_prev);                           \\
    L.stamp_prev = now_;                                                     \\
  }
__device__ __forceinline__ bool ivp_stamp_slow(int k) {
  ivp_stamp_acc[k * 128 + threadIdx.x] += 1;
  return true;
}
"""
STIFF_STAMP_TAKE = STAMP_TAKE.replace("IVP_ERK_LIBRARY()", "IVP_STIFF_LIBRARY()") \
    .replace("[6]", "[17]").replace("0, 0, 0, 0, 0, 0", "0")
_LOOP = ("  while (status == RUNNING && nstep - nstep0 < max_attempts && "
         "!out.full()) {\n")
_STAMP_KERNEL = (
    (("  L.s = lane_slots<T>();\n",),
     "  for (int q = 0; q < 13; ++q) ivp_stamp_acc[q * 128 + threadIdx.x] = 0;\n",
     "after", False),
    ((_LOOP,), "  L.stamp_prev = clock64();\n", "before", False),
    ((_LOOP,), "    IVP_STAMP(0);\n    ivp_stamp_acc[10 * 128 + threadIdx.x] += 1;\n",
     "after", False),
    (("  out.store();\n",),
     "  for (int q = 0; q < 13; ++q)\n"
     "    atomicAdd(&ivp_stamp_sums[q], ivp_stamp_acc[q * 128 + threadIdx.x]);\n",
     "before", False),
    (("IVP_STIFF_LIBRARY()\n",), STIFF_STAMP_TAKE, "replace", False),
)
# (anchors, text, where, optional) of each source; both PR 16's tree and
# its successors'.
STIFF_STAMPS = {
    "radau.cu": (
        (("  int singular;\n  Slots<T> s;\n",), "  long long stamp_prev;\n",
         "before", False),
        (("  // ---- Decompositions (reused",), "  IVP_STAMP(1);\n", "before",
         False),
        (("  const bool too_small = 0.1 * fabs(h) <= fabs(t) * o.uround;\n",),
         "  IVP_STAMP(2);\n", "before", False),
        (("  CT dynold = 0, thqold = 0, theta = (CT)fabs(o.thet);\n",),
         "  IVP_STAMP(3);\n", "before", False),
        (("  const bool converged = code == NEWTON_CONVERGED;\n",),
         "  IVP_STAMP(4);\n", "before", False),
        (("  // ---- Step-size controller ----\n",), "  IVP_STAMP(5);\n",
         "before", True),
        (("  // ---- Accept and reject paths ----\n",), "  IVP_STAMP(6);\n",
         "before", False),
        (("  if (too_small) return STEP_SIZE_TOO_SMALL;\n",),
         "  IVP_STAMP(7);\n", "before", False),
        (("  }\n  out.store();\n",), "    IVP_STAMP(8);\n", "before", False),
    ) + _STAMP_KERNEL,
    "bdf.cu": (
        (("  bool lu_current;\n  Slots<T> s;\n",), "  long long stamp_prev;\n",
         "before", False),
        (("  // ---- The iteration matrix, rebuilt when c drifts ----\n",),
         "  IVP_STAMP(3);\n", "before", False),
        (("  // ---- Simplified Newton ----\n",), "  IVP_STAMP(2);\n", "before",
         False),
        (("  const bool converged = done == 1;\n",), "  IVP_STAMP(4);\n",
         "before", False),
        (("  // ---- The error",), "  IVP_STAMP(1);\n", "before", False),
        (("  // ---- One rescale for every outcome",
          "  accepted = tl.accepted;\n  finished = accepted && last;\n"),
         "  IVP_STAMP(5);\n", "before", False),
        (("    emit(x_new, t, h_signed, y_new, order);\n",),
         "    IVP_STAMP(6);\n    emit(x_new, t, h_signed, y_new, order);\n"
         "    IVP_STAMP(8);\n", "replace", True),
        (("  factor = tl.factor;\n",), "  IVP_STAMP(6);\n", "before", True),
        (("  change_d<N, T>(s.at(K::D), ord_in, factor);\n",),
         "  change_d<N, T>(s.at(K::D), ord_in, factor);\n  IVP_STAMP(9);\n",
         "replace", True),
        (("  return (too_small || dead) ? STEP_SIZE_TOO_SMALL : RUNNING;\n",),
         "  IVP_STAMP(7);\n", "before", False),
        (("    change_d<N, T>(s.at(K::D), L.order, factor);\n",
          "      change_d<N, T>(s.at(K::D), L.order, factor);\n"),
         "    IVP_STAMP(8);\n    change_d<N, T>(s.at(K::D), L.order, factor);\n"
         "    IVP_STAMP(9);\n", "replace", True),
    ) + _STAMP_KERNEL,
}


# STIFF_STAMP_OUT's entries come in pairs where an older StiffOut (a direct
# store path beside the staged one) and one that stages every row differ.
STIFF_STAMP_OUT = (
    (("constexpr int SMEM_SM = 228 * 1024, SMEM_BLOCK_RESERVED = 1024;\n",),
     "constexpr int SMEM_SM = 228 * 1024,\n"
     "              SMEM_BLOCK_RESERVED = 1024 + 13 * 128 * 8;\n",
     "replace", True),
    (("constexpr int SLOTS_BLOCK_MAX = 227 * 1024;\n",),
     "constexpr int SLOTS_BLOCK_MAX = 227 * 1024 - 13 * 128 * 8;\n",
     "replace", True),
    (("  double* stage = nullptr;\n  int k = 0, run = 0;\n",),
     "  mutable long long ivp_c = 0;\n"
     "  mutable unsigned long long ivp_part[4] = {0, 0, 0, 0};\n"
     "  __device__ __forceinline__ void ivp_tick(int q) const {\n"
     "    const long long now = clock64();\n"
     "    ivp_part[q] += (unsigned long long)(now - ivp_c);\n"
     "    ivp_c = now;\n"
     "  }\n", "after", True),
    (("    if constexpr (MODE == STIFF_RECORD) {\n      double* r;\n",
      "    if constexpr (MODE == STIFF_RECORD) {\n      stage_wait_read();\n"),
     "      ivp_c = clock64();\n", "after", True),
    (("        stage_wait_read();\n", "      stage_wait_read();\n"),
     "      ivp_tick(0);\n", "after", True),
    (("      ++nrec;\n",), "      ivp_tick(1);\n", "before", True),
    (("          run = 0;\n        }\n      }\n    }\n",),
     "          run = 0;\n        }\n      }\n      ivp_tick(2);\n    }\n",
     "replace", True),
    (("        run = 0;\n      }\n    }\n  }\n",),
     "        run = 0;\n      }\n      ivp_tick(2);\n    }\n  }\n",
     "replace", True),
    (("    if constexpr (MODE == STIFF_RECORD) md.n_rec[i] = nrec;\n",),
     "    if constexpr (MODE == STIFF_RECORD) {\n"
     "      ivp_tick(3);\n"
     "      for (int q = 0; q < 4; ++q)\n"
     "        atomicAdd(&ivp_stamp_sums[13 + q], ivp_part[q]);\n"
     "    }\n", "before", True),
    (("      md.n_rec[i] = nrec;\n",),
     "      ivp_tick(3);\n"
     "      for (int q = 0; q < 4; ++q)\n"
     "        atomicAdd(&ivp_stamp_sums[13 + q], ivp_part[q]);\n",
     "before", True),
    (("    if constexpr (STAGED) {\n      if (run)\n",),
     "    ivp_c = clock64();\n", "before", True),
    (("    if constexpr (MODE == STIFF_RECORD) {\n      if (run)\n",),
     "      ivp_c = clock64();\n", "after", True),
)


def stiff_stamped_copy(src, dst):
    """A copy of the csrc tree ``src`` at ``dst`` with ``STIFF_STAMPS`` (and
    ``STIFF_STAMP_HEAD`` and ``STIFF_STAMP_OUT`` in stiff_common.cuh)
    applied as stamped_copy applies its entries, each of the tree's `if
    (!fast.ok` counted."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    common = dst / "stiff_common.cuh"
    common.write_text(common.read_text().replace(
        "constexpr int SINGULAR_MATRIX = 5;\n", STIFF_STAMP_HEAD, 1))
    for name, entries in (*STIFF_STAMPS.items(),
                          ("stiff_common.cuh", STIFF_STAMP_OUT)):
        # A kernel's source and, since the event entries, its template's
        # header (<kernel>.cuh), where most anchors sit.
        files = [f for f in (name[:-3] + ".cuh", name)
                 if (dst / f).is_file()] if name.endswith(".cu") else [name]
        texts = {f: (dst / f).read_text() for f in files}
        for anchors, new, where, optional in entries:
            hit = next(((f, o) for o in anchors for f in files
                        if texts[f].count(o) == 1), None)
            if hit is None:
                if optional:
                    continue
                raise RuntimeError(f"stiff_split: none of {anchors!r} is once "
                                   f"in {files}")
            f, old = hit
            indent = old[:len(old) - len(old.lstrip(" "))]
            first = old[:old.find("\n") + 1]
            new = {"before": (new if new.startswith(" ") else indent + new)
                   + old, "after": first + new + old[len(first):],
                   "replace": new}[where]
            texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            text = re.sub(r"if \(!fast\.ok(\(\))?",
                          r"if (!fast.ok\1 && ivp_stamp_slow(11)", text)
            text = text.replace("if (!wide.ok())",
                                "if (!wide.ok() && ivp_stamp_slow(12))")
            text = text.replace(
                "    if (!done) {\n      LibOps<CT> lib;",
                "    if (!done && ivp_stamp_slow(12)) {\n      LibOps<CT> lib;")
            (dst / f).write_text(text)


def stiff_regions(ins):
    """{part: [instructions, BRA, BSSY, CALL]} of a stamped listing: the
    instructions from one clock read to the next, in address order, each
    run counted to the part of the stamp that ends it (the slot its update
    addresses)."""
    out = {}
    clocks = [k for k, (_, _, op, arg) in enumerate(ins)
              if op.startswith("CS2R") and "SR_CLOCK" in arg]
    for k0, k1 in zip(clocks, clocks[1:]):
        part = "?"
        for _, _, op, arg in ins[k1 + 1:k1 + 40]:
            if op.startswith(("LDS", "STS")):
                m = re.search(r"\+0x([0-9a-f]+)\]", arg)
                q = int(m.group(1), 16) // 1024 if m else 0
                part = STIFF_PARTS[q] if q < len(STIFF_PARTS) else f"slot{q}"
                break
        c = out.setdefault(part, [0, 0, 0, 0])
        for _, _, op, _ in ins[k0 + 1:k1]:
            base = op.split(".")[0]
            c[0] += 1
            c[1] += base == "BRA"
            c[2] += base == "BSSY"
            c[3] += base == "CALL"
    return out


def stiff_split_inputs(B, dev):
    """bench.py's stiff row (VdP mu=1000, t to 3000) at ``B`` lanes and the
    sampled main path's 101-point grid."""
    import chip_smoke as cs

    y0 = torch.as_tensor(cs.stiff_y0(B), device=dev)
    return (cs.solve_args(y0, cs.STIFF_TF, *cs.STIFF_TOL, None, dev),
            cs.sampled_grid(B, dev))


def stiff_mode_fields(method, c):
    """stiff_carry_fields of a carry, with its samples and their count
    where it has them."""
    out = stiff_carry_fields(method, c)
    for f in ("sample_y", "s_cursor"):
        if getattr(c, f, None) is not None:
            out[f] = getattr(c, f)
    return out


def stiff_split(build, dev, variants):
    """Where an attempt of radau and bdf spends its cycles: for the
    package's own csrc ("new") and each of ``variants`` (csrc directories),
    a copy with the stamps
    (``stiff_stamped_copy``) under ``_variants/<label>-stiff-stamps/csrc``
    and the variant as it is, both built; VdP on the stiff main path (B
    from ``STIFF_SPLIT_B``, the float32 controller), lean and sampled on
    its 101-point grid, through each: the stamped build's outputs held bit
    for bit to the variant's, the cycles of each part (``STIFF_PARTS``) a
    lane-attempt and their sum, the attempts that ran a unit's library path,
    beside the variant's cycles a warp-attempt a scheduler (from its
    ``turn_ms`` median) and the stamped build's; then the stamped SASS's
    instructions, BRA, BSSY and CALL between stamps by part
    (``stiff_regions``) of the VdP float instantiations."""
    import ctypes

    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    import chip_smoke as cs

    root = Path(__file__).resolve().parent / "_variants"
    for label, variant in [("new", build.SRC_DIR)] + [
            (baseline_label(v), v) for v in variants]:
        stamped = root / f"{label}-stiff-stamps" / "csrc"
        stiff_stamped_copy(Path(variant), stamped)
        t = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            fs = {(w, m): ex.submit(build.build, src_dir=d, name=m)
                  for w, d in (("stamped", stamped), ("variant", Path(variant)))
                  for m in ("radau", "bdf")}
            paths = {k: f.result() for k, f in fs.items()}
        libs = {k: build.load(pth) for k, pth in paths.items()}
        line("stiff_split_build", variant=label,
             seconds=round(time.perf_counter() - t, 3))
        side = side_modules(None if label == "new" else variant)
        sums = (ctypes.c_ulonglong * 17)()
        for m in ("radau", "bdf"):
            for name, ins in sass_functions(paths["stamped", m]).items():
                if name.startswith(f"{m}/VdP/f32") and name.endswith(
                        ("/lean", "/sampled")):
                    line("stiff_regions", variant=label, instantiation=name,
                         **{p: c for p, c in stiff_regions(ins).items()})
        cases = [(f"vdp_B{B}", rhs.vdp, *stiff_split_inputs(B, dev),
                  (cs.STIFF_MU,), ("lean", "sampled"), ("float32",),
                  STIFF_SPLIT_ROUNDS) for B in STIFF_SPLIT_B]
        fun, a, args = stiff_inputs("decay", AB_STIFF_WIDE["decay"], dev)
        cases.append((f"decay_B{AB_STIFF_WIDE['decay']}", fun, a, None, args,
                      ("lean",), ("float32", "state"), 0))
        B = AB_STIFF_MODES["record"]
        cases.append((f"vdp_B{B}", rhs.vdp, stiff_split_inputs(B, dev)[0],
                      None, (cs.STIFF_MU,), ("lean", "record", "record_cont"),
                      ("float32",), STIFF_SPLIT_ROUNDS))
        for row, fun, a, grid, args, modes, cps, rounds in cases:
            B = a[0].shape[0]
            hmin = torch.zeros(B, dtype=torch.float64, device=dev)
            for method, mode, cp in ((mt, md, c) for mt in ("RADAU", "BDF")
                                     for md in modes for c in cps):
                m = method.lower()
                take = libs["stamped", m].ivp_stamp_sums_take
                take.argtypes, take.restype = [ctypes.c_void_p], ctypes.c_int
                p = stiff_spec(method, fun.n, None,
                               {"controller_precision": cp}).params()
                g = grid if mode == "sampled" else None
                if mode.startswith("record"):
                    run, fields, mds = {}, {}, {}
                    for w in ("stamped", "variant"):
                        run[w], fields[w], mds[w] = split_record_run(
                            side.S, method, fun, a, args, p, libs[w, m],
                            STIFF_REC_CAPS[0], mode == "record_cont", dev)
                else:
                    run = {w: (lambda lib=libs[w, m]:
                               side.S.stiff_ensemble_cuda(
                                   method, fun, *a, args, 100000, p, hmin,
                                   lib=lib, t_grid=g))
                           for w in ("stamped", "variant")}
                    fields = {w: (lambda c: stiff_mode_fields(method, c))
                              for w in run}
                build.check(take(sums), "ivp_stamp_sums_take",
                            libs["stamped", m])
                got = run["stamped"]()
                torch.cuda.synchronize()
                build.check(take(sums), "ivp_stamp_sums_take",
                            libs["stamped", m])
                parts = [int(x) for x in sums]
                ref = run["variant"]()
                torch.cuda.synchronize()
                diff = carry_lanes_differing(fields["stamped"](got),
                                             fields["variant"](ref))
                rows = 0
                if mode.startswith("record"):
                    rows = int(mds["variant"].n_rec.sum())
                    lay = side.S.layout(method, fun, cp, B,
                                        lib=libs["variant", m],
                                        mode=side.S.RECORD,
                                        record_cont=mode == "record_cont")
                ms = {"variant": [], "stamped": []}
                for r in range(rounds):
                    for w in (("variant", "stamped") if r % 2 == 0
                              else ("stamped", "variant")):
                        ms[w].append(turn_ms(run[w]))
                mhz, wa = sm_mhz(), warp_attempts(ref.nstep)
                med = {w: float(np.median(v)) if v else float("nan")
                       for w, v in ms.items()}
                n = max(parts[10], 1)
                split = {q: round(parts[k] / n, 1)
                         for k, q in enumerate(STIFF_PARTS)}
                line("stiff_split", variant=label, kernel=m, row=row,
                     mode=mode, precision=cp, B=B, **split,
                     sum_of_parts=round(sum(parts[:10]) / n, 1),
                     lane_attempts=parts[10], slow_path_runs=parts[11],
                     library_runs=parts[12],
                     variant_ms=round(med["variant"], 4),
                     stamped_ms=round(med["stamped"], 4),
                     cycles_variant=round(med["variant"] * 1e-3 * mhz * 1e6
                                          * 132 * 4 / wa, 1),
                     cycles_stamped=round(med["stamped"] * 1e-3 * mhz * 1e6
                                          * 132 * 4 / wa, 1),
                     sm_mhz=mhz,
                     identical_to_variant=all(v == 0 for v in diff.values()),
                     lanes_differing=repr({k: v for k, v in diff.items()
                                           if v}),
                     **({} if not rows else dict(
                         rows=rows, stage_rows=lay["stage_rows"],
                         blocks_per_sm=lay["blocks_per_sm"],
                         **{q: round(parts[13 + k] / rows, 1)
                            for k, q in enumerate(ROW_PARTS)})))
                del got, ref
            del a, grid, hmin


def split_record_run(S, method, fun, a, args, p, lib, cap, cont, dev,
                     stream=None):
    """One RECORD launch of ``S``'s wrappers (a side's stiff_ensemble) of
    ``lib`` on ``stream`` (0: a g++ build on CPU tensors) from the solve
    arguments ``a``, one chunk of ``cap`` rows:
    ``(run, fields, modes)``, ``run()`` the launch, returning its carry,
    ``fields(carry)`` stiff_carry_fields with ``n_rec`` and the rows over
    their fields, zero past each lane's count, and ``modes`` the launch's
    Modes."""
    from ivp_tpu_torch.core.driver import run_args
    from ivp_tpu_torch.kernels import erk_ensemble as E

    y0, t0, tf, hmax, fs, rtol, atol = a
    B, n = y0.shape
    hmin = torch.zeros(B, dtype=torch.float64, device=dev)
    ra = run_args(tf, rtol, atol, hmax, hmin, 100000, y0)
    first = S.nan_first_step(fs, B, dev)
    md = S.Modes(method, B, n, dev, None, cap, cont)
    c = S.empty_carry(method, B, n, S.controller_dtype(p), dev)
    launch = S.StiffLaunch(method, fun, ra, args, p, lib, md)
    W = E.record_width(method, n, cont)

    def run(ra=ra):   # the launch holds ra's addresses: keep ra alive
        launch(c, c, y0, t0, first, True, S.UNBOUNDED, stream)
        return c

    def fields(c):
        out = stiff_carry_fields(method, c)
        rows = md.rows[..., :W].clone()
        rows[torch.arange(cap, device=dev)[None, :]
             >= md.n_rec.to(torch.int64)[:, None]] = 0.0
        out.update(n_rec=md.n_rec, rows=rows)
        return out
    return run, fields, md


# fast_paths' checks of erk_common.cuh's FastCtl<float> and FastCtl<double>
# against the IEEE operations (and libdevice's powf), built from a copy of
# csrc with this source beside it: every float the square root's and the
# power's range tests admit, and FAST_DRAWS random operands (a hash of the
# index) for the float division (a divisor shared by two quotients, as the
# norm takes it), the step size over a float factor, the double division (a
# shared divisor too) and the double square root; each counts the inputs its
# range admits and those on which the result's bits differ, and keeps the
# first such input.
FAST_DRAWS = 1 << 30
FAST_SOURCE = r"""
#include "stiff_common.cuh"

namespace {
__device__ unsigned long long mix(unsigned long long x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}
// A float of random sign and significand with an exponent in [lo, hi].
__device__ float rand_float(unsigned long long r, int lo, int hi) {
  const unsigned e = (unsigned)(lo + (int)((r >> 23) % (unsigned)(hi - lo + 1)));
  return __uint_as_float((unsigned)((r >> 63) << 31) | ((e + 127u) << 23) |
                         (unsigned)(r & 0x7fffffu));
}
__device__ void tally(unsigned long long* out, bool admitted, bool same,
                      unsigned long long a, unsigned long long b) {
  if (!admitted) return;
  atomicAdd(&out[0], 1ull);
  if (!same && atomicAdd(&out[1], 1ull) == 0) {
    out[2] = a;
    out[3] = b;
  }
}
__global__ void sqrt_all(unsigned long long* out) {
  const unsigned long long n = 0x7f800000ull;
  for (unsigned long long u = blockIdx.x * (unsigned long long)blockDim.x +
                               threadIdx.x;
       u < n; u += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)u);
    ivp::FastCtl<float> op;
    const float got = op.sqrt(x);
    tally(out, op.ok, __float_as_uint(got) == __float_as_uint(sqrtf(x)), u, 0);
  }
}
// pow(x, -1/3) on every float: the bits of FastCtl<float>::pow_m13 where
// its range test admits x, against the library's powf.
__global__ void pow_all(unsigned long long* out) {
  const unsigned long long n = 1ull << 32;
  for (unsigned long long u = blockIdx.x * (unsigned long long)blockDim.x +
                               threadIdx.x;
       u < n; u += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)u);
    ivp::FastCtl<float> op;
    const float got = op.pow_m13(x);
    tally(out, op.ok,
          __float_as_uint(got) ==
              __float_as_uint(powf(x, (float)(-1.0 / 3.0))),
          u, 0);
  }
}
__global__ void div_random(unsigned long long* out, unsigned long long n) {
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                               threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned long long r1 = mix(2 * i), r2 = mix(2 * i + 1);
    const float b = rand_float(r1, -127, 127);
    const float a = (r2 & 0xff) == 0 ? 0.0f : rand_float(r2, -127, 127);
    const float a2 = rand_float(mix(r2), -40, 40);
    ivp::FastCtl<float> op;
    const ivp::Divisor<float> d = op.divisor(b);
    const float q = op.div_by(a, d), q2 = op.div_by(a2, d);
    const bool same = __float_as_uint(q) == __float_as_uint(a / b) &&
                      __float_as_uint(q2) == __float_as_uint(a2 / b);
    tally(out, op.ok, same, __float_as_uint(a) | (unsigned long long)__float_as_uint(a2) << 32,
          __float_as_uint(b));
  }
}
__global__ void hdiv_random(unsigned long long* out, unsigned long long n) {
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                               threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned long long r1 = mix(2 * i), r2 = mix(2 * i + 1);
    const float x = rand_float(r1, -127, 127);
    const unsigned long long e = 1023 - 810 + (r2 >> 52) % 1621;
    const double h = __longlong_as_double(
        (long long)((r2 & 0x800fffffffffffffull) | (e << 52)));
    ivp::FastCtl<float> op;
    const double got = op.hdiv(h, x);
    tally(out, op.ok,
          __double_as_longlong(got) == __double_as_longlong(h / (double)x),
          (unsigned long long)__double_as_longlong(h), __float_as_uint(x));
  }
}
// A double of random sign and significand with an exponent in [lo, hi].
__device__ double rand_double(unsigned long long r, int lo, int hi) {
  const unsigned long long e =
      (unsigned long long)(lo + (int)((r >> 52) % (unsigned)(hi - lo + 1)) + 1023);
  return __longlong_as_double(
      (long long)((r & 0x800fffffffffffffull) | (e << 52)));
}
__global__ void ddiv_random(unsigned long long* out, unsigned long long n) {
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                               threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned long long r1 = mix(3 * i), r2 = mix(3 * i + 1),
                             r3 = mix(3 * i + 2);
    const double b = rand_double(r1, -520, 520);
    const double a = (r2 & 0xff) == 0 ? 0.0 : rand_double(r2, -520, 520);
    const double a2 = rand_double(r3, -40, 40);
    ivp::FastCtl<double> op;
    const ivp::Divisor<double> d = op.divisor(b);
    const double q = op.div_by(a, d), q2 = op.div_by(a2, d);
    const bool same = __double_as_longlong(q) == __double_as_longlong(a / b) &&
                      __double_as_longlong(q2) == __double_as_longlong(a2 / b);
    tally(out, op.ok, same, (unsigned long long)__double_as_longlong(a),
          (unsigned long long)__double_as_longlong(b));
  }
}
__global__ void dsqrt_random(unsigned long long* out, unsigned long long n) {
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                               threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned long long r = mix(i);
    const double x = (r & 0xff) == 0 ? -rand_double(r, -1000, 1000)
                                     : fabs(rand_double(r, -1000, 1023));
    ivp::FastCtl<double> op;
    const double got = op.sqrt(x);
    tally(out, op.ok,
          __double_as_longlong(got) == __double_as_longlong(sqrt(x)),
          (unsigned long long)__double_as_longlong(x), 0);
  }
}
// pow(x, 0.8) on every float (Radau's faccon): FastCtl<float>::pow where
// its range test admits x, against the library's powf.
__global__ void pow08_all(unsigned long long* out) {
  const unsigned long long n = 1ull << 32;
  for (unsigned long long u = blockIdx.x * (unsigned long long)blockDim.x +
                               threadIdx.x;
       u < n; u += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)u);
    ivp::FastCtl<float> op;
    const float got = op.pow(x, 0.8f);
    tally(out, op.ok,
          __float_as_uint(got) == __float_as_uint(powf(x, 0.8f)), u, 0);
  }
}
// a over each constant divisor of Radau's collocation rows (div_known, from
// the reciprocal the compiler made), random a.
__global__ void dknown_random(unsigned long long* out, unsigned long long n) {
  using namespace ivp::radau;
  constexpr double B[5] = {C1MC2, C1, C2, C2M1, C1M1};
  constexpr double R[5] = {1.0 / C1MC2, 1.0 / C1, 1.0 / C2, 1.0 / C2M1,
                           1.0 / C1M1};
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                               threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned long long r = mix(5 * i + 7);
    const double a = (r & 0xff) == 0 ? 0.0 : rand_double(r, -520, 520);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      ivp::FastCtl<double> op;
      const double q = ivp::div_known(op, a, B[k], R[k]);
      tally(out, op.ok, __double_as_longlong(q) == __double_as_longlong(a / B[k]),
            (unsigned long long)__double_as_longlong(a),
            (unsigned long long)__double_as_longlong(B[k]));
    }
  }
}
// stiff_common.cuh's sqrt_wide on WideCtl<float> on every float, against
// sqrtf.
__global__ void fsqrt_wide_all(unsigned long long* out) {
  const unsigned long long n = 1ull << 32;
  for (unsigned long long u = blockIdx.x * (unsigned long long)blockDim.x +
                               threadIdx.x;
       u < n; u += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)u);
    ivp::WideCtl<float> op;
    const float got = ivp::sqrt_wide(op, x);
    tally(out, op.ok, __float_as_uint(got) == __float_as_uint(sqrtf(x)), u, 0);
  }
}
// div_wide, sqrt_wide and hdiv_wide off the fast paths' ranges: a float
// numerator with an exponent in [-126, 127] (one in 16 subnormal, one in 32
// an infinity or a NaN) over one in [-40, 40] (one in 32 an infinity or a
// NaN); a double numerator with an exponent in [-1022, 1023] (as many
// subnormal, infinite or NaN) over one in [-100, 100] (as many infinite or
// NaN); a double in [-1022, -900] or non-finite for the root; a step size
// over a non-finite float factor.  NaN equals NaN.
__device__ float special_float(unsigned long long r, float x) {
  const unsigned k = (unsigned)(r >> 59);   // 0..31
  return k == 0 ? (r & 1 ? INFINITY : -INFINITY) : (k == 1 ? NAN : x);
}
__device__ double special_double(unsigned long long r, double x) {
  const unsigned k = (unsigned)(r >> 59);
  return k == 0 ? (r & 1 ? (double)INFINITY : -(double)INFINITY)
                : (k == 1 ? (double)NAN : x);
}
__device__ bool same_f(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b) || (a != a && b != b);
}
__device__ bool same_d(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b) ||
         (a != a && b != b);
}
__global__ void wide_random(unsigned long long* out, unsigned long long n) {
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                               threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned long long r1 = mix(4 * i + 11), r2 = mix(4 * i + 12),
                             r3 = mix(4 * i + 13), r4 = mix(4 * i + 14);
    const bool sub = (r1 & 0xf) == 0;
    float a = rand_float(r1, -126, 127);
    if (sub) a = __uint_as_float(__float_as_uint(a) & 0x807fffffu);
    a = special_float(r3, a);
    const float b = special_float(r4 << 5, rand_float(r2, -40, 40));
    ivp::WideCtl<float> f;
    const float q = ivp::div_wide(f, a, b);
    tally(out, f.ok, same_f(q, a / b), __float_as_uint(a), __float_as_uint(b));
    double da = rand_double(r3, -1022, 1023);
    if (sub) da = __longlong_as_double(__double_as_longlong(da) &
                                       (long long)0x800fffffffffffffull);
    da = special_double(r1, da);
    const double db = special_double(r2 << 5, rand_double(r4, -100, 100));
    ivp::WideCtl<double> d;
    const double dq = ivp::div_wide(d, da, db);
    tally(out + 4, d.ok, same_d(dq, da / db),
          (unsigned long long)__double_as_longlong(da),
          (unsigned long long)__double_as_longlong(db));
    double x = fabs(rand_double(r4, -1022, -900));
    if (sub) x = __longlong_as_double(__double_as_longlong(x) &
                                      (long long)0x000fffffffffffffull);
    x = special_double(r3 << 7, x);
    ivp::WideCtl<double> e;
    const double rt = ivp::sqrt_wide(e, x);
    tally(out + 8, e.ok, same_d(rt, sqrt(x)),
          (unsigned long long)__double_as_longlong(x), 0);
    const double h = rand_double(r1 >> 3, -700, 700);
    const float fx = special_float(r2, rand_float(r3, -126, 127));
    ivp::WideCtl<float> g;
    const double hq = ivp::hdiv_wide(g, h, fx);
    tally(out + 12, g.ok, same_d(hq, h / (double)fx),
          (unsigned long long)__double_as_longlong(h), __float_as_uint(fx));
  }
}
// Brent's quotients (erk_common.cuh's brent_step) on Brent-shaped operands:
// event values near 0 (exponents in [-540, 40], one fa2 in 16 a zero), the
// secant's fc2 == fa2 with a2 == c2 on one draw in 4, brackets around a b2
// of exponent in [-520, 520] at relative widths 2^[-64, 0] (tiny and huge
// brackets), ee around xm.  brent_quotients: fb2 / fa2, fa2 / fc2 and
// fb2 / fc2 through FastCtl<double>'s shared divisors against the IEEE
// divisions, where its range test admits them; brent_step: the whole step
// (d_new and whether the interpolation is taken, which holds p / q) on
// FastCtl<double> against Ctl<double>, where ok.
__global__ void brent_random(unsigned long long* out, unsigned long long n) {
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                               threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const unsigned long long r1 = mix(5 * i + 101), r2 = mix(5 * i + 102),
                             r3 = mix(5 * i + 103), r4 = mix(5 * i + 104),
                             r5 = mix(5 * i + 105);
    const double b2 = rand_double(r1, -520, 520);
    const double wa = ldexp(rand_double(r2, -1, -1), -(int)(r2 >> 58));
    const double wc = ldexp(rand_double(r3, -1, -1), -(int)(r3 >> 58));
    const bool secant = (r4 & 3) == 0;
    const double a2 = b2 + b2 * wa, c2 = secant ? a2 : b2 + b2 * wc;
    const double fb2 = rand_double(r4, -540, 40);
    const double fa2 = (r5 & 0xf) == 0 ? 0.0 : rand_double(r5, -540, 40);
    const double fc2 = secant ? fa2 : rand_double(mix(r5), -540, 40);
    const double xm = __dmul_rn(0.5, __dsub_rn(c2, b2));
    const double tol1 = __dadd_rn(__dmul_rn(2.0 * 2.3e-16, fabs(b2)), 1e-12);
    const double ee = xm * ldexp(1.0, (int)(r1 >> 60) - 6);
    ivp::FastCtl<double> op;
    const ivp::Divisor<double> dc = op.divisor(fc2), da = op.divisor(fa2);
    const double qv = op.div_by(fa2, dc), rv = op.div_by(fb2, dc),
                 sq = op.div_by(fb2, da);
    tally(out, op.ok,
          same_d(qv, fa2 / fc2) && same_d(rv, fb2 / fc2) &&
              same_d(sq, fb2 / fa2),
          (unsigned long long)__double_as_longlong(fa2),
          (unsigned long long)__double_as_longlong(fc2));
    ivp::FastCtl<double> fast;
    ivp::Ctl<double> lib;
    bool take_f, take_l;
    const double df = ivp::brent_step(fast, a2, b2, c2, fa2, fb2, fc2, xm,
                                      tol1, ee, take_f);
    const double dl = ivp::brent_step(lib, a2, b2, c2, fa2, fb2, fc2, xm,
                                      tol1, ee, take_l);
    tally(out + 4, fast.ok, same_d(df, dl) && take_f == take_l,
          (unsigned long long)__double_as_longlong(fb2),
          (unsigned long long)__double_as_longlong(b2));
  }
}
}  // namespace

extern "C" int ivp_fast_paths(unsigned long long* out, unsigned long long n) {
  // out: 15 checks x [admitted, differing, first input a, first input b].
  cudaMemset(out, 0, 60 * sizeof(unsigned long long));
  sqrt_all<<<1056, 256>>>(out);
  div_random<<<1056, 256>>>(out + 4, n);
  hdiv_random<<<1056, 256>>>(out + 8, n);
  ddiv_random<<<1056, 256>>>(out + 12, n);
  dsqrt_random<<<1056, 256>>>(out + 16, n);
  pow_all<<<1056, 256>>>(out + 20);
  pow08_all<<<1056, 256>>>(out + 24);
  dknown_random<<<1056, 256>>>(out + 28, n);
  fsqrt_wide_all<<<1056, 256>>>(out + 32);
  wide_random<<<1056, 256>>>(out + 36, n);
  brent_random<<<1056, 256>>>(out + 52, n);
  return (int)cudaDeviceSynchronize();
}
extern "C" const char* ivp_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
"""


def fast_paths(build, dev):
    """Hold erk_common.cuh's FastCtl<float> and FastCtl<double> to the
    library's operations on the card (``FAST_SOURCE``): the float square
    root, pow(x, -1/3) and pow(x, 0.8) on every float their range tests
    admit, the divisions, the step size over a float factor, the double
    square root and stiff_common.cuh's division by Radau's five constants
    on ``FAST_DRAWS`` random operands each; stiff_common.cuh's WideCtl
    paths: sqrt_wide on every float, and with div_wide and hdiv_wide on
    operands off the fast paths' ranges (in float and double, subnormal,
    huge, infinite and NaN ones among them); erk_common.cuh's Brent
    quotients and whole step (brent_step) on Brent-shaped operands."""
    import ctypes

    src = build.BUILD_DIR / "fast_paths_src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.SRC_DIR, src)
    (src / "fast_paths.cu").write_text(FAST_SOURCE)
    t = time.perf_counter()
    lib = build.load(build.build(src_dir=src, name="fast_paths"))
    fn = lib.ivp_fast_paths
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_ulonglong], ctypes.c_int
    out = torch.zeros(60, dtype=torch.int64, device=dev)
    t1 = time.perf_counter()
    build.check(fn(out.data_ptr(), FAST_DRAWS), "ivp_fast_paths", lib)
    res = out.cpu().tolist()
    line("fast_paths_build", seconds=round(t1 - t, 3),
         run_seconds=round(time.perf_counter() - t1, 3))
    for q, (what, drawn) in enumerate((("fsqrt", 0x7f800000),
                                       ("fdiv", FAST_DRAWS),
                                       ("hdiv", FAST_DRAWS),
                                       ("ddiv", FAST_DRAWS),
                                       ("dsqrt", FAST_DRAWS),
                                       ("fpow_m13", 1 << 32),
                                       ("fpow_08", 1 << 32),
                                       ("ddiv_known", 5 * FAST_DRAWS),
                                       ("fsqrt_wide", 1 << 32),
                                       ("fdiv_wide", FAST_DRAWS),
                                       ("ddiv_wide", FAST_DRAWS),
                                       ("dsqrt_wide", FAST_DRAWS),
                                       ("hdiv_wide", FAST_DRAWS),
                                       ("brent_quotients", FAST_DRAWS),
                                       ("brent_step", FAST_DRAWS))):
        adm, bad, a, b = res[4 * q:4 * q + 4]
        line("fast_paths", op=what, inputs=drawn, admitted=adm,
             differing=bad, first_a=hex(a & (2**64 - 1)) if bad else None,
             first_b=hex(b & (2**64 - 1)) if bad else None)


OUTPUTS = ("t", "y", "status", "nfev", "nstep", "naccpt", "nrejct",
           "y_samples", "n_samples")


def lanes_differing(new_out, old_out):
    """{output: lanes on which it differs}; NaN equals NaN."""
    diff = {}
    for f, x, y in zip(OUTPUTS, new_out, old_out):
        if x is None:
            continue
        ne = x != y
        if x.is_floating_point():
            ne &= ~(torch.isnan(x) & torch.isnan(y))
        diff[f] = int(ne.reshape(x.shape[0], -1).any(dim=1).sum())
    return diff


def lean_cases(rhs, dev):
    """The lean DOPRI5 bit-for-bit cases at B=524288: ``[(name, fun, args,
    keyword args)]``, each ``PROBLEMS`` entry and chip_smoke.py's
    edge_cases."""
    from chip_smoke import edge_cases

    cases = [(name, getattr(rhs, name), problem_args(name, MAIN_B, dev), {})
             for name in PROBLEMS]
    return cases + [(name, rhs.vdp, a, kw)
                    for name, a, kw, _ in edge_cases(MAIN_B, dev)]


def dopri5_options_path(k, rhs, dev):
    """Lean DOPRI5 has two kernels: csrc/dopri5_ensemble.cu for the default
    options and the lean instantiation of csrc/erk_dopri5.cu for a solve
    with ``solver_options``.  Both with the default options at B=524288 on
    each ``PROBLEMS`` entry and chip_smoke.py's edge_cases: the lanes on
    which each output differs; then on the headline problem in
    ``AB_ERK_ROUNDS`` rounds of tuned, generic, generic, tuned."""
    from ivp_tpu_torch.kernels import erk_ensemble as K

    for name, fun, a, kw in lean_cases(rhs, dev):
        tuned = k.dopri5_ensemble_cuda(fun, *a, **kw)
        generic = K.erk_ensemble_cuda("DOPRI5", fun, *a, **kw)[:7]
        torch.cuda.synchronize()
        diff = lanes_differing(generic, tuned)
        line("erk_dopri5_options_path", case=name, B=MAIN_B,
             identical=all(v == 0 for v in diff.values()),
             lanes_differing=repr(diff))
        del tuned, generic
    args = problem_args("vdp", MAIN_B, dev)
    run = {"tuned": lambda: k.dopri5_ensemble_cuda(rhs.vdp, *args),
           "generic": lambda: K.erk_ensemble_cuda("DOPRI5", rhs.vdp, *args)}
    for what in run:
        run[what]()
    for r in range(AB_ERK_ROUNDS):
        for what in ("tuned", "generic", "generic", "tuned"):
            line("erk_dopri5_options_path", what=what, B=MAIN_B, round=r,
                 event_ms=round(turn_ms(run[what]), 4))


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


def kernel_ms(fn, n=TURN_LAUNCHES, match="erk_kernel", retry=4,
              launches=None):
    """Device ms of one launch of ``fn``'s kernels whose name holds
    ``match``, from torch.profiler over ``n`` launches after an untimed
    one in the same profile (chip_smoke.py's ``window_profile``): the
    kernel alone, where a turn's time (``turn_ms``) is held by the host's
    work around a short launch.  ``launches``: the number of those kernels
    a result of ``fn`` launched, which the profile must hold as many events
    of, or it raises; a profile that holds none of them, or not as many, is
    taken again, up to ``retry`` more times (an H100's trace lost a launch
    at its ends in two takes running)."""
    import chip_smoke as cs

    outs, events, _, _ = cs.window_profile(
        fn, lambda: [fn() for _ in range(n)])
    want = sum(launches(o) for o in outs) if launches else None
    del outs
    mine = [e for e in events if match in e.name]
    if not mine or want is not None and len(mine) != want:
        line("kernel_ms_missed", match=match, kernel_events=len(mine),
             launches=want, retry=retry)
        if retry:
            return kernel_ms(fn, n, match, retry - 1, launches)
        if want is not None:
            raise AssertionError(f"torch.profiler held {len(mine)} {match} "
                                 f"events for {want} launches")
    return 1e-3 * sum(e.time_range.elapsed_us() for e in mine) / n


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


def ab(k, build, rhs, dev, baseline, label):
    t0 = time.perf_counter()
    path = build.build(src_dir=baseline)
    old = build.load(path)
    line("ab_build", old=label, library=path.name,
         seconds=round(time.perf_counter() - t0, 3))
    for functor, info in ptxas_lines(path.with_suffix(".log").read_text()):
        line("ptxas", build=label, functor=functor, info=repr(info))
    sass_report(path, label)
    for name, fun, a, kw in lean_cases(rhs, dev):
        new_out = k.dopri5_ensemble_cuda(fun, *a, **kw)
        old_out = k.dopri5_ensemble_cuda(fun, *a, **kw, lib=old)
        torch.cuda.synchronize()
        diff = lanes_differing(new_out, old_out)
        line("ab_bitwise", old=label, functor=name, B=MAIN_B,
             identical=all(v == 0 for v in diff.values()),
             lanes_differing=repr(diff),
             statuses=repr(dict(Counter(new_out[2].cpu().tolist()))),
             max_abs_dy=float((new_out[1] - old_out[1]).abs().max()))
    a = problem_args("vdp", MAIN_B, dev)
    for r in range(AB_ERK_ROUNDS):
        for what in ("old", "new", "new", "old"):
            lib = old if what == "old" else None
            line("ab", old=label, round=r, what=what, B=MAIN_B,
                 event_ms=round(turn_ms(
                     lambda: k.dopri5_ensemble_cuda(rhs.vdp, *a, lib=lib)), 4))


# The erk occupancy sweep: (threads a block, min blocks an SM) for every
# entry of a library, -DIVP_ERK_THREADS/-DIVP_ERK_MIN_BLOCKS.
ERK_OCC = ((64, 4), (64, 6), (64, 8), (64, 10), (64, 12), (64, 16), (128, 2),
           (128, 4), (128, 6), (128, 8))
ERK_OCC_ROUNDS = 5


def erk_occupancy(build, rhs, dev, methods):
    """Each of ``methods``' lean and sampled instantiations on Lorenz under
    every ERK_OCC setting, at each of AB_ERK_B, in turns (and lean DOPRI5
    on the VdP headline at MAIN_B, its main path; and each main-path event
    instantiation of EVENT_B at its lane counts); counters held to the
    package build; ranked."""
    from ivp_tpu_torch.kernels import erk_ensemble as K

    sources = {K.KERNELS[m][1]: m for m in methods}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(ERK_OCC) * len(sources)) as ex:
        futs = {(src, s): ex.submit(build.build, defines=(
            f"IVP_ERK_THREADS={s[0]}", f"IVP_ERK_MIN_BLOCKS={s[1]}"), name=src)
            for src in sources for s in ERK_OCC}
        libs = {key: f.result() for key, f in futs.items()}
    line("erk_occupancy_build", libraries=len(libs),
         seconds=round(time.perf_counter() - t0, 3))
    for (src, s), path in sorted(libs.items()):
        for fn, regs, st, ld in build.ptxas_report(path):
            name = instantiation(fn)
            if (name.startswith(("Lorenz/f32", "VdP/f32/lean"))
                    or "/ev_" in name):
                line("erk_occupancy_ptxas", source=src, threads=s[0],
                     min_blocks=s[1], instantiation=name, registers=regs,
                     spill_stores=st, spill_loads=ld)
    loaded = {key: build.load(path) for key, path in libs.items()}
    for src, method in sources.items():
        kernel = K.KERNELS[method][0]
        cases = [(f"lorenz_{'sampled' if sampled else 'lean'}", B,
                  lorenz_args(method, B, dev, sampled))
                 for B in AB_ERK_B for sampled in (False, True)]
        if method == "DOPRI5":
            cases.append(("vdp_lean", MAIN_B,
                          (rhs.vdp, *problem_args("vdp", MAIN_B, dev))))
        kws = {}
        for m, set_name, Bs in EVENT_B:
            if m == method:
                for B in Bs:
                    fun, a, ev = event_main_inputs(m, set_name, B, dev)
                    case = f"{set_name}_events"
                    cases.append((case, B, (fun, *a, (), 200_000)))
                    kws[case, B] = dict(events=ev)
        for case, B, args in cases:
            kw = kws.get((case, B), {})
            ref = K.erk_ensemble_cuda(method, *args, **kw)
            run = {s: (lambda lib=loaded[src, s]: K.erk_ensemble_cuda(
                method, *args, lib=lib, **kw)) for s in ERK_OCC}
            equal = {}
            for s in ERK_OCC:
                out = run[s]()
                equal[s] = same_counters(out[:7], ref[:7])
            del out, ref
            ms = {s: [] for s in ERK_OCC}
            for r in range(ERK_OCC_ROUNDS):
                for s in (ERK_OCC if r % 2 == 0 else ERK_OCC[::-1]):
                    ms[s].append(turn_ms(run[s]))
            ranked = sorted(ERK_OCC, key=lambda s: np.median(ms[s]))
            line("erk_occupancy", kernel=kernel, case=case, B=B,
                 rounds=ERK_OCC_ROUNDS,
                 counters_equal=all(equal.values()),
                 ms_median={f"{t}x{mb}": round(float(np.median(ms[t, mb])), 4)
                            for t, mb in ERK_OCC},
                 fastest=[f"{t}x{mb}" for t, mb in ranked[:3]])


def erk_cases(method, B, dev):
    """The bit-for-bit cases of ``method``'s kernel at B lanes: ``[(name,
    erk_ensemble_cuda's args after method, keyword args)]``.  Lorenz (the
    main path's configuration), VdP (the headline problem; t in [0, 20] but
    for DOP853) and decay, lean and sampled, with the controller in float
    and in double (methods with a controller); chip_smoke.py's edge_cases,
    lean and with an 8-point grid per lane; stiff VdP with stiff_test=7."""
    from chip_smoke import edge_cases
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.methods import get_engine

    f64 = torch.float64
    ctl = ("float32",) if method == "RK4" else ("float32", "state")
    first = 2e-3 if method == "RK4" else None
    out = []
    for sampled in (False, True):
        mode = "sampled" if sampled else "lean"
        for prec in ctl:
            kw = {} if prec == "float32" else dict(params=get_engine(
                method, need_cont=sampled, controller_precision=prec)[1])
            a = lorenz_args(method, B, dev, sampled)
            out.append((f"lorenz_{mode}_{prec}", a[:-1], dict(kw, t_grid=a[-1])))
            for name in ("vdp", "decay"):
                y0, t0, tf, hmax, _, rtol, atol = problem_args(name, B, dev)
                if name == "vdp" and method != "DOP853":
                    tf = hmax = torch.full_like(tf, 20.0)
                fs = None if first is None else torch.full_like(tf, first)
                grid = (torch.broadcast_to(torch.linspace(
                    0.0, float(tf[0]) * (0.99 if method == "RK4" else 1.0),
                    ERK_SAMPLES, dtype=f64, device=dev), (B, ERK_SAMPLES))
                    if sampled else None)
                out.append((f"{name}_{mode}_{prec}",
                            (getattr(rhs, name), y0, t0, tf, hmax, fs, rtol,
                             atol), dict(kw, t_grid=grid)))
    for name, a, kw, _ in edge_cases(B, dev):
        if method == "RK4" and name == "vdp_stiff":
            continue      # a fixed step at mu = 1000 overflows to inf
        out.append((name, (rhs.vdp, *a), kw))
        t0, tf = a[1], a[2]
        u = torch.linspace(0.0, 1.0, 8, dtype=f64, device=dev)
        grid = (t0[:, None] + (tf - t0)[:, None] * u).contiguous()
        out.append((f"{name}_sampled", (rhs.vdp, *a), dict(kw, t_grid=grid)))
    if method in ("DOPRI5", "DOP853"):
        name, a, kw, _ = edge_cases(B, dev)[0]
        out.append((f"{name}_stiff_test7", (rhs.vdp, *a), dict(kw, params=(
            get_engine(method, need_cont=False, stiff_test=7)[1]))))
    if method == "DOP853":
        out += queue_cases(B, dev)
    return out


def queue_cases(B, dev):
    """Sampled cases that fill the deferred samples' queue (erk_common.cuh's
    DEFER_SAMPLES), as ``erk_cases`` gives them: Lorenz on t in [0, 1] with
    a per-lane grid of 400 sorted times inside it, denser than the steps
    (every step covers several, the slots fill every few steps); decay with
    every other lane backward and a per-lane grid of 64 times from t0 to tf;
    Lorenz on t in [0, 2] with a grid of t0 and tf alone."""
    from ivp_tpu_torch import rhs

    def T(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev).contiguous()

    rng = np.random.default_rng(7)
    tol = lambda n, r, a: (T(np.full((B, n), r)), T(np.full((B, n), a)))
    zero = T(np.zeros(B))
    y0 = 1.0 + rng.standard_normal((B, 3))
    one, two = T(np.ones(B)), T(np.full(B, 2.0))
    dense = T(np.sort(rng.uniform(0.0, 1.0, (B, 400)), axis=1))
    span = np.where(np.arange(B) % 2 == 1, -5.0, 5.0)
    back = T(span[:, None] * np.linspace(0.0, 1.0, 64))
    ends = T(np.stack([np.zeros(B), np.full(B, 2.0)], axis=1))
    return [
        ("lorenz_dense_grid", (rhs.lorenz, T(y0), zero, one, one, None,
                               *tol(3, 1e-8, 1e-10)), dict(t_grid=dense)),
        ("decay_backward_grid", (rhs.decay, T(rng.uniform(0.5, 2.0, (B, 1))),
                                 zero, T(span), T(np.abs(span)), None,
                                 *tol(1, 1e-8, 1e-10)),
         dict(args=(0.7,), t_grid=back)),
        ("lorenz_grid_ends", (rhs.lorenz, T(y0), zero, two, two, None,
                              *tol(3, 1e-8, 1e-10)), dict(t_grid=ends)),
    ]


def ab_erk(build, rhs, dev, baseline, label, methods=None):
    """The erk kernels built from ``baseline`` against the package's, at
    each of AB_ERK_B: lanes differing in each output of every erk_cases
    case of every method (of ``methods``, if given); the old build's loop
    SASS; then old, new, new, old rounds of each method's Lorenz main-path
    configurations, lean and sampled."""
    from ivp_tpu_torch.kernels import erk_ensemble as K

    methods = list(K.KERNELS) if methods is None else methods
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        futs = {m: ex.submit(build.build, src_dir=baseline,
                             name=K.KERNELS[m][1]) for m in methods}
        paths = {m: f.result() for m, f in futs.items()}
    old = {m: build.load(path) for m, path in paths.items()}
    line("ab_erk_build", old=label, seconds=round(time.perf_counter() - t0, 3))
    for m in methods:
        sass_report(paths[m], label, only="Lorenz/f32")

    for B in AB_ERK_B:
        for method in methods:
            for what, a, kw in erk_cases(method, B, dev):
                new_out = K.erk_ensemble_cuda(method, *a, **kw)
                old_out = K.erk_ensemble_cuda(method, *a, **kw,
                                              lib=old[method])
                torch.cuda.synchronize()
                diff = lanes_differing(new_out, old_out)
                line("ab_erk_bitwise", old=label,
                     kernel=K.KERNELS[method][0], case=what, B=B,
                     identical=all(v == 0 for v in diff.values()),
                     lanes_differing=repr(diff),
                     statuses=repr(dict(Counter(new_out[2].cpu().tolist()))),
                     max_abs_dy=float((new_out[1] - old_out[1]).abs().max()))
                del new_out, old_out
    for B in AB_ERK_B:
        for method in methods:
            for sampled in (False, True):
                a = lorenz_args(method, B, dev, sampled)
                run = {"new": lambda: K.erk_ensemble_cuda(method, *a),
                       "old": lambda: K.erk_ensemble_cuda(
                           method, *a, lib=old[method])}
                ms = {"old": [], "new": []}
                for r in range(AB_ERK_ROUNDS):
                    for what in ("old", "new", "new", "old"):
                        ms[what].append(turn_ms(run[what]))
                        line("ab_erk", old=label, kernel=K.KERNELS[method][0],
                             sampled=sampled, B=B, round=r, what=what,
                             event_ms=round(ms[what][-1], 4))
                ab_erk_summary(label, method, sampled, a, run["new"](),
                               ms, B)


def ptxas_smem(path):
    """``{kernel: static shared memory bytes}`` from the nvcc log beside a
    built library, the kernel as ptxas mangles it."""
    out, fn = {}, "?"
    for text in Path(path).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", text)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes smem", text)
        if m:
            out[fn] = int(m.group(1))
    return out


def ab_erk_summary(label, method, sampled, a, out, ms, B):
    """One line per A/B: each side's median, the rounds the new side won
    (its two turns against the old side's two), the cycles a warp-attempt
    per scheduler of each median at the SM clock read now, and the bound
    of this solve (``out``, the new build's) with its share of the new
    median; sampled, also with dense rows on every accepted step.  Then the
    new build's registers, spills and static shared memory a block of the
    Lorenz float-controller instantiation, and where that memory is the
    deferred samples' queue (sampled DOP853) its slots a lane: the bytes
    over 8 x (3 + 2n) x the block's threads."""
    from ivp_tpu_torch.kernels import build
    from ivp_tpu_torch.kernels import erk_ensemble as K

    fun, m = a[0], ERK_SAMPLES if sampled else 0
    med = {w: float(np.median(v)) for w, v in ms.items()}
    pairs = zip(zip(ms["new"][::2], ms["new"][1::2]),
                zip(ms["old"][::2], ms["old"][1::2]))
    wins = sum(sum(n) < sum(o) for n, o in pairs)
    mhz, wa = sm_mhz(), warp_attempts(out[4])
    cycles = {w: round(v * 1e-3 * mhz * 1e6 * 132 * 4 / wa, 1)
              for w, v in med.items()}
    bound, by = K.solve_bound(method, fun, out[4], out[5], out[8], m)
    every = (K.solve_bound(method, fun, out[4], out[5], out[8], m,
                           dense_steps=out[5])[0] if sampled else bound)
    line("ab_erk_summary", old=label, kernel=K.KERNELS[method][0],
         sampled=sampled, B=B, old_ms=round(med["old"], 4),
         new_ms=round(med["new"], 4),
         new_over_old=round(med["new"] / med["old"], 4),
         rounds_new_won=f"{wins}/{AB_ERK_ROUNDS}", sm_mhz=mhz,
         cycles_old=cycles["old"], cycles_new=cycles["new"],
         warp_eff=round(float(out[4].to(torch.int64).sum()) / (32 * wa), 5),
         bound_ms=round(bound, 6), bound_by=by,
         bound_share=round(bound / med["new"], 4),
         bound_ms_rows_every_accept=round(every, 6),
         bound_share_rows_every_accept=round(every / med["new"], 4),
         **new_layout(build, method, sampled))


def new_layout(build, method, sampled):
    """The package build's registers, spills, static shared memory a block
    and threads a block of ``method``'s Lorenz float-controller
    instantiation (lean or sampled), and for sampled DOP853 the slots a
    lane (ab_erk_summary)."""
    from ivp_tpu_torch.kernels import erk_ensemble as K

    path = build.library_path(name=K.KERNELS[method][1])
    want = f"Lorenz/f32/{'sampled' if sampled else 'lean'}"
    smem = ptxas_smem(path)
    for fn, regs, st, ld in build.ptxas_report(path):
        if instantiation(fn) != want:
            continue
        m = _ERK.search(fn)
        threads = int(m.group(7)) if m and m.group(7) else None
        lay = dict(registers=regs, spill_stores=st, spill_loads=ld,
                   smem_block=smem.get(fn), threads=threads)
        if method == "DOP853" and sampled and threads and smem.get(fn):
            lay["slots_q"] = smem[fn] / (8 * (3 + 2 * 3) * threads)
        return lay
    return {}


def blocks_by_registers(regs, threads):
    """Blocks of ``threads`` an H100 SM holds by registers alone: 65536 a
    SM, allocated 256 a warp, at most 64 warps and 32 blocks."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = min(64, 65536 // per_warp)
    return min(32, warps // (threads // 32))


def record_cases(method, dev):
    """``ab_record_bitwise``'s cases of ``method`` on Lorenz: ``[(label, B,
    rec_cap, kernel args, t_grid)]``, the main path's (B=16384,
    ``rec_cap=1024``, its span and options) and chip_smoke.py's check
    (B=4096, ``rec_cap=37``) without and with a 9-point grid."""
    from chip_smoke import (CHECK_B, LORENZ_B, REC_CAP_CHECK, RECORD_CONFIGS,
                            solve_args, lorenz_y0)

    _, tf_check, tf_main, (rtol, atol), opts = next(
        c for c in RECORD_CONFIGS if c[0] == method)
    first = opts.get("first_step")
    main = solve_args(torch.as_tensor(lorenz_y0(LORENZ_B, seed=8),
                                              device=dev),
                              tf_main, rtol, atol, first, dev)
    check = solve_args(torch.as_tensor(lorenz_y0(CHECK_B, seed=6),
                                               device=dev),
                               tf_check, rtol, atol, first, dev)
    grid = torch.broadcast_to(torch.linspace(
        0.0, tf_check * 0.99, 9, dtype=torch.float64, device=dev), (CHECK_B, 9))
    return [(f"main_path_tf{tf_main:g}", LORENZ_B, 1024, main, None),
            (f"chunked_tf{tf_check:g}", CHECK_B, REC_CAP_CHECK, check, None),
            (f"chunked_samples_tf{tf_check:g}", CHECK_B, REC_CAP_CHECK, check,
             grid)]


def record_lanes_differing(new, old, new_carry, old_carry):
    """{field: lanes on which it differs} over a RecordResult's fields and
    the lane carry (NaN equal to NaN; a field of another shape differs on
    every lane)."""
    pairs = [(f, getattr(new, f), getattr(old, f))
             for f in new._fields if f != "chunks"]
    pairs += [(f"carry_{f}", new_carry[f], old_carry[f]) for f in new_carry]
    diff = {"chunks": int(new.chunks != old.chunks)}
    for f, x, y in pairs:
        if x is None and y is None:
            continue
        B = x.shape[0]
        if x.shape != y.shape:
            diff[f] = B
            continue
        ne = x != y
        if x.is_floating_point():
            ne &= ~(torch.isnan(x) & torch.isnan(y))
        diff[f] = int(ne.reshape(B, -1).any(dim=1).sum())
    return diff


def ab_record(build, rhs, dev, baseline, label):
    """The record-mode instantiations built from ``baseline`` against the
    package's: ``ab_record_bitwise`` on every ``record_cases`` case, then
    ``ab_record`` turns of one launch of each main path's solve at each of
    AB_RECORD and an ``ab_record_summary`` line per kernel and B."""
    from chip_smoke import LORENZ_B, RECORD_CONFIGS, solve_args
    from chip_smoke import lorenz_y0
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import erk_record as R

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        futs = {m: ex.submit(build.build, src_dir=baseline,
                             name=K.KERNELS[m][1]) for m in K.KERNELS}
        old = {m: build.load(f.result()) for m, f in futs.items()}
    # A baseline with staged stores (a variant) reports its staging too.
    old_staged = {m: hasattr(old[m], f"ivp_{K.KERNELS[m][0]}"
                             "_record_layout_lorenz") for m in K.KERNELS}
    regs = {}
    for side, src in (("new", build.SRC_DIR), ("old", baseline)):
        for m in K.KERNELS:
            path = build.library_path(src, (), K.KERNELS[m][1])
            for fn, r, st, ld in build.ptxas_report(path):
                regs[(side, m, instantiation(fn))] = (r, st, ld)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for method in K.KERNELS:
        for case, B, cap, a, grid in record_cases(method, dev):
            for cont in (False, True):
                carry_new, carry_old = {}, {}
                new_out = R.record_launches(
                    method, rhs.lorenz, *a, (), 200_000, grid, None, cap,
                    cont, None, stream, carry_out=carry_new)
                old_out = R.record_launches(
                    method, rhs.lorenz, *a, (), 200_000, grid, None, cap,
                    cont, old[method], stream, carry_out=carry_old)
                torch.cuda.synchronize()
                diff = record_lanes_differing(new_out, old_out, carry_new,
                                              carry_old)
                line("ab_record_bitwise", old=label,
                     kernel=R.record_kernel(method, cont), case=case, B=B,
                     rec_cap=cap, chunks=new_out.chunks,
                     identical=all(v == 0 for v in diff.values()),
                     fields=len(diff), lanes_differing=repr(
                         {k: v for k, v in diff.items() if v}))
                del new_out, old_out, carry_new, carry_old
    for B, cap in AB_RECORD:
        y0 = torch.as_tensor(lorenz_y0(B, seed=8), device=dev)
        for method, _, tf, (rtol, atol), opts in RECORD_CONFIGS:
            a = solve_args(y0, tf, rtol, atol, opts.get("first_step"),
                                   dev)
            for cont in (False, True):
                run = {"new": R.RecordLaunch(
                    method, rhs.lorenz, *a, (), 200_000, None, None, cap, cont,
                    None, stream),
                    "old": R.RecordLaunch(
                    method, rhs.lorenz, *a, (), 200_000, None, None, cap, cont,
                    old[method], stream)}
                ms = {"old": [], "new": []}
                name = R.record_kernel(method, cont)
                for r in range(AB_ERK_ROUNDS):
                    for what in ("old", "new", "new", "old"):
                        ms[what].append(turn_ms(
                            lambda: run[what].launch(init=True)))
                        line("ab_record", old=label, kernel=name, B=B,
                             rec_cap=cap, round=r, what=what,
                             event_ms=round(ms[what][-1], 4))
                new = run["new"]
                new.launch(init=True)
                torch.cuda.synchronize()
                ab_record_summary(label, method, cont, new, ms, B, cap, regs,
                                  old[method] if old_staged[method]
                                  else None)
                del run, new
        del y0


def ab_record_summary(label, method, cont, new, ms, B, cap, regs, old_lib):
    """One line per record A/B: each side's median, the rounds the new
    side won, the rows of the launch, GB/s written (the unpadded rows, the
    work) and the share of ``record_bound`` of each side, registers and
    spills of each build's instantiation, and the new build's staging (and
    the old's, ``old_lib``, where it stages its rows too)."""
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import erk_record as R

    med = {w: float(np.median(v)) for w, v in ms.items()}
    pairs = zip(zip(ms["new"][::2], ms["new"][1::2]),
                zip(ms["old"][::2], ms["old"][1::2]))
    wins = sum(sum(n) < sum(o) for n, o in pairs)
    nstep, naccpt = new.ints[2], new.ints[3]
    rows = float(new.n_rec.double().sum())
    nbytes = 8.0 * R.record_width(method, 3, cont) * rows
    bound, by = R.record_bound(method, rhs.lorenz, nstep, naccpt, new.n_rec,
                               cont)
    inst = f"Lorenz/f32/lean/record{'_cont' if cont else ''}"
    r_new = regs.get(("new", method, inst), (None, None, None))
    r_old = regs.get(("old", method, inst), (None, None, None))
    lay = R.record_layout(method, rhs.lorenz, cont)
    line("ab_record_summary", old=label, kernel=R.record_kernel(method, cont),
         B=B, rec_cap=cap, old_ms=round(med["old"], 4),
         new_ms=round(med["new"], 4),
         new_over_old=round(med["new"] / med["old"], 4),
         rounds_new_won=f"{wins}/{AB_ERK_ROUNDS}", rows=int(rows),
         gbytes_written=round(nbytes / 1e9, 4),
         gbytes_per_s_old=round(nbytes / (med["old"] * 1e6), 1),
         gbytes_per_s_new=round(nbytes / (med["new"] * 1e6), 1),
         bound_ms=round(bound, 6), bound_by=by,
         bound_share_old=round(bound / med["old"], 4),
         bound_share_new=round(bound / med["new"], 4),
         registers_old=r_old[0], spill_old=r_old[1:],
         registers_new=r_new[0], spill_new=r_new[1:],
         blocks_per_sm_old_by_registers=(
             blocks_by_registers(r_old[0], lay["threads"])
             if r_old[0] else None),
         old_layout=(repr(R.record_layout(method, rhs.lorenz, cont,
                                          lib=old_lib))
                     if old_lib is not None else None),
         **lay)


def crossing_share(method, fun, a, ev, dev):
    """Where a solve's lanes cross, from a record-event run on the same
    inputs (steps records, ``rec_cap=1024``: the same steps as the lean
    solve's): ``{lane_share, warp_share, ...}``, the share of the lanes'
    advanced steps on which some event of the lane crosses, and of the
    warps' advanced-step iterations (32 consecutive lanes a warp, each warp
    iterating to its longest lane's rows) on which some lane of the warp
    crosses, the iterations a warp runs the rows and Brent at once.  A
    crossing's step is the row whose span holds its time (xold < t_ev <=
    t).  Rejected attempts are left out: the iteration of a lane's k-th
    step is k."""
    from ivp_tpu_torch.kernels import erk_record as R

    stream = torch.cuda.current_stream(dev).cuda_stream
    r = R.record_launches(method, fun, *a, (), 200_000, None, None, 1024,
                          False, None, stream, events=ev)
    B, S = r.rec_t.shape
    valid = torch.arange(S, device=dev)[None] < r.n_rec[:, None]
    ts = torch.where(valid, r.rec_t, torch.inf).contiguous()
    E, cap = r.events.t_events.shape[1:]
    tev = r.events.t_events.reshape(B, E * cap).contiguous()
    ok = (torch.arange(cap, device=dev)[None, None]
          < r.events.n_events[:, :, None]).reshape(B, E * cap)
    idx = torch.searchsorted(ts, tev).clamp(max=max(S - 1, 0))
    mark = torch.zeros((B, S + 1), dtype=torch.bool, device=dev)
    mark.scatter_(1, torch.where(ok, idx, S), True)
    mark = mark[:, :S]
    W = B // 32
    warp_mark = mark[:W * 32].reshape(W, 32, S).any(1)
    warp_rows = r.n_rec[:W * 32].reshape(W, 32).max(1).values
    out = dict(lane_share=float(mark.sum()) / float(r.n_rec.sum()),
               warp_share=float(warp_mark.sum()) / float(warp_rows.sum()),
               crossing_steps_per_lane=float(mark.sum()) / B,
               rows_per_lane=float(r.n_rec.double().mean()),
               warp_iterations_per_warp=float(warp_rows.double().mean()),
               warp_iterations_crossing_per_warp=float(warp_mark.sum()) / W)
    del r, ts, tev, mark, warp_mark
    return out


def events_phase(build, dev):
    """Each main-path event instantiation alone (chip_smoke.py's inputs:
    the ball from heights 2..20 with 8 restarts, the Lorenz section to t =
    20) at each of its EVENT_B lane counts: ``EVENT_ROUNDS`` turns, the
    bound by both counts (erk_ensemble.event_bound: rows on the steps the
    function needs them on, and on every accepted step), its share, warp efficiency,
    the event work a lane, Brent's evaluations a crossing and steps a
    crossing, and where the lanes cross (crossing_share); the Lorenz
    section's lean DOP853 solve over the same span beside it; then ptxas's
    registers and spills of every event instantiation."""
    from ivp_tpu_torch.events import SETS
    from ivp_tpu_torch.kernels import erk_ensemble as K

    for method, set_name, Bs in EVENT_B:
        for B in Bs:
            fun, a, ev = event_main_inputs(method, set_name, B, dev)
            run = lambda: K.erk_ensemble_cuda(method, fun, *a, (), 200_000,
                                              events=ev)
            out = run()
            torch.cuda.synchronize()
            ms = [turn_ms(run) for _ in range(EVENT_ROUNDS)]
            b_ms, b_by, every = K.event_bound(method, fun, SETS[set_name],
                                              out[4], out[5], out[9])
            fl, _ = K.event_work(method, fun, SETS[set_name], out[5], out[9])
            med = float(np.median(ms))
            crossings = float(out[9].n_events.double().sum())
            extra = {}
            if set_name == "section":
                lean = lambda: K.erk_ensemble_cuda(method, fun, *a, (),
                                                   200_000)
                lean()
                extra["lean_same_span_ms"] = float(np.median(
                    [turn_ms(lean) for _ in range(EVENT_ROUNDS)]))
            line("events", kernel=f"{K.KERNELS[method][0]}_ev", set=set_name,
                 B=B, turn_ms=[round(m, 4) for m in ms], median_ms=med,
                 bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / med,
                 bound_ms_rows_every_accept=every,
                 bound_share_rows_every_accept=every / med,
                 event_flops_share=fl / (fl + K.solve_flops(
                     method, fun, out[4], out[5],
                     dense_steps=K.crossing_steps(out[9]))),
                 mean_nstep=float(out[4].double().mean()),
                 warp_efficiency=float(out[4].double().sum())
                 / (32 * warp_attempts(out[4])),
                 mean_events=float(out[9].n_events.double().mean()),
                 mean_restarts=float(out[9].n_restarts.double().mean()),
                 brent_evals_per_lane=float(out[9].n_brent.double().mean()),
                 brent_evals_per_crossing=float(out[9].n_brent.double().sum())
                 / crossings,
                 attempts_per_crossing=float(out[4].double().sum())
                 / crossings,
                 statuses=repr(dict(Counter(out[2].cpu().tolist()))),
                 **extra)
            del out
            line("events_crossings", kernel=f"{K.KERNELS[method][0]}_ev",
                 set=set_name, B=B,
                 **crossing_share(method, fun, a, ev, dev))
            del a
    # The recording ball's kernel alone: one launch, the first chunk.
    import chip_smoke as cs
    from ivp_tpu_torch import events as E
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.events import EventArgs
    from ivp_tpu_torch.kernels import erk_record as R

    B, cap = EVENT_RECORD
    y0 = torch.as_tensor(cs.ball_y0(B), device=dev)
    a = cs.solve_args(y0, cs.BALL_TF, cs.BALL_TOL, cs.BALL_TOL, None, dev)
    ev = EventArgs((E.ground,), cs.BALL_CAP, cs.BALL_RESTARTS)
    r = R.RecordLaunch("DOPRI5", rhs.ball, *a, (), 200_000, None, None, cap,
                       True, None, torch.cuda.current_stream(dev).cuda_stream,
                       ev)
    run = lambda: r.launch(init=True)
    run()
    torch.cuda.synchronize()
    ms = [turn_ms(run) for _ in range(EVENT_ROUNDS)]
    rows = int(r.n_rec.sum())
    b_ms, b_by = R.record_bound("DOPRI5", rhs.ball, r.ints[2], r.ints[3],
                                r.n_rec, True, events=(SETS["ground"],
                                                       r.ev_out))
    med = float(np.median(ms))
    line("events_record", kernel="dopri5_record_cont_ev", set="ground", B=B,
         rec_cap=cap, turn_ms=[round(m, 4) for m in ms], median_ms=med,
         rows=rows, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / med,
         warp_efficiency=float(r.ints[2].double().sum())
         / (32 * warp_attempts(r.ints[2])))
    del r, a, y0
    for name in ERK_LIBS:
        path = build.library_path(name=name)
        for fn, regs, st, ld in build.ptxas_report(path):
            inst = instantiation(fn)
            if "/ev_" in inst:
                line("ptxas_events", library=name, instantiation=inst,
                     registers=regs, spill_stores=st, spill_loads=ld)


ENSEMBLE_FIELDS = ("t", "y", "status", "nfev", "nstep", "naccpt", "nrejct",
                   "y_samples", "n_samples")


def event_ab_cases(dev, B=None, caps=AB_EVENTS_CAPS):
    """The bit-for-bit cases of every event instantiation at ``B`` lanes:
    ``[(case, kernel, method, run)]``, ``run(lib, stream) -> {field:
    tensor}``
    every output, event buffer and (record modes) lane and event carry
    field of one solve through ``lib``'s entry (None: the package's) on
    ``stream``; on CPU tensors with stream 0 it runs a g++ build (the
    rehearsal).  For each method, chip_smoke.py's event checks: the ball
    (heights 2..20, t in [0, 8], 8 restarts; sampled with 2) and the Lorenz
    section on t in [0, 2] (every crossing; sampled with the third
    terminal), lean, sampled, and recorded in both record modes at each of
    ``caps`` rows a chunk; lean on the section: the third crossing
    terminal, both directions, 2 occurrences a lane (overflow), and a
    step budget that stops each lane after about 60% of its attempts
    (``AB_EVENTS_BUDGET``; ``method``: the kernel's); both sets recorded
    with samples (the first of ``caps``); and with the controller in
    double (every method but RK4): both sets lean, sampled, recorded and
    recorded with samples."""
    import chip_smoke as cs
    from ivp_tpu_torch import events as E
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.events import EventArgs
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.methods.erk import make_engine

    B = AB_EVENTS_B if B is None else B
    T = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    yb, yl = T(cs.ball_y0(B)), T(cs.lorenz_y0(B, seed=11))
    grids = {"ground": torch.broadcast_to(
        T(np.linspace(0.0, cs.BALL_CHECK_TF, 31)), (B, 31)),
        "section": torch.broadcast_to(
        T(np.linspace(0.0, cs.EVENT_CHECK_TF, 21)), (B, 21))}
    sec = E.lorenz_section

    def lean(method, fun, a, ev, grid=None, max_steps=200_000, params=None):
        def run(lib, stream):
            out = K.ensemble_launch(method, fun, *a, (), max_steps, grid,
                                    params, lib, stream, ev)
            return {**dict(zip(ENSEMBLE_FIELDS, out[:9])),
                    **out[9]._asdict()}
        return run

    def record(method, fun, a, ev, cap, cont, grid=None, params=None):
        def run(lib, stream):
            carry = {}
            r = R.record_launches(method, fun, *a, (), 200_000, grid, params,
                                  cap, cont, lib, stream, carry_out=carry,
                                  events=ev)
            out = {f: getattr(r, f) for f in r._fields
                   if f not in ("events", "chunks")}
            out.update(r.events._asdict())
            out.update({f"carry_{k}": v for k, v in carry.items()})
            out["chunks"] = torch.full((B,), r.chunks, device=dev)
            return out
        return run

    out = []
    for method, (rtol, atol, h) in cs.EVENT_LORENZ.items():
        kern = K.KERNELS[method][0]
        ab = cs.solve_args(yb, cs.BALL_CHECK_TF, cs.BALL_TOL, cs.BALL_TOL,
                           cs.RK4_BALL_STEP if method == "RK4" else None, dev)
        al = cs.solve_args(yl, cs.EVENT_CHECK_TF, rtol, atol, h, dev)
        full = EventArgs((E.ground,), cs.BALL_CAP, cs.BALL_RESTARTS)
        every = EventArgs((sec,), cs.SECTION_CAP, 0)
        cases = [
            ("ground_lean", f"{kern}_ev", lean(method, rhs.ball, ab, full)),
            ("ground_sampled", f"{kern}_ev", lean(
                method, rhs.ball, ab, EventArgs((E.ground,), cs.BALL_CAP, 2),
                grids["ground"])),
            ("section_lean", f"{kern}_ev", lean(method, rhs.lorenz, al,
                                                every)),
            ("section_terminal3", f"{kern}_ev", lean(
                method, rhs.lorenz, al,
                EventArgs((sec.replace(terminal=3),), cs.SECTION_CAP, 0))),
            ("section_both_directions", f"{kern}_ev", lean(
                method, rhs.lorenz, al,
                EventArgs((sec.replace(direction=0),), cs.SECTION_CAP, 0))),
            ("section_cap2", f"{kern}_ev", lean(
                method, rhs.lorenz, al, EventArgs((sec,), 2, 0))),
            ("section_budget", f"{kern}_ev", lean(
                method, rhs.lorenz, al, every,
                max_steps=AB_EVENTS_BUDGET[method])),
            ("section_sampled", f"{kern}_ev", lean(
                method, rhs.lorenz, al,
                EventArgs((sec.replace(terminal=3),), cs.SECTION_CAP, 0),
                grids["section"]))]
        for cap in caps:
            for cont in (False, True):
                name = R.record_kernel(method, cont, True)
                cases += [(f"ground_record_cap{cap}", name,
                         record(method, rhs.ball, ab, full, cap, cont)),
                        (f"section_record_cap{cap}", name,
                         record(method, rhs.lorenz, al, every, cap, cont))]
        # The sampled record modes, and the controller in double (every
        # mode but RK4's, which has none).
        states = [("", None)] + ([] if method == "RK4" else [(
            "_state", make_engine(method, True,
                                  controller_precision="state")[1])])
        for tag, params in states:
            cap = caps[0]
            if params is not None:
                cases += [
                    (f"ground_lean{tag}", f"{kern}_ev",
                     lean(method, rhs.ball, ab, full, params=params)),
                    (f"ground_sampled{tag}", f"{kern}_ev", lean(
                        method, rhs.ball, ab,
                        EventArgs((E.ground,), cs.BALL_CAP, 2),
                        grids["ground"], params=params)),
                    (f"section_lean{tag}", f"{kern}_ev",
                     lean(method, rhs.lorenz, al, every, params=params)),
                    (f"section_sampled{tag}", f"{kern}_ev", lean(
                        method, rhs.lorenz, al,
                        EventArgs((sec.replace(terminal=3),), cs.SECTION_CAP,
                                  0), grids["section"], params=params))]
            for cont in (False, True):
                name = R.record_kernel(method, cont, True)
                if params is not None:
                    cases += [(f"ground_record{tag}_cap{cap}", name, record(
                        method, rhs.ball, ab, full, cap, cont, params=params)),
                        (f"section_record{tag}_cap{cap}", name, record(
                            method, rhs.lorenz, al, every, cap, cont,
                            params=params))]
                cases += [(f"ground_sampled_record{tag}_cap{cap}", name,
                           record(method, rhs.ball, ab, full, cap, cont,
                                  grids["ground"], params)),
                          (f"section_sampled_record{tag}_cap{cap}", name,
                           record(method, rhs.lorenz, al, every, cap, cont,
                                  grids["section"], params))]
        out += [(case, kernel, method, run) for case, kernel, run in cases]
    return out


def event_main_inputs(method, set_name, B, dev):
    """``(fun, kernel args, EventArgs)`` of a main-path event solve at B
    lanes (chip_smoke.py's inputs): the ball from heights 2..20 to t = 15
    with 8 restarts, the Lorenz section to t = 20."""
    import chip_smoke as cs
    from ivp_tpu_torch import events as E
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.events import EventArgs

    if set_name == "ground":
        y0 = torch.as_tensor(cs.ball_y0(B), device=dev)
        return rhs.ball, cs.solve_args(y0, cs.BALL_TF, cs.BALL_TOL,
                                       cs.BALL_TOL, None, dev), EventArgs(
            (E.ground,), cs.BALL_CAP, cs.BALL_RESTARTS)
    y0 = torch.as_tensor(cs.lorenz_y0(B, seed=9), device=dev)
    return rhs.lorenz, cs.solve_args(y0, cs.SECTION_TF, *cs.LORENZ_TOL, None,
                                     dev), EventArgs(
        (E.lorenz_section,), cs.SECTION_CAP, 0)


def ab_events(build, dev, baseline, label, methods=None, variants=()):
    """The event instantiations built from ``baseline`` against the
    package's: ``ab_events_bitwise``, the lanes differing in every output,
    event buffer and carry field (bits; a NaN equals any NaN) of each
    ``event_ab_cases`` case and of each main path at its EVENT_B lanes;
    then ``ab_events``: ``AB_EVENTS_ROUNDS`` rounds of old, new, new, old
    ``turn_ms`` of each main path at each of its EVENT_B and each side's
    kernel alone by torch.profiler (old, new, new, old: ``kernel_ms``), with
    the bound by both counts (erk_ensemble.event_bound) and each side's
    share, and both sides' registers and spills of every event
    instantiation; then the recording ball (``ab_events_record``: one
    launch of EVENT_RECORD alone with record_bound's share, and the solve
    end to end, kernel and drain, in the same turns).  ``methods``: the
    methods held (default all); ``variants``: ``-D`` define tuples of
    builds of the package's sources of those methods, each held and timed
    against ``baseline`` as the package is (labelled ``new:<defines>``)."""
    from ivp_tpu_torch.events import SETS
    from ivp_tpu_torch.kernels import erk_ensemble as K

    methods = list(K.KERNELS) if methods is None else methods
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(
            len(methods) * (1 + len(variants))) as ex:
        futs = {m: ex.submit(build.build, src_dir=baseline,
                             name=K.KERNELS[m][1]) for m in methods}
        vfuts = {(v, m): ex.submit(build.build, defines=v,
                                   name=K.KERNELS[m][1])
                 for v in variants for m in methods}
        paths = {m: f.result() for m, f in futs.items()}
        vlibs = {}
        for (v, m), f in vfuts.items():
            vlibs.setdefault("new:" + "+".join(v), {})[m] = build.load(
                f.result())
    old = {m: build.load(p) for m, p in paths.items()}
    line("ab_events_build", old=label,
         seconds=round(time.perf_counter() - t0, 3))
    for side, src in (("new", build.SRC_DIR), (label, baseline)):
        for m in methods:
            p = build.library_path(src, (), K.KERNELS[m][1])
            for fn, regs, st, ld in build.ptxas_report(p):
                inst = instantiation(fn)
                if "/ev_" in inst:
                    line("ab_events_ptxas", side=side, library=p.name,
                         instantiation=inst, registers=regs,
                         spill_stores=st, spill_loads=ld)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for case, kernel, m, run in event_ab_cases(dev):
        if m not in methods:
            continue
        ref = run(old[m], stream)
        sides = [("new", None)] + [(v, libs[m]) for v, libs in
                                   vlibs.items()]
        for side, lib in sides:
            new = run(lib, stream)
            torch.cuda.synchronize()
            diff = fields_lanes_differing(new, ref)
            line("ab_events_bitwise", old=label, new=side, kernel=kernel,
                 case=case, B=int(new["t"].shape[0]),
                 identical=not any(diff.values()), fields=len(diff),
                 lanes_differing=repr({k: v for k, v in diff.items() if v}),
                 mean_events=float(new["n_events"].double().mean()))
            del new
        del ref
    for method, set_name, Bs in EVENT_B:
        if method not in methods:
            continue
        for B in Bs:
            fun, a, ev = event_main_inputs(method, set_name, B, dev)
            mk = lambda lib: (lambda: K.erk_ensemble_cuda(
                method, fun, *a, (), 200_000, lib=lib, events=ev))
            news = {"new": mk(None)}
            news.update({v: mk(libs[method]) for v, libs in vlibs.items()})
            ref = mk(old[method])()
            for side, new_run in news.items():
                outs = {"new": new_run(), "old": ref}
                torch.cuda.synchronize()
                diff = fields_lanes_differing(
                    *({**dict(zip(ENSEMBLE_FIELDS, o[:9])), **o[9]._asdict()}
                      for o in (outs["new"], outs["old"])))
                line("ab_events_bitwise", old=label, new=side,
                     kernel=f"{K.KERNELS[method][0]}_ev",
                     case=f"{set_name}_main", B=B,
                     identical=not any(diff.values()), fields=len(diff),
                     lanes_differing=repr({k: v for k, v in diff.items()
                                           if v}),
                     mean_events=float(outs["new"][9].n_events.double()
                                       .mean()))
                out = outs["new"]
                del outs
                run = {"new": new_run, "old": mk(old[method])}
                ms = {"old": [], "new": []}
                for r in range(AB_EVENTS_ROUNDS):
                    for what in ("old", "new", "new", "old"):
                        ms[what].append(turn_ms(run[what]))
                med = {w: float(np.median(v)) for w, v in ms.items()}
                prof = {"old": [], "new": []}
                for what in ("old", "new", "new", "old"):
                    prof[what].append(kernel_ms(run[what]))
                pairs = zip(zip(ms["new"][::2], ms["new"][1::2]),
                            zip(ms["old"][::2], ms["old"][1::2]))
                b_ms, b_by, every = K.event_bound(method, fun,
                                                  SETS[set_name], out[4],
                                                  out[5], out[9])
                line("ab_events", old=label, new=side,
                     kernel=f"{K.KERNELS[method][0]}_ev",
                     set=set_name, B=B,
                     old_ms=[round(x, 4) for x in ms["old"]],
                     new_ms=[round(x, 4) for x in ms["new"]],
                     old_median=round(med["old"], 4),
                     new_median=round(med["new"], 4),
                     new_over_old=round(med["new"] / med["old"], 4),
                     rounds_new_won=f"{sum(sum(n) < sum(o) for n, o in pairs)}"
                                    f"/{AB_EVENTS_ROUNDS}",
                     profiler_kernel_ms_old=[round(x, 4) for x in prof["old"]],
                     profiler_kernel_ms_new=[round(x, 4) for x in prof["new"]],
                     bound_ms=round(b_ms, 6), bound_by=b_by,
                     share_new=round(b_ms / med["new"], 4),
                     share_old=round(b_ms / med["old"], 4),
                     bound_ms_rows_every_accept=round(every, 6),
                     share_new_rows_every_accept=round(every / med["new"], 4),
                     warp_efficiency=round(float(out[4].double().sum())
                                           / (32 * warp_attempts(out[4])), 5))
                del out
            del ref, a
    if "DOPRI5" in methods:
        ab_events_record(dev, old["DOPRI5"], label)
        for v, libs in vlibs.items():
            ab_events_record(dev, old["DOPRI5"], label, libs["DOPRI5"], v)


def written_rows(r):
    """A RecordLaunch's rows as the launch wrote them: each lane's first
    n_rec rows over the row's width (the pad and the rows past n_rec are
    never written, NaN here)."""
    W = 3 + r.n + r.C * r.n
    valid = (torch.arange(r.cap, device=r.rows.device)[None]
             < r.n_rec[:, None])
    return torch.where(valid[:, :, None], r.rows[:, :, :W], float("nan"))


def ab_events_record(dev, old_lib, label, new_lib=None, new_label="new"):
    """The recording ball (chip_smoke.py's inputs, EVENT_RECORD's B and
    rec_cap, ``dopri5_record_cont_ev``) through the package's build and
    ``old_lib``: one launch alone (the first chunk, from y0) and the solve
    end to end (every chunk's launch and the drain,
    erk_record.record_launches), each held bit for bit (every output, row,
    event buffer and carry field) and timed in ``AB_EVENTS_ROUNDS`` rounds
    of old, new, new, old ``turn_ms``; the launch's share of record_bound
    and its kernel by torch.profiler."""
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.events import SETS
    from ivp_tpu_torch.kernels import erk_record as R

    B, cap = EVENT_RECORD
    fun, a, ev = event_main_inputs("DOPRI5", "ground", B, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = {w: R.RecordLaunch("DOPRI5", fun, *a, (), 200_000, None, None,
                                  cap, True, lib, stream, ev)
                for w, lib in (("new", new_lib), ("old", old_lib))}

    def solve(lib):
        carry = {}
        r = R.record_launches("DOPRI5", fun, *a, (), 200_000, None, None,
                              cap, True, lib, stream, carry_out=carry,
                              events=ev)
        out = {f: getattr(r, f) for f in r._fields
               if f not in ("events", "chunks")}
        out.update(r.events._asdict())
        out.update({f"carry_{k}": v for k, v in carry.items()})
        out["chunks"] = torch.full((B,), r.chunks, device=dev)
        return out

    for w in launches:
        launches[w].launch(init=True)
    torch.cuda.synchronize()
    one = {w: {**dict(zip(ENSEMBLE_FIELDS, r.last())), **r.ev_out._asdict(),
               "rows": written_rows(r), "n_rec": r.n_rec}
           for w, r in launches.items()}
    diff = fields_lanes_differing(one["new"], one["old"])
    line("ab_events_bitwise", old=label, new=new_label,
         kernel="dopri5_record_cont_ev", case="ground_record_main_launch",
         B=B, identical=not any(diff.values()), fields=len(diff),
         lanes_differing=repr({k: v for k, v in diff.items() if v}))
    full = {"new": solve(new_lib), "old": solve(old_lib)}
    torch.cuda.synchronize()
    diff = fields_lanes_differing(full["new"], full["old"])
    line("ab_events_bitwise", old=label, new=new_label,
         kernel="dopri5_record_cont_ev", case="ground_record_main_solve",
         B=B, identical=not any(diff.values()), fields=len(diff),
         lanes_differing=repr({k: v for k, v in diff.items() if v}),
         chunks=int(full["new"]["chunks"][0]))
    r = launches["new"]
    b_ms, b_by = R.record_bound("DOPRI5", rhs.ball, r.ints[2], r.ints[3],
                                r.n_rec, True,
                                events=(SETS["ground"], r.ev_out))
    del one, full
    runs = {"launch": {w: (lambda r=r: r.launch(init=True))
                       for w, r in launches.items()},
            "solve": {"new": lambda: solve(new_lib),
                      "old": lambda: solve(old_lib)}}
    for what, run in runs.items():
        ms = {"old": [], "new": []}
        for _ in range(AB_EVENTS_ROUNDS):
            for w in ("old", "new", "new", "old"):
                ms[w].append(turn_ms(run[w]))
        med = {w: float(np.median(v)) for w, v in ms.items()}
        pairs = zip(zip(ms["new"][::2], ms["new"][1::2]),
                    zip(ms["old"][::2], ms["old"][1::2]))
        extra = {}
        if what == "launch":
            extra = dict(
                profiler_kernel_ms_old=round(kernel_ms(run["old"]), 4),
                profiler_kernel_ms_new=round(kernel_ms(run["new"]), 4),
                bound_ms=round(b_ms, 6), bound_by=b_by,
                share_new=round(b_ms / med["new"], 4),
                share_old=round(b_ms / med["old"], 4),
                rows=int(r.n_rec.sum()))
        line("ab_events_record", old=label, new=new_label,
             kernel="dopri5_record_cont_ev",
             what=what, B=B, rec_cap=cap,
             old_ms=[round(x, 4) for x in ms["old"]],
             new_ms=[round(x, 4) for x in ms["new"]],
             old_median=round(med["old"], 4), new_median=round(med["new"], 4),
             new_over_old=round(med["new"] / med["old"], 4),
             rounds_new_won=f"{sum(sum(n) < sum(o) for n, o in pairs)}"
                            f"/{AB_EVENTS_ROUNDS}", **extra)


def fields_lanes_differing(new, old):
    """{field: lanes on which it differs} of two dicts of per-lane tensors
    (carry_lanes_differing's bits; a field of another shape differs on
    every lane, None equals None)."""
    diff = {}
    for f, x in new.items():
        y = old[f]
        if x is None or y is None:
            diff[f] = 0 if x is None and y is None else -1
        elif x.shape != y.shape:
            diff[f] = x.shape[0]
        else:
            diff.update(carry_lanes_differing({f: x}, {f: y}))
    return diff


def stiff_phase(build, dev):
    """Each stiff kernel alone on the stiff main path's inputs (see the
    module docstring)."""
    import chip_smoke as cs
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    libs = {m: build.build(name=m) for m in ("radau", "bdf")}
    for method in ("RADAU", "BDF"):
        for cp in ("float32", "state"):
            spec = stiff_spec(method, 2, None, {"controller_precision": cp})
            p = spec.params()
            for B in STIFF_B:
                y0 = torch.as_tensor(cs.stiff_y0(B), device=dev)
                a = cs.solve_args(y0, cs.STIFF_TF, *cs.STIFF_TOL, None, dev)
                hmin = torch.zeros(B, dtype=torch.float64, device=dev)
                run = lambda: S.stiff_ensemble_cuda(
                    method, rhs.vdp, *a, (cs.STIFF_MU,), 100000, p, hmin)
                c = run()
                torch.cuda.synchronize()
                ms = [turn_ms(run) for _ in range(STIFF_ROUNDS)]
                med = float(np.median(ms))
                b_ms, b_by = S.stiff_bound(method, rhs.vdp, c.nstep, c.naccpt,
                                           c.nrejct, c.nfev, c.njev, c.nlu)
                mean = lambda x: float(x.double().mean())
                line("stiff", kernel=method.lower(), controller=cp, B=B,
                     turn_ms=[round(m, 4) for m in ms], median_ms=med,
                     bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / med,
                     warp_efficiency=float(c.nstep.double().sum())
                     / (32 * warp_attempts(c.nstep)),
                     mean_nstep=mean(c.nstep), max_nstep=int(c.nstep.max()),
                     mean_nfev=mean(c.nfev), mean_njev=mean(c.njev),
                     mean_nlu=mean(c.nlu),
                     statuses=repr(dict(Counter(c.status.cpu().tolist()))))
                del c, a, y0
    stiff_ptxas("new", libs)
    for method in ("RADAU", "BDF"):
        for fun in (rhs.vdp, rhs.decay, rhs.robertson):
            for cp in ("float32", "state"):
                for B in STIFF_B:
                    line("stiff_layout", kernel=method.lower(), rhs=fun.name,
                         controller=cp, B=B, **S.layout(method, fun, cp, B))
    for name, path in libs.items():
        stiff_sass_report(path, "new")
    resume_alone(build, dev)


def resume_alone(build, dev):
    """The explicit resumable mode alone on chip_smoke.py's resumable cases
    (B=16384): from a started carry, one launch with no budget, the
    kernel's device ms by torch.profiler (``kernel_ms``, in
    ``STIFF_ROUNDS`` rounds), with the bound, warp efficiency and ptxas's
    registers of the resumable instantiations."""
    import chip_smoke as cs
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.batch import _solver_params
    from ivp_tpu_torch.core.driver import run_args
    from ivp_tpu_torch.kernels import erk_ensemble as K
    from ivp_tpu_torch.kernels import resumable as RES
    from ivp_tpu_torch.kernels import stiff_ensemble as S

    for method, fname, tf, rt, at in cs.RESUME_CASES:
        fun = getattr(rhs, fname)
        B = cs.RESUME_B
        y0 = torch.as_tensor(cs.lorenz_y0(B) if fun.n == 3 else
                             cs.vdp_y0(B), device=dev)
        a = cs.solve_args(y0, tf, rt, at, None, dev)
        ra = run_args(a[2], a[5], a[6], tf, 0.0, 100_000, y0)
        p = _solver_params(method, fun.n, None, None, False)
        start, resume = card_route(RES, method, fun, (), p)
        c0 = start(y0, a[1], None, ra)
        run = lambda: resume(c0, ra, S.UNBOUNDED)
        c = run()
        torch.cuda.synchronize()
        ms = [kernel_ms(run) for _ in range(STIFF_ROUNDS)]
        med = float(np.median(ms))
        b_ms, b_by = K.solve_bound(method, fun, c.nstep, c.naccpt)
        line("resume", kernel=f"{K.KERNELS[method][0].replace('_sampled', '')}"
             "_resume", rhs=fname, B=B, tf=tf,
             profiler_ms=[round(m, 4) for m in ms], median_ms=med,
             bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / med,
             warp_efficiency=float(c.nstep.double().sum())
             / (32 * warp_attempts(c.nstep)),
             mean_nstep=float(c.nstep.double().mean()))
        del c, c0, y0
    for name in ERK_LIBS:
        for fn, regs, st, ld in build.ptxas_report(
                build.library_path(name=name)):
            inst = instantiation(fn)
            if inst.endswith("/resume"):
                line("ptxas_resume", library=name, instantiation=inst,
                     registers=regs, spill_stores=st, spill_loads=ld)


# resume_profile: the chunked solves timed unprofiled (CUDA events, the
# median of these after a warm-up) besides the one profiled.
RESUME_PROFILE_ROUNDS = 3
# The wrapper functions whose host time resume_profile names, where a tree
# has them: (module, attribute, part).
RESUME_PARTS = (
    ("stiff_ensemble", "clone_carry", "clone"),
    ("erk_ensemble", "check_inputs", "checks"),
    ("stiff_ensemble", "_check", "checks"),
    ("resumable", "_direction_t0", "args"),
    ("resumable", "stiff_in", "conversions"),
)


def _part_wrappers(side):
    """Wrap ``RESUME_PARTS`` of ``side``'s modules (``side_modules``; and
    every RHS's ``kernel_args`` as "args", and each C entry ``build.entry``
    hands out as "ctypes") in torch.profiler ranges named
    ``part:<part>``; returns the undo."""
    from torch.profiler import record_function

    rhs, build = side.rhs, side.build
    mods = {"erk_ensemble": side.E, "resumable": side.RES,
            "stiff_ensemble": side.S}
    undo = []

    def wrap(owner, attr, part):
        fn = getattr(owner, attr, None)
        if fn is None:
            return

        def ranged(*a, **kw):
            with record_function(f"part:{part}"):
                return fn(*a, **kw)
        setattr(owner, attr, ranged)
        undo.append((owner, attr, fn))

    for mod, attr, part in RESUME_PARTS:
        wrap(mods[mod], attr, part)
    wrap(rhs.CudaRHS, "kernel_args", "args")
    entry = build.entry

    def ranged_entry(*a, **kw):
        fn = entry(*a, **kw)

        def call(*args):
            with record_function("part:ctypes"):
                return fn(*args)
        return call
    build.entry = ranged_entry
    undo.append((build, "entry", entry))

    def restore():
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)
    return restore


def _resume_events(prof, match):
    """From one profiled chunked solve: ``(host, kernels)``: ``host`` the
    µs of each top-level range (``start``, ``resume``, ``sync``,
    ``extract``) and, under ``start`` and ``resume``, of each direct child
    (a ``part:`` range or an aten op) and of the rest ("python": the range
    less its children), summed over the calls; ``kernels`` the device
    ``(start µs, µs)`` of each kernel whose name holds ``match``, in
    order."""
    from torch.autograd import DeviceType

    host, kernels = Counter(), []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            if match in ev.name:
                kernels.append((ev.time_range.start,
                                ev.time_range.elapsed_us()))
            continue
        if ev.name in ("start", "resume", "sync", "extract"):
            host[ev.name] += ev.cpu_time_total
            host[f"n_{ev.name}"] += 1
            if ev.name not in ("start", "resume"):
                continue
            inner = 0.0
            for ch in ev.cpu_children:
                key = ch.name[5:] if ch.name.startswith("part:") else ch.name
                host[f"{ev.name}/{key}"] += ch.cpu_time_total
                inner += ch.cpu_time_total
            host[f"{ev.name}/python"] += ev.cpu_time_total - inner
    return host, sorted(kernels)


def resume_profile(dev, side=None, label="new"):
    """A chunked solve's time, split (``side``: an older tree's modules,
    ``side_modules``; default this tree's): each of chip_smoke.py's
    ``RESUME_CASES`` (B=16384, chunk 256) and bench.py's stiff row (Radau
    and BDF, B=131072, chunk 4096) solved through
    ``build_resumable_solver``'s start / resume until ``carry.done.all()``
    / extract.  One line a solve (``resume_profile``): launches, solve ms
    (CUDA events, the median of ``RESUME_PROFILE_ROUNDS`` after a warm-up),
    host µs of a ``start``, a ``resume`` and an ``extract`` (perf_counter
    around the call, unprofiled), then from one solve under torch.profiler
    (CPU and CUDA): each kernel's device ms (the init launch, then each
    chunk), their sum, the device's idle µs between consecutive kernels,
    and the host µs of ``start`` and ``resume`` (each split by part: the
    wrapper functions of ``RESUME_PARTS``, the ctypes call and each
    top-level aten op), the ``done`` syncs and ``extract``.  Then, where
    the tree has it (an older resumable tier cloned the carry given), the
    host µs of one ``clone_carry`` of a stiff carry at B=131072."""
    import chip_smoke as cs
    from torch.profiler import record_function

    from ivp_tpu_torch.kernels import erk_ensemble as K

    side = side or side_modules()
    rhs, S = side.rhs, side.S
    cases = [(method, getattr(rhs, fname), (), tf, (rt, at), cs.RESUME_B,
              cs.RESUME_CHUNK, "erk_kernel",
              f"{K.KERNELS[method][0].replace('_sampled', '')}_resume")
             for method, fname, tf, rt, at in cs.RESUME_CASES]
    cases += [(m, rhs.vdp, (cs.STIFF_MU,), cs.STIFF_TF, cs.STIFF_TOL,
               cs.STIFF_B, cs.STIFF_CHUNK, f"{m.lower()}_kernel", m.lower())
              for m in ("RADAU", "BDF")]
    for method, fun, args, tf, tol, B, chunk, match, name in cases:
        if fun is rhs.vdp and not args:
            y0 = torch.as_tensor(cs.vdp_y0(B), device=dev)
        elif fun is rhs.vdp:
            y0 = torch.as_tensor(cs.stiff_y0(B), device=dev)
        else:
            y0 = torch.as_tensor(cs.lorenz_y0(B), device=dev)
        start, resume, extract = side.batch.build_resumable_solver(
            fun, method, n=fun.n, args=args, chunk_steps=chunk)
        host_us = {"start": [], "resume": [], "extract": []}

        def solve(ranged=False, timed=False):
            def rng(label):
                return record_function(label) if ranged else \
                    contextlib.nullcontext()

            def clock(label, t):
                if timed:
                    host_us[label].append(1e6 * (time.perf_counter() - t))
            t = time.perf_counter()
            with rng("start"):
                carry, ra = start(y0, 0.0, tf, *tol)
            clock("start", t)
            launches = 1
            while True:
                with rng("sync"):
                    if bool(carry.done.all()):
                        break
                t = time.perf_counter()
                with rng("resume"):
                    carry = resume(carry, ra)
                clock("resume", t)
                launches += 1
            t = time.perf_counter()
            with rng("extract"):
                out = extract(carry)
            clock("extract", t)
            return out, launches

        solve()
        torch.cuda.synchronize()
        ms = []
        for _ in range(RESUME_PROFILE_ROUNDS):
            (res, launches), m_, _ = timed(lambda: solve(timed=True))
            ms.append(m_)
            del res
        restore = _part_wrappers(side)
        try:
            solve()   # the entries handed out again, wrapped
            torch.cuda.synchronize()
            with cs.settled_profile() as prof:
                solve(ranged=True)
                torch.cuda.synchronize()
        finally:
            restore()
        host, kern = _resume_events(prof, match)
        # The start's host time by function (cProfile over a few starts,
        # the card unprofiled): each function's own µs a start.
        pr = cProfile.Profile()
        starts = 10
        for _ in range(starts):
            pr.enable()
            start(y0, 0.0, tf, *tol)
            pr.disable()
            torch.cuda.synchronize()
        st = pstats.Stats(pr).stats
        top = sorted(((v[2], k) for k, v in st.items()), reverse=True)[:16]
        line("resume_profile_start", tree=label, kernel=name, B=B,
             own_us_per_start={f"{Path(k[0]).name}:{k[1]}:{k[2]}":
                               round(1e6 * t / starts, 1) for t, k in top})
        gaps = [b[0] - (a[0] + a[1]) for a, b in zip(kern, kern[1:])]
        n_res = max(1, host["n_resume"])
        line("resume_profile", tree=label, kernel=name, B=B, chunk=chunk,
             launches=launches, solve_ms=[round(x, 4) for x in ms],
             solve_median_ms=round(float(np.median(ms)), 4),
             host_us={k: round(float(np.mean(v)), 1) if v else None
                      for k, v in host_us.items()},
             kernel_ms=round(1e-3 * sum(d for _, d in kern), 4),
             kernel_ms_each=[round(1e-3 * d, 4) for _, d in kern],
             idle_us_between=[round(g, 1) for g in gaps],
             profiled_host_us={k: round(v, 1) for k, v in sorted(host.items())
                               if "/" not in k and not k.startswith("n_")},
             profiled_start_us={
                 k[6:]: round(v, 1) for k, v in sorted(
                     host.items(), key=lambda kv: -kv[1])
                 if k.startswith("start/")},
             profiled_resume_us_per_call={
                 k[7:]: round(v / n_res, 1) for k, v in sorted(
                     host.items(), key=lambda kv: -kv[1])
                 if k.startswith("resume/")},
             resumes=host["n_resume"], syncs=host["n_sync"])
        if hasattr(S, "clone_carry") and B == cs.STIFF_B:
            carry, _ = start(y0, 0.0, tf, *tol)
            torch.cuda.synchronize()
            us, dev_ms = [], []
            for _ in range(10):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t = time.perf_counter()
                e0.record()
                c2 = S.clone_carry(carry)
                e1.record()
                us.append(1e6 * (time.perf_counter() - t))
                torch.cuda.synchronize()
                dev_ms.append(e0.elapsed_time(e1))
                del c2
            nbytes = sum(x.numel() * x.element_size() for x in
                         torch.utils._pytree.tree_leaves(carry)
                         if torch.is_tensor(x))
            line("resume_profile_clone", tree=label, kernel=name, B=B,
                 host_us=[round(x, 1) for x in us],
                 host_us_median=round(float(np.median(us)), 1),
                 device_ms_median=round(float(np.median(dev_ms)), 4),
                 bytes=nbytes)
            del carry
        del y0


STIFF_FIELDS = ("t", "y", "status", "done", "nfev", "njev", "nlu", "nstep",
                "naccpt", "nrejct")


def stiff_carry_fields(method, c):
    """{field: tensor} of a stiff carry: the driver's fields and every field
    of the method state the kernel reads and writes."""
    from ivp_tpu_torch.kernels import stiff_ensemble as S

    out = {f: getattr(c, f) for f in STIFF_FIELDS}
    out.update(S._ms_fields(method, c.ms))
    return out


def carry_lanes_differing(new, old):
    """{field: lanes on which its bits differ} of two carries' fields
    (stiff_carry_fields); a NaN equals any NaN, a signed zero only
    itself."""
    diff = {}
    for f, x in new.items():
        y = old[f]
        if x.is_floating_point():
            ints = torch.int64 if x.dtype == torch.float64 else torch.int32
            ne = x.view(ints) != y.view(ints)
            ne &= ~(torch.isnan(x) & torch.isnan(y))
        else:
            ne = x != y
        diff[f] = int(ne.reshape(x.shape[0], -1).any(dim=1).sum())
    return diff


def stiff_inputs(case, B, dev):
    """``(fun, solve arguments, RHS arguments)`` of ``B`` lanes of
    ``stiff_cases``'s "robertson" (over [0, 1e8]) or "decay" (per-lane
    rates, t0, spans, some backward, and per-component tolerances)."""
    import chip_smoke as cs
    from ivp_tpu_torch import rhs

    def T(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev).contiguous()

    if case == "robertson":
        return rhs.robertson, cs.solve_args(
            T(cs.robertson_y0(B)), cs.ROB_TF, 1e-6, 1e-6, None, dev), ()
    rng = np.random.default_rng(5)
    t0 = rng.uniform(-1.0, 1.0, B)
    dt = 5.0 * rng.uniform(0.5, 1.0, B)
    dt[1::4] *= -1.0
    dt[0] = 0.0
    a = (T(rng.uniform(0.5, 2.0, (B, 1))), T(t0), T(t0 + dt), T(np.abs(dt)),
         None, T(10.0 ** rng.uniform(-8, -4, (B, 1))),
         T(10.0 ** rng.uniform(-10, -6, (B, 1))))
    return rhs.decay, a, (T(rng.uniform(0.5, 50.0, B)),)


def stiff_cases(dev, sizes=AB_STIFF_B, stream=None):
    """The bit-for-bit cases of the stiff kernels: ``[(case, B, run)]``,
    ``run(method, controller, lib, side=None) -> (carry, launches)`` one
    solve through ``lib``'s kernel of ``method`` under ``controller``
    ("float32" or "state"), launched by ``side``'s modules (default this
    tree's; ``side_modules``) on ``stream`` (0: a g++ build on CPU
    tensors).  bench.py's stiff row (chip_smoke.py's stiff main path's
    inputs, one launch with no budget); Robertson and decay
    (``stiff_inputs``), each also at ``sizes``' "_wide" lanes; the singular
    retry (decay at rate -1 from a first step whose first
    decomposition is exactly singular, and a NaN rate, singular at every
    attempt, on alternate lanes); a max_steps-bounded launch on the stiff
    row; chip_smoke.py's ``vdp_limits`` lanes (first_step, max_step, t0 =
    1e6); and the stiff row resumably, chunk_steps 64."""
    import chip_smoke as cs
    from ivp_tpu_torch import rhs, tableaus
    from ivp_tpu_torch.core.driver import run_args
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    f64 = torch.float64

    def T(a):
        return torch.as_tensor(a, dtype=f64, device=dev).contiguous()

    def spec(method, n, cp):
        return stiff_spec(method, n, None, {"controller_precision": cp})

    def one(fun, a, args, max_steps=100000):
        def run(method, cp, lib, side=None):
            hmin = torch.zeros(a[0].shape[0], dtype=f64, device=dev)
            return (side or side_modules()).S.stiff_ensemble_cuda(
                method, fun, *a, args, max_steps,
                spec(method, fun.n, cp).params(), hmin, lib=lib,
                stream=stream), 1
        return run

    out = []
    B = sizes["bench"]
    bench = cs.solve_args(T(cs.stiff_y0(B)), cs.STIFF_TF, *cs.STIFF_TOL, None,
                          dev)
    out.append(("vdp_bench", B, one(rhs.vdp, bench, (cs.STIFF_MU,))))
    for case in ("robertson", "decay", "robertson_wide", "decay_wide"):
        if case in sizes:
            B = sizes[case]
            out.append((case, B, one(*stiff_inputs(case.split("_")[0], B,
                                                   dev))))
    B = sizes["singular"]
    odd = np.arange(B) % 2 == 1
    rate = T(np.where(odd, np.nan, -1.0))
    for method, first in (("RADAU", tableaus.RADAU_U1),
                          ("BDF", float(tableaus.BDF_ALPHA[1]))):
        a = (T(np.ones((B, 1))), T(np.zeros(B)), T(np.where(odd, 1.0, 30.0)),
             T(np.where(odd, 1.0, 30.0)), T(np.where(odd, 0.01, first)),
             T(np.full((B, 1), 1e-6)), T(np.full((B, 1), 1e-9)))
        out.append((f"singular_{method.lower()}", B,
                    one(rhs.decay, a, (rate,))))
    B = sizes["max_steps"]
    out.append(("vdp_max_steps", B, one(rhs.vdp, tuple(
        x[:B] if torch.is_tensor(x) else x for x in bench), (cs.STIFF_MU,),
        max_steps=50)))
    B = sizes["limits"]
    _, a, kw, _ = cs.edge_cases(B, dev)[1]
    out.append(("vdp_limits", B, one(rhs.vdp, a, (), kw["max_steps"])))
    B = sizes["chunk"]

    def chunked(method, cp, lib, side=None):
        RES = (side or side_modules()).RES
        a = tuple(x[:B] if torch.is_tensor(x) else x for x in bench)
        ra = run_args(a[2], a[5], a[6], a[3], 0.0, 100000, a[0])
        sp = spec(method, 2, cp)
        start, resume = card_route(RES, method, rhs.vdp, (cs.STIFF_MU,), sp,
                                   lib, stream)
        c = start(a[0], a[1], None, ra)
        launches = 1
        while not bool(c.done.all()):
            c = resume(c, ra, 64)
            launches += 1
        return c, launches
    out.append(("vdp_chunk64", B, chunked))
    return out


# stiff_mode_cases' lanes on the card: the sampled main path's, the
# recording main path's, Robertson's and the step budget's.
AB_STIFF_MODES = {"sampled": 131072, "record": 16384, "robertson": 4096,
                  "max_steps": 4096}
# Rows a record chunk holds: the whole span (VdP to 3000 takes up to ~810
# rows a lane) and chunks of 64.
STIFF_REC_CAPS = (1024, 64)


def stiff_mode_cases(dev, sizes=AB_STIFF_MODES, stream=None):
    """The bit-for-bit cases of the stiff kernels' SAMPLED and RECORD modes:
    ``[(case, B, run)]``, ``run(method, controller, lib) -> ({field: tensor},
    launches)`` one solve through ``lib`` (this tree's wrappers) on
    ``stream`` (0: a g++ build on CPU tensors).  The sampled main path
    (bench.py's stiff row on its 101-point grid); the recording main path's
    lanes, with and without coefficients, in one chunk and in chunks of 64
    rows, two of them with the grid's samples too; Robertson sampled at 0
    and on 40 log-spaced times to 1e8; the sampled row with max_steps 50,
    which stops lanes mid-span."""
    import chip_smoke as cs
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    def spec(method, n, cp):
        return stiff_spec(method, n, None, {"controller_precision": cp})

    def sampled(fun, a, args, grid, max_steps=100000):
        def run(method, cp, lib):
            hmin = torch.zeros(a[0].shape[0], dtype=torch.float64, device=dev)
            c = S.stiff_ensemble_cuda(method, fun, *a, args, max_steps,
                                      spec(method, fun.n, cp).params(), hmin,
                                      lib=lib, stream=stream, t_grid=grid)
            return stiff_mode_fields(method, c), 1
        return run

    def recorded(a, grid, cap, cont):
        def run(method, cp, lib):
            r = R.stiff_record_launches(
                method, rhs.vdp, *a, (cs.STIFF_MU,), 100000, grid,
                spec(method, 2, cp), cap, cont, 0.0, lib, stream)
            return {f: getattr(r, f) for f in r._fields
                    if torch.is_tensor(getattr(r, f))}, r.chunks
        return run

    out = []
    B = sizes["sampled"]
    a, grid = stiff_split_inputs(B, dev)
    out.append(("vdp_sampled", B, sampled(rhs.vdp, a, (cs.STIFF_MU,), grid)))
    B = sizes["record"]
    a, grid = stiff_split_inputs(B, dev)
    for cont, cap, g in ((False, STIFF_REC_CAPS[0], None),
                         (False, STIFF_REC_CAPS[1], grid),
                         (True, STIFF_REC_CAPS[0], grid),
                         (True, STIFF_REC_CAPS[1], None)):
        name = (f"vdp_record{'_cont' if cont else ''}_cap{cap}"
                f"{'_grid' if g is not None else ''}")
        out.append((name, B, recorded(a, g, cap, cont)))
    B = sizes["robertson"]
    yr = torch.as_tensor(cs.robertson_y0(B), device=dev)
    ar = cs.solve_args(yr, cs.ROB_TF, 1e-6, 1e-6, None, dev)
    gr = torch.broadcast_to(torch.as_tensor(np.concatenate(
        [[0.0], np.logspace(-6, 8, 40)]), device=dev), (B, 41))
    out.append(("robertson_log_grid", B, sampled(rhs.robertson, ar, (), gr)))
    B = sizes["max_steps"]
    a, grid = stiff_split_inputs(B, dev)
    out.append(("vdp_sampled_max_steps", B,
                sampled(rhs.vdp, a, (cs.STIFF_MU,), grid, max_steps=50)))
    return out


# The modes' timing rows: (mode, B, rows a chunk, lanes): the sampled main
# path, the recording one's first chunk, and the recording lanes at 131072
# in chunks of 64, where the stage must keep the residency of four blocks an
# SM; then Robertson's lanes (stiff_inputs) recorded with coefficients at
# 65536, where Radau's stage (18 doubles a row beside 504 B of slots) fits at
# two blocks an SM, not the entry's three.
AB_STIFF_MODE_ROWS = (("sampled", 131072, 0, "vdp"),
                      ("record", 16384, STIFF_REC_CAPS[0], "vdp"),
                      ("record_cont", 16384, STIFF_REC_CAPS[0], "vdp"),
                      ("record", 131072, STIFF_REC_CAPS[1], "vdp"),
                      ("record_cont", 131072, STIFF_REC_CAPS[1], "vdp"),
                      ("record_cont", 65536, STIFF_REC_CAPS[1], "robertson"))


def ab_stiff_modes(dev, old, label, old_side=None):
    """ab_stiff's part for the SAMPLED and RECORD modes: the lanes differing
    in every output, sample, row and count of each ``stiff_mode_cases`` case
    under both controller types (``old``: the baseline's libraries by
    kernel, launched by this tree's wrappers, whose entries they share; the
    rows over their fields, the drain's views, never the pad of the even
    stride, which a build with direct stores leaves unwritten), then
    ``AB_STIFF_ROUNDS`` rounds of old, new, new, old ``turn_ms`` of one
    launch of each of ``AB_STIFF_MODE_ROWS`` (a recording row's first
    chunk), the float32 controller, each side through its own wrappers
    (``old_side``, side_modules: a baseline package's rows at its own
    stride), with each side's share of the bound and each side's layout
    (with its RECORD stage: rows and bytes a lane)."""
    import inspect
    import chip_smoke as cs
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.core.driver import run_args
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    old_side = old_side or side_modules()
    wrappers = {}
    for case, B, run in stiff_mode_cases(dev):
        for method in ("RADAU", "BDF"):
            for cp in ("float32", "state"):
                new, ln = run(method, cp, None)
                ref, lo = run(method, cp, old[method.lower()])
                torch.cuda.synchronize()
                diff = carry_lanes_differing(new, ref)
                diff["launches"] = int(ln != lo)
                line("ab_stiff_modes_bitwise", old=label,
                     kernel=method.lower(), controller=cp, case=case, B=B,
                     identical=all(v == 0 for v in diff.values()),
                     lanes_differing=repr(diff), launches=ln,
                     statuses=repr(dict(Counter(new["status"].cpu().tolist()))))
                del new, ref
    for mode, B, cap, lanes in AB_STIFF_MODE_ROWS:
        if lanes == "vdp":
            a, grid = stiff_split_inputs(B, dev)
            fargs = (cs.STIFF_MU,)
        else:
            (_, a, fargs), grid = stiff_inputs(lanes, B, dev), None
        y0, t0, tf, hmax, fs, rtol, atol = a
        n = y0.shape[1]
        hmin = torch.zeros(B, dtype=torch.float64, device=dev)
        ra = run_args(tf, rtol, atol, hmax, hmin, 100000, y0)
        first = S.nan_first_step(fs, B, dev)
        fun0 = getattr(rhs, lanes)
        wrappers["new"] = (S, fun0, None)
        for method in ("RADAU", "BDF"):
            p = stiff_spec(method, n, None,
                           {"controller_precision": "float32"}).params()
            wrappers["old"] = (old_side.S, getattr(old_side.rhs, lanes),
                               old[method.lower()])
            sides = {}
            for w, (M, fun, lib) in wrappers.items():
                md = (M.Modes(method, B, n, dev, grid) if mode == "sampled"
                      else M.Modes(method, B, n, dev, None, cap,
                                   mode == "record_cont"))
                c = M.empty_carry(method, B, n, M.controller_dtype(p), dev)
                launch = M.StiffLaunch(method, fun, ra, fargs, p, lib, md)
                sides[w] = (lambda launch=launch, c=c, M=M: launch(
                    c, c, y0, t0, first, True, M.UNBOUNDED, None)), c, md
            ms = {"old": [], "new": []}
            for r in range(AB_STIFF_ROUNDS):
                for w in ("old", "new", "new", "old"):
                    ms[w].append(turn_ms(sides[w][0]))
            torch.cuda.synchronize()
            c, md = sides["new"][1], sides["new"][2]
            ns = md.n_samples if mode == "sampled" else None
            b_ms, b_by = S.stiff_bound(
                method, fun0, c.nstep, c.naccpt, c.nrejct, c.nfev, c.njev,
                c.nlu, **({"n_samples": ns, "m": md.m} if ns is not None
                          else {"n_rec": md.n_rec,
                                "record_cont": mode == "record_cont"}))
            med = {w: float(np.median(v)) for w, v in ms.items()}
            rows_bytes = 0.0 if ns is not None else 8.0 * float(
                md.n_rec.double().sum()) * R.record_width(
                    method, n, mode == "record_cont")
            pairs = zip(zip(ms["new"][::2], ms["new"][1::2]),
                        zip(ms["old"][::2], ms["old"][1::2]))
            lay = {}
            for w, (M, fun, lib) in wrappers.items():
                kw = ({"record_cont": mode == "record_cont"} if "record_cont"
                      in inspect.signature(M.layout).parameters else {})
                lay[w] = M.layout(method, fun, "float32", B, lib=lib,
                                  mode=M.SAMPLED if mode == "sampled"
                                  else M.RECORD, **kw)
            line("ab_stiff_modes", old=label, kernel=method.lower(), mode=mode,
                 lanes=lanes, B=B, rec_cap=cap, old_ms=[round(x, 4) for x in ms["old"]],
                 new_ms=[round(x, 4) for x in ms["new"]],
                 old_median=round(med["old"], 4),
                 new_median=round(med["new"], 4),
                 new_over_old=round(med["new"] / med["old"], 4),
                 rounds_new_won=f"{sum(sum(n) < sum(o) for n, o in pairs)}"
                                f"/{AB_STIFF_ROUNDS}",
                 bound_ms=round(b_ms, 6), bound_by=b_by,
                 share_new=round(b_ms / med["new"], 4),
                 share_old=round(b_ms / med["old"], 4),
                 warp_attempts=warp_attempts(c.nstep),
                 cycles_new=round(med["new"] * 1e-3 * sm_mhz() * 1e6 * 132 * 4
                                  / warp_attempts(c.nstep), 1),
                 cycles_old=round(med["old"] * 1e-3 * sm_mhz() * 1e6 * 132 * 4
                                  / warp_attempts(c.nstep), 1),
                 **({} if ns is not None else {f"gbytes_per_s_{w}": round(
                     rows_bytes / (med[w] * 1e6), 1) for w in med}),
                 **({} if ns is not None else {
                     f"row_stride_{w}": sides[w][2].rows.shape[-1]
                     for w in sides}),
                 **{f"{w}_{k}": v for w in ("new", "old")
                    for k, v in lay[w].items()})
            del sides, c, md
        del a, grid, hmin, ra
    ab_stiff_record_solves(dev, old, label, old_side)


def ab_stiff_record_solves(dev, old, label, old_side):
    """The recording main path's solve end to end, kernel and drain
    (erk_record.stiff_record_launches: B=16384, ``STIFF_REC_CAPS[0]``
    rows a chunk, with and without coefficients, the float32 controller):
    ``AB_STIFF_ROUNDS`` rounds of old, new, new, old ``turn_ms``, each side
    through its own package's wrappers (``old_side``), so each side's rows
    lie at its own strides."""
    import importlib

    import chip_smoke as cs
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    pkg = old_side.S.__name__.rsplit(".", 1)[0]
    sides = {"new": (R, rhs.vdp),
             "old": (importlib.import_module(f"{pkg}.erk_record"),
                     old_side.rhs.vdp)}
    B = AB_STIFF_MODES["record"]
    a, _ = stiff_split_inputs(B, dev)
    for method in ("RADAU", "BDF"):
        spec = stiff_spec(method, 2, None, {"controller_precision": "float32"})
        libs = {"new": None, "old": old[method.lower()]}
        for cont in (True, False):
            run = {w: (lambda M=M, fun=fun, lib=libs[w]:
                       M.stiff_record_launches(
                           method, fun, *a, (cs.STIFF_MU,), 100000, None,
                           spec, STIFF_REC_CAPS[0], cont, 0.0, lib))
                   for w, (M, fun) in sides.items()}
            ms = {"old": [], "new": []}
            for r in range(AB_STIFF_ROUNDS):
                for w in ("old", "new", "new", "old"):
                    ms[w].append(turn_ms(run[w]))
            med = {w: float(np.median(v)) for w, v in ms.items()}
            pairs = zip(zip(ms["new"][::2], ms["new"][1::2]),
                        zip(ms["old"][::2], ms["old"][1::2]))
            line("ab_stiff_record_solve", old=label, kernel=method.lower(),
                 record_cont=cont, B=B, rec_cap=STIFF_REC_CAPS[0],
                 old_ms=[round(x, 4) for x in ms["old"]],
                 new_ms=[round(x, 4) for x in ms["new"]],
                 old_median=round(med["old"], 4),
                 new_median=round(med["new"], 4),
                 new_over_old=round(med["new"] / med["old"], 4),
                 rounds_new_won=f"{sum(sum(n) < sum(o) for n, o in pairs)}"
                                f"/{AB_STIFF_ROUNDS}")
    del a


def ab_stiff(build, dev, baseline, label):
    """The stiff kernels built from ``baseline`` against the package's:
    the lanes differing in every output and carry field of each
    ``stiff_cases`` case under both controller types, then
    ``AB_STIFF_ROUNDS`` rounds of old, new, new, old ``turn_ms`` of one
    launch with no budget on the stiff row at each of ``STIFF_B`` and on
    ``stiff_inputs``' Robertson and decay at ``AB_STIFF_WIDE``, with each
    side's registers and spills and the new side's layout."""
    import chip_smoke as cs
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futs = {m: ex.submit(build.build, src_dir=baseline, name=m)
                for m in ("radau", "bdf")}
        paths = {m: f.result() for m, f in futs.items()}
    old = {m: build.load(p) for m, p in paths.items()}
    old_side = side_modules(baseline)
    line("ab_stiff_build", old=label, seconds=round(time.perf_counter() - t0, 3))
    new_paths = {m: build.build(name=m) for m in ("radau", "bdf")}
    for side, ps in (("new", new_paths), (label, paths)):
        stiff_ptxas(side, ps)
        for p in ps.values():
            stiff_sass_report(p, side)
    for case, B, run in stiff_cases(dev):
        for method in ("RADAU", "BDF"):
            if case.startswith("singular_") and case != \
                    f"singular_{method.lower()}":
                continue
            for cp in ("float32", "state"):
                new, ln = run(method, cp, None)
                ref, lo = run(method, cp, old[method.lower()], old_side)
                torch.cuda.synchronize()
                diff = carry_lanes_differing(stiff_carry_fields(method, new),
                                             stiff_carry_fields(method, ref))
                diff["launches"] = int(ln != lo)
                line("ab_stiff_bitwise", old=label, kernel=method.lower(),
                     controller=cp, case=case, B=B,
                     identical=all(v == 0 for v in diff.values()),
                     lanes_differing=repr(diff), launches=ln,
                     statuses=repr(dict(Counter(new.status.cpu().tolist()))))
                del new, ref
    ab_stiff_modes(dev, old, label, old_side)
    rows = [(f"vdp_B{B}", B, lambda B=B: (
        rhs.vdp, cs.solve_args(torch.as_tensor(cs.stiff_y0(B), device=dev),
                               cs.STIFF_TF, *cs.STIFF_TOL, None, dev),
        (cs.STIFF_MU,))) for B in STIFF_B]
    rows += [(f"{case}_B{B}", B, lambda case=case, B=B: stiff_inputs(
        case, B, dev)) for case, B in AB_STIFF_WIDE.items()]
    for row, B, inputs in rows:
        fun, a, fargs = inputs()
        hmin = torch.zeros(B, dtype=torch.float64, device=dev)
        for method in ("RADAU", "BDF"):
            for cp in ("float32", "state"):
                p = stiff_spec(method, fun.n, None,
                               {"controller_precision": cp}).params()
                libs = {"new": (S, None),
                        "old": (old_side.S, old[method.lower()])}
                run = {w: (lambda M=M, lib=lib: M.stiff_ensemble_cuda(
                    method, fun, *a, fargs, 100000, p, hmin,
                    lib=lib)) for w, (M, lib) in libs.items()}
                ms = {"old": [], "new": []}
                for r in range(AB_STIFF_ROUNDS):
                    for what in ("old", "new", "new", "old"):
                        ms[what].append(turn_ms(run[what]))
                c = run["new"]()
                torch.cuda.synchronize()
                med = {w: float(np.median(v)) for w, v in ms.items()}
                pairs = zip(zip(ms["new"][::2], ms["new"][1::2]),
                            zip(ms["old"][::2], ms["old"][1::2]))
                b_ms, b_by = S.stiff_bound(method, fun, c.nstep, c.naccpt,
                                           c.nrejct, c.nfev, c.njev, c.nlu)
                lay = S.layout(method, fun, cp, B)
                line("ab_stiff", old=label, kernel=method.lower(),
                     controller=cp, row=row, B=B,
                     old_ms=[round(x, 4) for x in ms["old"]],
                     new_ms=[round(x, 4) for x in ms["new"]],
                     old_median=round(med["old"], 4),
                     new_median=round(med["new"], 4),
                     new_over_old=round(med["new"] / med["old"], 4),
                     rounds_new_won=f"{sum(sum(n) < sum(o) for n, o in pairs)}"
                                    f"/{AB_STIFF_ROUNDS}",
                     bound_ms=round(b_ms, 6), bound_by=b_by,
                     share_new=round(b_ms / med["new"], 4),
                     share_old=round(b_ms / med["old"], 4),
                     warp_efficiency=round(float(c.nstep.double().sum())
                                           / (32 * warp_attempts(c.nstep)), 5),
                     **{f"new_{k}": v for k, v in lay.items()})
                del c
        del a, hmin


def stiff_event_ab_cases(dev, B=AB_STIFF_EV_B):
    """``[(case, method, controller, run(lib))]``: each stiff event entry
    on chip_smoke.py's event inputs (``stiff_ev_inputs``) at ``B`` lanes,
    through this tree's wrappers with the library ``lib`` (None: the
    package's build): the oscillator over [0, 3000] lean, sampled (101
    points) and recording (``AB_STIFF_EV_CAP`` rows a chunk, with
    coefficients and without, with the samples), the restarts lean and
    recording with coefficients, each method and controller type.
    ``run`` returns ``{field: tensor}``: the final state, every counter, the
    event buffers and counts, the samples, the rows and their counts."""
    import chip_smoke as cs
    from ivp_tpu_torch.kernels import erk_record as R
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    def ensemble(method, cp, which, m):
        def run(lib):
            fun, a, ev, grid, _ = cs.stiff_ev_inputs(which, B, dev, grid_m=m)
            spec = stiff_spec(method, fun.n, None,
                              {"controller_precision": cp})
            return cs.ev_dict(_ens(S, method, fun, a, spec, lib, grid, ev))
        return run

    def record(method, cp, which, cont, m):
        def run(lib):
            fun, a, ev, grid, _ = cs.stiff_ev_inputs(which, B, dev, grid_m=m)
            spec = stiff_spec(method, fun.n, None,
                              {"controller_precision": cp})
            r = R.stiff_record_launches(
                method, fun, *a, grid, spec, AB_STIFF_EV_CAP, cont, 0.0, lib,
                torch.cuda.current_stream(dev).cuda_stream, events=ev)
            d = {f: getattr(r, f) for f in cs.STIFF_FINAL + cs.REC_FIELDS
                 + ("n_rec", "y_samples", "n_samples")}
            d.update(zip(("t_events", "y_events", "n_events",
                          "event_overflow", "n_restarts", "n_brent"),
                         r.events))
            return d
        return run

    out = []
    for method in ("RADAU", "BDF"):
        for cp in ("float32", "state"):
            tag = f"{method.lower()}_{cp}"
            out += [(f"crossing_lean_{tag}", method, cp,
                     ensemble(method, cp, "crossing", 0)),
                    (f"crossing_sampled_{tag}", method, cp,
                     ensemble(method, cp, "crossing", cs.SAMPLED_M)),
                    (f"crossing_record_{tag}", method, cp,
                     record(method, cp, "crossing", False, cs.SAMPLED_M)),
                    (f"crossing_record_cont_{tag}", method, cp,
                     record(method, cp, "crossing", True, cs.SAMPLED_M)),
                    (f"replenish_lean_{tag}", method, cp,
                     ensemble(method, cp, "replenish", 0)),
                    (f"replenish_record_cont_{tag}", method, cp,
                     record(method, cp, "replenish", True, 0))]
    return out


def _ens(S, method, fun, a, spec, lib, grid, ev):
    """One stiff event ensemble launch from ``lib`` on the current stream:
    stiff_ensemble's outputs with events."""
    B = a[0].shape[0]
    hmin = torch.zeros(B, dtype=torch.float64, device=a[0].device)
    c = S.stiff_ensemble_cuda(method, fun, *a, spec.params(), hmin, lib=lib,
                              t_grid=grid, events=ev)
    return (c.t, c.y, c.status, c.nfev, c.nstep, c.naccpt, c.nrejct,
            c.sample_y if grid is not None else None,
            c.s_cursor if grid is not None else None, c.ev, c.njev, c.nlu)


def ab_stiff_events(build, dev, baseline, label):
    """The stiff kernels' event entries built from ``baseline`` (a ``csrc``
    with radau_ev.cu and bdf_ev.cu, launched through this tree's wrappers)
    against the package's: ``ab_stiff_events_bitwise`` lines, the lanes
    differing in every output of each ``stiff_event_ab_cases`` case (bits;
    NaN equals NaN; must be 0 for a change claimed bit for bit), then
    ``AB_STIFF_EV_ROUNDS`` rounds of old, new, new, old ``turn_ms`` of the
    event main paths' launches at chip_smoke.py's B (the oscillator lean
    and sampled, the restarts; the float32 controller):
    ``ab_stiff_events``.  A baseline without those sources is named in an
    ``ab_stiff_events_skipped`` line."""
    import chip_smoke as cs
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    names = ("radau_ev", "bdf_ev")
    if not all((Path(baseline) / f"{n}.cu").is_file() for n in names):
        line("ab_stiff_events_skipped", old=label,
             reason="the baseline has no radau_ev.cu and bdf_ev.cu")
        return
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        futs = {n: ex.submit(build.build, src_dir=baseline, name=n)
                for n in names}
        new_futs = {n: ex.submit(build.build, name=n) for n in names}
        old = {n.split("_")[0].upper(): build.load(f.result())
               for n, f in futs.items()}
        new_paths = {n: f.result() for n, f in new_futs.items()}
    line("ab_stiff_events_build", old=label,
         seconds=round(time.perf_counter() - t0, 3))
    stiff_ptxas("new", new_paths)
    for case, method, cp, run in stiff_event_ab_cases(dev):
        new, ref = run(None), run(old[method])
        torch.cuda.synchronize()
        diff = fields_lanes_differing(new, ref)
        line("ab_stiff_events_bitwise", old=label, kernel=method.lower(),
             case=case, B=AB_STIFF_EV_B,
             identical=all(v == 0 for v in diff.values()),
             lanes_differing=repr(diff),
             statuses=repr(dict(Counter(new["status"].cpu().tolist()))),
             events=int(new["n_events"].sum()),
             restarts=int(new["n_restarts"].sum()))
        del new, ref
    B = cs.STIFF_B
    for which, m in (("crossing", 0), ("crossing", cs.SAMPLED_M),
                     ("replenish", 0)):
        fun, a, ev, grid, ev_set = cs.stiff_ev_inputs(which, B, dev,
                                                      grid_m=m)
        for method in ("RADAU", "BDF"):
            spec = stiff_spec(method, fun.n, None, None)
            run = {w: (lambda lib=lib: _ens(S, method, fun, a, spec, lib,
                                            grid, ev))
                   for w, lib in (("new", None), ("old", old[method]))}
            ms = {"old": [], "new": []}
            for r in range(AB_STIFF_EV_ROUNDS):
                for w in ("old", "new", "new", "old"):
                    ms[w].append(turn_ms(run[w]))
            out = run["new"]()
            torch.cuda.synchronize()
            med = {w: float(np.median(v)) for w, v in ms.items()}
            b_ms, b_by = S.stiff_bound(
                method, fun, out[4], out[5], out[6], out[3], out[10],
                out[11], n_samples=out[8], m=m, events=(ev_set, out[9]))
            line("ab_stiff_events", old=label, kernel=method.lower(),
                 row=f"{which}{'_sampled' if m else ''}_B{B}",
                 old_ms=[round(x, 4) for x in ms["old"]],
                 new_ms=[round(x, 4) for x in ms["new"]],
                 old_median=round(med["old"], 4),
                 new_median=round(med["new"], 4),
                 new_over_old=round(med["new"] / med["old"], 4),
                 bound_ms=round(b_ms, 6), bound_by=b_by,
                 share_new=round(b_ms / med["new"], 4),
                 brent_evals=int(out[9].n_brent.sum()),
                 events=int(out[9].n_events.sum()),
                 restarts=int(out[9].n_restarts.sum()))
            del out
        del a


# ab_resume: rounds of old, new, new, old whole chunked solves; the lanes,
# chunk and step budget of the decay cases (per-lane t0 and spans, some
# backward, one of length 0; stiff lanes stop at the budget).
AB_RESUME_ROUNDS = 5
AB_RESUME_DECAY = (4096, 64, 2000)


def side_modules(baseline=None):
    """The modules (``S``: stiff_ensemble, ``RES``: resumable, ``E``:
    erk_ensemble, ``build``, ``batch``, ``rhs``) that launch a baseline's
    kernels: where its ``csrc`` sits in a copy of the
    package (``git archive <commit> ivp_tpu_torch``), that copy's own,
    imported under another name, since its entries may take other
    arguments; else (and with no baseline) this tree's."""
    import importlib
    import importlib.util
    import types

    pkg = None if baseline is None else Path(baseline).resolve().parent
    if pkg is None or not (pkg / "__init__.py").exists():
        from ivp_tpu_torch import batch, rhs
        from ivp_tpu_torch.kernels import build, erk_ensemble, resumable
        from ivp_tpu_torch.kernels import stiff_ensemble
        return types.SimpleNamespace(S=stiff_ensemble, RES=resumable,
                                     E=erk_ensemble, build=build,
                                     batch=batch, rhs=rhs)
    alias = f"_side_{pkg.parent.name}_{pkg.name}"
    if alias not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[alias] = mod
        spec.loader.exec_module(mod)
    return types.SimpleNamespace(
        S=importlib.import_module(f"{alias}.kernels.stiff_ensemble"),
        RES=importlib.import_module(f"{alias}.kernels.resumable"),
        E=importlib.import_module(f"{alias}.kernels.erk_ensemble"),
        build=importlib.import_module(f"{alias}.kernels.build"),
        batch=importlib.import_module(f"{alias}.batch"),
        rhs=importlib.import_module(f"{alias}.rhs"))


def side_libraries(build, side, baseline) -> dict:
    """Build the resumable and stiff libraries of ``baseline`` (a ``csrc``)
    with this tree's build (nvcc, all at once) and hand them to ``side``'s
    own ``build.library``, so that its solvers launch them;
    ``{name: path}``."""
    from ivp_tpu_torch.kernels import erk_ensemble as K

    names = sorted({K.KERNELS[m][1] for m in K.KERNELS} | {"radau", "bdf"})
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        paths = dict(zip(names, ex.map(
            lambda n: build.build(src_dir=baseline, name=n), names)))
    for n, p in paths.items():
        side.build._libs.setdefault(n, build.load(p))
    return paths


def baseline_label(baseline):
    """A baseline's label: the directory above its ``csrc``, or above the
    package copy that holds it."""
    above = Path(baseline).parent
    return (above.parent.name if (above / "__init__.py").exists()
            else above.name if Path(baseline).name == "csrc"
            else Path(baseline).name)


def resume_carry_fields(method, c):
    """{field: tensor} of a resumable carry: the driver's fields and the
    method state's (``lin`` spelt out)."""
    from ivp_tpu_torch.kernels import stiff_ensemble as S

    out = {f: getattr(c, f) for f in STIFF_FIELDS}
    out.update(S._ms_fields(method, c.ms) if method in ("RADAU", "BDF")
               else c.ms._asdict())
    return out


def resume_ab_cases(dev, B=None):
    """The resumable solver's A/B cases: ``[(case, method, fun, solve
    arguments, RHS arguments, params, chunk_steps, max_steps)]``.  chip_smoke.py's
    ``RESUME_CASES`` (B=16384, chunk 256); DOPRI5 on VdP and RK4 on Lorenz
    with the controller in double (RK4 keeps it in float, stored double);
    DOPRI5, DOP853 and RK4 on ``stiff_inputs``' decay lanes (per-lane t0,
    spans some backward, one of length 0, per-lane rates and tolerances;
    ``AB_RESUME_DECAY``'s chunk and step budget); Radau and BDF on bench.py's stiff
    row at B=16384, chunk 64, both controller types.  ``B`` replaces every
    lane count (a rehearsal on the CPU)."""
    import chip_smoke as cs
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.batch import _solver_params
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    def params(method, n, cp=None):
        so = None if cp is None else {"controller_precision": cp}
        if method in ("RADAU", "BDF"):
            return stiff_spec(method, n, None, so)
        return _solver_params(method, n, None, so, False)

    out = []
    explicit = [(m, f, tf, rt, at, None)
                for m, f, tf, rt, at in cs.RESUME_CASES]
    explicit += [("DOPRI5", "vdp", 20.0, 1e-6, 1e-8, "state"),
                 ("RK4", "lorenz", 2.0, 1e-6, 1e-8, "state")]
    for method, fname, tf, rt, at, cp in explicit:
        fun = getattr(rhs, fname)
        Bc = B or cs.RESUME_B
        y0 = torch.as_tensor(cs.lorenz_y0(Bc) if fun.n == 3 else
                             cs.vdp_y0(Bc), device=dev)
        out.append((f"{method.lower()}_{fname}" + (f"_{cp}" if cp else ""),
                    method, fun, cs.solve_args(y0, tf, rt, at, None, dev), (),
                    params(method, fun.n, cp), cs.RESUME_CHUNK, 100000))
    Bd, chunk, budget = AB_RESUME_DECAY
    fun, a, fargs = stiff_inputs("decay", B or Bd, dev)
    # Not RK23: a backward lane of these overflows, and a build before the
    # port's RK23 counted an attempt whose error estimate is not finite
    # rejects that lane forever within one launch (ROADMAP §3 fault 7):
    # ``rk23_decay_case`` runs it on this tree alone.
    for method in ("DOPRI5", "DOP853", "RK4"):
        out.append((f"{method.lower()}_decay", method, fun, a, fargs,
                    params(method, 1), chunk, budget))
    Bs = B or AB_STIFF_B["chunk"]
    y0 = torch.as_tensor(cs.stiff_y0(Bs), device=dev)
    for method in ("RADAU", "BDF"):
        for cp in ("float32", "state"):
            out.append((f"{method.lower()}_stiff_row_{cp}", method, rhs.vdp,
                        cs.solve_args(y0, cs.STIFF_TF, *cs.STIFF_TOL, None,
                                      dev), (cs.STIFF_MU,),
                        params(method, 2, cp), 64, 100000))
    return out


def rk23_decay_case(dev, B=None):
    """RK23 on ``resume_ab_cases``' decay lanes (some overflow backward,
    their error estimates NaN), as one of its cases: run on this tree's
    build alone, where such a lane ends at the step budget (ROADMAP §3
    fault 7), since a parent's loops there."""
    from ivp_tpu_torch.batch import _solver_params

    Bd, chunk, budget = AB_RESUME_DECAY
    fun, a, fargs = stiff_inputs("decay", B or Bd, dev)
    return ("rk23_decay", "RK23", fun, a, fargs,
            _solver_params("RK23", 1, None, None, False), chunk, budget)


def rk23_decay_alone(dev, new_side, stream=None, label="new"):
    """``ab_resume_rk23_decay``: ``rk23_decay_case`` chunked through this
    tree's resumable launches and, on the same lanes, through the plain
    version's (``run_bounded``, chunk by chunk): every lane ends, and every
    carry field's lanes differing between the two at the end (the
    kernel's FMAs: a count, not a gate), with the statuses."""
    from ivp_tpu_torch.core.driver import run_args
    from ivp_tpu_torch.kernels import erk_ensemble as K

    case, method, fun, a, args, params, chunk, max_steps = rk23_decay_case(
        dev)
    y0, t0, tf, hmax, fs, rtol, atol = a
    ra = run_args(tf, rtol, atol, hmax, 0.0, max_steps, y0)
    start, resume = card_route(new_side.RES, method, fun, args, params,
                               None, stream)
    c, launches = start(y0, t0, fs, ra), 1
    while not bool(c.done.all()):
        c = resume(c, ra, chunk)
        launches += 1
    init_carry, run_bounded = K.plain_driver(method, fun, y0, args, 0,
                                             params, None, bounded=True,
                                             unroll=1)
    p = init_carry(t0, y0, fs, ra)
    while not bool(p.done.all()):
        p = run_bounded(p, ra, chunk)
    same = {f: int((getattr(c, f) != getattr(p, f)).sum())
            for f in ("status", "nfev", "nstep", "naccpt", "nrejct")}
    line("ab_resume_rk23_decay", build=label, case=case, B=y0.shape[0],
         chunk=chunk, launches=launches, all_done=bool(c.done.all()),
         lanes_differing_from_plain=repr(same),
         statuses=repr(dict(Counter(c.status.cpu().tolist()))))
    return bool(c.done.all())


def card_route(RES, method, fun, args, params, lib=None, stream=None):
    """``(start(y0, t0, first_step, ra), resume(carry, ra, max_attempts))``:
    the resumable launches on the card of a tree's ``RES`` (its
    ``CardSolve``; an older tree's ``start_on_card`` /
    ``resume_on_card``)."""
    if hasattr(RES, "CardSolve"):
        s = RES.CardSolve(method, fun, args, params, lib)
        return (lambda y0, t0, fs, ra: s.start(y0, t0, fs, ra, stream),
                lambda c, ra, k: s.resume(c, ra, k, stream))
    return (lambda y0, t0, fs, ra: RES.start_on_card(
                method, fun, y0, t0, fs, args, ra, params, lib=lib,
                stream=stream),
            lambda c, ra, k: RES.resume_on_card(
                method, fun, c, args, ra, params, k, lib=lib, stream=stream))


def chunked_solve(RES, method, fun, a, args, params, chunk, max_steps,
                  lib=None, stream=None, host_us=None):
    """``(carry, launches)``: one solve through ``RES``'s resumable launches
    (``card_route``) until ``carry.done.all()``, the host µs of each resume
    call appended to ``host_us``."""
    from ivp_tpu_torch.core.driver import run_args

    y0, t0, tf, hmax, fs, rtol, atol = a
    ra = run_args(tf, rtol, atol, hmax, 0.0, max_steps, y0)
    start, resume = card_route(RES, method, fun, args, params, lib, stream)
    c = start(y0, t0, fs, ra)
    launches = 1
    while not bool(c.done.all()):
        t = time.perf_counter()
        c = resume(c, ra, chunk)
        if host_us is not None:
            host_us.append(1e6 * (time.perf_counter() - t))
        launches += 1
    return c, launches


def resume_bitwise(cases, new_libs, old_libs, new_side, old_side, stream,
                   label):
    """``ab_resume_bitwise`` lines: each case solved by both sides in step,
    the lanes differing in each field of their carries summed over every
    chunk boundary (the start's carry first), and whether they made the
    same launches.  ``*_libs(method)``: a side's library; ``*_side``: its
    modules (``side_modules``).  True if every case is identical."""
    from ivp_tpu_torch.core.driver import run_args

    same = True
    for case, method, fun, a, args, params, chunk, max_steps in cases:
        y0, t0, tf, hmax, fs, rtol, atol = a
        ra = run_args(tf, rtol, atol, hmax, 0.0, max_steps, y0)
        sides = [card_route(R, method, fun, args, params, lib, stream)
                 for R, lib in ((new_side.RES, new_libs(method)),
                                (old_side.RES, old_libs(method)))]
        cs_ = [start(y0, t0, fs, ra) for start, _ in sides]
        diff, launches, boundaries = Counter(), 1, 0
        while True:
            boundaries += 1
            diff.update(carry_lanes_differing(
                resume_carry_fields(method, cs_[0]),
                resume_carry_fields(method, cs_[1])))
            done = [bool(c.done.all()) for c in cs_]
            if done[0] != done[1]:
                diff["launches"] += 1
            if any(done):
                break
            cs_ = [resume(c, ra, chunk) for (_, resume), c in zip(sides, cs_)]
            launches += 1
        diff = dict(diff, launches=diff["launches"])
        ok = all(v == 0 for v in diff.values())
        same &= ok
        line("ab_resume_bitwise", old=label, case=case, B=y0.shape[0],
             chunk=chunk, launches=launches, boundaries=boundaries,
             identical=ok, lanes_differing=repr(diff),
             statuses=repr(dict(Counter(cs_[0].status.cpu().tolist()))))
        del cs_
    return same


def ab_resume(build, dev, baseline, label):
    """The resumable tier against a baseline (``side_modules``: an older
    tree's wrapper and kernels): ``ab_resume_bitwise`` on every
    ``resume_ab_cases`` case, then for each ``AB_RESUME_ROUNDS`` rounds
    of old, new, new, old whole chunked solves through ``RES``'s
    resumable launches (``card_route``; CUDA events around the start, every
    resume and every read of ``done``), with each side's kernels' device ms
    by torch.profiler over one more solve, launches, host µs a resume, and
    the time besides the kernels a launch (``ab_resume``); then the same
    through each side's ``batch.build_resumable_solver`` (built, started,
    resumed and extracted inside the time, as chip_smoke.py's phases 12
    and 13 run it) on chip_smoke.py's ``RESUME_CASES`` and bench.py's stiff
    row uncut (B=131072, chunk 4096): ``ab_resume_solver``."""
    import chip_smoke as cs
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import erk_ensemble as K

    old_side, new_side = side_modules(baseline), side_modules()
    t0 = time.perf_counter()
    old_paths = side_libraries(build, old_side, baseline)
    old = {n: old_side.build.library(n) for n in old_paths}
    sources = sorted(old_paths)
    line("ab_resume_build", old=label,
         seconds=round(time.perf_counter() - t0, 3))
    for side, paths in (("new", {n: build.build(name=n) for n in sources}),
                        (label, old_paths)):
        for n_, path in paths.items():
            for fn, regs, st, ld in build.ptxas_report(path):
                if instantiation(fn).endswith("/resume"):
                    line("ab_resume_ptxas", build=side, library=n_,
                         instantiation=instantiation(fn), registers=regs,
                         spill_stores=st, spill_loads=ld)
    src = (lambda m: m.lower() if m in ("RADAU", "BDF")
           else K.KERNELS[m][1])
    cases = resume_ab_cases(dev)
    resume_bitwise(cases, lambda m: None, lambda m: old[src(m)], new_side,
                   old_side, None, label)
    rk23_decay_alone(dev, new_side)
    for case, method, fun, a, args, params, chunk, max_steps in cases:
        match = (f"{method.lower()}_kernel" if method in ("RADAU", "BDF")
                 else "erk_kernel")
        sides = {"new": (new_side, None), "old": (old_side, old[src(method)])}
        ms, host = {"old": [], "new": []}, {"old": [], "new": []}
        for r in range(AB_RESUME_ROUNDS):
            for w in ("old", "new", "new", "old"):
                side, lib = sides[w]
                (c, launches), m_, _ = timed(lambda: chunked_solve(
                    side.RES, method, fun, a, args, params, chunk, max_steps,
                    lib, host_us=host[w]))
                ms[w].append(m_)
                del c
        kern = {w: kernel_ms(lambda side=side, lib=lib: chunked_solve(
            side.RES, method, fun, a, args, params, chunk, max_steps, lib),
            n=1, match=match, launches=lambda o: o[1])
            for w, (side, lib) in sides.items()}
        ab_resume_line("ab_resume", label, case, a[0].shape[0], chunk,
                       launches, ms, kern, host)
    solver_cases = [(m, getattr(rhs, f), (), tf, (rt, at), cs.RESUME_B,
                     cs.RESUME_CHUNK) for m, f, tf, rt, at in cs.RESUME_CASES]
    solver_cases += [(m, rhs.vdp, (cs.STIFF_MU,), cs.STIFF_TF, cs.STIFF_TOL,
                      cs.STIFF_B, cs.STIFF_CHUNK) for m in ("RADAU", "BDF")]
    for method, fun, args, tf, tol, B, chunk in solver_cases:
        y0 = torch.as_tensor(cs.stiff_y0(B) if args else cs.lorenz_y0(B)
                             if fun.n == 3 else cs.vdp_y0(B), device=dev)
        match = (f"{method.lower()}_kernel" if method in ("RADAU", "BDF")
                 else "erk_kernel")
        ms, host = {"old": [], "new": []}, {"old": [], "new": []}

        def solve(side, host_us=None):
            start, resume, extract = side.batch.build_resumable_solver(
                getattr(side.rhs, fun.name), method, n=fun.n, args=args,
                chunk_steps=chunk)
            carry, ra = start(y0, 0.0, tf, *tol)
            launches = 1
            while not bool(carry.done.all()):
                t = time.perf_counter()
                carry = resume(carry, ra)
                if host_us is not None:
                    host_us.append(1e6 * (time.perf_counter() - t))
                launches += 1
            return extract(carry), launches
        sides = {"new": new_side, "old": old_side}
        for w in sides:
            solve(sides[w])
        for r in range(AB_RESUME_ROUNDS):
            for w in ("old", "new", "new", "old"):
                (res, launches), m_, _ = timed(
                    lambda: solve(sides[w], host[w]))
                ms[w].append(m_)
                del res
        kern = {w: kernel_ms(lambda side=side: solve(side), n=1, match=match,
                             launches=lambda o: o[1])
                for w, side in sides.items()}
        ab_resume_line("ab_resume_solver", label,
                       f"{method.lower()}_{fun.name}", B, chunk, launches, ms,
                       kern, host)
        del y0


def ab_resume_line(what, label, case, B, chunk, launches, ms, kern, host):
    """One line of ab_resume's turns: each side's solve ms, their medians,
    the kernels' ms, host µs a resume and ms besides the kernels a
    launch."""
    med = {w: float(np.median(v)) for w, v in ms.items()}
    pairs = zip(zip(ms["new"][::2], ms["new"][1::2]),
                zip(ms["old"][::2], ms["old"][1::2]))
    line(what, old=label, case=case, B=B, chunk=chunk,
         launches=launches, old_ms=[round(x, 4) for x in ms["old"]],
         new_ms=[round(x, 4) for x in ms["new"]],
         old_median=round(med["old"], 4), new_median=round(med["new"], 4),
         new_over_old=round(med["new"] / med["old"], 4),
         rounds_new_won=f"{sum(sum(n) < sum(o) for n, o in pairs)}"
                        f"/{AB_RESUME_ROUNDS}",
         old_kernel_ms=round(kern["old"], 4),
         new_kernel_ms=round(kern["new"], 4),
         old_host_us_per_resume=round(float(np.mean(host["old"])), 1),
         new_host_us_per_resume=round(float(np.mean(host["new"])), 1),
         old_besides_kernel_ms=round(med["old"] - kern["old"], 4),
         new_besides_kernel_ms=round(med["new"] - kern["new"], 4),
         old_besides_kernel_ms_per_launch=round(
             (med["old"] - kern["old"]) / launches, 4),
         new_besides_kernel_ms_per_launch=round(
             (med["new"] - kern["new"]) / launches, 4))


# rehearse: the lanes of every case, and the stiff_cases sizes, of the CPU
# rehearsal on g++ builds (a lane count that fills no block).
REHEARSE_B = 37
REHEARSE_STIFF = {"bench": 40, "robertson": 24, "decay": 40, "singular": 16,
                  "max_steps": 40, "limits": 40, "chunk": 40}
REHEARSE_MODES = {"sampled": 40, "record": 24, "robertson": 16,
                  "max_steps": 40}


def rehearse(baseline, label):
    """On the CPU, no card: the resumable, stiff and erk kernels of this
    tree and of ``baseline`` built with g++ (gxx.py) into ``_build/gxx/``,
    held field by field on CPU tensors: ``ab_resume_bitwise`` on every
    ``resume_ab_cases`` case at ``REHEARSE_B`` lanes, ``rehearse_stiff``
    on every ``stiff_cases`` case at ``REHEARSE_STIFF`` under both
    controller types and ``rehearse_stiff_modes`` on every
    ``stiff_mode_cases`` case at ``REHEARSE_MODES``, then ``rehearse_erk`` on every ``erk_cases`` case of
    every erk kernel (lean and sampled; DOP853's queue cases) at
    ``REHEARSE_B`` lanes.  True if every case is identical."""
    import gxx
    from ivp_tpu_torch.kernels import build
    from ivp_tpu_torch.kernels import erk_ensemble as K

    dev = torch.device("cpu")
    names = sorted({K.KERNELS[m][1] for m in K.KERNELS} | {"radau", "bdf"})
    t0 = time.perf_counter()
    libs = {w: {n: build.load(p) for n, p in gxx.build_all(
        src, build.BUILD_DIR / "gxx" / w, names).items()}
        for w, src in (("new", build.SRC_DIR), (label, baseline))}
    line("rehearse_build", old=label, seconds=round(time.perf_counter() - t0, 3))
    src = (lambda m: m.lower() if m in ("RADAU", "BDF")
           else K.KERNELS[m][1])
    old_side = side_modules(baseline)
    same = resume_bitwise(resume_ab_cases(dev, REHEARSE_B),
                          lambda m: libs["new"][src(m)],
                          lambda m: libs[label][src(m)], side_modules(),
                          old_side, 0, label)
    for case, B, run in stiff_cases(dev, REHEARSE_STIFF, stream=0):
        for method in ("RADAU", "BDF"):
            if case.startswith("singular_") and case != \
                    f"singular_{method.lower()}":
                continue
            for cp in ("float32", "state"):
                new, ln = run(method, cp, libs["new"][method.lower()])
                ref, lo = run(method, cp, libs[label][method.lower()],
                              old_side)
                diff = carry_lanes_differing(stiff_carry_fields(method, new),
                                             stiff_carry_fields(method, ref))
                diff["launches"] = int(ln != lo)
                ok = all(v == 0 for v in diff.values())
                same &= ok
                line("rehearse_stiff", old=label, kernel=method.lower(),
                     controller=cp, case=case, B=B, identical=ok,
                     lanes_differing=repr({k: v for k, v in diff.items()
                                           if v}))
    for case, B, run in stiff_mode_cases(dev, REHEARSE_MODES, stream=0):
        for method in ("RADAU", "BDF"):
            for cp in ("float32", "state"):
                new, ln = run(method, cp, libs["new"][method.lower()])
                ref, lo = run(method, cp, libs[label][method.lower()])
                diff = carry_lanes_differing(new, ref)
                diff["launches"] = int(ln != lo)
                ok = all(v == 0 for v in diff.values())
                same &= ok
                line("rehearse_stiff_modes", old=label,
                     kernel=method.lower(), controller=cp, case=case, B=B,
                     identical=ok, launches=ln,
                     lanes_differing=repr({k: v for k, v in diff.items()
                                           if v}))
    for method, (kernel, source) in K.KERNELS.items():
        for case, a, kw in erk_cases(method, REHEARSE_B, dev):
            kw = dict(kw)
            fun, y0, t0, tf, hmax, fs, rtol, atol = a[:8]
            run = (lambda lib: K.ensemble_launch(
                method, fun, y0, t0, tf, hmax, fs, rtol, atol,
                a[8] if len(a) > 8 else kw.get("args", ()),
                a[9] if len(a) > 9 else kw.get("max_steps", 100_000),
                kw.get("t_grid"), kw.get("params"), lib, 0))
            diff = lanes_differing(run(libs["new"][source]),
                                   run(libs[label][source]))
            ok = all(v == 0 for v in diff.values())
            same &= ok
            line("rehearse_erk", old=label, kernel=kernel, case=case,
                 B=REHEARSE_B, identical=ok,
                 lanes_differing=repr({k: v for k, v in diff.items() if v}))
    line("rehearse", old=label, identical=same)
    return same


# The stiff occupancy sweep: (threads a block, min blocks an SM) of every
# entry of csrc/radau.cu and csrc/bdf.cu, -DIVP_THREADS/-DIVP_MIN_BLOCKS.
STIFF_OCC = ((64, 8), (128, 1), (128, 3), (128, 4), (256, 2))
STIFF_OCC_ROUNDS = 4


def stiff_occupancy(build, dev):
    """radau and bdf built under every ``STIFF_OCC`` setting in parallel:
    ptxas's registers, frame and spills and the layout of each VdP
    instantiation; each timed under every setting in turns on the stiff row
    at each of ``STIFF_B`` under both controller types, every field held
    bit for bit to the package build; the settings ranked."""
    import chip_smoke as cs
    from ivp_tpu_torch import rhs
    from ivp_tpu_torch.kernels import stiff_ensemble as S
    from ivp_tpu_torch.methods.jacobian import stiff_spec

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2 * len(STIFF_OCC)) as ex:
        futs = {(m, st): ex.submit(build.build, defines=(
            f"IVP_THREADS={st[0]}", f"IVP_MIN_BLOCKS={st[1]}"), name=m)
            for m in ("radau", "bdf") for st in STIFF_OCC}
        libs = {key: f.result() for key, f in futs.items()}
    line("stiff_occupancy_build", libraries=len(libs),
         seconds=round(time.perf_counter() - t0, 3))
    loaded = {key: build.load(path) for key, path in libs.items()}
    for (m, st), path in sorted(libs.items()):
        for fn, regs, frame, sst, sld in ptxas_frames(path):
            name = instantiation(fn)
            if name.startswith(f"{m}/VdP"):
                line("stiff_occupancy_ptxas", threads=st[0], min_blocks=st[1],
                     instantiation=name, registers=regs, stack_frame=frame,
                     spill_stores=sst, spill_loads=sld)
    for B in STIFF_B:
        y0 = torch.as_tensor(cs.stiff_y0(B), device=dev)
        a = cs.solve_args(y0, cs.STIFF_TF, *cs.STIFF_TOL, None, dev)
        hmin = torch.zeros(B, dtype=torch.float64, device=dev)
        for m in ("radau", "bdf"):
            for cp in ("float32", "state"):
                p = stiff_spec(m.upper(), 2, None,
                               {"controller_precision": cp}).params()
                run = {st: (lambda lib=loaded[m, st]: S.stiff_ensemble_cuda(
                    m.upper(), rhs.vdp, *a, (cs.STIFF_MU,), 100000, p, hmin,
                    lib=lib)) for st in STIFF_OCC}
                ref = stiff_carry_fields(m.upper(), S.stiff_ensemble_cuda(
                    m.upper(), rhs.vdp, *a, (cs.STIFF_MU,), 100000, p, hmin))
                equal = {}
                for st in STIFF_OCC:
                    got = stiff_carry_fields(m.upper(), run[st]())
                    equal[st] = not any(carry_lanes_differing(got, ref).values())
                del got, ref
                ms = {st: [] for st in STIFF_OCC}
                for r in range(STIFF_OCC_ROUNDS):
                    for st in (STIFF_OCC if r % 2 == 0 else STIFF_OCC[::-1]):
                        ms[st].append(turn_ms(run[st]))
                ranked = sorted(STIFF_OCC, key=lambda st: np.median(ms[st]))
                lay = {st: S.layout(m, rhs.vdp, cp, B, lib=loaded[m, st])
                       for st in STIFF_OCC}
                line("stiff_occupancy", kernel=m, controller=cp, B=B,
                     rounds=STIFF_OCC_ROUNDS,
                     bitwise_equal=all(equal.values()),
                     ms_median={f"{t}x{mb}": round(float(np.median(ms[t, mb])), 4)
                                for t, mb in STIFF_OCC},
                     blocks_per_sm={f"{t}x{mb}": lay[t, mb]["blocks_per_sm"]
                                    for t, mb in STIFF_OCC},
                     registers={f"{t}x{mb}": lay[t, mb]["registers"]
                                for t, mb in STIFF_OCC},
                     fastest=[f"{t}x{mb}" for t, mb in ranked[:3]])
        del y0, a


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="a csrc directory to build and hold against "
                         "(repeatable)")
    ap.add_argument("--phases",
                    help=f"comma-separated subset of {','.join(PHASES)} "
                         "(default: all; ab, which includes ab_record, "
                         "and ab_stiff only with --baseline)")
    ap.add_argument("--occupancy-methods", default="DOP853,RK23,RK4,DOPRI5",
                    help="methods whose libraries erk_occupancy sweeps")
    ap.add_argument("--sass-dir", type=Path,
                    help="write each SASS listing the phases read here")
    ap.add_argument("--split-method", default="DOP853",
                    choices=sorted(STAMP_METHOD),
                    help="the method cycle_split and cover_share measure")
    ap.add_argument("--ab-methods", default=None,
                    help="methods whose erk kernels ab_erk and ab_events "
                         "hold and time (default: all)")
    ap.add_argument("--variants", default="",
                    help="';'-separated builds of the package's erk sources "
                         "that ab_events also holds and times, each "
                         "'+'-joined -D defines (e.g. A=1+B=0;A=2)")
    opts = ap.parse_args()
    global SASS_DIR
    SASS_DIR = opts.sass_dir
    phases = (set(opts.phases.split(",")) if opts.phases else
              set(PHASES) - ({"ab_record", "ab_stiff", "ab_events",
                              "ab_resume", "rehearse", "ab_erk",
                              "cycle_split", "stiff_split",
                              "event_split", "ab_stiff_events"}
                             if opts.baseline else
                             {"ab", "ab_record", "ab_stiff", "ab_events",
                              "ab_resume", "rehearse", "ab_erk",
                              "cycle_split", "stiff_split",
                              "event_split", "ab_stiff_events"}))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
    if phases & {"ab", "ab_record", "ab_stiff", "ab_events", "ab_erk",
                 "ab_resume", "rehearse", "cycle_split",
                 "stiff_split", "ab_stiff_events"} and not opts.baseline:
        ap.error("the ab phases, rehearse, cycle_split and stiff_split need "
                 "--baseline")
    if phases == {"rehearse"}:
        torch.set_num_threads(2)
        return int(not all([rehearse(b, baseline_label(b))
                            for b in opts.baseline]))
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
    if phases & {"sass", "erk", "erk_occupancy", "ab", "ab_record",
                 "cover_share", "events", "ab_events", "resume_profile",
                 "ab_erk"}:
        t = time.perf_counter()
        erk_libs = build.build_all()
        line("build_all", seconds=round(time.perf_counter() - t, 3),
             libraries=sorted(p.name for p in erk_libs.values()))
        for name in ERK_LIBS:
            for fn, regs, st, ld in build.ptxas_report(erk_libs[name]):
                line("ptxas", build="new", instantiation=instantiation(fn),
                     registers=regs, spill_stores=st, spill_loads=ld)
    if "sass" in phases:
        sass_report(lib, "new")
        for name in ERK_LIBS:
            sass_report(erk_libs[name], f"new:{name}",
                        only=("Lorenz/f32", "VdP/f32/lean"))
        for name in ("radau", "bdf"):
            stiff_sass_report(erk_libs[name], "new")

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
    if "erk" in phases:
        erk_sweep(rhs, dev)
        dopri5_options_path(k, rhs, dev)
    if "erk_occupancy" in phases:
        erk_occupancy(build, rhs, dev, opts.occupancy_methods.split(","))
    if "events" in phases:
        events_phase(build, dev)
    if "cover_share" in phases:
        cover_share(build, dev, opts.baseline, opts.split_method)
    if "fast_paths" in phases:
        fast_paths(build, dev)
    if "cycle_split" in phases:
        cycle_split(build, dev, opts.baseline, opts.split_method)
    if "event_split" in phases:
        event_split(build, dev, [(baseline_label(b), b) for b in opts.baseline]
                    + [("new", build.SRC_DIR)])
    if "stiff_split" in phases:
        stiff_split(build, dev, opts.baseline)
    if "stiff" in phases:
        stiff_phase(build, dev)
    if "resume_profile" in phases:
        resume_profile(dev)
    for baseline in (opts.baseline if phases & {
            "ab", "ab_record", "ab_stiff", "ab_events", "ab_resume",
            "resume_profile", "ab_erk", "ab_stiff_events"} else ()):
        label = baseline_label(baseline)
        if "ab_stiff" in phases:
            ab_stiff(build, dev, baseline, label)
        if "ab_stiff_events" in phases:
            ab_stiff_events(build, dev, baseline, label)
        if "ab_events" in phases:
            ab_events(build, dev, baseline, label,
                      opts.ab_methods.split(",") if opts.ab_methods else None,
                      [tuple(v.split("+")) for v in
                       opts.variants.split(";") if v])
        if "ab_resume" in phases:
            ab_resume(build, dev, baseline, label)
        if "resume_profile" in phases:
            side = side_modules(baseline)
            side_libraries(build, side, baseline)
            resume_profile(dev, side, label)
        if "ab" in phases:
            ab(k, build, rhs, dev, baseline, label)
        if phases & {"ab", "ab_erk"}:
            ab_erk(build, rhs, dev, baseline, label,
                   opts.ab_methods.split(",") if opts.ab_methods else None)
        if phases & {"ab", "ab_record"}:
            ab_record(build, rhs, dev, baseline, label)
    if "stiff_occupancy" in phases:
        stiff_occupancy(build, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
