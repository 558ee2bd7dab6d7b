"""The fused DOPRI5 ensemble kernel: wrapper, CUDA launch and plain version.

``dopri5_ensemble`` integrates a ``(B, n)`` ensemble to each lane's final
state.  It is the one entry the solvers call (batch.py), and it picks the
route from the device of ``y0``:

* a CPU tensor runs :func:`dopri5_ensemble_torch`, the plain version: the
  ported driver (core/driver.py) around ``methods/erk.py::dopri5_attempt``
  on the whole batch;
* a CUDA tensor with a :class:`~ivp_tpu_torch.rhs.CudaRHS` launches the
  hand-written kernel ``csrc/dopri5_ensemble.cu`` (:func:`dopri5_ensemble_cuda`),
  which replaces ``attic/pallas_erk.py::dopri5_ensemble_pallas``;
* a CUDA tensor with any other callable raises NotImplementedError.

There is no fallback: a failed build or launch raises.  Every route takes
the same per-lane arguments, already broadcast by the caller:
``y0 (B, n)``, ``t0, tf, hmax (B,)``, ``first_step (B,)`` or None (hinit),
``rtol, atol (B, n)``, the RHS ``args`` and ``max_steps``.  Each returns
``(t, y, status, nfev, nstep, naccpt, nrejct)``.

:func:`solve_bound` gives the least time an H100 could take for a solve,
from the float64 work of its attempts (``FLOPS_PER_ATTEMPT``) and the bytes
it must move.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.driver import DriverConfig, make_driver, run_args
from ..methods import get_engine
from ..rhs import CudaRHS
from . import build

# Kernel launches made by this process (dopri5_ensemble_cuda adds one per
# launch).  A caller may reset it to 0 to count the launches of one run.
LAUNCHES = 0

# Masked attempts per host check of the done mask in the plain version
# (build_ensemble_solver's default unroll in ivp_tpu).
_UNROLL = 4

# float64 operations of one attempt of the kernel's loop (csrc/
# dopri5_ensemble.cu), per functor: an add, subtract or multiply counts 1 (an
# FMA 2), a division 1; compares, fabs, selects and the float32 controller
# count 0.  Per state component: the stage sums of stages 2-6 and ynew,
# 3+5+7+9+11+11 = 46; the error vector h*(E1 k1+E3 k3+...+E7 k7), 12.  Per
# attempt: too_small 2 and last 4 (6), one division h/fac (1), t+h to advance
# (1); the t + c*h of the stages are dead (no functor reads t).  Not counted:
# the stiffness differences (2n subtractions on 1 attempt in ~1000) and each
# lane's hinit, so the bound stays a lower one.
FLOPS_PER_ATTEMPT = {
    # n=2: 2*46 + 6 RHS * 5 (mu*(1-y0*y0)*y1 - y0) + 2*12 + 6 + 1 + 1
    "vdp": 154,
    # n=1: 46 + 6 RHS * 1 (-k*y) + 12 + 6 + 1 + 1
    "decay": 72,
    # n=3: 3*46 + 6 RHS * 8 (2 + 3 + 3) + 3*12 + 6 + 1 + 1
    "lorenz": 230,
}
# NVIDIA H100 SXM data sheet: FP64 (not the tensor cores, which need a
# matrix product) and HBM3.
FP64_PEAK = 34e12     # flop/s
HBM_RATE = 3.35e12    # bytes/s

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
             _P, _P, _P, _P, _P, _P, _P, _P]


def dopri5_ensemble_torch(fun, y0, t0, tf, hmax, first_step, rtol, atol,
                          args=(), max_steps=100_000):
    """Plain PyTorch version: the ported driver on the whole batch, on the
    device of ``y0`` and in its dtype (float32 or float64)."""
    B, n = y0.shape
    dtype = y0.dtype

    def rhs(t, y):
        return torch.as_tensor(fun(t, y, *args), dtype=dtype,
                               device=y.device).reshape(B, n)

    engine, p = get_engine("DOPRI5", need_cont=False)
    init_carry, run_chunk, _ = make_driver(engine, p,
                                           DriverConfig(unroll=_UNROLL), rhs)
    ra = run_args(tf, rtol, atol, hmax, 0.0, max_steps, y0)
    t0 = torch.broadcast_to(torch.as_tensor(t0, dtype=dtype, device=y0.device),
                            (B,))
    c = run_chunk(init_carry(t0, y0, first_step, ra), ra)
    return c.t, c.y, c.status, c.nfev, c.nstep, c.naccpt, c.nrejct


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, y0 on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def solve_bound(fun: CudaRHS, nstep, peak=FP64_PEAK, rate=HBM_RATE):
    """``(ms, bound_by)``: the least time a card with float64 rate ``peak``
    and memory rate ``rate`` could take for a solve whose lanes made
    ``nstep`` attempts.  The larger of the float64 work of those attempts
    over ``peak`` and, over ``rate``, the bytes read once (y0, rtol, atol;
    t0, tf, hmax, first_step; the args) and written once (t, y; five int32
    counters).  ``bound_by`` is ``"operations"`` or ``"bytes"``."""
    nstep = torch.as_tensor(nstep)
    B, n = nstep.numel(), fun.n
    flops = FLOPS_PER_ATTEMPT[fun.name] * float(nstep.to(torch.float64).sum())
    nbytes = B * (8 * (3 * n + 4 + len(fun.defaults)) + 8 * (1 + n) + 4 * 5)
    t_ops, t_bytes = flops / peak, nbytes / rate
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def dopri5_ensemble_cuda(fun: CudaRHS, y0, t0, tf, hmax, first_step, rtol,
                         atol, args=(), max_steps=100_000, lib=None):
    """Launch the CUDA kernel on the current stream (no synchronisation).
    float64 only.  ``lib``: a library from ``build.load`` to launch from
    instead of the package's (measure_kernel.py's A/B and sweep)."""
    global LAUNCHES
    if not isinstance(fun, CudaRHS):
        raise TypeError(f"the CUDA kernel runs a CudaRHS, got {fun!r}")
    dev = y0.device
    if dev.type != "cuda":
        raise ValueError(f"y0 must be a CUDA tensor, got {dev}")
    B, n = y0.shape if y0.dim() == 2 else (-1, -1)
    f64 = torch.float64
    _check("y0", y0, (B, fun.n), f64, dev)
    for name, x in (("t0", t0), ("tf", tf), ("hmax", hmax)):
        _check(name, x, (B,), f64, dev)
    if first_step is None:
        first_step = torch.full((B,), float("nan"), dtype=f64, device=dev)
    _check("first_step", first_step, (B,), f64, dev)
    _check("rtol", rtol, (B, n), f64, dev)
    _check("atol", atol, (B, n), f64, dev)
    kargs = fun.kernel_args(args, B, dev)

    t_out = torch.empty((B,), dtype=f64, device=dev)
    y_out = torch.empty((B, n), dtype=f64, device=dev)
    ints = [torch.empty((B,), dtype=torch.int32, device=dev) for _ in range(5)]
    if B == 0:
        return (t_out, y_out, *ints)

    lib_n = build.entry(f"ivp_rhs_n_{fun.name}", [], lib=lib)()
    lib_nargs = build.entry(f"ivp_rhs_nargs_{fun.name}", [], lib=lib)()
    if (lib_n, lib_nargs) != (fun.n, kargs.shape[1]):
        raise RuntimeError(
            f"{fun!r} has n={fun.n}, {kargs.shape[1]} args; its CUDA functor "
            f"has n={lib_n}, {lib_nargs} args")
    launch = build.entry(f"ivp_dopri5_{fun.name}", _ARGTYPES, lib=lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(B, y0.data_ptr(), t0.data_ptr(), tf.data_ptr(),
                     hmax.data_ptr(), first_step.data_ptr(), rtol.data_ptr(),
                     atol.data_ptr(), kargs.data_ptr(), int(max_steps),
                     t_out.data_ptr(), y_out.data_ptr(),
                     *(x.data_ptr() for x in ints), stream)
    build.check(err, f"dopri5 kernel launch ({fun.name}, B={B})", lib)
    LAUNCHES += 1
    return (t_out, y_out, *ints)


def dopri5_ensemble(fun, y0, t0, tf, hmax, first_step, rtol, atol,
                    args=(), max_steps=100_000):
    """Route by the device of ``y0``: CPU -> plain version, CUDA -> kernel."""
    if y0.device.type == "cpu":
        return dopri5_ensemble_torch(fun, y0, t0, tf, hmax, first_step, rtol,
                                     atol, args, max_steps)
    if y0.device.type != "cuda":
        raise NotImplementedError(f"no route for device {y0.device}")
    if not isinstance(fun, CudaRHS):
        raise NotImplementedError(
            "on a CUDA device the ensemble solve runs a CudaRHS "
            "(ivp_tpu_torch.rhs) through the fused kernel; an arbitrary "
            "torch RHS on the GPU is not ported yet: ROADMAP §1 item 12 "
            "(arbitrary RHS on the GPU)")
    return dopri5_ensemble_cuda(fun, y0, t0, tf, hmax, first_step, rtol, atol,
                                args, max_steps)
