"""The resumable solver's launches on the card (batch.py::
build_resumable_solver): the carry is the plain driver's
:class:`~ivp_tpu_torch.core.driver.Carry`, and each ``resume`` is one kernel
launch that runs every lane until it is done or has made ``chunk_steps``
counted attempts, as ``core/driver.py::run_bounded`` counts them.

* Radau and BDF: the stiff kernels (kernels/stiff_ensemble.py), which read
  and write the carry's tensors, RadauState or BDFState included, in place.
* RK45, DOP853, RK23, RK4: the resumable mode of ``csrc/erk_common.cuh::
  erk_kernel`` (entries ``ivp_<kernel>_resume_<rhs>`` of each
  ``csrc/erk_*.cu``), which replaces ``ivp_tpu/core/driver.py::run_bounded``
  (:478-489) for the explicit engines.  It keeps the record mode's lane
  carry (``ErkCarry``: k1, h, the controller's facold and hlamb widened to
  double, the stiffness counters) with no rows; this module moves the
  carry's ERKState in and out of it (the widening is exact), and derives
  DOPRI5's countdown to its periodic stiffness test from ``naccpt``.

A launch never changes the carry it is given: ``resume`` clones it first, so
an older carry stays a valid checkpoint.  The card runs the lean solve;
``t_eval`` samples and events in the resumable solver run with
``device='cpu'`` (ROADMAP §1 item 16).
"""
from __future__ import annotations

import torch

from ..core.driver import Carry
from ..methods.erk import ERKState
from ..rhs import CudaRHS
from ..types import Status
from . import build
from . import erk_ensemble as E
from . import erk_record as R
from . import stiff_ensemble as S

# Launches made by this process, per explicit kernel in resumable mode (the
# stiff kernels count theirs in stiff_ensemble.LAUNCHES).  A caller may
# reset a count to 0.
LAUNCHES = {f"{k}_resume": 0 for k in ("dopri5", "dop853", "rk23", "rk4")}

_ARGTYPES = E._ARGTYPES[:-1] + [R.KernelCarry, E._I, E._P]


def _direction_t0(c: Carry, tend):
    """A start time whose direction to ``tend`` is the lane's ``posneg``
    (the kernel reads the direction from ``sign(tend - t0)``)."""
    d = c.ms.posneg * torch.clamp_min(torch.abs(tend), 1.0)
    return (tend - d).contiguous()


def stiff_in(naccpt, stiff_test: int):
    """DOPRI5's accepted attempts until its periodic stiffness test, 0
    exactly where ``(naccpt + 1) % stiff_test == 0``
    (``csrc/erk_dopri5.cu``, ``Lane::stiff_in``)."""
    s = abs(int(stiff_test))
    if s == 0:
        return (-1 - naccpt).to(torch.int32)
    return torch.remainder(s - 1 - naccpt, s).to(torch.int32)


def empty_erk_carry(B, n, cdt, device) -> Carry:
    """A lean explicit-tier Carry of ``B`` lanes for the init launch."""
    e = lambda *s, dt=torch.float64: torch.empty(s, dtype=dt, device=device)
    ms = ERKState(h=e(B), k1=e(B, n), facold=e(B, dt=cdt),
                  reject=e(B, dt=torch.bool), iasti=e(B, dt=torch.int32),
                  nonstiff=e(B, dt=torch.int32), hlamb=e(B, dt=cdt),
                  posneg=e(B))
    return S.lean_carry(ms, B, n, device)


def erk_resume_launch(method, fun: CudaRHS, c: Carry, ra, y0, t0, first_step,
                      args, params, init: bool, max_attempts: int, lib=None,
                      stream=None) -> None:
    """One launch of ``method``'s kernel in resumable mode on the carry
    ``c`` (updated in place), from ``lib`` (default: the package's build of
    the method's source) on ``stream`` (default: the current stream; 0 for a
    build rehearsed without nvcc on CPU tensors).  ``init``: run the
    method's init from ``y0``, ``t0`` (``first_step`` NaN where hinit picks
    it) first."""
    method = method.upper()
    kernel, source = E.KERNELS[method]
    dev = c.y.device
    B, n = c.y.shape
    if B == 0:
        return
    f64, i32 = torch.float64, torch.int32
    ms = c.ms
    if init:
        t0_arg = t0
    else:
        t0_arg = _direction_t0(c, ra.tend)
        y0 = c.y
        first_step = torch.full((B,), float("nan"), dtype=f64, device=dev)
    first_step, _, _ = E.check_inputs(fun, y0, t0_arg, ra.tend, ra.hmax,
                                      first_step, ra.rtol, ra.atol, None)
    kargs = fun.kernel_args(args, B, dev)
    lib = build.library(source) if lib is None else lib
    E.check_functor(lib, fun, kargs)
    # The lane carry as the kernel keeps it: the controller widened to
    # double, the reject flag as int.
    facold, hlamb = ms.facold.to(f64), ms.hlamb.to(f64)
    reject = ms.reject.to(i32)
    countdown = (stiff_in(c.naccpt, params.stiff_test) if not init
                 else torch.empty((B,), dtype=i32, device=dev))
    iasti, nonstiff = ms.iasti.contiguous(), ms.nonstiff.contiguous()
    carry = R.KernelCarry(ms.k1.data_ptr(), ms.h.data_ptr(),
                          facold.data_ptr(), hlamb.data_ptr(),
                          reject.data_ptr(), iasti.data_ptr(),
                          nonstiff.data_ptr(), countdown.data_ptr(),
                          int(bool(init)))
    entry = build.entry(f"ivp_{kernel}_resume_{fun.name}", _ARGTYPES, lib=lib)
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = entry(B, y0.data_ptr(), t0_arg.data_ptr(), ra.tend.data_ptr(),
                ra.hmax.data_ptr(), first_step.data_ptr(), ra.rtol.data_ptr(),
                ra.atol.data_ptr(), kargs.data_ptr(), int(ra.max_steps),
                E.kernel_options(params), 0, 0, 0, c.t.data_ptr(),
                c.y.data_ptr(), c.status.data_ptr(), c.nfev.data_ptr(),
                c.nstep.data_ptr(), c.naccpt.data_ptr(), c.nrejct.data_ptr(),
                0, 0, carry, int(max_attempts), stream)
    build.check(err, f"{kernel} resumable launch (B={B})", lib)
    LAUNCHES[f"{E.KERNELS[method][0].replace('_sampled', '')}_resume"] += 1
    ms.facold.copy_(facold)
    ms.hlamb.copy_(hlamb)
    ms.reject.copy_(reject != 0)
    if init:
        ms.posneg.copy_(torch.sign(ra.tend - t0))
    torch.ne(c.status, Status.RUNNING, out=c.done)


def start_on_card(method, fun, y0, t0, first_step, args, ra, params,
                  lib=None, stream=None):
    """The carry of a fresh solve on the card: the init launch (no
    attempts).  ``lib``, ``stream``: as the launches take them."""
    B, n = y0.shape
    fs = (first_step if first_step is not None else
          torch.full((B,), float("nan"), dtype=torch.float64,
                     device=y0.device))
    stiff = method in ("RADAU", "BDF")
    p = params.params() if stiff else params
    cdt = (torch.float32 if p.controller_precision == "float32"
           else torch.float64)
    if stiff:
        c = S.empty_carry(method, B, n, cdt, y0.device)
        S.stiff_launch(method, fun, c, ra, y0, t0, fs, args, p, True, 0, lib,
                       stream)
    else:
        c = empty_erk_carry(B, n, cdt, y0.device)
        erk_resume_launch(method, fun, c, ra, y0, t0, fs, args, p, True, 0,
                          lib, stream)
    return c


def resume_on_card(method, fun, carry: Carry, args, ra, params,
                   max_attempts: int, lib=None, stream=None) -> Carry:
    """One bounded launch on a copy of ``carry``."""
    c = S.clone_carry(carry)
    B = c.y.shape[0]
    nan = torch.full((B,), float("nan"), dtype=torch.float64,
                     device=c.y.device)
    if method in ("RADAU", "BDF"):
        S.stiff_launch(method, fun, c, ra, c.y, c.t, nan, args,
                       params.params(), False, max_attempts, lib, stream)
    else:
        erk_resume_launch(method, fun, c, ra, c.y, c.t, nan, args, params,
                          False, max_attempts, lib, stream)
    return c
