"""The resumable solver's launches on the card (batch.py::
build_resumable_solver): the carry is the plain driver's
:class:`~ivp_tpu_torch.core.driver.Carry`, and each ``resume`` is one kernel
launch that runs every lane until it is done or has made ``chunk_steps``
counted attempts, as ``core/driver.py::run_bounded`` counts them.

* Radau and BDF: the stiff kernels (kernels/stiff_ensemble.py,
  :class:`~ivp_tpu_torch.kernels.stiff_ensemble.StiffLaunch`).
* RK45, DOP853, RK23, RK4: the resumable mode of ``csrc/erk_common.cuh::
  erk_kernel`` (entries ``ivp_<kernel>_resume_<rhs>`` of each
  ``csrc/erk_*.cu``), which replaces ``ivp_tpu/core/driver.py::run_bounded``
  (:478-489) for the explicit engines.  It loads and stores the carry's
  ERKState as the carry holds it (``ErkResumeCarry``: the controller in its
  own type, ``reject`` as bool bytes) and derives DOPRI5's and DOP853's
  countdown to their periodic stiffness test from ``naccpt``.

A launch reads one carry and writes another, as ``ivp_tpu``'s jitted
``resume`` writes fresh buffers and leaves its input alone: the carry given
to ``resume`` is never written, and stays a valid checkpoint.  The new carry
holds the fields a launch writes in one fresh buffer per dtype, split into
views, and shares with the carry given the tensors no resumable launch
writes: the zero-size record, sample and event fields, ``n_restarts``, and
``njev`` and ``nlu`` of the explicit methods.  A carry's tensors must not
be written in place by the caller either.

A resumable solver keeps one :class:`CardSolve` for its launches on the
card (batch.py::build_resumable_solver's closure).  What every launch of a
solve passes the same (the run arguments checked and their addresses) is
made when a solve's ``ra`` is first seen and kept while the solver is given
the same ``ra``; what its solves share (the entry, the options; the
functor's arguments and the NaN first step of the last size and device) is
made once.  The functor's arguments are read once, as
``ivp_tpu``'s ``resume`` closes over them.  The card runs the lean solve;
``t_eval`` samples and events in the resumable solver run with
``device='cpu'`` (ROADMAP §1 item 16).
"""
from __future__ import annotations

import ctypes
import operator

import torch

from ..core.driver import Carry
from ..rhs import CudaRHS
from . import build
from . import carry as K
from . import erk_ensemble as E
from . import stiff_ensemble as S
from .carry import F64, STIFF
from .dopri5_ensemble import _check

# Launches made by this process, per explicit kernel in resumable mode (the
# stiff kernels count theirs in stiff_ensemble.LAUNCHES).  A caller may
# reset a count to 0.
LAUNCHES = {f"{k}_resume": 0 for k in ("dopri5", "dop853", "rk23", "rk4")}


class ResumeCarry(ctypes.Structure):
    """``ErkResumeCarry`` of csrc/erk_common.cuh (same layout): the fields
    an explicit resumable launch loads and stores."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "t", "y", "status", "done", "nfev", "nstep", "naccpt", "nrejct",
        "k1", "h", "facold", "hlamb", "reject", "iasti", "nonstiff",
        "posneg")]


ERK_FIELDS = tuple(f for f, _ in ResumeCarry._fields_)
_P, _I = ctypes.c_void_p, ctypes.c_int
# B; y0, t0, tf, hmax, first_step, rtol, atol, args; max_steps; options; the
# carry loaded, the carry stored; init; max_attempts; stream.
_ARGTYPES = ([_I] + [_P] * 8 + [_I, E.KernelOptions, ResumeCarry,
                                ResumeCarry, _I, _I, _P])


class CardSolve:
    """The launches on the card of one resumable solver of ``method`` on
    the functor ``fun`` with its arguments ``args`` and the options of
    ``params`` (an ERKParams, or a StiffSpec), from ``lib`` (default: the
    package's build of the method's source).  :meth:`start` and
    :meth:`resume` take a solve's batched RunArgs ``ra`` (float64, shaped
    ``(B,)`` and ``(B, n)`` for ``fun``, contiguous on one device), checked
    once while the same ``ra`` comes back (:meth:`bind`), and launch on
    ``stream`` (default: the current stream; 0 for a build rehearsed
    without nvcc on CPU tensors)."""

    def __init__(self, method, fun: CudaRHS, args, params, lib=None):
        self.method = method = method.upper()
        self.stiff = method in STIFF
        self.fun, self.fargs, self.lib = fun, args, lib
        self.p = p = params.params() if self.stiff else params
        self.cdt = (torch.float32 if p.controller_precision == "float32"
                    else F64)
        self.state = [f for f, *_ in K.state_specs(method, fun.n, self.cdt)]
        self.ra = self.lanes = None
        self.fields = ERK_FIELDS if not self.stiff else S.DRIVER_FIELDS + (
            S.RADAU_FIELDS if method == "RADAU" else S.BDF_FIELDS)
        # Each field of the carry given, in the order of the kernel's
        # structs, with the dtype the kernel reads.
        dtypes = {f: dt for f, _, dt in K.driver_specs(fun.n, self.stiff)
                  + K.state_specs(method, fun.n, self.cdt)}
        lin = {"RADAU": ("inv1", "br", "bi"), "BDF": ("inv",)}.get(method, ())

        def getter(f):
            if f in Carry._fields:
                return operator.attrgetter(f)
            if f in lin:   # the inverse backend's lin tuple, spelt out
                return lambda c, j=lin.index(f): c.ms.lin[j]
            return operator.attrgetter(f"ms.{f}")
        self.read = [(getter(f), dtypes[f]) for f in self.fields]
        if self.stiff:
            return
        kernel, source = E.KERNELS[method]
        self.name = f"{kernel.replace('_sampled', '')}_resume"
        if lib is None:
            self.lib = build.library(source)
        self.entry = build.entry(f"ivp_{kernel}_resume_{fun.name}",
                                 _ARGTYPES, lib=self.lib)
        self.opts = E.kernel_options(p)

    def bind(self, ra) -> None:
        """Make what every launch with ``ra`` passes the same, unless the
        last launch had this very ``ra``."""
        if ra is self.ra:
            return
        dev = ra.rtol.device
        B, n = ra.rtol.shape
        if self.lanes is None or self.lanes[0] != (B, dev):
            # The NaN first step and the functor's arguments of B lanes on
            # dev.
            nan = torch.full((B,), float("nan"), dtype=F64, device=dev)
            kargs = None
            if not self.stiff:
                kargs = self.fun.kernel_args(self.fargs, B, dev)
                E.check_functor(self.lib, self.fun, kargs)
            self.lanes = ((B, dev), nan, kargs)
        self.B, self.n, self.dev = B, n, dev
        self.new = K.layout(self.method, n, self.cdt, B)
        if self.stiff:
            self.launch = S.StiffLaunch(self.method, self.fun, ra, self.fargs,
                                        self.p, self.lib)
        else:
            for name, x in (("tf", ra.tend), ("hmax", ra.hmax)):
                _check(name, x, (B,), F64, dev)
            _check("rtol", ra.rtol, (B, self.fun.n), F64, dev)
            _check("atol", ra.atol, (B, self.fun.n), F64, dev)
            self.args = (ra.tend.data_ptr(), ra.hmax.data_ptr(),
                         ra.rtol.data_ptr(), ra.atol.data_ptr(),
                         self.lanes[2].data_ptr(), int(ra.max_steps))
        # Held: the launches read its tensors at these addresses.
        self.ra = ra

    def start(self, y0, t0, first_step, ra, stream=None) -> Carry:
        """The carry of a fresh solve: the init launch (no attempts) from
        ``y0`` ``(B, n)``, ``t0`` and ``first_step`` ``(B,)`` (None: the
        method picks it)."""
        self.bind(ra)
        B, dev = self.B, self.dev
        fs = self.lanes[1] if first_step is None else first_step
        _check("y0", y0, (B, self.n), F64, dev)
        for name, x in (("t0", t0), ("first_step", fs)):
            _check(name, x, (B,), F64, dev)
        c, ptrs = K.new(self.method, B, self.n, self.cdt, dev)
        out = [ptrs[k] for k in self.fields]
        self._launch(out, out, y0, t0, fs, True, 0, stream)
        return c

    def resume(self, carry: Carry, ra, max_attempts: int,
               stream=None) -> Carry:
        """One launch of at most ``max_attempts`` counted attempts a lane
        from ``carry`` (not changed) to a new carry."""
        self.bind(ra)
        if carry.y.shape[0] != self.B:
            raise ValueError(f"the carry has {carry.y.shape[0]} lanes, the "
                             f"run arguments {self.B}")
        # A field that is not as the kernel reads it (contiguous, of its
        # dtype, on the device) is read from a copy, held until the launch
        # is queued: the carry given is not changed.
        dev, held, ins = self.dev, [], []
        for get, dt in self.read:
            x = get(carry)
            if x.dtype != dt or x.device != dev or not x.is_contiguous():
                x = x.to(device=dev, dtype=dt).contiguous()
                held.append(x)
            ins.append(x.data_ptr())
        f, ptrs = self.new.alloc(dev)
        c = carry._replace(
            ms=K.state(self.method, {k: f.pop(k) for k in self.state}), **f)
        self._launch(ins, [ptrs[k] for k in self.fields], None, None, None,
                     False, max_attempts, stream)
        return c

    def _launch(self, ins, outs, y0, t0, fs, init, max_attempts, stream):
        """One launch from the carry at addresses ``ins`` to the one at
        ``outs``."""
        if self.B == 0:
            return
        if stream is None:
            # The current stream's handle, without the torch.cuda.Stream
            # that current_stream() builds (~10 µs of a launch's host time).
            stream = torch._C._cuda_getCurrentRawStream(self.dev.index)
        if self.stiff:
            nd = len(S.DRIVER_FIELDS)
            self.launch.raw(ins[:nd], ins[nd:], outs[:nd], outs[nd:], y0, t0,
                            fs, init, max_attempts, stream)
            return
        ptr = lambda v: 0 if v is None else v.data_ptr()
        tend, hmax, rtol, atol, kargs, max_steps = self.args
        err = self.entry(self.B, ptr(y0), ptr(t0), tend, hmax, ptr(fs), rtol,
                         atol, kargs, max_steps, self.opts,
                         ResumeCarry(*ins), ResumeCarry(*outs), int(init),
                         int(max_attempts), stream)
        build.check(err, f"{self.name} launch (B={self.B})", self.lib)
        LAUNCHES[self.name] += 1
