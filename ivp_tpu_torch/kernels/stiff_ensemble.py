"""The stiff tier's fused ensemble kernels: router, launches, carry, plain
version.

``stiff_ensemble`` integrates a ``(B, n)`` ensemble with Radau or BDF to
each lane's final state, or with its states on a ``t_grid``; a
:class:`StiffLaunch` launches the kernel of one solve, from one carry to
another, which kernels/resumable.py runs in bounded launches for the
resumable solver (batch.py) and kernels/erk_record.py in chunks for the
record mode.  The route follows the device of ``y0``:

* a CPU tensor runs the plain version: the ported driver
  (core/driver.py) around the ported engine (methods/radau.py,
  methods/bdf.py) on the whole batch;
* a CUDA tensor with a :class:`~ivp_tpu_torch.rhs.CudaRHS` that has a
  Jacobian launches the hand-written kernel of the method:

  ====== ================ ===============================================
  kernel source           replaces (XLA-fused in ``ivp_tpu``)
  ====== ================ ===============================================
  radau  csrc/radau.cu    core/driver.py's loop around methods/radau.py::
                          make_radau_attempt (:348) with core/linalg.py::
                          inv (:280) and inv_complex (:327)
  bdf    csrc/bdf.cu      the same loop around methods/bdf.py::
                          make_bdf_attempt (:312), change_d (:232), inv
  ====== ================ ===============================================

  Each kernel has three modes (csrc/stiff_common.cuh): LEAN, SAMPLED
  (the samples on a t_grid, the driver's sample mode) and RECORD (one row
  per accepted step, the driver's record mode), the last two through a
  :class:`Modes` (``ivp_<kernel>_modes_<rhs>`` entries).  No TPU kernel
  stands behind either.  Each launch loads every lane's
  carry (the plain driver's :class:`~ivp_tpu_torch.core.driver.Carry` with
  its RadauState or BDFState: the very tensors, struct of arrays), runs
  each lane until it is done or has made ``max_attempts`` counted attempts,
  and stores the carry whole to another carry, or to the same one; a
  solve's first launch runs the method's init from ``y0`` and ``t0``
  instead of loading.  ``build_ensemble_solver`` makes one launch with no
  budget;
* anything else raises NotImplementedError.

On the card only the inverse linear backend runs (n <= 8), with the
functor's Jacobian and float64 state; ``linear_mode="lu"``, a callable or
constant ``jac``, n > 8 and float32 raise NotImplementedError (ROADMAP §1
item 15) before anything is placed.  With events (a declared event set of
the CudaRHS, ivp_tpu_torch/events.py: ``crossing`` of ``rhs.vdp``,
``replenish`` of ``rhs.decay``) each mode launches the set's event entry
(``ivp_<kernel>_ev_<rhs>_<set>`` of csrc/radau_ev.cu and csrc/bdf_ev.cu,
the kernels' template with the set, csrc/stiff_events.cuh), counted in
``LAUNCHES`` as ``<kernel>[_sampled|_record|_record_cont]_ev``.  There is
no fallback: a failed build or launch raises.

:func:`stiff_bound` gives the least time an H100 could take for a solve
from the float64 operations its lanes did (:func:`stiff_flops`) and the
bytes it moved, its samples and rows included.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.driver import Carry, run_args
from ..methods.jacobian import StiffSpec
from ..methods.radau import INV_AUTO_N, STIFF_REST_ITEM
from ..rhs import CudaRHS
from . import build, carry
from .dopri5_ensemble import FP64_PEAK, HBM_RATE, _check
from . import erk_ensemble as E

# Launches made by this process, per kernel and mode (``<kernel>``: lean;
# ``_sampled``; ``_record``: steps, ``_record_cont``: with coefficients;
# each with ``_ev`` for its event mode); a StiffLaunch adds one per launch.
# A caller may reset a count to 0.
LAUNCHES = {f"{k}{m}{e}": 0 for k in ("radau", "bdf")
            for m in ("", "_sampled", "_record", "_record_cont")
            for e in ("", "_ev")}

# csrc/stiff_common.cuh's modes.
LEAN, SAMPLED, RECORD = 0, 1, 2

# The most attempts one launch may make (a solve's single launch).
UNBOUNDED = 2**31 - 1

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


class KernelRun(ctypes.Structure):
    """``StiffRun`` of csrc/stiff_common.cuh."""

    _fields_ = [(f, _P) for f in ("tend", "rtol", "atol", "hmax", "hmin")] \
        + [("max_steps", _I)]


class KernelDriver(ctypes.Structure):
    """``StiffDriver`` of csrc/stiff_common.cuh: the Carry's driver fields."""

    _fields_ = [(f, _P) for f in ("t", "y", "status", "done", "nfev", "njev",
                                  "nlu", "nstep", "naccpt", "nrejct")]


class RadauOptions(ctypes.Structure):
    """``RadauOptions`` of csrc/radau.cu."""

    _fields_ = [(f, _D) for f in ("uround", "safety", "facl", "facr", "cfac",
                                  "thet", "quot1", "quot2", "newton_tol")] \
        + [(f, _I) for f in ("newton_maxiter", "predictive", "const_jac",
                             "state_precision")]


class BDFOptions(ctypes.Structure):
    """``BDFOptions`` of csrc/bdf.cu."""

    _fields_ = [("newton_tol", _D)] + [(f, _I) for f in (
        "newton_maxiter", "const_jac", "state_precision")]


RADAU_FIELDS = ("h", "hold", "posneg", "f0", "cont", "scal", "first",
                "reject", "last", "faccon", "theta", "hhfac", "h_acc",
                "err_acc", "call_jac", "call_decomp", "singular", "jac",
                "inv1", "br", "bi")
BDF_FIELDS = ("h_abs", "posneg", "D", "order", "n_equal", "jac", "inv",
              "lu_current", "current_c")


class KernelModes(ctypes.Structure):
    """``StiffModes`` of csrc/stiff_common.cuh."""

    _fields_ = [("t_grid", _P), ("m", _I), ("grid_stride", _I),
                ("y_samples", _P), ("n_samples", _P), ("rows", _P),
                ("n_rec", _P), ("cap", _I), ("stride", _I),
                ("record_cont", _I)]


class Modes:
    """What a SAMPLED or RECORD launch of ``B`` lanes of ``method`` with
    ``n`` components writes, on ``dev``: with a ``t_grid`` ``(B, m)``, the
    samples ``y_samples (B, m, n)`` (rows past a lane's count stay zero, as
    the plain version's) and their count ``n_samples (B,)``, which a launch
    that is not a solve's first continues; with ``rec_cap`` > 0 (RECORD),
    one chunk's ``rows (B, rec_cap, stride)`` and their count ``n_rec
    (B,)``: the kernels stage their rows in shared memory and write them by
    bulk copies (csrc/stiff_common.cuh's SlotsStage), so at the stride those
    copies need, ``erk_ensemble.record_stride`` (the row's width rounded up
    to even, whose pad is never read), and a launch refuses another.
    ``arg`` is the launch argument and ``key`` the LAUNCHES key."""

    def __init__(self, method, B, n, dev, t_grid=None, rec_cap=0,
                 record_cont=False):
        kernel = method.lower()
        f64, i32 = torch.float64, torch.int32
        self.m = m = 0 if t_grid is None else int(t_grid.shape[-1])
        self.cap = cap = int(rec_cap)
        if not m and not cap:
            raise ValueError("a mode launch needs a t_grid or rec_cap > 0")
        self.C = E.record_coeffs(method) if record_cont else 0
        grid_ptr, grid_stride, self.grid = E.grid_arg(t_grid, B, dev)
        self.y_samples = (torch.zeros((B, m, n), dtype=f64, device=dev)
                          if m else None)
        self.n_samples = (torch.zeros((B,), dtype=i32, device=dev) if m
                          else None)
        stride = E.record_stride(method, n, record_cont)
        self.rows = (torch.empty((B, cap, stride), dtype=f64, device=dev)
                     if cap else None)
        self.n_rec = (torch.zeros((B,), dtype=i32, device=dev) if cap
                      else None)
        ptr = lambda x: 0 if x is None else x.data_ptr()
        self.arg = KernelModes(grid_ptr, m, grid_stride, ptr(self.y_samples),
                               ptr(self.n_samples), ptr(self.rows),
                               ptr(self.n_rec), cap, stride,
                               int(record_cont))
        self.key = (f"{kernel}_sampled" if not cap else
                    f"{kernel}_record{'_cont' if record_cont else ''}")


class RadauCarryArg(ctypes.Structure):
    _fields_ = [(f, _P) for f in RADAU_FIELDS]


class BDFCarryArg(ctypes.Structure):
    _fields_ = [(f, _P) for f in BDF_FIELDS]


# The keys of a stiff instantiation's layout, in the order
# csrc/stiff_common.cuh::slots_layout fills them (a staged RECORD
# instantiation's lane and block bytes hold its stage), then a mode's:
# its RECORD stage's rows a lane and bytes a lane (0 unstaged: every
# SAMPLED instantiation).
LAYOUT_KEYS = ("threads", "min_blocks", "lane_bytes", "block_bytes",
               "blocks_per_sm", "registers", "local_bytes")
STAGE_KEYS = ("stage_rows", "stage_lane_bytes")


def layout(method, fun, controller="float32", B=1, lib=None,
           mode=LEAN, record_cont=False) -> dict:
    """The instantiation a launch of ``B`` lanes in ``mode`` takes, as the
    library reports it (``ivp_<kernel>_layout_<rhs>``, the modes'
    ``ivp_<kernel>_modes_layout_<rhs>``, RECORD with coefficients or
    without): ``LAYOUT_KEYS``, blocks an SM holds at once by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, registers and
    local-memory bytes a thread by cudaFuncGetAttributes; a mode's also
    ``STAGE_KEYS``.  Needs the card."""
    kernel = method.lower()
    lib = build.library(kernel) if lib is None else lib
    keys = LAYOUT_KEYS + (STAGE_KEYS if mode != LEAN else ())
    info = (ctypes.c_int * len(keys))()
    args = (int(controller != "float32"), int(B),
            ctypes.cast(info, ctypes.c_void_p))
    if mode == LEAN:
        entry = build.entry(f"ivp_{kernel}_layout_{fun.name}", [_I, _I, _P],
                            lib=lib)
    else:
        entry = build.entry(f"ivp_{kernel}_modes_layout_{fun.name}",
                            [_I, _I, _I, _P, _I], lib=lib)
        args = (int(mode),) + args + (int(record_cont),)
    build.check(entry(*args), f"{kernel} layout (mode {mode})", lib)
    return dict(zip(keys, info))


def radau_options(p) -> RadauOptions:
    """A RadauParams as the kernel's launch argument: each float is the
    Python float the plain version hands to a tensor operation."""
    return RadauOptions(
        uround=p.uround, safety=p.safety, facl=1.0 / p.scale_min,
        facr=1.0 / p.scale_max,
        cfac=p.safety * (1.0 + 2.0 * p.newton_maxiter), thet=p.thet,
        quot1=p.quot1, quot2=p.quot2,
        newton_tol=float("nan") if p.newton_tol is None else p.newton_tol,
        newton_maxiter=p.newton_maxiter, predictive=int(p.predictive),
        const_jac=int(p.const_jac),
        state_precision=int(p.controller_precision != "float32"))


def bdf_options(p) -> BDFOptions:
    return BDFOptions(newton_tol=p.newton_tol,
                      newton_maxiter=p.newton_maxiter,
                      const_jac=int(p.const_jac),
                      state_precision=int(p.controller_precision != "float32"))


def _ms_fields(method, ms) -> dict:
    """The kernel's carry fields of a RadauState / BDFState (the inverse
    backend's ``lin`` spelt out)."""
    d = ms._asdict()
    lin = d.pop("lin")
    if method == "RADAU":
        d.update(inv1=lin[0], br=lin[1], bi=lin[2])
    else:
        d.update(inv=lin[0])
    return d


def empty_carry(method, B, n, cdt, device) -> Carry:
    """A lean Carry of ``B`` lanes with ``method``'s state (controller type
    ``cdt``) for the stiff kernel's init launch to fill (kernels/
    carry.py)."""
    return carry.new(method, B, n, cdt, device)[0]


def check_card(spec: StiffSpec, fun) -> None:
    """NotImplementedError for what the stiff kernels do not run: raised
    before anything is placed."""
    item = f"ROADMAP §1 {STIFF_REST_ITEM}"
    if not isinstance(fun, CudaRHS) or fun.jac is None:
        raise NotImplementedError(
            f"Radau and BDF on the card run a CudaRHS with a Jacobian "
            f"(rhs.vdp, rhs.decay, rhs.robertson); {fun!r} runs with "
            f"device='cpu': {item}")
    if spec.jac is not None:
        raise NotImplementedError(
            f"a callable or constant jac runs with device='cpu'; on the card "
            f"the Jacobian is the CudaRHS's own: {item}")
    if spec.n > INV_AUTO_N:
        raise NotImplementedError(
            f"Radau and BDF on the card run n <= {INV_AUTO_N} (the inverse "
            f"backend), got n={spec.n}: {item}")
    p = spec.params()
    if p.linear_mode == "lu":
        raise NotImplementedError(
            f"linear_mode='lu' runs with device='cpu'; the kernels invert "
            f"(n <= {INV_AUTO_N}): {item}")


# B; y0, t0, first_step; the run; args; options; the driver and method
# carry loaded (d_in, c_in), then stored (d, c); init, max_attempts; stream.
_ARGTYPES = [_I, _P, _P, _P, KernelRun, _P, None, KernelDriver, None,
             KernelDriver, None, _I, _I, _P]
DRIVER_FIELDS = tuple(f for f, _ in KernelDriver._fields_)


class StiffLaunch:
    """The launches of one solve of ``method``'s kernel (csrc/radau.cu or
    csrc/bdf.cu, from ``lib``, default the package's build): what each
    launch passes the same is made once here (the batched RunArgs ``ra``
    checked, the functor's arguments, the options of the engine's
    RadauParams / BDFParams ``params``, the entry; with ``modes``, a
    :class:`Modes`, the SAMPLED or RECORD entry writing there).  With
    ``events`` (an EventArgs of the CudaRHS's declared set) the event entry
    of the set (``ivp_<kernel>_ev_<rhs>_<set>`` of csrc/radau_ev.cu or
    csrc/bdf_ev.cu; ``lib`` default the package's build of it) in the mode
    ``modes`` gives, LEAN without: its outputs in ``ev_out`` (an
    erk_ensemble.EventOut), and in RECORD the event values and hit counts
    kept between chunks (``ev_keep``).  A call is one launch from the carry
    ``c_in`` to the carry ``c`` (which may be the same)."""

    def __init__(self, method, fun: CudaRHS, ra, args, params, lib=None,
                 modes: "Modes | None" = None, events=None):
        method = method.upper()
        self.kernel = kernel = method.lower()
        self.method, self.fun = method, fun
        self.dev = dev = ra.rtol.device
        self.B = B = ra.rtol.shape[0]
        f64 = torch.float64
        for name, x in (("tend", ra.tend), ("hmax", ra.hmax),
                        ("hmin", ra.hmin)):
            _check(name, x, (B,), f64, dev)
        _check("rtol", ra.rtol, (B, fun.n), f64, dev)
        _check("atol", ra.atol, (B, fun.n), f64, dev)
        self.kargs = fun.kernel_args(args, B, dev)
        self.events, self.ev_out, self.ev_keep = events, None, None
        if events is not None:
            self.ev_out, self.ev_keep = E.event_buffers(
                events, B, fun.n, dev,
                carry=modes is not None and modes.cap > 0)
            ev_set, self.ev_arg = E.kernel_events(fun, events, self.ev_out,
                                                  self.ev_keep)
        self.lib = (build.library(kernel + ("" if events is None else "_ev"))
                    if lib is None else lib)
        E.check_functor(self.lib, fun, self.kargs)
        if method == "RADAU":
            self.opts, self.carry_t, self.fields = (
                radau_options(params), RadauCarryArg, RADAU_FIELDS)
        else:
            self.opts, self.carry_t, self.fields = (
                bdf_options(params), BDFCarryArg, BDF_FIELDS)
        argtypes = list(_ARGTYPES)
        argtypes[6], argtypes[8], argtypes[10] = (type(self.opts),
                                                  self.carry_t, self.carry_t)
        self.modes, self.key, name = modes, kernel, f"ivp_{kernel}_{fun.name}"
        if modes is not None:
            argtypes.insert(-1, KernelModes)
            self.key, name = modes.key, f"ivp_{kernel}_modes_{fun.name}"
        if events is not None:
            if modes is None:
                argtypes.insert(-1, KernelModes)
            argtypes.insert(-1, E.KernelEvents)
            self.key += "_ev"
            name = f"ivp_{kernel}_ev_{fun.name}_{ev_set.name}"
        self.entry = build.entry(name, argtypes, lib=self.lib)
        self.run = KernelRun(ra.tend.data_ptr(), ra.rtol.data_ptr(),
                             ra.atol.data_ptr(), ra.hmax.data_ptr(),
                             ra.hmin.data_ptr(), int(ra.max_steps))

    def pointers(self, c: Carry):
        """``(driver addresses, carry addresses)`` of the carry ``c``, in
        the order of StiffDriver and of the method's carry struct;
        ValueError for a field that is not contiguous on the launch's
        device."""
        ms = _ms_fields(self.method, c.ms)
        drv = [getattr(c, f) for f in DRIVER_FIELDS]
        mine = [ms[f] for f in self.fields]
        for f, x in zip(DRIVER_FIELDS + self.fields, drv + mine):
            if not x.is_contiguous() or x.device != self.dev:
                raise ValueError(f"carry field {f} must be contiguous on "
                                 f"{self.dev}")
        return [x.data_ptr() for x in drv], [x.data_ptr() for x in mine]

    def __call__(self, c_in, c, y0, t0, first_step, init: bool,
                 max_attempts: int, stream=None) -> None:
        """One launch on ``stream`` (default: the current stream of the
        device; 0 for a build rehearsed without nvcc on CPU tensors) that
        loads ``c_in`` (or, with ``init``, runs the method's init from
        ``y0``, ``t0`` and ``first_step``, NaN where the method picks it)
        and stores to ``c``."""
        if init:
            f64 = torch.float64
            _check("y0", y0, (self.B, self.fun.n), f64, self.dev)
            _check("t0", t0, (self.B,), f64, self.dev)
            _check("first_step", first_step, (self.B,), f64, self.dev)
        drv, carry = self.pointers(c)
        drv_in, carry_in = (drv, carry) if c_in is c else self.pointers(c_in)
        if stream is None:
            stream = torch.cuda.current_stream(self.dev).cuda_stream
        self.raw(drv_in, carry_in, drv, carry, y0, t0, first_step, init,
                 max_attempts, stream)

    def raw(self, drv_in, carry_in, drv, carry, y0, t0, first_step, init,
            max_attempts, stream) -> None:
        """The launch of :meth:`__call__` from the carries' addresses
        (``pointers``), unchecked."""
        B = self.B
        if B == 0:
            return
        ptr = lambda x: 0 if x is None else x.data_ptr()
        md = () if self.modes is None else (self.modes.arg,)
        if self.events is not None:
            md = (md or (KernelModes(),)) + (self.ev_arg,)
        err = self.entry(B, ptr(y0), ptr(t0), ptr(first_step), self.run,
                         self.kargs.data_ptr(), self.opts,
                         KernelDriver(*drv_in), self.carry_t(*carry_in),
                         KernelDriver(*drv), self.carry_t(*carry),
                         int(bool(init)), int(max_attempts), *md, stream)
        build.check(err, f"{self.key} kernel launch (B={B})", self.lib)
        LAUNCHES[self.key] += 1


def inverses(a, ai, lib=None, stream=None):
    """The stiff kernels' own inverses of a batch, for checking them:
    ``(inv, singular, (br, bi), csingular)`` of ``a (B, n, n)`` and of ``a +
    i ai``, n = 1..8, from the ``ivp_stiff_inverses`` entry of
    csrc/radau.cu (the device functions of csrc/stiff_common.cuh that
    core/linalg.py::inv and inv_complex are on the CPU)."""
    B, n = a.shape[0], a.shape[-1]
    f64, dev = torch.float64, a.device
    for name, x in (("a", a), ("ai", ai)):
        _check(name, x, (B, n, n), f64, dev)
    out = [torch.empty_like(a) for _ in range(3)]
    s = [torch.empty(B, dtype=torch.bool, device=dev) for _ in range(2)]
    lib = build.library("radau") if lib is None else lib
    entry = build.entry("ivp_stiff_inverses", [_I, _I] + [_P] * 8, lib=lib)
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(entry(n, B, a.data_ptr(), ai.data_ptr(),
                      *(x.data_ptr() for x in out),
                      *(x.data_ptr() for x in s), stream),
                f"inverses (n={n}, B={B})", lib)
    return out[0], s[0], (out[1], out[2]), s[1]


def controller_dtype(params):
    """The dtype of a stiff solve's controller fields (its RadauParams or
    BDFParams)."""
    return (torch.float32 if params.controller_precision == "float32"
            else torch.float64)


def nan_first_step(first_step, B, dev):
    """``first_step``, or NaN on every lane (the method picks it)."""
    if first_step is not None:
        return first_step
    return torch.full((B,), float("nan"), dtype=torch.float64, device=dev)


def stiff_ensemble_cuda(method, fun: CudaRHS, y0, t0, tf, hmax, first_step,
                        rtol, atol, args, max_steps, params, hmin,
                        lib=None, stream=None, t_grid=None,
                        events=None) -> Carry:
    """One launch with no budget from a fresh carry: the final-state solve,
    or with a ``(B, m)`` ``t_grid`` the SAMPLED one; with ``events`` (an
    EventArgs) the event entry of their set (``lib`` then a build of
    csrc/<kernel>_ev.cu).  Returns the carry (its ``t``, ``y``, status and
    counters are the result; with a grid its ``sample_y`` and ``s_cursor``
    hold the samples and their count; with events its ``ev`` holds the
    erk_ensemble.EventOut and ``n_restarts`` the restarts)."""
    method = method.upper()
    B, n = y0.shape
    c = empty_carry(method, B, n, controller_dtype(params), y0.device)
    ra = run_args(tf, rtol, atol, hmax, hmin, max_steps, y0)
    modes = None if t_grid is None else Modes(method, B, n, y0.device, t_grid)
    launch = StiffLaunch(method, fun, ra, args, params, lib, modes, events)
    launch(c, c, y0, t0, nan_first_step(first_step, B, y0.device), True,
           UNBOUNDED, stream)
    if modes is not None:
        c = c._replace(sample_y=modes.y_samples, s_cursor=modes.n_samples)
    if events is not None:
        c = c._replace(ev=launch.ev_out, n_restarts=launch.ev_out.n_restarts)
    return c


def stiff_ensemble(method, fun, y0, t0, tf, hmax, first_step, rtol, atol,
                   args, max_steps, spec: StiffSpec, hmin=0.0, t_grid=None,
                   events=None):
    """Route by the device of ``y0``: ``(t, y, status, nfev, nstep, naccpt,
    nrejct, y_samples, n_samples, njev, nlu)``, the samples None without a
    ``t_grid`` ``(B, m)``; with ``events`` (an EventArgs) their
    erk_ensemble.EventOut before ``njev``."""
    method = method.upper()
    if y0.device.type == "cpu":
        out = E.erk_ensemble_torch(method, fun, y0, t0, tf, hmax, first_step,
                                   rtol, atol, args, max_steps, t_grid, spec,
                                   events, hmin=hmin, counters=True)
        return (*out[:-1], *out[-1])
    if y0.device.type != "cuda":
        raise NotImplementedError(f"no route for device {y0.device}")
    check_card(spec, fun)
    if t_grid is not None and t_grid.shape[-1] == 0:
        t_grid = None   # no samples, as the plain version gives none
    B = y0.shape[0]
    hmin_b = torch.broadcast_to(torch.as_tensor(
        hmin, dtype=y0.dtype, device=y0.device), (B,)).contiguous()
    with torch.cuda.device(y0.device):
        c = stiff_ensemble_cuda(method, fun, y0, t0, tf, hmax, first_step,
                                rtol, atol, args, max_steps, spec.params(),
                                torch.abs(hmin_b), t_grid=t_grid,
                                events=events)
    samples = (c.sample_y, c.s_cursor) if t_grid is not None else (None, None)
    ev = () if events is None else (c.ev,)
    return (c.t, c.y, c.status, c.nfev, c.nstep, c.naccpt, c.nrejct,
            *samples, *ev, c.njev, c.nlu)


# float64 operations of the stiff kernels, counted from csrc/radau.cu and
# csrc/bdf.cu as kernels/erk_ensemble.py's FLOPS are (an add, subtract,
# multiply, division or square root 1; compares, fabs, negations, selects
# and the float32 controller 0), by state size n.  The inverses (n <= 3,
# stiff_common.cuh): the real one divides the n*n entries by the scale, takes
# its reciprocal, the determinant and the adjugate's products, and divides
# and rescales every entry; the split-complex one the same in complex pairs
# (a complex product 6).
INV_REAL = {1: 4, 2: 16, 3: 60}
INV_CPLX = {1: 16, 2: 66, 3: 260}


def radau_flops(n: int) -> dict:
    """Radau: ``attempt`` every attempt (the Newton tolerance, fac1, alphn
    and betan, too_small, the start values from the last collocation
    polynomial, the error estimate and its matvec, the step's divisions);
    ``newton`` each Newton iteration besides its three RHS evaluations (the
    stage arguments, the TI transform, the mass terms, one real and two
    complex matvecs, the F update and the T back-transform);
    ``decomp`` each decomposition pair (E1, E2 and their inverses);
    ``accept`` an accepted attempt besides its RHS evaluation (the new state,
    the four collocation rows, the scale, the next step's clamps)."""
    mv = 2 * n * n - n
    return dict(attempt=17 + 42 * n + mv,
                newton=5 + 40 * n + 10 * n * n,
                decomp=5 * n * n + INV_REAL[n] + INV_CPLX[n],
                accept=7 + 13 * n)


def bdf_flops(n: int) -> dict:
    """BDF, at order 1 where the order's sums are longer (a lower bound):
    ``attempt`` every attempt (the Newton tolerance, the step's end, the
    predictor, psi and the scales); ``newton`` each Newton iteration besides
    its RHS evaluation (the residual, a matvec, the updates); ``decomp``
    each I - cJ and its inverse; ``accept`` the difference array's update;
    ``rescale`` one change_d (the 6 x 6 polynomial in the factor and the
    product with D's first six rows), counted on rejected attempts only."""
    return dict(attempt=19 + 9 * n, newton=4 * n + 2 * n * n,
                decomp=2 * n * n + INV_REAL[n], accept=3 * n,
                rescale=184 + 72 * n)


# float64 operations of one Jacobian of each functor (csrc/rhs/*.cuh).
JAC_FLOPS = {"vdp": 7, "decay": 0, "robertson": 8}

# float64 operations of one sample, a + b n (radau_interp: s, then the
# nested polynomial; bdf_interp: the five factors and their product, then
# at order 1, a lower bound, one product and five sums a component).
SAMPLE_FLOPS = {"RADAU": (3, 8), "BDF": (30, 6)}


def stiff_flops(method, fun: CudaRHS, nstep, naccpt, nrejct, nfev, njev,
                nlu) -> float:
    """float64 operations of a solve from its counters: ``nfev`` RHS
    evaluations, ``njev`` Jacobians, the decompositions (Radau: nlu / 2
    pairs; BDF: nlu), and each attempt's, Newton iteration's and accepted
    attempt's work (:func:`radau_flops`, :func:`bdf_flops`).  Newton
    iterations are counted from nfev less the evaluations that are not
    theirs (the init's, one an accepted Radau attempt, Radau's error
    refinements, at most one a rejection), so the count is a lower bound."""
    n, r = fun.n, E.RHS_FLOPS[fun.name]
    tot = lambda x: float(torch.as_tensor(x).to(torch.float64).sum())
    B = torch.as_tensor(nstep).numel()
    if method.upper() == "RADAU":
        f = radau_flops(n)
        iters = max(0.0, tot(nfev) - tot(naccpt) - tot(nrejct) - 2 * B) / 3
        flops = tot(nlu) / 2 * f["decomp"]
    else:
        f = bdf_flops(n)
        iters = max(0.0, tot(nfev) - 2 * B)
        flops = tot(nlu) * f["decomp"] + tot(nrejct) * f["rescale"]
    flops += tot(nfev) * r + tot(njev) * JAC_FLOPS[fun.name]
    flops += (tot(nstep) * f["attempt"] + iters * f["newton"]
              + tot(naccpt) * f["accept"])
    return flops


def stiff_event_work(method, fun: CudaRHS, ev_set, naccpt, out):
    """``(flops, bytes)`` of an event-mode solve's event work, besides
    :func:`stiff_flops`' (kernels/erk_ensemble.py::event_work for the
    stiff kernels): each event function at every accepted step
    (``naccpt``), one interpolant (``SAMPLE_FLOPS``) and one event function
    a Brent evaluation (``out.n_brent``, the kernel's own count), and each
    restart's map, event values and method init (Radau: one RHS evaluation
    and the scale; BDF: two RHS evaluations, hinit, the Jacobian and D's
    first rows); the bytes are the recorded occurrences (a time and a state
    each) and each lane's counts, flags, restarts and Brent count.
    ``out``: the solve's erk_ensemble.EventOut; ``ev_set``: its declared
    set (events.SETS)."""
    n, r = fun.n, E.RHS_FLOPS[fun.name]
    tot = lambda x: float(torch.as_tensor(x).to(torch.float64).sum())
    a, b = SAMPLE_FLOPS[method.upper()]
    values = float(sum(ev_set.value_flops))
    brent = a + b * n + max(ev_set.value_flops)
    init = (r + 2 * n if method.upper() == "RADAU" else
            2 * r + E.INIT_FLOPS_N * n + E.INIT_FLOPS + JAC_FLOPS[fun.name]
            + 2 * n)
    restart = max(ev_set.restart_flops) + values + init
    flops = (tot(naccpt) * values + tot(out.n_brent) * brent
             + tot(out.n_restarts) * restart)
    B, ne = out.n_events.shape
    nbytes = 8.0 * (1 + n) * tot(out.n_events) + B * (ne * (4 + 1) + 4 + 4)
    return flops, nbytes


def stiff_bound(method, fun: CudaRHS, nstep, naccpt, nrejct, nfev, njev,
                nlu, peak=FP64_PEAK, rate=HBM_RATE, n_samples=None, m=0,
                n_rec=None, record_cont=False, events=None):
    """``(ms, bound_by)``: the least time a card with float64 rate ``peak``
    and memory rate ``rate`` could take for the solve, the larger of
    :func:`stiff_flops` (with ``n_samples`` the samples' work,
    ``SAMPLE_FLOPS``; with ``events``, ``(set, EventOut)``, the event work
    of :func:`stiff_event_work`) over ``peak`` and, over ``rate``, each
    lane's inputs read once (y0, rtol, atol, t0, tf, hmax, hmin, first
    step, args; its ``m`` grid times) and its outputs written once (t, y,
    status and six counters; the samples emitted and their count; the
    ``n_rec`` rows of ``erk_ensemble.record_width`` doubles; the event
    buffers)."""
    B, n = torch.as_tensor(nstep).numel(), fun.n
    tot = lambda x: float(torch.as_tensor(x).to(torch.float64).sum())
    flops = stiff_flops(method, fun, nstep, naccpt, nrejct, nfev, njev, nlu)
    lane = 8 * (3 * n + 5 + len(fun.defaults)) + 8 * (1 + n) + 4 * 7
    extra = 0.0
    if events is not None:
        ev_flops, ev_bytes = stiff_event_work(method, fun, events[0],
                                              naccpt, events[1])
        flops += ev_flops
        extra += ev_bytes
    if n_samples is not None:
        a, b = SAMPLE_FLOPS[method.upper()]
        flops += tot(n_samples) * (a + b * n)
        lane += 8 * m + 4
        extra += 8.0 * n * tot(n_samples)
    if n_rec is not None:
        extra += 8.0 * tot(n_rec) * E.record_width(method, n, record_cont)
    t_ops, t_bytes = flops / peak, (B * lane + extra) / rate
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")
