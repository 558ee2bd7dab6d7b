"""Explicit Runge–Kutta engines (``ivp_tpu.methods.erk``): RK4, RK23,
DOPRI5, DOP853, each with its dense output.

The attempt is branchless and acts on the whole batch at once: every lane
takes its own step size, and the driver masks out lanes that are done.
Formulas, controllers and counters follow ``ivp_tpu.methods.erk`` line for
line; the CUDA kernels (csrc/dopri5_ensemble.cu, csrc/erk_*.cu) follow this
module.

Under the default ``controller_precision="float32"`` the error norm, the
stiffness detector and the controller run in float32 while the state runs in
its own dtype, with every constant a float32 literal (JAX's weak typing does
the same in the reference): the step sequences match ``ivp_tpu`` only so.

Dense coefficients ``cont`` are ``(B, C, n)`` (the reference's ``(C, n)``
under vmap); an interpolant takes them with the step's left edge and size
``(B,)`` and one time per lane.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .. import tableaus as tab
from ..types import Status
from ..core.common import div_const, hinit, rowsum, safe_pow, scaled_rms
from .base import Engine, RunArgs, StepProposal, dotk


class ERKState(NamedTuple):
    h: Any        # (B,) signed next step size
    k1: Any       # (B, n) derivative at (t, y) — FSAL carry
    facold: Any   # (B,) log(facold), controller precision
    reject: Any   # (B,) bool: previous attempt was rejected
    iasti: Any    # (B,) int32 stiffness counter
    nonstiff: Any  # (B,) int32
    hlamb: Any    # (B,) controller precision
    posneg: Any   # (B,) integration direction sign


@dataclasses.dataclass(frozen=True)
class ERKParams:
    """Controller configuration (the fields of ``ivp_tpu``'s ERKParams)."""

    method: str
    need_cont: bool
    uround: float = 2.3e-16
    safety: float = 0.9
    scale_min: float = 0.2
    scale_max: float = 10.0
    beta: float = 0.04
    stiff_test: int = 1000
    stiff_threshold: float = 3.25
    iord: int = 5
    # "float32": error norm + controller in float32 (the reference default);
    # "state": in the state dtype.
    controller_precision: str = "float32"


DOPRI5_DEFAULTS = dict(scale_min=0.2, scale_max=10.0, beta=0.04,
                       stiff_threshold=3.25, iord=5)
DOP853_DEFAULTS = dict(scale_min=0.333, scale_max=6.0, beta=0.0,
                       stiff_threshold=6.1, iord=8)
RK23_DEFAULTS = dict(scale_min=0.2, scale_max=10.0, iord=3)


def _cdt(p: ERKParams, dtype):
    return torch.float32 if p.controller_precision == "float32" else dtype


def erk_init(rhs, t0, y0, first_step, ra: RunArgs, p: ERKParams):
    """Common ERK initialization: evaluate k1, choose h (hinit or given)."""
    posneg = torch.sign(ra.tend - t0)
    k1 = rhs(t0, y0)
    if first_step is not None:
        h = torch.abs(first_step) * posneg
        nfev = 1
    else:
        h, _ = hinit(rhs, t0, y0, posneg, k1, p.iord, ra.hmax, ra.atol, ra.rtol)
        nfev = 2
    cdt = _cdt(p, y0.dtype)
    B = y0.shape[0]
    dev = y0.device
    ms = ERKState(
        h=h, k1=k1,
        facold=torch.log(torch.full((B,), 1e-4, dtype=cdt, device=dev)),
        reject=torch.zeros(B, dtype=torch.bool, device=dev),
        iasti=torch.zeros(B, dtype=torch.int32, device=dev),
        nonstiff=torch.zeros(B, dtype=torch.int32, device=dev),
        hlamb=torch.zeros(B, dtype=cdt, device=dev),
        posneg=posneg,
    )
    return ms, nfev


def dopri5_attempt(rhs, t, y, naccpt, ms: ERKState, ra: RunArgs, p: ERKParams):
    A, C, E, D = tab.DOPRI5_A, tab.DOPRI5_C, tab.DOPRI5_E, tab.DOPRI5_D
    h, posneg = ms.h, ms.posneg
    facc1 = 1.0 / p.scale_min
    facc2 = 1.0 / p.scale_max
    expo1 = 0.2 - p.beta * 0.75

    too_small = 0.1 * torch.abs(h) <= torch.abs(t) * p.uround
    last = (t + 1.01 * h - ra.tend) * posneg > 0.0
    h = torch.where(last, ra.tend - t, h)
    hy = h[:, None]

    k1 = ms.k1
    k2 = rhs(t + float(C[1]) * h, y + hy * dotk(A[0], [k1]))
    k3 = rhs(t + float(C[2]) * h, y + hy * dotk(A[1], [k1, k2]))
    k4 = rhs(t + float(C[3]) * h, y + hy * dotk(A[2], [k1, k2, k3]))
    k5 = rhs(t + float(C[4]) * h, y + hy * dotk(A[3], [k1, k2, k3, k4]))
    ysti = y + hy * dotk(A[4], [k1, k2, k3, k4, k5])
    k6 = rhs(t + h, ysti)
    ynew = y + hy * dotk(A[5], [k1, k2, k3, k4, k5, k6])
    k7 = rhs(t + h, ynew)
    ks = [k1, k2, k3, k4, k5, k6, k7]

    cdt = _cdt(p, y.dtype)
    err_vec = hy * dotk(E, ks)
    sk = (ra.atol.to(cdt) + ra.rtol.to(cdt)
          * torch.maximum(torch.abs(y.to(cdt)), torch.abs(ynew.to(cdt))))
    err = scaled_rms(err_vec.to(cdt), sk)

    accepted = (err <= 1.0) & ~too_small

    # --- Stiffness detection (square-sums, divide, sqrt in controller
    #     precision, as the reference) ---
    do_stiff = accepted & (((naccpt + 1) % p.stiff_test == 0) | (ms.iasti > 0))
    dk = (k7 - k6).to(cdt)
    dy = (ynew - ysti).to(cdt)
    hlamb, iasti, nonstiff, stiff_fail = _stiffness(
        do_stiff, rowsum(dk * dk), rowsum(dy * dy), torch.abs(h).to(cdt), ms, p)

    advance = accepted & ~stiff_fail

    # --- Dense output ---
    cont = None
    if p.need_cont:
        ydiff = ynew - y
        bspl = hy * k1 - ydiff
        cont = torch.stack([y, ydiff, bspl, -hy * k7 + ydiff - bspl,
                            hy * dotk(D, ks)], dim=1)

    # --- Controller (Lund-stabilized PI, err^expo1 / facold^beta through
    #     one log and two exps; facold is stored as its log) ---
    log_err = torch.log(torch.clamp_min(err, 1e-35))
    fac11 = torch.exp(expo1 * log_err)
    fac = torch.exp(expo1 * log_err - p.beta * ms.facold)
    fac = torch.clamp_min(torch.clamp_max(div_const(fac, p.safety), facc1),
                          facc2)
    hnew_acc = h / fac
    hnew_acc = torch.where(torch.abs(hnew_acc) > ra.hmax, posneg * ra.hmax,
                           hnew_acc)
    hnew_acc = torch.where(
        ms.reject, posneg * torch.minimum(torch.abs(hnew_acc), torch.abs(h)),
        hnew_acc)
    hnew_rej = h / torch.clamp_max(div_const(fac11, p.safety), facc1)
    h_next = torch.where(accepted, hnew_acc, hnew_rej)

    t_new = torch.where(last, ra.tend, t + h)
    status = torch.where(
        too_small, Status.STEP_SIZE_TOO_SMALL,
        torch.where(stiff_fail, Status.PROBABLY_STIFF, Status.RUNNING),
    ).to(torch.int32)

    log_facold_floor = math.log(1e-4)
    ms_new = ERKState(
        h=h_next,
        k1=torch.where(advance[:, None], k7, k1),
        facold=torch.where(accepted, torch.clamp_min(log_err, log_facold_floor),
                           ms.facold),
        reject=~accepted,
        iasti=iasti, nonstiff=nonstiff, hlamb=hlamb, posneg=posneg,
    )
    return StepProposal(
        accepted=accepted, advance=advance, finished=advance & last,
        status=status,
        t_new=torch.where(advance, t_new, t),
        y_new=torch.where(advance[:, None], ynew, y),
        xold=t, h_used=h, cont=cont,
        nfev_inc=6, njev_inc=0, nlu_inc=0,
        count_step=~too_small,
        count_reject=(~accepted) & (naccpt > 1) & ~too_small,
        ms=ms_new,
    )


def _theta(xold, h, ti):
    """The time ratio of an interpolant, as a column for ``(B, n)`` rows."""
    return ((ti - xold) / h)[:, None]


def dopri5_interp(cont, xold, h, ti):
    theta = _theta(xold, h, ti)
    theta1 = 1.0 - theta
    return cont[:, 0] + theta * (
        cont[:, 1] + theta1 * (cont[:, 2] + theta * (cont[:, 3]
                                                     + theta1 * cont[:, 4])))


def _stiffness(do_stiff, stnum, stden, h_abs, ms: ERKState, p: ERKParams):
    """The stiffness detector's state update, shared by DOPRI5 and DOP853:
    ``(hlamb, iasti, nonstiff, stiff_fail)``."""
    hlamb = torch.where(do_stiff & (stden > 0.0),
                        h_abs * torch.sqrt(stnum / stden), ms.hlamb)
    is_stiff = hlamb > p.stiff_threshold
    iasti = torch.where(do_stiff & is_stiff, ms.iasti + 1, ms.iasti)
    nonstiff = torch.where(do_stiff,
                           torch.where(is_stiff, 0, ms.nonstiff + 1),
                           ms.nonstiff).to(torch.int32)
    iasti = torch.where(do_stiff & ~is_stiff & (nonstiff == 6), 0, iasti)
    iasti = iasti.to(torch.int32)
    return hlamb, iasti, nonstiff, do_stiff & is_stiff & (iasti == 15)


# =============================================================================
# DOP853
# =============================================================================

def dop853_attempt(rhs, t, y, naccpt, ms: ERKState, ra: RunArgs, p: ERKParams):
    C = tab.DOP853_C
    h, posneg = ms.h, ms.posneg
    facc1 = 1.0 / p.scale_min
    facc2 = 1.0 / p.scale_max
    expo1 = 1.0 / 8.0 - p.beta * 0.2
    n = y.shape[-1]

    too_small = 0.1 * torch.abs(h) <= torch.abs(t) * p.uround
    last = (t + 1.01 * h - ra.tend) * posneg > 0.0
    h = torch.where(last, ra.tend - t, h)
    hy = h[:, None]

    ks = [ms.k1]
    for i, row in enumerate(tab.DOP853_A):
        ks.append(rhs(t + float(C[i + 1]) * h, y + hy * dotk(row, ks)))
    y12 = y + hy * dotk(tab.DOP853_A[-1], ks[:-1])  # stage-12 state

    kb = dotk(tab.DOP853_B, ks)
    ynew = y + hy * kb

    cdt = _cdt(p, y.dtype)
    sk = (ra.atol.to(cdt) + ra.rtol.to(cdt)
          * torch.maximum(torch.abs(y.to(cdt)), torch.abs(ynew.to(cdt))))
    bh1, bh2, bh3 = tab.DOP853_BH
    err2_vec = (kb - bh1 * ks[0] - bh2 * ks[8] - bh3 * ks[11]).to(cdt)
    err5_vec = dotk(tab.DOP853_ER, ks).to(cdt)
    r2, r5 = err2_vec / sk, err5_vec / sk
    err2 = rowsum(r2 * r2)
    err5 = rowsum(r5 * r5)
    deno = err5 + 0.01 * err2
    deno = torch.where(deno <= 0.0, torch.ones_like(deno), deno)
    err = (torch.abs(h).to(cdt) * err5
           * torch.sqrt(div_const(n * deno, 1.0, reverse=True)))

    accepted = (err <= 1.0) & ~too_small

    # The derivative at the new point and the 3 extra dense stages belong to
    # accepted attempts only (the reference gates them behind a cond): here
    # the whole batch evaluates them and rejected lanes get the zeros of the
    # reference's other branch.  nfev counts them per lane.
    acc = accepted[:, None]
    zero = torch.zeros_like(y)
    f_new = torch.where(acc, rhs(t + h, ynew), zero)
    if p.need_cont:
        k_ext = ks + [f_new]
        k14 = rhs(t + tab.DOP853_C14 * h, y + hy * dotk(tab.DOP853_A14, k_ext))
        k15 = rhs(t + tab.DOP853_C15 * h,
                  y + hy * dotk(tab.DOP853_A15, k_ext + [k14]))
        k16 = rhs(t + tab.DOP853_C16 * h,
                  y + hy * dotk(tab.DOP853_A16, k_ext + [k14, k15]))
        k14, k15, k16 = (torch.where(acc, k, zero) for k in (k14, k15, k16))
    nfev = (11 + torch.where(accepted, 4 if p.need_cont else 1, 0)
            ).to(torch.int32)

    # --- Stiffness detection ---
    do_stiff = accepted & (((naccpt + 1) % p.stiff_test == 0) | (ms.iasti > 0))
    dk = (f_new - ks[11]).to(cdt)
    dy = (ynew - y12).to(cdt)
    hlamb, iasti, nonstiff, stiff_fail = _stiffness(
        do_stiff, rowsum(dk * dk), rowsum(dy * dy), torch.abs(h).to(cdt), ms, p)
    advance = accepted & ~stiff_fail

    # --- Dense output: 8 coefficients from the 3 extra stages above ---
    cont = None
    if p.need_cont:
        k_all = ks + [f_new, k14, k15, k16]
        ydiff = ynew - y
        bspl = hy * ks[0] - ydiff
        rows = [y, ydiff, bspl, ydiff - hy * f_new - bspl]
        for r in range(4, 8):
            rows.append(hy * dotk(tab.DOP853_D[r], k_all))
        cont = torch.stack(rows, dim=1)

    # --- Controller ---
    if p.beta == 0.0 and expo1 == 0.125:
        # Default DOP853 (beta=0): err^(1/8) is a pure sqrt chain and the
        # facold memory is unused: no transcendentals at all.
        fac11 = torch.sqrt(torch.sqrt(torch.sqrt(err)))
        fac = fac11
        facold_new = ms.facold
    else:
        log_err = torch.log(torch.clamp_min(err, 1e-35))
        fac11 = torch.exp(expo1 * log_err)
        fac = torch.exp(expo1 * log_err - p.beta * ms.facold)
        facold_new = torch.where(
            accepted, torch.clamp_min(log_err, math.log(1e-4)), ms.facold)
    fac = torch.clamp_min(torch.clamp_max(div_const(fac, p.safety), facc1),
                          facc2)
    hnew_acc = h / fac
    hnew_acc = torch.where(torch.abs(hnew_acc) > ra.hmax, posneg * ra.hmax,
                           hnew_acc)
    hnew_acc = torch.where(
        ms.reject, posneg * torch.minimum(torch.abs(hnew_acc), torch.abs(h)),
        hnew_acc)
    hnew_rej = h / torch.clamp_max(div_const(fac11, p.safety), facc1)
    h_next = torch.where(accepted, hnew_acc, hnew_rej)

    t_new = torch.where(last, ra.tend, t + h)
    status = torch.where(
        too_small, Status.STEP_SIZE_TOO_SMALL,
        torch.where(stiff_fail, Status.PROBABLY_STIFF, Status.RUNNING),
    ).to(torch.int32)

    ms_new = ERKState(
        h=h_next,
        k1=torch.where(advance[:, None], f_new, ms.k1),
        facold=facold_new,
        reject=~accepted,
        iasti=iasti, nonstiff=nonstiff, hlamb=hlamb, posneg=posneg,
    )
    return StepProposal(
        accepted=accepted, advance=advance, finished=advance & last,
        status=status,
        t_new=torch.where(advance, t_new, t),
        y_new=torch.where(advance[:, None], ynew, y),
        xold=t, h_used=h, cont=cont,
        nfev_inc=nfev, njev_inc=0, nlu_inc=0,
        count_step=~too_small,
        count_reject=(~accepted) & (naccpt > 1) & ~too_small,
        ms=ms_new,
    )


def dop853_interp(cont, xold, h, ti):
    s = _theta(xold, h, ti)
    s1 = 1.0 - s
    conpar = cont[:, 4] + s * (cont[:, 5] + s1 * (cont[:, 6] + s * cont[:, 7]))
    return cont[:, 0] + s * (cont[:, 1] + s1 * (
        cont[:, 2] + s * (cont[:, 3] + s1 * conpar)))


# =============================================================================
# RK23 (Bogacki–Shampine)
# =============================================================================

def rk23_attempt(rhs, t, y, naccpt, ms: ERKState, ra: RunArgs, p: ERKParams):
    h, posneg = ms.h, ms.posneg

    # Step-underflow guard: a lane stuck at err > 1 with h -> 0 ends with a
    # status instead of looping until max_steps.
    too_small = 0.1 * torch.abs(h) <= torch.abs(t) * p.uround

    last = (t + h - ra.tend) * posneg > 0.0
    h = torch.where(last, ra.tend - t, h)
    hy = h[:, None]

    k1 = ms.k1
    k2 = rhs(t + 0.5 * h, y + hy * 0.5 * k1)
    k3 = rhs(t + 0.75 * h, y + hy * 0.75 * k2)
    ynew = y + hy * dotk(tab.RK23_B, [k1, k2, k3])
    k4 = rhs(t + h, ynew)
    ks = [k1, k2, k3, k4]

    cdt = _cdt(p, y.dtype)
    err_vec = hy * dotk(tab.RK23_E, ks)
    sk = (ra.atol.to(cdt) + ra.rtol.to(cdt)
          * torch.maximum(torch.abs(ynew), torch.abs(y)).to(cdt))
    err = scaled_rms(err_vec.to(cdt), sk)

    accepted = (err <= 1.0) & ~too_small
    t_new = torch.where(last, ra.tend, t + h)
    finished = accepted & (last | (t_new == ra.tend))

    cont = None
    if p.need_cont:
        cont = torch.stack([y, k1, dotk(tab.RK23_D2, ks),
                            dotk(tab.RK23_D3, ks)], dim=1)

    err_pow = safe_pow(err, -1.0 / 3.0)
    factor = torch.clamp(p.safety * err_pow, p.scale_min, p.scale_max)
    h_acc = h * factor
    h_acc = torch.where(torch.abs(h_acc) > ra.hmax, ra.hmax * posneg, h_acc)
    h_rej = h * torch.clamp(p.safety * err_pow, p.scale_min, 1.0)
    h_next = torch.where(accepted, h_acc, h_rej)

    ms_new = ms._replace(h=h_next, k1=torch.where(accepted[:, None], k4, k1),
                         reject=~accepted)
    return StepProposal(
        accepted=accepted, advance=accepted, finished=finished,
        status=torch.where(too_small, Status.STEP_SIZE_TOO_SMALL,
                           Status.RUNNING).to(torch.int32),
        t_new=torch.where(accepted, t_new, t),
        y_new=torch.where(accepted[:, None], ynew, y),
        xold=t, h_used=h, cont=cont,
        nfev_inc=3, njev_inc=0, nlu_inc=0,
        # An attempt whose error estimate is not finite counts too, so that
        # such a lane, rejected on every attempt, ends at max_steps as
        # DOPRI5's does (ivp_tpu's RK23 counts accepted attempts only and
        # never ends it: a stated deviation, ROADMAP §3 fault 7).
        count_step=accepted | (~torch.isfinite(err) & ~too_small),
        count_reject=(~accepted) & ~too_small,
        ms=ms_new,
    )


def rk23_interp(cont, xold, h, ti):
    s = _theta(xold, h, ti)
    hy = h[:, None]
    return cont[:, 0] + hy * (cont[:, 1] * s + cont[:, 2] * s * s
                              + cont[:, 3] * s * s * s)


# =============================================================================
# RK4 (classic, fixed step)
# =============================================================================

def rk4_attempt(rhs, t, y, naccpt, ms: ERKState, ra: RunArgs, p: ERKParams):
    h = ms.h
    # 'last' is decided before stepping; the step is always taken with the
    # full fixed h, so the last one may overshoot tend.
    last = (t + 1.01 * h - ra.tend) * torch.sign(h) > 0.0

    hy = h[:, None]
    k1 = ms.k1
    k2 = rhs(t + 0.5 * h, y + 0.5 * hy * k1)
    k3 = rhs(t + 0.5 * h, y + 0.5 * hy * k2)
    k4 = rhs(t + h, y + hy * k3)
    ynew = y + hy * dotk(tab.RK4_B, [k1, k2, k3, k4])
    t_new = t + h
    k1_new = rhs(t_new, ynew)

    # Cubic Hermite on the start slope: [y0, f0, f1, y1].
    cont = torch.stack([y, k1, k1_new, ynew], dim=1) if p.need_cont else None

    true_ = torch.ones_like(last)
    return StepProposal(
        accepted=true_, advance=true_, finished=last,
        status=torch.full_like(ms.iasti, Status.RUNNING),
        t_new=t_new, y_new=ynew, xold=t, h_used=h, cont=cont,
        nfev_inc=4, njev_inc=0, nlu_inc=0,
        count_step=true_, count_reject=~true_,
        ms=ms._replace(k1=k1_new),
    )


def rk4_interp(cont, xold, h, ti):
    s = _theta(xold, h, ti)
    hy = h[:, None]
    s2 = s * s
    s3 = s2 * s
    h00 = 2.0 * s3 - 3.0 * s2 + 1.0
    h10 = s3 - 2.0 * s2 + s
    h01 = -2.0 * s3 + 3.0 * s2
    h11 = s3 - s2
    return (h00 * cont[:, 0] + h10 * hy * cont[:, 1] + h01 * cont[:, 3]
            + h11 * hy * cont[:, 2])


# =============================================================================
# Engine registry
# =============================================================================

_ENGINES = {
    "DOPRI5": (DOPRI5_DEFAULTS, dopri5_attempt, dopri5_interp, 5),
    "DOP853": (DOP853_DEFAULTS, dop853_attempt, dop853_interp, 8),
    "RK23": (RK23_DEFAULTS, rk23_attempt, rk23_interp, 4),
    "RK4": ({}, rk4_attempt, rk4_interp, 4),
}


def make_engine(method: str, need_cont: bool,
                **overrides) -> tuple[Engine, ERKParams]:
    """The engine of ``method`` and its controller parameters: the method's
    defaults with ``overrides`` (the fields of :class:`ERKParams`; an unknown
    one raises TypeError).  Both routes read the same parameters: the plain
    driver here, the CUDA kernels through their launch arguments."""
    method = method.upper()
    if method not in _ENGINES:
        raise ValueError(f"unknown explicit method {method!r}")
    defaults, attempt, interp, ncoeff = _ENGINES[method]
    cfg = dict(defaults)
    cfg.update(overrides)
    p = ERKParams(method=method, need_cont=need_cont, **cfg)
    eng = Engine(name=method, ncoeff=ncoeff if need_cont else 0,
                 init=erk_init, attempt=attempt, interp=interp)
    return eng, p
