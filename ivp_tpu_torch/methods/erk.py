"""Explicit Runge–Kutta engines (``ivp_tpu.methods.erk``): DOPRI5.

The attempt is branchless and acts on the whole batch at once: every lane
takes its own step size, and the driver masks out lanes that are done.
Formulas, controller and counters follow ``ivp_tpu.methods.erk`` line for
line; the CUDA kernel (csrc/dopri5_ensemble.cu) follows this module.

Under the default ``controller_precision="float32"`` the error norm, the
stiffness detector and the controller run in float32 while the state runs in
its own dtype, with every constant a float32 literal (JAX's weak typing does
the same in the reference): the step sequences match ``ivp_tpu`` only so.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .. import tableaus as tab
from ..types import Status
from ..core.common import div_const, hinit, rowsum, scaled_rms
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
    A, C, E = tab.DOPRI5_A, tab.DOPRI5_C, tab.DOPRI5_E
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
    stnum = rowsum(dk * dk)
    stden = rowsum(dy * dy)
    hlamb = torch.where(do_stiff & (stden > 0.0),
                        torch.abs(h).to(cdt) * torch.sqrt(stnum / stden),
                        ms.hlamb)
    is_stiff = hlamb > p.stiff_threshold
    iasti = torch.where(do_stiff & is_stiff, ms.iasti + 1, ms.iasti)
    nonstiff = torch.where(do_stiff,
                           torch.where(is_stiff, 0, ms.nonstiff + 1),
                           ms.nonstiff).to(torch.int32)
    iasti = torch.where(do_stiff & ~is_stiff & (nonstiff == 6), 0, iasti)
    iasti = iasti.to(torch.int32)
    stiff_fail = do_stiff & is_stiff & (iasti == 15)

    advance = accepted & ~stiff_fail

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
        xold=t, h_used=h, cont=None,
        nfev_inc=6, njev_inc=0, nlu_inc=0,
        count_step=~too_small,
        count_reject=(~accepted) & (naccpt > 1) & ~too_small,
        ms=ms_new,
    )


# Where each other method lands (ROADMAP.md §1).
_LATER = {
    "DOP853": "ROADMAP §1 item 3 (the rest of the explicit tier)",
    "RK23": "ROADMAP §1 item 3 (the rest of the explicit tier)",
    "RK4": "ROADMAP §1 item 3 (the rest of the explicit tier)",
}


def make_engine(method: str, need_cont: bool) -> tuple[Engine, ERKParams]:
    """DOPRI5 with its default controller.  The CUDA kernel compiles the
    same constants in, so per-solve controller options wait for the
    ``solver_options`` slice, which passes them to the kernel as well."""
    method = method.upper()
    if method in _LATER:
        raise NotImplementedError(
            f"method {method!r} is not ported yet: {_LATER[method]}")
    if method != "DOPRI5":
        raise ValueError(f"unknown explicit method {method!r}")
    if need_cont:
        raise NotImplementedError(
            "DOPRI5 dense output is not ported yet: ROADMAP §1 item 3")
    p = ERKParams(method=method, need_cont=need_cont, **DOPRI5_DEFAULTS)
    eng = Engine(name=method, ncoeff=0, init=erk_init, attempt=dopri5_attempt)
    return eng, p
