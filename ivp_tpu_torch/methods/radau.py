"""RADAU: the 3-stage Radau IIA order-5 implicit Runge-Kutta engine
(``ivp_tpu.methods.radau``), batched.

Simplified Newton iterations on the T-transformed stages, Jacobian and
decomposition reuse, the theta convergence-rate divergence predictor and the
predictive Gustafsson controller, as the reference has them (Hairer &
Wanner's RADAU5), operation for operation.  The attempt acts on the whole
batch: the Newton iteration is a masked loop of at most ``newton_maxiter``
iterations in which each lane stops at its own exit (converged, predicted
divergence, theta blow-up, maxiter), and the Jacobian and decomposition are
evaluated where a lane asks for them and kept elsewhere.

Under the default ``controller_precision="float32"`` the Newton and error
norms, the rates and the step controller run in float32 while the state runs
in its own dtype, every constant a float32 literal, as the reference's weak
typing has it.  The linear backends ported are ``"inverse"`` (the default
for n <= 8: the explicit inverse of E1 and the split-complex inverse of E2,
so each Newton solve is a matvec) and ``"lu"``; ``"banded"``, the mass
matrix, the DAE index options and ``newton_precision="mixed"`` raise
NotImplementedError (ROADMAP §1 item 15).  The kernel ``csrc/radau.cu``
follows this module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from .. import tableaus as tab
from ..types import Status
from ..core.common import div_const, sqrt_rn, rowsum
from ..core.linalg import (inv, inv_complex, lu_factor, lu_factor_cpair,
                           lu_solve, lu_solve_cpair, matvec,
                           solve_complex_inv)
from .base import Engine, RunArgs, StepProposal

# Where ROADMAP §1 keeps the stiff tier's options that are not ported.
STIFF_REST_ITEM = "item 15 (the stiff tier's remainder)"


class RadauState(NamedTuple):
    h: Any          # (B,) signed step size for the next attempt
    hold: Any       # (B,) h of the last accepted step (Newton extrapolation)
    posneg: Any
    f0: Any         # (B, n) rhs at (t, y)
    cont: Any       # (B, 4, n) collocation coefficients of the last step
    scal: Any       # (B, n) error scale
    first: Any      # (B,) bool
    reject: Any     # (B,) bool
    last: Any       # (B,) bool: the next accepted step lands on tend
    faccon: Any     # controller precision
    theta: Any
    hhfac: Any      # time precision
    h_acc: Any      # Gustafsson memory
    err_acc: Any
    call_jac: Any   # (B,) bool
    call_decomp: Any
    singular: Any   # (B,) int32 consecutive-failure counter
    jac: Any        # (B, n, n)
    lin: Any        # (inv1, Br, Bi) or ((lu1, P1), (lu2r, lu2i, P2))


@dataclasses.dataclass(frozen=True)
class RadauParams:
    """The fields of ``ivp_tpu``'s RadauParams."""

    need_cont: bool
    n: int
    uround: float = 2.3e-16
    safety: float = 0.9
    scale_min: float = 0.2
    scale_max: float = 8.0
    newton_maxiter: int = 7
    newton_tol: Optional[float] = None
    predictive: bool = True
    thet: float = 0.001
    quot1: float = 1.0
    quot2: float = 1.2
    nind: Tuple[Optional[int], Optional[int], Optional[int]] = (None, None,
                                                                None)
    has_mass: bool = False
    const_jac: bool = False
    linear_mode: str = "auto"
    band: Optional[Tuple[int, int]] = None
    newton_precision: str = "full"
    controller_precision: str = "float32"
    factor_f32: bool = False
    jac_precision: str = "auto"


# n at or below which "auto" uses the explicit-inverse linear path.
INV_AUTO_N = 8

# Newton-loop exit codes.
_CONTINUE, _CONVERGED, _DIVERGED, _BAD_THETA, _MAXITER = 0, 1, 2, 3, 4


def unported_options(p) -> None:
    """NotImplementedError for the stiff options this slice does not run
    (RadauParams or BDFParams)."""
    rest = [("linear_mode='banded'", p.linear_mode == "banded"
             or p.band is not None),
            ("newton_precision='mixed'", p.newton_precision == "mixed"),
            (f"jac_precision={p.jac_precision!r}",
             p.jac_precision not in ("auto", "state")),
            ("factor_f32", p.factor_f32)]
    if isinstance(p, RadauParams):
        rest += [("mass", p.has_mass),
                 ("nind", any(v is not None for v in p.nind))]
    for name, is_set in rest:
        if is_set:
            raise NotImplementedError(
                f"{name} is not ported to ivp_tpu_torch yet: ROADMAP §1 "
                f"{STIFF_REST_ITEM}")


def backend_kind(p) -> str:
    """``"inverse"`` or ``"lu"`` (``ivp_tpu``'s ``_backend_kind`` without the
    banded backend, which raises)."""
    if p.linear_mode not in ("auto", "lu", "inverse", "banded"):
        raise ValueError(
            f"linear_mode must be one of 'auto', 'lu', 'inverse', 'banded'; "
            f"got {p.linear_mode!r}")
    unported_options(p)
    if p.linear_mode in ("inverse", "lu"):
        return p.linear_mode
    return "inverse" if p.n <= INV_AUTO_N else "lu"


def make_linear_backend(p: RadauParams):
    """``(factor, solve1, solve2, zero_lin)`` for the E1/E2 systems:
    ``factor(e1, e2r, e2i) -> (lin, singular)``, ``solve1(lin, b)`` solves
    E1 x = b, ``solve2(lin, br, bi)`` solves E2 (xr + i xi) = br + i bi."""
    n = p.n
    if backend_kind(p) == "inverse":
        def factor(e1, e2r, e2i):
            inv1, s1 = inv(e1)
            binv, s2 = inv_complex(e2r, e2i)
            return (inv1, binv[0], binv[1]), s1 | s2

        def solve1(lin, b):
            return matvec(lin[0], b)

        def solve2(lin, br_, bi_):
            return solve_complex_inv((lin[1], lin[2]), br_, bi_)

        def zero_lin(B, dtype, device):
            z = torch.zeros((B, n, n), dtype=dtype, device=device)
            return (z, z.clone(), z.clone())
    else:
        def factor(e1, e2r, e2i):
            lu1_piv, s1 = lu_factor(e1)
            lu2_rep, s2 = lu_factor_cpair(e2r, e2i)
            return (lu1_piv, lu2_rep), s1 | s2

        def solve1(lin, b):
            return lu_solve(lin[0], b)

        def solve2(lin, br_, bi_):
            return lu_solve_cpair(lin[1], br_, bi_)

        def zero_lin(B, dtype, device):
            z = torch.zeros((B, n, n), dtype=dtype, device=device)
            eye = torch.eye(n, dtype=dtype, device=device).expand(B, n, n)
            return ((z, eye.clone()), (z.clone(), z.clone(), eye.clone()))
    return factor, solve1, solve2, zero_lin


def _w(mask, a, b):
    """``torch.where`` with a ``(B,)`` mask over tensors of any rank, or
    over nested tuples of them."""
    if isinstance(a, tuple):
        return tuple(_w(mask, x, y) for x, y in zip(a, b))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _lane(v, like):
    """A Python number as a ``(B,)`` tensor of ``like``'s dtype."""
    return torch.full_like(like, v)


def transform_tols(ra: RunArgs):
    """rtol <- 0.1 rtol^(2/3), atol scaled to keep the ratio."""
    quot = ra.atol / ra.rtol
    rtol_t = 0.1 * ra.rtol ** (2.0 / 3.0)
    return rtol_t, rtol_t * quot


def cdtype(p, dtype):
    return torch.float32 if p.controller_precision == "float32" else dtype


def make_radau_init(jac_fn, p: RadauParams):
    n = p.n
    zero_lin = make_linear_backend(p)[3]

    def init(rhs, t0, y0, first_step, ra: RunArgs, p_):
        dtype, dev = y0.dtype, y0.device
        B = y0.shape[0]
        posneg = torch.sign(ra.tend - t0)
        if first_step is not None:
            h = torch.abs(first_step) * posneg
        else:
            h = 1.0e-6 * posneg
        h = torch.minimum(torch.maximum(h, -ra.hmax), ra.hmax)
        f0 = rhs(t0, y0)
        rtol_t, atol_t = transform_tols(ra)
        scal = atol_t + rtol_t * torch.abs(y0)
        cdt = cdtype(p, dtype)
        lane = lambda v, dt: torch.full((B,), v, dtype=dt, device=dev)
        ms = RadauState(
            h=h, hold=h, posneg=posneg, f0=f0,
            cont=torch.zeros((B, 4, n), dtype=dtype, device=dev), scal=scal,
            first=lane(True, torch.bool), reject=lane(False, torch.bool),
            last=lane(False, torch.bool),
            faccon=lane(1.0, cdt), theta=lane(p.thet, cdt),
            hhfac=h, h_acc=torch.zeros_like(h), err_acc=lane(0.0, cdt),
            call_jac=lane(True, torch.bool),
            call_decomp=lane(True, torch.bool),
            singular=lane(0, torch.int32),
            jac=torch.zeros((B, n, n), dtype=dtype, device=dev),
            lin=zero_lin(B, dtype, dev),
        )
        return ms, 1

    return init


def _sumsq(v):
    return rowsum(v * v)


def make_radau_attempt(jac_fn, p: RadauParams):
    n = p.n
    factor, solve1, solve2, _ = make_linear_backend(p)
    T, TI = tab.RADAU_T.tolist(), tab.RADAU_TI.tolist()
    C1, C2 = float(tab.RADAU_C1), float(tab.RADAU_C2)
    C1M1, C2M1 = float(tab.RADAU_C1M1), float(tab.RADAU_C2M1)
    C1MC2 = float(tab.RADAU_C1MC2)
    DD = [float(x) for x in tab.RADAU_DD]
    U1, ALPH, BETA = tab.RADAU_U1, tab.RADAU_ALPH, tab.RADAU_BETA
    facl = 1.0 / p.scale_min
    facr = 1.0 / p.scale_max
    cfac = p.safety * (1.0 + 2.0 * p.newton_maxiter)
    maxit = p.newton_maxiter

    def lin_comb(M, row, a, b, c):
        return M[row][0] * a + M[row][1] * b + M[row][2] * c

    def attempt(rhs, t, y, naccpt, ms: RadauState, ra: RunArgs, p_):
        dtype = y.dtype
        B = y.shape[0]
        rtol_t, atol_t = transform_tols(ra)
        cdt = cdtype(p, dtype)
        if p.newton_tol is not None:
            newton_tol = torch.full((B,), p.newton_tol, dtype=cdt,
                                    device=y.device)
        else:
            tolst = rtol_t[:, 0]
            newton_tol = torch.maximum(
                div_const(tolst, 10.0 * p.uround, reverse=True),
                torch.clamp_max(sqrt_rn(tolst), 0.03)).to(cdt)

        h, posneg = ms.h, ms.posneg
        hc = h[:, None]

        # ---- Jacobian (reused while theta stays small) ----
        jac = ms.jac
        if bool(ms.call_jac.any()):
            jac = _w(ms.call_jac, jac_fn(t, y).to(dtype), ms.jac)
        njev = (ms.call_jac & (not p.const_jac)).to(torch.int32)

        # ---- Decompositions (reused when the step ratio stays near 1) ----
        fac1 = div_const(h, U1, reverse=True)
        alphn = div_const(h, ALPH, reverse=True)
        betan = div_const(h, BETA, reverse=True)
        lin = ms.lin
        sing = torch.zeros_like(ms.call_decomp)
        if bool(ms.call_decomp.any()):
            eye = torch.eye(n, dtype=dtype, device=y.device)
            e1 = fac1[:, None, None] * eye - jac
            e2r = alphn[:, None, None] * eye - jac
            e2i = betan[:, None, None] * eye
            lin_new, sing_new = factor(e1, e2r, e2i)
            lin = _w(ms.call_decomp, lin_new, ms.lin)
            sing = ms.call_decomp & sing_new
        nlu = torch.where(ms.call_decomp, 2, 0).to(torch.int32)

        too_small = 0.1 * torch.abs(h) <= torch.abs(t) * p.uround
        scal = ms.scal

        # ---- Newton starting values: the last collocation polynomial ----
        c3q = (h / ms.hold)[:, None]
        c1q = C1 * c3q
        c2q = C2 * c3q
        ak1, ak2, ak3 = ms.cont[:, 1], ms.cont[:, 2], ms.cont[:, 3]

        def extrap(cq):
            return cq * (ak1 + (cq - C2M1) * (ak2 + (cq - C1M1) * ak3))

        first = ms.first[:, None]
        zero = torch.zeros_like(y)
        z1 = torch.where(first, zero, extrap(c1q))
        z2 = torch.where(first, zero, extrap(c2q))
        z3 = torch.where(first, zero, extrap(c3q))
        f1 = torch.where(first, zero, lin_comb(TI, 0, z1, z2, z3))
        f2 = torch.where(first, zero, lin_comb(TI, 1, z1, z2, z3))
        f3 = torch.where(first, zero, lin_comb(TI, 2, z1, z2, z3))

        fac1c, alphnc, betanc = fac1[:, None], alphn[:, None], betan[:, None]

        # ---- Simplified Newton iteration ----
        faccon = torch.clamp_min(ms.faccon, p.uround) ** 0.8
        inv_scal_c = div_const(scal, 1.0, reverse=True).to(cdt)
        zc = torch.zeros(B, dtype=cdt, device=y.device)
        it = torch.zeros(B, dtype=torch.int32, device=y.device)
        dyno, dynold, thqold = zc, zc, zc
        theta = torch.full_like(zc, abs(p.thet))
        hhfac = ms.hhfac
        code = torch.where(sing | too_small, _MAXITER, _CONTINUE).to(
            torch.int32)
        nfev = torch.zeros_like(it)
        tiny = 1e-300
        for _ in range(maxit + 1):
            live = code == _CONTINUE
            if not bool(live.any()):
                break
            maxed = it >= maxit
            g1 = rhs(t + C1 * h, y + z1)
            g2 = rhs(t + C2 * h, y + z2)
            g3 = rhs(t + h, y + z3)
            r1 = lin_comb(TI, 0, g1, g2, g3)
            r2 = lin_comb(TI, 1, g1, g2, g3)
            r3 = lin_comb(TI, 2, g1, g2, g3)
            r1 = r1 - fac1c * f1
            r2 = r2 - alphnc * f2 + betanc * f3
            r3 = r3 - alphnc * f3 - betanc * f2
            r1 = solve1(lin, r1)
            r2, r3 = solve2(lin, r2, r3)

            it_n = it + 1
            q1 = r1.to(cdt) * inv_scal_c
            q2 = r2.to(cdt) * inv_scal_c
            q3 = r3.to(cdt) * inv_scal_c
            dyno_n = sqrt_rn(div_const(
                _sumsq(q1) + _sumsq(q2) + _sumsq(q3), 3.0 * n))

            check = (it_n > 1) & (it_n < maxit)
            thq = dyno_n / torch.clamp_min(dynold, tiny)
            theta_n = torch.where(it_n == 2, thq, sqrt_rn(
                thq * torch.clamp_min(thqold, tiny)))
            theta_n = torch.where(check, theta_n, theta)
            thqold_n = torch.where(check, thq, thqold)
            ok_theta = theta_n < 0.99
            faccon_n = torch.where(check & ok_theta,
                                   theta_n / (1.0 - theta_n), faccon)
            rem = float(maxit - 1) - it_n.to(cdt)
            rem_i = maxit - 1 - it_n
            theta_rem = torch.ones_like(theta_n)
            pw = torch.ones_like(theta_n)
            for k in range(1, max(maxit - 1, 1)):
                pw = pw * theta_n
                theta_rem = torch.where(rem_i >= k, pw, theta_rem)
            dyth = faccon_n * dyno_n * theta_rem / newton_tol
            diverged = check & ok_theta & (dyth >= 1.0)
            qnewt = torch.clamp_max(torch.clamp_min(dyth, 1e-4), 20.0)
            hhfac_div = (0.8 * qnewt ** div_const(4.0 + rem, -1.0,
                                                  reverse=True)).to(dtype)
            hhfac_n = torch.where(diverged, hhfac_div, hhfac)
            bad_theta = check & ~ok_theta
            dynold_n = torch.clamp_min(dyno_n, p.uround)

            f1n, f2n, f3n = f1 + r1, f2 + r2, f3 + r3
            z1n = lin_comb(T, 0, f1n, f2n, f3n)
            z2n = lin_comb(T, 1, f1n, f2n, f3n)
            z3n = T[2][0] * f1n + f2n
            converged = faccon_n * dyno_n <= newton_tol
            code_n = torch.where(maxed, _MAXITER, torch.where(
                bad_theta, _BAD_THETA, torch.where(
                    diverged, _DIVERGED, torch.where(
                        converged, _CONVERGED, _CONTINUE)))).to(torch.int32)

            ran = live & ~maxed
            rc = ran[:, None]
            z1, z2, z3 = (torch.where(rc, z1n, z1), torch.where(rc, z2n, z2),
                          torch.where(rc, z3n, z3))
            f1, f2, f3 = (torch.where(rc, f1n, f1), torch.where(rc, f2n, f2),
                          torch.where(rc, f3n, f3))
            it = torch.where(ran, it_n, it)
            dyno = torch.where(ran, dyno_n, dyno)
            dynold = torch.where(ran, dynold_n, dynold)
            thqold = torch.where(ran, thqold_n, thqold)
            theta = torch.where(ran, theta_n, theta)
            faccon = torch.where(ran, faccon_n, faccon)
            hhfac = torch.where(ran, hhfac_n, hhfac)
            code = torch.where(live, code_n, code)
            nfev = nfev + (3 * ran.to(torch.int32))

        newt = it.to(cdt)
        converged = code == _CONVERGED

        # ---- Error estimation ----
        hee = [div_const(h, d, reverse=True)[:, None] for d in DD]
        f1e = hee[0] * z1 + hee[1] * z2 + hee[2] * z3
        err_vec = solve1(lin, f1e + ms.f0)

        def rms(v):
            vc = v.to(cdt) * inv_scal_c
            return torch.clamp_min(sqrt_rn(div_const(_sumsq(vc), n)),
                                   1e-10)

        err = rms(err_vec)
        do_refine = converged & (err >= 1.0) & (ms.first | ms.reject)
        if bool(do_refine.any()):
            fr = rhs(t, err_vec + y)
            err = torch.where(do_refine, rms(solve1(lin, fr + f1e)), err)
        nfev = nfev + do_refine.to(torch.int32)

        # ---- Step-size controller ----
        fac = torch.clamp_max(div_const(newt + 2.0 * maxit, cfac,
                                        reverse=True), p.safety)
        quot = torch.clamp_min(torch.clamp_max(
            sqrt_rn(sqrt_rn(err)) / fac, facl), facr)
        hnew = h / quot.to(h.dtype)
        accepted = converged & (err <= 1.0) & ~sing & ~too_small

        if p.predictive:
            can_pred = accepted & (naccpt + 1 > 1)
            ratio = torch.clamp_max(
                err * err / torch.clamp_min(ms.err_acc, 1e-30), 1e30)
            facgus = div_const((ms.h_acc / h).to(cdt)
                               * sqrt_rn(sqrt_rn(ratio)), p.safety)
            facgus = torch.clamp_min(torch.clamp_max(facgus, facl), facr)
            quot = torch.where(can_pred, torch.maximum(quot, facgus), quot)
            hnew = h / quot.to(h.dtype)
            h_acc = torch.where(accepted, h, ms.h_acc)
            err_acc = torch.where(accepted, torch.clamp_min(err, 1e-2),
                                  ms.err_acc)
        else:
            h_acc, err_acc = ms.h_acc, ms.err_acc

        # ---- Accept path ----
        y_new = y + z3
        t_new = torch.where(ms.last, ra.tend, t + h)
        ak = div_const(z1 - z2, C1MC2)
        acont3 = div_const(ak - div_const(z1, C1), C2)
        c1r = div_const(z2 - z3, C2M1)
        c2r = div_const(ak - c1r, C1M1)
        c3r = c2r - acont3
        cont_state = torch.stack([y_new, c1r, c2r, c3r], dim=1)
        f0_new = ms.f0
        if bool(accepted.any()):
            f0_new = rhs(t_new, y_new)
        nfev = nfev + accepted.to(torch.int32)
        scal_acc = atol_t + rtol_t * torch.abs(y_new)

        hnew_acc = torch.minimum(torch.maximum(torch.abs(hnew), ra.hmin),
                                 ra.hmax) * posneg
        hnew_acc = torch.where(
            ms.reject,
            posneg * torch.minimum(torch.abs(hnew_acc), torch.abs(h)),
            hnew_acc)
        hit_end = (t_new + div_const(hnew_acc, p.quot1) - ra.tend) \
            * posneg >= 0.0
        qt = hnew_acc / h
        reuse = (~hit_end & (theta < p.thet) & (qt > p.quot1)
                 & (qt < p.quot2))
        h_acc_next = torch.where(hit_end, ra.tend - t_new,
                                 torch.where(reuse, h, hnew_acc))
        hhfac_acc = torch.where(reuse, ms.hhfac, h_acc_next)
        call_jac_acc = ~reuse & (theta >= p.thet)

        # ---- Reject paths ----
        h_rej = torch.where(ms.first, h * 0.1, hnew)
        hhfac_rej = torch.where(ms.first, _lane(0.1, h), hnew / h)
        h_div = h * hhfac
        h_half = h * 0.5
        diverged = code == _DIVERGED
        broke = (code == _MAXITER) | (code == _BAD_THETA) | sing

        h_next = torch.where(accepted, h_acc_next, torch.where(
            diverged, h_div, torch.where(broke, h_half, h_rej)))
        hhfac_next = torch.where(accepted, hhfac_acc, torch.where(
            diverged, hhfac, torch.where(broke, _lane(0.5, h), hhfac_rej)))
        call_decomp_next = torch.where(accepted, ~reuse,
                                       torch.ones_like(reuse))
        call_jac_next = torch.where(accepted, call_jac_acc, ms.call_jac)
        # One counter for singular decompositions, Newton maxiter and theta
        # blow-ups, reset on accept: more than 5 in a row is SINGULAR_MATRIX.
        singular_next = torch.where(accepted, torch.zeros_like(ms.singular),
                                    torch.where(broke, ms.singular + 1,
                                                ms.singular))
        status = torch.where(
            too_small, Status.STEP_SIZE_TOO_SMALL,
            torch.where(broke & (singular_next > 5), Status.SINGULAR_MATRIX,
                        Status.RUNNING)).to(torch.int32)

        acc = accepted[:, None]
        ms_new = RadauState(
            h=h_next, hold=torch.where(accepted, h, ms.hold), posneg=posneg,
            f0=torch.where(acc, f0_new, ms.f0),
            cont=torch.where(acc[:, :, None], cont_state, ms.cont),
            scal=torch.where(acc, scal_acc, scal),
            first=ms.first & ~accepted,
            reject=torch.where(accepted, torch.zeros_like(accepted),
                               ms.reject | diverged | (err > 1.0) | broke),
            last=torch.where(accepted, hit_end, torch.zeros_like(hit_end)),
            faccon=faccon, theta=theta, hhfac=hhfac_next, h_acc=h_acc,
            err_acc=err_acc, call_jac=call_jac_next,
            call_decomp=call_decomp_next, singular=singular_next.to(
                torch.int32),
            jac=jac, lin=lin,
        )
        # A singular-decomposition retry is not a step; rejections count
        # error rejections after the first step and Newton divergence.
        count_step = ~sing
        count_reject = ~accepted & ~sing & (
            diverged | (converged & (err > 1.0) & ~ms.first))
        return StepProposal(
            accepted=accepted, advance=accepted,
            finished=accepted & ms.last, status=status,
            t_new=torch.where(accepted, t_new, t),
            y_new=torch.where(acc, y_new, y),
            xold=t, h_used=h, cont=cont_state if p.need_cont else None,
            nfev_inc=nfev, njev_inc=njev, nlu_inc=nlu,
            count_step=count_step, count_reject=count_reject, ms=ms_new)

    return attempt


def radau_interp(cont, xold, h, ti):
    """The collocation polynomial in s = (t - (xold + h)) / h."""
    s = ((ti - (xold + h)) / h)[:, None]
    C2M1, C1M1 = float(tab.RADAU_C2M1), float(tab.RADAU_C1M1)
    return cont[:, 0] + s * (cont[:, 1] + (s - C2M1) * (
        cont[:, 2] + (s - C1M1) * cont[:, 3]))


def make_engine(need_cont: bool, *, jac_fn, const_jac=False, mass=None,
                nind=(None, None, None), n=0, **overrides):
    if jac_fn is None:
        raise ValueError("RADAU requires a Jacobian function")
    p = RadauParams(need_cont=need_cont, n=n, nind=tuple(nind),
                    has_mass=mass is not None, const_jac=const_jac,
                    **overrides)
    backend_kind(p)
    eng = Engine(name="RADAU", ncoeff=4 if need_cont else 0,
                 init=make_radau_init(jac_fn, p),
                 attempt=make_radau_attempt(jac_fn, p), interp=radau_interp)
    return eng, p
