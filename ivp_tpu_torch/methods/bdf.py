"""BDF: the variable-order (1..5) backward differentiation formula engine
(``ivp_tpu.methods.bdf``), batched.

SciPy-style quasi-constant-step BDF with the difference array D, the
iteration matrix I - cJ rebuilt when c = h/alpha[order] drifts, a
rate-controlled simplified Newton, and order adaptation after order+1 equal
steps, operation for operation as the reference has them.  The order is a
per-lane int32; the order-dependent sums are masked sums over D's fixed
MAX_ORDER+3 rows, taken in the reference's order.  The linear backends
ported are ``"inverse"`` (n <= 8) and ``"lu"``; the others raise
NotImplementedError (ROADMAP §1 item 15).  The kernel ``csrc/bdf.cu``
follows this module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import tableaus as tab
from ..types import Status
from ..core.common import div_const, sqrt_rn, hinit, rowsum
from ..core.linalg import inv, lu_factor, lu_solve, matvec
from .base import Engine, RunArgs, StepProposal
from .radau import _w, backend_kind, cdtype

MAX_ORDER = tab.BDF_MAX_ORDER
NEWTON_MAXITER = 4
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
SAFETY = 0.9
EPS = 2.220446049250313e-16
ROWS = MAX_ORDER + 3


class BDFState(NamedTuple):
    h_abs: Any      # (B,) positive step size
    posneg: Any     # (B,) integration direction
    D: Any          # (B, MAX_ORDER+3, n) difference array
    order: Any      # (B,) int32 in [1, 5]
    n_equal: Any    # (B,) int32 steps taken at the current (h, order)
    jac: Any        # (B, n, n)
    lin: Any        # (inverse,) or ((lu, P),)
    lu_current: Any  # (B,) bool
    current_c: Any  # (B,)


@dataclasses.dataclass(frozen=True)
class BDFParams:
    """The fields of ``ivp_tpu``'s BDFParams."""

    need_cont: bool
    n: int
    const_jac: bool = False
    newton_maxiter: int = NEWTON_MAXITER
    newton_tol: float = 0.0  # 0 => derived from the tolerances
    linear_mode: str = "auto"
    band: Any = None
    newton_precision: str = "full"
    newton_unroll: bool = False
    controller_precision: str = "float32"
    factor_f32: bool = False
    jac_precision: str = "auto"


def make_linear_backend(p):
    """``(factor, solve, zero_lin)`` for the iteration matrix I - cJ."""
    n = p.n
    if backend_kind(p) == "inverse":
        def factor(m):
            ainv, s = inv(m)
            return (ainv,), s

        def solve(lin, b):
            return matvec(lin[0], b)

        def zero_lin(B, dtype, device):
            return (torch.zeros((B, n, n), dtype=dtype, device=device),)
    else:
        def factor(m):
            lu_piv, s = lu_factor(m)
            return (lu_piv,), s

        def solve(lin, b):
            return lu_solve(lin[0], b)

        def zero_lin(B, dtype, device):
            eye = torch.eye(n, dtype=dtype, device=device).expand(B, n, n)
            return ((torch.zeros((B, n, n), dtype=dtype, device=device),
                     eye.clone()),)
    return factor, solve, zero_lin


def _change_d_poly_coeffs():
    """The constant matrices C_d with R(f) @ R(1) = sum_d f^d C_d
    (``ivp_tpu.methods.bdf._change_d_poly_coeffs``, the same numpy code)."""
    size = MAX_ORDER + 1
    Rcoef = np.zeros((size, size, size))
    for m in range(size):
        for i in range(size):
            poly = np.array([1.0])
            for k in range(1, i + 1):
                lin = np.array([(k - 1.0) / k, -m / k])
                poly = np.convolve(poly, lin)
            Rcoef[: poly.shape[0], i, m] = poly
    U = np.ones((size, size))
    for i in range(1, size):
        mi = np.where(np.arange(size) == 0, 0.0,
                      (i - 1.0 - np.arange(size)) / float(i))
        U[i] = U[i - 1] * mi
    return np.einsum("dim,mj->dij", Rcoef, U)


CHANGE_D_C = _change_d_poly_coeffs()  # (6, 6, 6)


def change_d(D, order, factor):
    """Rescale D[0..order] for a step-size change by ``factor`` ``(B,)``:
    D <- (R(factor) @ R(1))^T D, rows and columns past ``order`` untouched;
    P is the polynomial sum_d factor^d C_d, row i of degree i."""
    size = MAX_ORDER + 1
    dev, dt = D.device, D.dtype
    C = torch.as_tensor(CHANGE_D_C, dtype=dt, device=dev)
    f = factor[:, None]
    f2 = f * f
    f3 = f2 * f
    pw = (None, f, f2, f3, f2 * f2, f3 * f2)
    rows = []
    for i in range(size):
        acc = C[0, i].expand(D.shape[0], size)
        for d in range(1, i + 1):
            acc = acc + pw[d] * C[d, i]
        rows.append(acc)
    P = torch.stack(rows, dim=1)                      # (B, 6, 6)
    k = torch.arange(size, device=dev)
    in_blk = ((k[None, :, None] <= order[:, None, None])
              & (k[None, None, :] <= order[:, None, None]))
    T = torch.where(in_blk, P, torch.eye(size, dtype=dt, device=dev))
    D6 = 0.0
    for m in range(size):
        D6 = D6 + T[:, m, :, None] * D[:, m, None, :]
    D_new = torch.cat([D6, D[:, size:]], dim=1)
    return torch.where((factor == 1.0)[:, None, None], D, D_new)


def _masked_rows_sum(D, mask):
    """sum over rows k of where(mask[k], D[k], 0), left to right."""
    acc = None
    for k in range(D.shape[1]):
        term = torch.where(mask[:, k, None], D[:, k], torch.zeros_like(D[:, k]))
        acc = term if acc is None else acc + term
    return acc


def _sel(vec, idx):
    """``vec[idx]`` of a Python list per lane: the reference's masked select
    (a sum of zeros and the entry), as a tensor of ``idx``'s shape."""
    out = torch.zeros(idx.shape, dtype=torch.float64, device=idx.device)
    for k, v in enumerate(vec):
        out = torch.where(idx == k, float(v), out)
    return out + 0.0


def make_bdf_init(jac_fn, p: BDFParams):
    n = p.n
    zero_lin = make_linear_backend(p)[2]

    def init(rhs, t0, y0, first_step, ra: RunArgs, p_):
        dtype, dev = y0.dtype, y0.device
        B = y0.shape[0]
        posneg = torch.sign(ra.tend - t0)
        f0 = rhs(t0, y0)
        jac = jac_fn(t0, y0).to(dtype)
        if first_step is not None:
            h_abs = torch.abs(first_step)
            nfev = 1
        else:
            h, _ = hinit(rhs, t0, y0, posneg, f0, 1, ra.hmax, ra.atol,
                         ra.rtol)
            h_abs = torch.abs(h)
            nfev = 2
        h_abs = torch.minimum(torch.minimum(h_abs, torch.abs(ra.tend - t0)),
                              ra.hmax)
        D = torch.zeros((B, ROWS, n), dtype=dtype, device=dev)
        D[:, 0] = y0
        D[:, 1] = f0 * (h_abs * posneg)[:, None]
        lane = lambda v, dt: torch.full((B,), v, dtype=dt, device=dev)
        ms = BDFState(
            h_abs=h_abs, posneg=posneg, D=D, order=lane(1, torch.int32),
            n_equal=lane(0, torch.int32), jac=jac,
            lin=zero_lin(B, dtype, dev),
            lu_current=lane(False, torch.bool),
            current_c=torch.zeros_like(h_abs))
        return ms, nfev

    return init


def make_bdf_attempt(jac_fn, p: BDFParams):
    n = p.n
    factor, solve, _ = make_linear_backend(p)
    gamma = [float(x) for x in tab.BDF_GAMMA] + [0.0, 0.0]
    alpha = [float(x) for x in tab.BDF_ALPHA]
    maxit = p.newton_maxiter

    def rms(v):
        return sqrt_rn(div_const(rowsum(v * v), n))

    def attempt(rhs, t, y, naccpt, ms: BDFState, ra: RunArgs, p_):
        dtype, dev = y.dtype, y.device
        B = y.shape[0]
        cdt = cdtype(p, dtype)
        ec = [float(np.float32(x)) if cdt == torch.float32 else float(x)
              for x in tab.BDF_ERROR_CONST]
        rtol_min = torch.clamp_min(ra.rtol.amin(dim=1), EPS)
        if p.newton_tol > 0.0:
            newton_tol = torch.full((B,), p.newton_tol, dtype=cdt, device=dev)
        else:
            newton_tol = torch.maximum(
                div_const(rtol_min, 10.0 * EPS, reverse=True),
                torch.clamp_max(sqrt_rn(rtol_min), 0.03)).to(cdt)

        posneg, order, D = ms.posneg, ms.order, ms.D
        h_abs, n_equal = ms.h_abs, ms.n_equal
        h_signed = posneg * h_abs
        last = posneg * (t + h_signed - ra.tend) >= 0.0
        x_new = torch.where(last, ra.tend, t + h_signed)
        too_small = (h_abs < 1e-290) | ((t + 0.1 * torch.abs(h_signed)) == t)

        # ---- Predictor and psi ----
        r = torch.arange(ROWS, device=dev)
        y_predict = _masked_rows_sum(D, r[None, :] <= order[:, None])
        scale = ra.atol + ra.rtol * torch.abs(y_predict)
        scale = torch.where(scale == 0.0, EPS, scale)
        inv_scale = div_const(scale, 1.0, reverse=True).to(cdt)
        gmask = (r[None, :] >= 1) & (r[None, :] <= order[:, None])
        gD = torch.stack([gamma[k] * D[:, k] for k in range(ROWS)], dim=1)
        psi = _masked_rows_sum(gD, gmask)
        alpha_ord = _sel(alpha, order).to(dtype)
        psi = psi / alpha_ord[:, None]
        c = h_signed / alpha_ord

        # ---- The iteration matrix, rebuilt when c drifts ----
        drift = (torch.abs(c - ms.current_c)
                 / torch.clamp_min(torch.abs(c), 1.0)) > 0.1
        rebuild = ~ms.lu_current | drift
        lin = ms.lin
        sing = torch.zeros_like(rebuild)
        if bool(rebuild.any()):
            eye = torch.eye(n, dtype=dtype, device=dev)
            lin_new, sing_new = factor(eye - c[:, None, None] * ms.jac)
            lin = _w(rebuild, lin_new, ms.lin)
            sing = rebuild & sing_new
        nlu = rebuild.to(torch.int32)
        lu_current = ms.lu_current | rebuild
        current_c = torch.where(rebuild, c, ms.current_c)

        # ---- Simplified Newton ----
        y_new = y_predict
        delta = torch.zeros_like(y)
        prev = torch.full((B,), -1.0, dtype=cdt, device=dev)
        it = torch.zeros(B, dtype=torch.int32, device=dev)
        done = torch.where(sing | too_small, 2, 0).to(torch.int32)
        nfev = torch.zeros_like(it)
        cy = c[:, None]
        for _ in range(maxit + 1):
            live = done == 0
            if not bool(live.any()):
                break
            maxed = it >= maxit
            f = rhs(x_new, y_new)
            dy = solve(lin, cy * f - psi - delta)
            dy_norm = rms(dy.to(cdt) * inv_scale)
            has_prev = prev >= 0.0
            rate = dy_norm / torch.clamp_min(prev, 1e-300)
            rem_i = maxit - it
            pw = rate
            rate_rem = rate
            for k in range(2, maxit + 1):
                pw = pw * rate
                rate_rem = torch.where(rem_i >= k, pw, rate_rem)
            one_m = torch.clamp_min(1.0 - rate, 1e-300)
            estimate_full = rate_rem / one_m * dy_norm
            rate_bad = has_prev & (prev > 0.0) & (
                (rate >= 1.0) | (estimate_full > newton_tol))
            est1 = rate / one_m * dy_norm
            converged = (dy_norm == 0.0) | (
                has_prev & (prev > 0.0) & (rate < 1.0) & (est1 < newton_tol))
            done_n = torch.where(maxed, 2, torch.where(
                converged, 1, torch.where(rate_bad, 2, 0))).to(torch.int32)
            ran = live & ~maxed
            rc = ran[:, None]
            y_new = torch.where(rc, y_new + dy, y_new)
            delta = torch.where(rc, delta + dy, delta)
            prev = torch.where(ran, dy_norm, prev)
            it = torch.where(ran & (done_n == 0), it + 1, it)
            done = torch.where(live, done_n, done)
            nfev = nfev + ran.to(torch.int32)
        converged = done == 1
        newton_fail = ~converged
        n_iter = it.to(cdt)

        # ---- A Newton failure refreshes the Jacobian ----
        refresh = newton_fail & ~too_small
        jac_new = ms.jac
        if bool(refresh.any()):
            jac_new = _w(refresh, jac_fn(x_new, y_predict).to(dtype), ms.jac)
        njev = (refresh & (not p.const_jac)).to(torch.int32)

        safety = div_const(2.0 * maxit + n_iter + 1.0,
                           SAFETY * (2.0 * maxit + 1.0), reverse=True)
        scale2 = ra.atol + ra.rtol * torch.abs(y_new)
        scale2 = torch.where(scale2 == 0.0, EPS, scale2)
        inv_scale2 = div_const(scale2, 1.0, reverse=True).to(cdt)
        ec_ord = _sel(ec, order).to(cdt)[:, None]
        error_norm = rms(ec_ord * delta.to(cdt) * inv_scale2)
        accepted = converged & (error_norm <= 1.0)
        err_reject = converged & (error_norm > 1.0)

        # ---- Accept: update the difference array ----
        rcol = r[None, :]
        ordc = order[:, None]
        row_op1 = _masked_rows_sum(D, rcol == ordc + 1)
        D_acc = torch.where((rcol == ordc + 2)[:, :, None],
                            (delta - row_op1)[:, None, :], D)
        D_acc = torch.where((rcol == ordc + 1)[:, :, None], delta[:, None, :],
                            D_acc)
        contrib = torch.where((rcol <= ordc + 1)[:, :, None], D_acc,
                              torch.zeros_like(D_acc))
        srows = [contrib[:, ROWS - 1]]
        for kk in range(ROWS - 2, -1, -1):
            srows.append(contrib[:, kk] + srows[-1])
        S = torch.stack(srows[::-1], dim=1)
        D_acc = torch.where((rcol <= ordc)[:, :, None], S, D_acc)

        cont = None
        if p.need_cont:
            kk = torch.arange(MAX_ORDER, device=dev)[None, :]
            dcoef = torch.where((kk + 1 <= ordc)[:, :, None],
                                D_acc[:, 1:MAX_ORDER + 1],
                                torch.zeros_like(D_acc[:, 1:MAX_ORDER + 1]))
            cont = torch.cat([D_acc[:, :1], dcoef,
                              order.to(dtype)[:, None, None].expand(B, 1, n)],
                             dim=1)

        # ---- Order and step adaptation after order+1 equal steps ----
        n_equal_acc = n_equal + 1
        finished = accepted & last
        adapt = accepted & (n_equal_acc >= order + 1) & ~finished
        ec_m = _sel(ec, order - 1).to(cdt)[:, None]
        ec_p = _sel(ec, order + 1).to(cdt)[:, None]
        row_ord = _masked_rows_sum(D, rcol == ordc) + delta
        row_op2 = delta - row_op1
        inf = torch.full((B,), float("inf"), dtype=cdt, device=dev)
        err_m = torch.where(order > 1, rms(ec_m * row_ord.to(cdt)
                                           * inv_scale2), inf)
        err_p = torch.where(order < MAX_ORDER, rms(ec_p * row_op2.to(cdt)
                                                   * inv_scale2), inf)
        errs3 = torch.clamp(torch.stack([err_m, error_norm, err_p], dim=1),
                            1e-30, 1e30)
        log_errs = torch.log(errs3)
        ks = torch.arange(3, dtype=cdt, device=dev)[None, :]
        exponents = div_const(order.to(cdt)[:, None] + ks, -1.0,
                              reverse=True)
        log_factors = exponents * log_errs
        best = torch.argmax(log_factors, dim=1).to(torch.int32)
        delta_order = torch.clamp(best - 1, -1, 1)
        new_order = torch.clamp(order + delta_order, 1, MAX_ORDER).to(
            torch.int32)
        step_factor = torch.clamp_max(
            safety * torch.exp(log_factors.amax(dim=1)), MAX_FACTOR)
        order_next = torch.where(adapt, new_order, order)
        order_changed = adapt & (new_order != order)
        jac_after = jac_new
        if bool(order_changed.any()):
            jac_after = _w(order_changed, jac_fn(x_new, y_new).to(dtype),
                           jac_new)
        njev = njev + (order_changed & (not p.const_jac)).to(torch.int32)

        # ---- One rescale for every outcome and the next step's clamps ----
        fac_rej = torch.clamp_min(safety * torch.exp(log_factors[:, 1]),
                                  MIN_FACTOR)
        half = torch.full_like(fac_rej, 0.5)
        fac_case = torch.where(adapt, step_factor, torch.where(
            accepted, torch.ones_like(half),
            torch.where(newton_fail, half, fac_rej)))
        t_next = torch.where(accepted, x_new, t)
        h_des = h_abs * fac_case.to(h_abs.dtype)
        h1 = torch.minimum(h_des, ra.hmax)
        h1 = torch.where((h1 < ra.hmin) & (ra.hmin > 0.0), ra.hmin, h1)
        overshoot = posneg * (t_next + posneg * h1 - ra.tend) > 0.0
        h1 = torch.where(overshoot, torch.abs(ra.tend - t_next), h1)
        clamp_changed = h1 != h_des

        D_in = torch.where(accepted[:, None, None], D_acc, D)
        ord_in = torch.where(adapt, new_order, order)
        f_total = h1 / torch.clamp_min(h_abs, 1e-300)
        D_next = change_d(D_in, ord_in, f_total)
        n_equal_next = torch.where(accepted & ~adapt & ~clamp_changed,
                                   n_equal_acc, 0).to(torch.int32)
        lu_next = lu_current & ~newton_fail & ~adapt & ~clamp_changed

        # A non-finite step size or accepted state ends the lane.
        dead = ~torch.isfinite(h1) | (
            accepted & ~torch.isfinite(y_new).all(dim=1))
        status = torch.where(too_small | dead, Status.STEP_SIZE_TOO_SMALL,
                             Status.RUNNING).to(torch.int32)
        ms_new = BDFState(
            h_abs=h1, posneg=posneg, D=D_next, order=order_next,
            n_equal=n_equal_next, jac=jac_after, lin=lin,
            lu_current=lu_next, current_c=current_c)
        return StepProposal(
            accepted=accepted, advance=accepted, finished=finished,
            status=status, t_new=torch.where(accepted, x_new, t),
            y_new=torch.where(accepted[:, None], y_new, y),
            xold=t, h_used=h_signed, cont=cont,
            nfev_inc=nfev, njev_inc=njev, nlu_inc=nlu,
            count_step=~too_small,
            count_reject=(newton_fail | err_reject) & ~too_small, ms=ms_new)

    return attempt


def bdf_interp(cont, xold, h, ti):
    """Newton-form dense evaluation; ``cont`` rows: [D0, D1..D5, order]."""
    order_f = cont[:, MAX_ORDER + 1, 0]
    x_new = xold + h
    acc = cont[:, 0]
    pk = None
    terms = []
    for k in range(MAX_ORDER):
        denom = h * (k + 1.0)
        t_shift = x_new - h * float(k)
        xf = (ti - t_shift) / denom
        pk = xf if pk is None else pk * xf
        terms.append(torch.where((k < order_f)[:, None],
                                 cont[:, k + 1] * pk[:, None],
                                 torch.zeros_like(acc)))
    s = terms[0]
    for x in terms[1:]:
        s = s + x
    return acc + s


def make_engine(need_cont: bool, *, jac_fn, const_jac=False, n=0,
                **overrides):
    if jac_fn is None:
        raise ValueError("BDF requires a Jacobian function")
    p = BDFParams(need_cont=need_cont, n=n, const_jac=const_jac, **overrides)
    backend_kind(p)
    eng = Engine(name="BDF", ncoeff=MAX_ORDER + 2 if need_cont else 0,
                 init=make_bdf_init(jac_fn, p),
                 attempt=make_bdf_attempt(jac_fn, p), interp=bdf_interp,
                 init_njev=0 if const_jac else 1)
    return eng, p
