"""Small dense linear algebra of the implicit solvers (``ivp_tpu.core.linalg``),
batched over a leading ``(B,)`` axis.

Every function here follows its ``ivp_tpu`` counterpart operation for
operation: the same pivot choice (the first largest magnitude), the same row
exchanges as masked rank-2 updates (which do not always reproduce the
exchanged row to the last bit, and the reference's step counts depend on
that), the same singular flags and the same order of every sum (left to
right, one term at a time, as XLA's CPU reduction runs).  A sum over a
masked row adds exact zeros; ``x + 0.0`` stands for the reference's masked
extraction of one entry (it turns ``-0.0`` into ``0.0``, as the reduction
from an initial ``0.0`` does).  Divisions by a Python number are true
divisions (``div_const``).  The kernels' copy of the inverse path is
``csrc/stiff_common.cuh``.

Shapes: a matrix is ``(B, n, n)``, a vector ``(B, n)``, a flag ``(B,)``.
The reference's float32 scan branches (for ``n`` above its unroll window)
compute the same values as the unrolled loops here.
"""
from __future__ import annotations

import torch

from .common import div_const

# Size cutoff for the closed-form adjugate inverse (ivp_tpu's _ADJUGATE_N).
ADJUGATE_N = 3


def _sum(terms):
    """Left-to-right sum of a list of tensors."""
    acc = terms[0]
    for x in terms[1:]:
        acc = acc + x
    return acc


def _pick(m, idx):
    """``m[b, idx[b]]`` of a ``(B, n, ...)`` tensor (the reference's masked
    row extraction of row ``idx``), plus 0.0."""
    rows = torch.arange(m.shape[0], device=m.device)
    return m[rows, idx] + 0.0


def lu_factor(a):
    """Partial-pivot LU: ``((lu, P), singular)``.  ``lu`` packs the unit
    lower L (strictly below) and U; ``P @ a = L @ U``."""
    B, n = a.shape[0], a.shape[-1]
    dev, dt = a.device, a.dtype
    rows = torch.arange(n, device=dev)
    lu = a.clone()
    P = torch.eye(n, dtype=dt, device=dev).expand(B, n, n).clone()
    sing = torch.zeros(B, dtype=torch.bool, device=dev)
    for k in range(n):
        colk = lu[:, :, k] + 0.0
        mag = torch.where(rows[None, :] >= k, torch.abs(colk),
                          torch.full_like(colk, -1.0))
        p = torch.argmax(mag, dim=1)
        is_p = rows[None, :] == p[:, None]
        fk = (rows == k).to(dt)[None, :, None]
        fp = is_p.to(dt)[:, :, None]

        def swap(m, rk, rp):
            return (m - fk * (rk - rp)[:, None, :]
                    - fp * (rp - rk)[:, None, :])

        rowk = lu[:, k, :] + 0.0
        rowp = _pick(lu, p)
        lu = swap(lu, rowk, rowp)
        P = swap(P, P[:, k, :] + 0.0, _pick(P, p))
        ck = colk[:, k] + 0.0
        cp = _pick(colk, p)
        colk2 = (colk + fk[..., 0] * (cp - ck)[:, None]
                 + fp[..., 0] * (ck - cp)[:, None])
        sing = sing | (cp == 0.0) | ~torch.isfinite(cp)
        denom = torch.where(cp == 0.0, torch.ones_like(cp), cp)
        factors = torch.where(rows[None, :] > k, colk2 / denom[:, None],
                              torch.zeros_like(colk2))
        urow = torch.where((p == k)[:, None], rowk, rowp)
        upper = torch.where(rows[None, :] > k, urow, torch.zeros_like(urow))
        lu = lu - factors[:, :, None] * upper[:, None, :]
        in_col = (rows[:, None] > k) & (rows[None, :] == k)
        lu = torch.where(in_col[None], factors[:, :, None], lu)
    return (lu, P), sing


def _permute(P, b):
    """``sum(P * b[None, :], axis=1)`` of the reference: ``P @ b`` with the
    products summed left to right (``b (B, n)`` or ``(B, n, k)``)."""
    n = P.shape[-1]
    if b.dim() == 2:
        return _sum([P[:, :, j] * b[:, j, None] for j in range(n)])
    return _sum([P[:, :, j, None] * b[:, None, j, :] for j in range(n)])


def lu_solve(lu_piv, b):
    """Solve ``A x = b`` from :func:`lu_factor`'s output."""
    lu, P = lu_piv
    n = lu.shape[-1]
    x = _permute(P, b)
    for k in range(1, n):
        s = _sum([lu[:, k, j] * x[:, j] for j in range(k)])
        x = x.clone()
        x[:, k] = x[:, k] - s
    for k in range(n - 1, -1, -1):
        right = [lu[:, k, j] * x[:, j] for j in range(k + 1, n)]
        s = _sum(right) if right else torch.zeros_like(x[:, k])
        diag = lu[:, k, k] + 0.0
        x = x.clone()
        x[:, k] = (x[:, k] + 0.0 - s) / diag
    return x


def _lu_solve_cols(lu_piv, bcols):
    """Multi-RHS :func:`lu_solve`: ``A X = B`` for ``B (B, n, k)``."""
    lu, P = lu_piv
    n = lu.shape[-1]
    x = _permute(P, bcols)
    for k in range(1, n):
        s = _sum([lu[:, k, j, None] * x[:, j] for j in range(k)])
        x = x.clone()
        x[:, k] = x[:, k] - s
    for k in range(n - 1, -1, -1):
        right = [lu[:, k, j, None] * x[:, j] for j in range(k + 1, n)]
        s = _sum(right) if right else torch.zeros_like(x[:, k])
        diag = lu[:, k, k, None] + 0.0
        x = x.clone()
        x[:, k] = (x[:, k] + 0.0 - s) / diag
    return x


def matvec(a, x):
    """``(B, n, n) @ (B, n)``, each row's products summed left to right."""
    n = a.shape[-1]
    return _sum([a[:, :, j] * x[:, j, None] for j in range(n)])


def _prescale(*mats):
    """The largest magnitude over the matrices, per lane (``(scale, bad)``):
    1.0 where it is zero or not finite.  The reference divides by it before
    forming the adjugate's products (its TPU's emulated f64 broke on products
    beyond the float32 range); the port keeps it, as it changes rounding."""
    s = torch.zeros(mats[0].shape[0], dtype=mats[0].dtype,
                    device=mats[0].device)
    for m in mats:
        s = torch.maximum(s, torch.abs(m).flatten(1).amax(dim=1))
    bad = (s == 0.0) | ~torch.isfinite(s)
    return torch.where(bad, torch.ones_like(s), s), bad


def inv(a):
    """Explicit inverse with a singular flag, ``(a_inv, singular)``: the
    closed-form adjugate of the prescaled matrix for ``n <= 3``, LU and a
    multi-RHS substitution above."""
    B, n = a.shape[0], a.shape[-1]
    if n > ADJUGATE_N:
        lu_piv, sing = lu_factor(a)
        eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(B, n, n)
        return _lu_solve_cols(lu_piv, eye), sing
    scale, bad = _prescale(a)
    a = a / scale[:, None, None]
    rescale = div_const(scale, 1.0, reverse=True)[:, None, None]
    if n == 1:
        det = a[:, 0, 0]
        sing = bad | (det == 0.0) | ~torch.isfinite(det)
        d = torch.where(sing, torch.ones_like(det), det)
        adj = torch.ones_like(a)
        return (adj / d[:, None, None]) * rescale, sing
    if n == 2:
        det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
        sing = bad | (det == 0.0) | ~torch.isfinite(det)
        d = torch.where(sing, torch.ones_like(det), det)
        adj = torch.stack([torch.stack([a[:, 1, 1], -a[:, 0, 1]], -1),
                           torch.stack([-a[:, 1, 0], a[:, 0, 0]], -1)], 1)
        return (adj / d[:, None, None]) * rescale, sing
    r0, r1, r2 = a[:, 0], a[:, 1], a[:, 2]
    c12 = _cross(r1, r2)
    det = r0[:, 0] * c12[:, 0] + r0[:, 1] * c12[:, 1] + r0[:, 2] * c12[:, 2]
    sing = bad | (det == 0.0) | ~torch.isfinite(det)
    d = torch.where(sing, torch.ones_like(det), det)
    # The inverse's columns are r1 x r2, r2 x r0, r0 x r1 over det.
    adj = torch.stack([c12, _cross(r2, r0), _cross(r0, r1)], dim=2)
    return (adj / d[:, None, None]) * rescale, sing


def _cross(u, v):
    return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                        u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                        u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=-1)


def _cmul(x, y):
    return x[0] * y[0] - x[1] * y[1], x[0] * y[1] + x[1] * y[0]


def _cdiv_by(x, dr, di):
    mag = dr * dr + di * di
    return (x[0] * dr + x[1] * di) / mag, (x[1] * dr - x[0] * di) / mag


def inv_complex(ar, ai):
    """Inverse of ``ar + i ai`` as ``((br, bi), singular)``: the closed-form
    complex adjugate of the prescaled pair for ``n <= 3``, the complex-pair
    LU solved against the identity above."""
    B, n = ar.shape[0], ar.shape[-1]
    if n > ADJUGATE_N:
        lu_rep, sing = lu_factor_cpair(ar, ai)
        eye = torch.eye(n, dtype=ar.dtype, device=ar.device).expand(B, n, n)
        return _lu_solve_cols_cpair(lu_rep, eye, torch.zeros_like(eye)), sing
    scale, bad = _prescale(ar, ai)
    ar = ar / scale[:, None, None]
    ai = ai / scale[:, None, None]
    rescale = div_const(scale, 1.0, reverse=True)
    E = lambda m, i, j: m[:, i, j]
    if n == 1:
        dr, di = E(ar, 0, 0), E(ai, 0, 0)
    elif n == 2:
        m0 = _cmul((E(ar, 0, 0), E(ai, 0, 0)), (E(ar, 1, 1), E(ai, 1, 1)))
        m1 = _cmul((E(ar, 0, 1), E(ai, 0, 1)), (E(ar, 1, 0), E(ai, 1, 0)))
        dr, di = m0[0] - m1[0], m0[1] - m1[1]
    else:
        rows = [(ar[:, k], ai[:, k]) for k in range(3)]
        c12 = _cross_c(rows[1], rows[2])
        pr, pi = _cmul((rows[0][0][:, 0], rows[0][1][:, 0]),
                       (c12[0][:, 0], c12[1][:, 0]))
        for k in (1, 2):
            qr, qi = _cmul((rows[0][0][:, k], rows[0][1][:, k]),
                           (c12[0][:, k], c12[1][:, k]))
            pr, pi = pr + qr, pi + qi
        dr, di = pr, pi
    sing = (bad | ((dr == 0.0) & (di == 0.0)) | ~torch.isfinite(dr)
            | ~torch.isfinite(di))
    dr = torch.where(sing, torch.ones_like(dr), dr)
    di = torch.where(sing, torch.zeros_like(di), di)
    D = lambda v: v[:, None, None]
    if n == 1:
        br, bi = _cdiv_by((torch.ones_like(ar), torch.zeros_like(ai)),
                          D(dr), D(di))
    elif n == 2:
        adj_r = torch.stack([torch.stack([ar[:, 1, 1], -ar[:, 0, 1]], -1),
                             torch.stack([-ar[:, 1, 0], ar[:, 0, 0]], -1)], 1)
        adj_i = torch.stack([torch.stack([ai[:, 1, 1], -ai[:, 0, 1]], -1),
                             torch.stack([-ai[:, 1, 0], ai[:, 0, 0]], -1)], 1)
        br, bi = _cdiv_by((adj_r, adj_i), D(dr), D(di))
    else:
        c20 = _cross_c(rows[2], rows[0])
        c01 = _cross_c(rows[0], rows[1])
        adj_r = torch.stack([c12[0], c20[0], c01[0]], dim=2)
        adj_i = torch.stack([c12[1], c20[1], c01[1]], dim=2)
        br, bi = _cdiv_by((adj_r, adj_i), D(dr), D(di))
    return (br * D(rescale), bi * D(rescale)), sing


def _cross_c(u, v):
    out_r, out_i = [], []
    for (p, q) in ((1, 2), (2, 0), (0, 1)):
        a_ = _cmul((u[0][:, p], u[1][:, p]), (v[0][:, q], v[1][:, q]))
        b_ = _cmul((u[0][:, q], u[1][:, q]), (v[0][:, p], v[1][:, p]))
        out_r.append(a_[0] - b_[0])
        out_i.append(a_[1] - b_[1])
    return torch.stack(out_r, -1), torch.stack(out_i, -1)


def solve_complex_inv(binv, br_, bi_):
    """Apply a complex inverse ``binv = (Br, Bi)`` to ``br_ + i bi_``."""
    Br, Bi = binv
    return (matvec(Br, br_) - matvec(Bi, bi_),
            matvec(Bi, br_) + matvec(Br, bi_))


def lu_factor_cpair(ar, ai):
    """Complex partial-pivot LU on (re, im) pairs, pivoting on |re| + |im|:
    ``((lur, lui, P), singular)``, packed as :func:`lu_factor`'s."""
    B, n = ar.shape[0], ar.shape[-1]
    dev, dt = ar.device, ar.dtype
    rows = torch.arange(n, device=dev)
    lur, lui = ar.clone(), ai.clone()
    P = torch.eye(n, dtype=dt, device=dev).expand(B, n, n).clone()
    sing = torch.zeros(B, dtype=torch.bool, device=dev)
    for k in range(n):
        colr0 = lur[:, :, k] + 0.0
        coli0 = lui[:, :, k] + 0.0
        mag = torch.where(rows[None, :] >= k,
                          torch.abs(colr0) + torch.abs(coli0),
                          torch.full_like(colr0, -1.0))
        p = torch.argmax(mag, dim=1)
        fk = (rows == k).to(dt)[None, :, None]
        fp = (rows[None, :] == p[:, None]).to(dt)[:, :, None]

        def swap(m):
            rk = m[:, k, :] + 0.0
            rp = _pick(m, p)
            return (m - fk * (rk - rp)[:, None, :]
                    - fp * (rp - rk)[:, None, :]), rk, rp

        lur, rk_r, rp_r = swap(lur)
        lui, rk_i, rp_i = swap(lui)
        P, _, _ = swap(P)

        def exch(col):
            ck = col[:, k] + 0.0
            cp = _pick(col, p)
            return (col + fk[..., 0] * (cp - ck)[:, None]
                    + fp[..., 0] * (ck - cp)[:, None]), cp

        colr, piv_r = exch(colr0)
        coli, piv_i = exch(coli0)
        pmag = torch.abs(piv_r) + torch.abs(piv_i)
        sing = sing | (pmag == 0.0) | ~torch.isfinite(pmag)
        den = piv_r * piv_r + piv_i * piv_i
        den = torch.where(den == 0.0, torch.ones_like(den), den)
        inv_r = piv_r / den
        inv_i = -piv_i / den
        below = rows[None, :] > k
        fr = torch.where(below, colr, torch.zeros_like(colr))
        fi = torch.where(below, coli, torch.zeros_like(coli))
        fac_r = fr * inv_r[:, None] - fi * inv_i[:, None]
        fac_i = fr * inv_i[:, None] + fi * inv_r[:, None]
        sel = (p == k)[:, None]
        ur = torch.where(sel, rk_r, rp_r)
        ui = torch.where(sel, rk_i, rp_i)
        right = rows[None, :] > k
        ur_u = torch.where(right, ur, torch.zeros_like(ur))[:, None, :]
        ui_u = torch.where(right, ui, torch.zeros_like(ui))[:, None, :]
        lur = lur - (fac_r[:, :, None] * ur_u - fac_i[:, :, None] * ui_u)
        lui = lui - (fac_r[:, :, None] * ui_u + fac_i[:, :, None] * ur_u)
        in_col = ((rows[:, None] > k) & (rows[None, :] == k))[None]
        lur = torch.where(in_col, fac_r[:, :, None], lur)
        lui = torch.where(in_col, fac_i[:, :, None], lui)
    return (lur, lui, P), sing


def _cpair_sub(lur, lui, xr, xi, cols):
    """The forward and back substitutions of the complex-pair solves, on
    ``x (B, n)`` or, with ``cols``, ``(B, n, k)``."""
    n = lur.shape[-1]
    c = (lambda v: v[:, None]) if cols else (lambda v: v)
    for k in range(1, n):
        lr = [c(lur[:, k, j]) for j in range(k)]
        li = [c(lui[:, k, j]) for j in range(k)]
        sr = _sum([lr[j] * xr[:, j] - li[j] * xi[:, j] for j in range(k)])
        si = _sum([lr[j] * xi[:, j] + li[j] * xr[:, j] for j in range(k)])
        xr, xi = xr.clone(), xi.clone()
        xr[:, k] = xr[:, k] - sr
        xi[:, k] = xi[:, k] - si
    for k in range(n - 1, -1, -1):
        js = range(k + 1, n)
        if len(js):
            sr = _sum([c(lur[:, k, j]) * xr[:, j] - c(lui[:, k, j]) * xi[:, j]
                       for j in js])
            si = _sum([c(lur[:, k, j]) * xi[:, j] + c(lui[:, k, j]) * xr[:, j]
                       for j in js])
        else:
            sr = si = torch.zeros_like(xr[:, k])
        rr = (xr[:, k] + 0.0) - sr
        ri = (xi[:, k] + 0.0) - si
        dr = c(lur[:, k, k] + 0.0)
        di = c(lui[:, k, k] + 0.0)
        den = dr * dr + di * di
        den = torch.where(den == 0.0, torch.ones_like(den), den)
        xr, xi = xr.clone(), xi.clone()
        xr[:, k] = (rr * dr + ri * di) / den
        xi[:, k] = (ri * dr - rr * di) / den
    return xr, xi


def _lu_solve_cols_cpair(lu_rep, Br, Bi):
    """Multi-RHS complex-pair solve, ``A X = B`` for ``B (B, n, k)``."""
    lur, lui, P = lu_rep
    return _cpair_sub(lur, lui, _permute(P, Br), _permute(P, Bi), True)


def lu_solve_cpair(lu_rep, br, bi):
    """Solve ``(ar + i ai)(xr + i xi) = br + i bi`` from
    :func:`lu_factor_cpair`."""
    lur, lui, P = lu_rep
    return _cpair_sub(lur, lui, _permute(P, br), _permute(P, bi), False)
