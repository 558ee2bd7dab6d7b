"""Shared numerical utilities for the step engines (``ivp_tpu.core.common``).

Batched: every state-shaped tensor has a leading batch axis, ``(B, n)``, and
every per-lane scalar has shape ``(B,)``.  Sums over the state axis run left
to right, one component at a time, as XLA's CPU reduction does, so the
port's step sequences follow the reference's.

Ported: the primal ``hinit`` and ``brentq`` (the events' root finder); the
custom JVPs of ``ivp_tpu.core.common`` wait for the differentiation slice.
"""
from __future__ import annotations

import numpy as np
import torch

UROUND = 2.3e-16  # machine rounding unit used by the controllers (f64)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root.  ``torch.sqrt`` on a CPU tensor is
    not (in float64 about 0.9% of operands, in float32 0.7%, round to the
    other neighbour of the root, as a vectorised approximation does), where
    XLA's, numpy's and the kernels' ``sqrt.rn`` are; on the CPU the root is
    numpy's, elsewhere torch's."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.sqrt(x.detach().numpy()))


def rowsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right: ``(B, n) -> (B,)``."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def div_const(x, c, reverse=False):
    """``x / c`` (or ``c / x`` with ``reverse``) as a true IEEE division on
    every device.  PyTorch turns a division by a Python scalar on a CUDA
    tensor, and ``scalar / tensor`` everywhere, into a multiplication by a
    reciprocal, which rounds differently from the reference and the kernel."""
    cc = torch.full_like(x, c)
    return cc / x if reverse else x / cc


def safe_pow(x, p):
    """``x**p`` robust to non-finite bases: ``inf**p`` is 0 for ``p < 0`` and
    inf for ``p > 0``; NaN and ``-inf`` bases give NaN (as
    ``ivp_tpu.core.common.safe_pow``, whose platform pow misbehaves there)."""
    finite = torch.isfinite(x)
    r = torch.where(finite, x, torch.ones_like(x)) ** p
    pos_inf = torch.isinf(x) & (x > 0)
    r = torch.where(pos_inf, torch.full_like(x, float("inf") if p > 0 else 0.0),
                    r)
    bad = torch.isnan(x) | (torch.isinf(x) & (x < 0))
    return torch.where(bad, torch.full_like(x, float("nan")), r)


def error_scale(atol, rtol, y):
    """Component scale ``atol + rtol*|y|``."""
    return atol + rtol * torch.abs(y)


def scaled_rms(v, scale):
    """sqrt(mean((v/scale)^2)) over the last axis — the weighted RMS error
    norm used everywhere."""
    r = v / scale
    return torch.sqrt(div_const(rowsum(r * r), v.shape[-1]))


def hinit(rhs, t, y, posneg, f0, iord, hmax, atol, rtol):
    """Automatic initial step size (Hairer's HINIT), per lane.

    ``t, posneg, hmax``: ``(B,)``; ``y, f0, atol, rtol``: ``(B, n)``.
    Returns ``(h, f1)`` with ``f1`` the RHS at the Euler probe point (one
    extra RHS evaluation, counted by the caller).  Its square roots are
    correctly rounded (:func:`sqrt_rn`), as the kernels' ``hinit``'s are.
    """
    sk = atol + rtol * torch.abs(y)
    fs, ys = f0 / sk, y / sk
    dnf = rowsum(fs * fs)
    dny = rowsum(ys * ys)

    h = torch.where((dnf <= 1e-10) | (dny <= 1e-10),
                    torch.full_like(dnf, 1.0e-6), sqrt_rn(dny / dnf) * 0.01)
    h = torch.minimum(h, torch.abs(hmax))
    h = torch.abs(h) * torch.sign(posneg)

    # Explicit Euler probe.
    y1 = y + h[:, None] * f0
    f1 = rhs(t + h, y1)

    df = (f1 - f0) / sk
    der2 = sqrt_rn(rowsum(df * df)) / torch.abs(h)

    der12 = torch.maximum(torch.abs(der2), sqrt_rn(dnf))
    h1 = torch.where(der12 <= 1.0e-15,
                     torch.clamp_min(torch.abs(h) * 1.0e-3, 1.0e-6),
                     div_const(der12, 0.01, reverse=True) ** (1.0 / iord))
    # min(|h|, 100|h|, h1, |hmax|) == min(|h|, h1, |hmax|)
    h_final = torch.minimum(torch.minimum(torch.abs(h), h1), torch.abs(hmax))
    return torch.abs(h_final) * torch.sign(posneg), f1


def brentq(gfun, a, b, fa, fb, active, xtol=2e-12, rtol=UROUND,
           maxiter=100):
    """Brent's root finder on the lanes where ``active`` (``(B,)`` bool),
    with ``scipy.optimize.brentq``'s semantics (``ivp_tpu.core.common.brentq``):
    a root in ``[a, b]`` of ``gfun``, given ``fa = gfun(a)`` and ``fb =
    gfun(b)`` of opposite signs, to ``xtol + 2 rtol |root|``; an endpoint with
    ``|f| <= xtol`` is the root at once.  ``gfun`` maps ``(B,)`` times to
    ``(B,)`` values.

    The lanes run in lock step, as the reference's vmapped ``while_loop``
    does: a lane that has converged (or is not active) is frozen while the
    others iterate, and ``gfun`` sees its frozen point.  Returns ``(root,
    evals)``: the root (``b`` where not active) and the ``gfun`` evaluations
    each lane used ``(B,)`` int32 (the kernel's Brent counts the same)."""
    a_is_root = torch.abs(fa) <= xtol
    b_is_root = torch.abs(fb) <= xtol
    done = ~active | a_is_root | b_is_root
    a0, b0 = a, b
    c, fc = a, fa
    d = e = b - a
    evals = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    for _ in range(maxiter):
        if bool(done.all()):
            break
        # Re-bracket.
        rebr = fb * fc > 0.0
        c = torch.where(rebr, a, c)
        fc = torch.where(rebr, fa, fc)
        d = torch.where(rebr, b - a, d)
        e = torch.where(rebr, d, e)
        # Swap so |fb| <= |fc|.
        swap = torch.abs(fc) < torch.abs(fb)
        a2 = torch.where(swap, b, a)
        b2 = torch.where(swap, c, b)
        c2 = torch.where(swap, a2, c)
        fa2 = torch.where(swap, fb, fa)
        fb2 = torch.where(swap, fc, fb)
        fc2 = torch.where(swap, fa2, fc)

        tol1 = 2.0 * rtol * torch.abs(b2) + 0.5 * xtol
        xm = 0.5 * (c2 - b2)
        converged = (torch.abs(xm) <= tol1) | (fb2 == 0.0)

        # Interpolation step (secant / inverse quadratic).
        use_interp = (torch.abs(e) >= tol1) & (torch.abs(fa2) > torch.abs(fb2))
        s_lin = fb2 / fa2
        p_lin = 2.0 * xm * s_lin
        q_lin = 1.0 - s_lin
        q_val = fa2 / fc2
        r_val = fb2 / fc2
        s_q = fb2 / fa2
        p_quad = s_q * (2.0 * xm * q_val * (q_val - r_val)
                        - (b2 - a2) * (r_val - 1.0))
        q_quad = (q_val - 1.0) * (r_val - 1.0) * (s_q - 1.0)
        linear = a2 == c2
        p = torch.where(linear, p_lin, p_quad)
        q = torch.where(linear, q_lin, q_quad)
        p, q = torch.where(q > 0.0, -p, p), torch.where(q > 0.0, q, -q)
        ok = 2.0 * p < torch.minimum(3.0 * xm * q - torch.abs(tol1 * q),
                                     torch.abs(e * q))
        take = use_interp & ok
        d_new = torch.where(take, p / q, xm)
        e_new = torch.where(take, d, d_new)
        b_next = torch.where(torch.abs(d_new) > tol1, b2 + d_new,
                             b2 + torch.where(xm > 0.0, tol1, -tol1))

        # A converging lane keeps this iteration's bracket; a frozen one
        # keeps all it had.  gfun sees the frozen lanes' b.
        stay = done | converged
        fb_next = gfun(torch.where(stay, b, b_next))
        live = ~stay
        evals = evals + live.to(torch.int32)
        conv_now = converged & ~done
        a = torch.where(live, b2, torch.where(conv_now, a2, a))
        fa = torch.where(live, fb2, torch.where(conv_now, fa2, fa))
        b = torch.where(live, b_next, torch.where(conv_now, b2, b))
        fb = torch.where(live, fb_next, torch.where(conv_now, fb2, fb))
        c = torch.where(done, c, c2)
        fc = torch.where(done, fc, fc2)
        d = torch.where(live, d_new, d)
        e = torch.where(live, e_new, e)
        done = stay
    root = torch.where(b_is_root, b0, b)
    root = torch.where(a_is_root, a0, root)
    return root, evals
