"""Shared numerical utilities for the step engines (``ivp_tpu.core.common``).

Batched: every state-shaped tensor has a leading batch axis, ``(B, n)``, and
every per-lane scalar has shape ``(B,)``.  Sums over the state axis run left
to right, one component at a time, as XLA's CPU reduction does, so the
port's step sequences follow the reference's.

Only the primal ``hinit`` is ported here; the custom JVPs of
``ivp_tpu.core.common`` wait for the differentiation slice.
"""
from __future__ import annotations

import torch

UROUND = 2.3e-16  # machine rounding unit used by the controllers (f64)


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
    extra RHS evaluation, counted by the caller).
    """
    sk = atol + rtol * torch.abs(y)
    fs, ys = f0 / sk, y / sk
    dnf = rowsum(fs * fs)
    dny = rowsum(ys * ys)

    h = torch.where((dnf <= 1e-10) | (dny <= 1e-10),
                    torch.full_like(dnf, 1.0e-6), torch.sqrt(dny / dnf) * 0.01)
    h = torch.minimum(h, torch.abs(hmax))
    h = torch.abs(h) * torch.sign(posneg)

    # Explicit Euler probe.
    y1 = y + h[:, None] * f0
    f1 = rhs(t + h, y1)

    df = (f1 - f0) / sk
    der2 = torch.sqrt(rowsum(df * df)) / torch.abs(h)

    der12 = torch.maximum(torch.abs(der2), torch.sqrt(dnf))
    h1 = torch.where(der12 <= 1.0e-15,
                     torch.clamp_min(torch.abs(h) * 1.0e-3, 1.0e-6),
                     div_const(der12, 0.01, reverse=True) ** (1.0 / iord))
    # min(|h|, 100|h|, h1, |hmax|) == min(|h|, h1, |hmax|)
    h_final = torch.minimum(torch.minimum(torch.abs(h), h1), torch.abs(hmax))
    return torch.abs(h_final) * torch.sign(posneg), f1
