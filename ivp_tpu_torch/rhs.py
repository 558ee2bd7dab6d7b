"""Right-hand sides that both routes can run.

A torch RHS is batched: ``fun(t, y, *args)`` takes ``t`` of shape ``(B,)``
and ``y`` of shape ``(B, n)`` and returns ``(B, n)``.  Each arg is a Python
number or 0-d tensor shared by all lanes, or, with ``args_batched=True``, a
``(B,)`` tensor with one value per lane.

A :class:`CudaRHS` pairs such a torch function with a CUDA device functor
of the same name in ``csrc/rhs/<name>.cuh``, compiled into the kernel library
(kernels/build.py).  On a CUDA tensor the ensemble solve runs only a
``CudaRHS``; any torch callable runs on the CPU.  To add one: write the
functor header, add its ``IVP_DOPRI5_ENTRY`` line to
``csrc/dopri5_ensemble.cu`` and define it here.
"""
from __future__ import annotations

from typing import Callable

import torch


class CudaRHS:
    """A torch RHS with a CUDA functor of the same ``name``.

    ``defaults`` holds the value of every scalar parameter, in order; a call
    may give fewer args, and the rest take their defaults.
    """

    def __init__(self, name: str, n: int, fn: Callable, defaults: tuple):
        self.name = name
        self.n = n
        self.fn = fn
        self.defaults = tuple(float(d) for d in defaults)

    def __call__(self, t, y, *args):
        return self.fn(t, y, *self._full(args))

    def __repr__(self):
        return f"CudaRHS({self.name!r}, n={self.n})"

    def _full(self, args):
        if len(args) > len(self.defaults):
            raise ValueError(f"{self.name} takes at most {len(self.defaults)} "
                             f"args, got {len(args)}")
        return tuple(args) + self.defaults[len(args):]

    def kernel_args(self, args, B: int, device) -> torch.Tensor:
        """The args as the kernel reads them: a contiguous ``(B, nargs)``
        float64 tensor.  Each arg is one number shared by every lane or a
        ``(B,)`` tensor of per-lane values."""
        cols = []
        for i, a in enumerate(self._full(args)):
            if isinstance(a, (int, float)):   # filled on the device, no copy
                cols.append(torch.full((B,), float(a), dtype=torch.float64,
                                       device=device))
                continue
            a = torch.as_tensor(a, dtype=torch.float64, device=device)
            if a.numel() == 1:
                a = a.reshape(()).expand(B)
            elif a.shape != (B,):
                raise ValueError(f"{self.name} arg {i} must be a scalar or "
                                 f"have shape ({B},), got {tuple(a.shape)}")
            cols.append(a)
        if not cols:
            return torch.empty((B, 0), dtype=torch.float64, device=device)
        return torch.stack(cols, dim=-1).contiguous()


def _vdp(t, y, mu=1.0):
    y0, y1 = y[:, 0], y[:, 1]
    return torch.stack([y1, mu * (1.0 - y0 * y0) * y1 - y0], dim=-1)


def _decay(t, y, k=1.0):
    return -k * y


def _lorenz(t, y, sigma=10.0, rho=28.0, beta=8.0 / 3.0):
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    return torch.stack([sigma * (y1 - y0), y0 * (rho - y2) - y1,
                        y0 * y1 - beta * y2], dim=-1)


# Van der Pol, y0' = y1, y1' = mu (1 - y0^2) y1 - y0 (mu = 1: non-stiff).
vdp = CudaRHS("vdp", 2, _vdp, (1.0,))
# Exponential decay, y' = -k y.
decay = CudaRHS("decay", 1, _decay, (1.0,))
# Lorenz 63.
lorenz = CudaRHS("lorenz", 3, _lorenz, (10.0, 28.0, 8.0 / 3.0))
