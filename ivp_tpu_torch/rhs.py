"""Right-hand sides that both routes can run.

A torch RHS is batched: ``fun(t, y, *args)`` takes ``t`` of shape ``(B,)``
and ``y`` of shape ``(B, n)`` and returns ``(B, n)``.  Each arg is a Python
number or 0-d tensor shared by all lanes, or, with ``args_batched=True``, a
``(B,)`` tensor with one value per lane.

A :class:`CudaRHS` pairs such a torch function with a CUDA device functor
of the same name in ``csrc/rhs/<name>.cuh``, compiled into the kernel
libraries (kernels/build.py).  On a CUDA tensor the ensemble solve and
``solve_ivp`` run only a ``CudaRHS``; any torch callable runs on the CPU.  To
add one: write the functor header, include it in ``csrc/erk_common.cuh`` and
``csrc/dopri5_ensemble.cu``, add its ``IVP_DOPRI5_ENTRY`` line there, its
``IVP_ERK_ENTRY`` line (which declares the lean, sampled and record entries)
to each ``csrc/erk_*.cu`` and its two lines to ``IVP_ERK_LIBRARY``, give
``kernels/erk_ensemble.py::RHS_FLOPS`` and
``kernels/dopri5_ensemble.py::FLOPS_PER_ATTEMPT`` its operation counts, and
define it here.  A functor that runs only with its event sets (as
``ball``) has no ``IVP_DOPRI5_ENTRY`` or ``IVP_ERK_ENTRY`` line: its
``IVP_ERK_EVENT_ENTRY`` lines declare it (ivp_tpu_torch/events.py says how
to add an event set), and a launch without them finds no entry and raises
NotImplementedError.

The stiff methods (Radau, BDF) need the RHS's Jacobian.  A CudaRHS may bring
its own: ``jac``, a torch function ``jac(t (B,), y (B, n), *args) -> (B,
n, n)`` with ``J[b, i, j] = d f_i / d y_j``, twin of a ``jac(t, y, J, args)``
method of the CUDA functor (``J`` row-major, ``n * n`` doubles), which the
stiff kernels (csrc/radau.cu, csrc/bdf.cu) call.  Both compute each entry in
the order of operations that forward-mode differentiation of the RHS
(``jax.jacfwd`` in ``ivp_tpu``) produces, so the torch twin, the reference
and the kernel round alike (the stiff kernels are built without FMA
contraction, kernels/build.py).  A stiff solve on the card needs a CudaRHS
with a Jacobian (``vdp``, ``decay``, ``robertson``); on the CPU any RHS runs,
differentiated by ``torch.func`` where it brings no Jacobian.  To give a
functor the stiff kernels: its ``jac`` method, an include in
``csrc/stiff_common.cuh``, one ``IVP_RADAU_ENTRY`` line in ``csrc/radau.cu``
and one ``IVP_BDF_ENTRY`` line in ``csrc/bdf.cu``, its two lines in
``IVP_STIFF_LIBRARY``, and its operation counts in
``kernels/stiff_ensemble.py::JAC_FLOPS`` and
``kernels/erk_ensemble.py::RHS_FLOPS``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


class CudaRHS:
    """A torch RHS with a CUDA functor of the same ``name``.

    ``defaults`` holds the value of every scalar parameter, in order; a call
    may give fewer args, and the rest take their defaults.
    """

    def __init__(self, name: str, n: int, fn: Callable, defaults: tuple,
                 jac: Optional[Callable] = None):
        self.name = name
        self.n = n
        self.fn = fn
        self.defaults = tuple(float(d) for d in defaults)
        self.jac = jac

    def __call__(self, t, y, *args):
        return self.fn(t, y, *self._full(args))

    def __repr__(self):
        return f"CudaRHS({self.name!r}, n={self.n})"

    def jacobian(self, t, y, *args):
        """The torch twin of the functor's Jacobian, ``(B, n, n)``."""
        if self.jac is None:
            raise NotImplementedError(f"{self.name} has no Jacobian")
        return self.jac(t, y, *self._full(args))

    def _full(self, args):
        if len(args) > len(self.defaults):
            raise ValueError(f"{self.name} takes at most {len(self.defaults)} "
                             f"args, got {len(args)}")
        return tuple(args) + self.defaults[len(args):]

    def kernel_args(self, args, B: int, device) -> torch.Tensor:
        """The args as the kernel reads them: a contiguous ``(B, nargs)``
        float64 tensor.  Each arg is one number shared by every lane or a
        ``(B,)`` tensor of per-lane values."""
        full = self._full(args)
        if len(full) == 1 and isinstance(full[0], (int, float)):
            return torch.full((B, 1), float(full[0]), dtype=torch.float64,
                              device=device)
        cols = []
        for i, a in enumerate(full):
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


def _vdp_jac(t, y, mu=1.0):
    # jax.jacfwd of _vdp: d/dy0 of mu (1 - y0 y0) y1 - y0 is
    # mu * (-(y0 + y0)) * y1 - 1.0 (the product's tangent, then the
    # subtraction's).
    y0, y1 = y[:, 0], y[:, 1]
    zero, one = torch.zeros_like(y0), torch.ones_like(y0)
    return torch.stack([
        torch.stack([zero, one], -1),
        torch.stack([mu * (-(y0 + y0)) * y1 - 1.0, mu * (1.0 - y0 * y0)], -1),
    ], 1)


def _lane_col(k):
    """A per-lane ``(B,)`` arg as a column ``(B, 1)``, to scale each lane's
    state; a number as it is."""
    return k[:, None] if isinstance(k, torch.Tensor) and k.ndim == 1 else k


def _decay(t, y, k=1.0):
    return -_lane_col(k) * y


def _decay_jac(t, y, k=1.0):
    if isinstance(k, torch.Tensor):
        return (-_lane_col(k)).to(y.dtype).expand(y.shape)[:, :, None].clone()
    return torch.full_like(y, -k)[:, :, None]


def _robertson(t, y):
    x, u, z = y[:, 0], y[:, 1], y[:, 2]
    return torch.stack([-0.04 * x + 1e4 * u * z,
                        0.04 * x - 1e4 * u * z - 3e7 * u * u,
                        3e7 * u * u], dim=-1)


def _robertson_jac(t, y):
    # jax.jacfwd of _robertson: (3e7 u) u differentiates to 3e7 u + 3e7 u,
    # and (1e4 u) z to 1e4 z and 1e4 u.
    x, u, z = y[:, 0], y[:, 1], y[:, 2]
    c = lambda v: torch.full_like(x, v)
    du = 3e7 * u + 3e7 * u
    return torch.stack([
        torch.stack([c(-0.04), 1e4 * z, 1e4 * u], -1),
        torch.stack([c(0.04), -(1e4 * z) - du, -(1e4 * u)], -1),
        torch.stack([c(0.0), du, c(0.0)], -1),
    ], 1)


def _lorenz(t, y, sigma=10.0, rho=28.0, beta=8.0 / 3.0):
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    return torch.stack([sigma * (y1 - y0), y0 * (rho - y2) - y1,
                        y0 * y1 - beta * y2], dim=-1)


def _ball(t, y, g=9.81):
    return torch.stack([y[:, 1], torch.zeros_like(y[:, 1]) - g], dim=-1)


def _cr3bp(t, s, mu=0.012277471):
    # The operations and their order of tests/test_gates.py's jnp RHS (and
    # of csrc/rhs/cr3bp.cuh): squares as products, r**3 as r * (r * r).
    x, y, z = s[:, 0], s[:, 1], s[:, 2]
    xm, xm1 = x + mu, (x - 1.0) + mu
    y2, z2 = y * y, z * z
    r1 = torch.sqrt((xm * xm + y2) + z2)
    r2 = torch.sqrt((xm1 * xm1 + y2) + z2)
    r13, r23 = r1 * (r1 * r1), r2 * (r2 * r2)
    om = 1.0 - mu
    return torch.stack([
        s[:, 3], s[:, 4], s[:, 5],
        ((x + 2.0 * s[:, 4]) - (om * xm) / r13) - (mu * xm1) / r23,
        ((y - 2.0 * s[:, 3]) - (om * y) / r13) - (mu * y) / r23,
        ((-om) * z) / r13 - (mu * z) / r23], dim=-1)


# Van der Pol, y0' = y1, y1' = mu (1 - y0^2) y1 - y0 (mu = 1: non-stiff).
vdp = CudaRHS("vdp", 2, _vdp, (1.0,), _vdp_jac)
# Exponential decay, y' = -k y.
decay = CudaRHS("decay", 1, _decay, (1.0,), _decay_jac)
# Lorenz 63.
lorenz = CudaRHS("lorenz", 3, _lorenz, (10.0, 28.0, 8.0 / 3.0))
# The circular restricted three-body problem in the rotating frame, state
# (x, y, z, vx, vy, vz), mass ratio mu (default: Earth-Moon, the Arenstorf
# orbit's).
cr3bp = CudaRHS("cr3bp", 6, _cr3bp, (0.012277471,))
# Robertson's chemical kinetics (tests/test_stiff.py), stiff over [0, 1e8];
# no parameters.
robertson = CudaRHS("robertson", 3, _robertson, (), _robertson_jac)
# A ball in free fall, y = (height, velocity), y' = (v, -g).  On the card it
# runs only with its event set ``events.ground`` (the bounce),
# csrc/events/ground.cuh.
ball = CudaRHS("ball", 2, _ball, (9.81,))
