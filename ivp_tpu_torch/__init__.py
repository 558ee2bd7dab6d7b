"""ivp_tpu_torch — the PyTorch/CUDA port of ``ivp_tpu``.

The JAX package ``ivp_tpu`` stays the reference; this package runs the same
solves with PyTorch on the CPU and on an NVIDIA Hopper GPU (H100), and
imports no jax.  Ported so far: the explicit tier of the ensemble solve
(``build_ensemble_solver`` / ``solve_ivp_ensemble`` with ``"RK45"``,
``"DOP853"``, ``"RK23"`` and ``"RK4"``), to each lane's final state or with
in-loop samples on a ``t_eval`` grid, with the engines' ``solver_options``:
through the plain PyTorch driver on the CPU and one hand-written CUDA kernel
launch per solve on the GPU (kernels/erk_ensemble.py).  ROADMAP.md lists the
slices still to come.

The RHS contract differs from ``ivp_tpu`` in one way: a torch RHS is
batched, ``fun(t, y, *args)`` with ``t`` of shape ``(B,)`` and ``y`` of shape
``(B, n)``, returning ``(B, n)``.  On a GPU the RHS must be a
:class:`~ivp_tpu_torch.rhs.CudaRHS` (``rhs.vdp``, ``rhs.decay``,
``rhs.lorenz``), whose CUDA functor is compiled into the kernel.
"""
from . import rhs
from .types import Status, strict_methods
from .batch import EnsembleResult, build_ensemble_solver, solve_ivp_ensemble

__version__ = "0.1.0"

__all__ = [
    "build_ensemble_solver",
    "solve_ivp_ensemble",
    "EnsembleResult",
    "Status",
    "strict_methods",
    "rhs",
]
