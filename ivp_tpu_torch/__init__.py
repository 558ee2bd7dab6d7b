"""ivp_tpu_torch — the PyTorch/CUDA port of ``ivp_tpu``.

The JAX package ``ivp_tpu`` stays the reference; this package runs the same
solves with PyTorch on the CPU and on an NVIDIA Hopper GPU (H100), and
imports no jax.  Ported so far, for the explicit methods ``"RK45"``,
``"DOP853"``, ``"RK23"`` and ``"RK4"`` and the stiff ``"Radau"`` and
``"BDF"`` (with ``jac``), with the engines' ``solver_options``:

* the ensemble solve (``build_ensemble_solver`` / ``solve_ivp_ensemble``),
  to each lane's final state or with in-loop samples on a ``t_eval`` grid,
  and its recording tier (``record_trajectories``, ``dense_output`` and
  :class:`BatchOdeSolution`);
* the resumable solver (``batch.build_resumable_solver``: the carry is the
  checkpoint) and an integer ``lane_chunk``;
* the SciPy-compatible single-IVP facade :func:`solve_ivp`, with ``t_eval``,
  ``dense_output`` (:class:`OdeSolution`) and ``first_step``;
* events and in-loop restarts through all of them (``events``,
  ``event_capacity``, ``max_restarts``; :mod:`ivp_tpu_torch.events` has the
  contract and the event sets the kernels run).

Each runs through the plain PyTorch driver on the CPU and hand-written CUDA
kernels on the GPU (kernels/erk_ensemble.py, kernels/erk_record.py,
kernels/stiff_ensemble.py, kernels/resumable.py); Radau and BDF run on the
GPU to the final state or resumably.  ROADMAP.md lists the slices still to
come.

The RHS contract: an ensemble's torch RHS is batched, ``fun(t, y, *args)``
with ``t`` of shape ``(B,)`` and ``y`` of shape ``(B, n)``, returning
``(B, n)``; ``solve_ivp`` takes a SciPy-style callable (``t`` 0-d, ``y`` of
shape ``(n,)``) on the CPU.  On a GPU the RHS must be a
:class:`~ivp_tpu_torch.rhs.CudaRHS` (``rhs.vdp``, ``rhs.decay``,
``rhs.lorenz``, ``rhs.cr3bp``, ``rhs.robertson``), whose CUDA functor is
compiled into the kernels; ``solve_ivp`` runs one as a single lane.
"""
from . import rhs
from .types import Status, strict_methods
from .batch import (BatchOdeSolution, EnsembleResult, build_ensemble_solver,
                    build_recording_solver, solve_ivp_ensemble)
from .solve import OdeResult, OdeSolution, solve_ivp

__version__ = "0.1.0"

__all__ = [
    "solve_ivp",
    "OdeResult",
    "OdeSolution",
    "build_ensemble_solver",
    "build_recording_solver",
    "BatchOdeSolution",
    "solve_ivp_ensemble",
    "EnsembleResult",
    "Status",
    "strict_methods",
    "rhs",
]
