"""The stiff engines' Jacobian (``ivp_tpu.solve._normalize_jac``) and the
spec a stiff solve carries to its route.  (``ivp_tpu.solve.
_facade_jac_dtype`` picks a float32 Jacobian only under the options of
ROADMAP §1 item 15, which raise here; on the default path the Jacobian
runs in the state's dtype.)

A Jacobian function here is batched: ``jac_fn(t (B,), y (B, n)) -> (B, n,
n)``, ``J[b, i, j] = d f_i / d y_j`` on lane ``b``.  What the user gives as
``jac``:

* None: the RHS's own Jacobian where it has one (a :class:`CudaRHS` with a
  ``jac``, the plain twin of its CUDA functor's), else forward-mode
  differentiation of the RHS per lane (``torch.func.jvp`` along each basis
  vector, which is what ``jax.jacfwd`` does);
* a callable, batched like the RHS: ``jac(t (B,), y (B, n), *args) -> (B,
  n, n)`` (``solve_ivp`` wraps a SciPy-style one);
* a constant ``(n, n)`` matrix (numpy, a tensor or scipy-sparse): then
  ``const_jac`` is True and njev stays 0.

``jac_sparsity``, ``jac_precision`` other than the default and
``newton_precision="mixed"`` are ROADMAP §1 item 15.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..rhs import CudaRHS


def forward_jacobian(rhs, n):
    """``jac_fn`` of a batched ``rhs(t, y)`` by forward-mode
    differentiation: column j is the JVP along the j-th basis vector."""
    def jac_fn(t, y):
        cols = []
        for j in range(n):
            e = torch.zeros_like(y)
            e[:, j] = 1.0
            _, tj = torch.func.jvp(lambda yy: rhs(t, yy), (y,), (e,))
            cols.append(tj)
        return torch.stack(cols, dim=-1)
    return jac_fn


def normalize_jac(jac, rhs, n, dtype, args, fun=None):
    """``(jac_fn, const_jac)`` for the user's ``jac`` (see the module
    docstring).  ``rhs(t, y)`` is the solve's batched RHS with its args
    bound, ``fun`` the user's RHS (a CudaRHS brings its own Jacobian)."""
    if jac is None:
        if isinstance(fun, CudaRHS) and fun.jac is not None:
            def jac_fn(t, y):
                return fun.jacobian(t, y, *args).to(y.dtype)
            return jac_fn, False
        return forward_jacobian(rhs, n), False
    if callable(jac):
        def jac_fn(t, y):
            j = jac(t, y, *args)
            if hasattr(j, "toarray"):
                j = j.toarray()
            return torch.as_tensor(j, dtype=y.dtype, device=y.device).reshape(
                y.shape[0], n, n)
        return jac_fn, False
    j = jac.toarray() if hasattr(jac, "toarray") else jac
    if isinstance(j, torch.Tensor):
        j = j.detach().cpu().numpy()
    j_const = np.asarray(j, dtype=float).reshape(n, n)
    cache = {}

    def jac_fn(t, y):
        key = (y.device, y.dtype)
        m = cache.get(key)
        if m is None:
            m = cache[key] = torch.as_tensor(j_const, dtype=y.dtype,
                                             device=y.device)
        return m.expand(y.shape[0], n, n)
    return jac_fn, True


@dataclasses.dataclass(frozen=True)
class StiffSpec:
    """What a Radau or BDF solve hands its route besides the RHS: the
    method, the state size, the engine's ``solver_options`` (sorted items)
    and the user's ``jac`` (not compared: a spec is equal to another with
    the same options).  ``params`` are the engine's RadauParams or
    BDFParams with the default Jacobian, for the kernel's launch."""

    method: str
    n: int
    options: tuple
    jac: Any = dataclasses.field(default=None, compare=False, hash=False)

    def engine(self, fun, rhs, args, dtype, need_cont: bool):
        """``(engine, params)`` of the plain version, with ``rhs(t, y)`` the
        solve's batched RHS with its args bound."""
        from . import get_engine
        jac_fn, const_jac = normalize_jac(self.jac, rhs, self.n, dtype, args,
                                          fun)
        return get_engine(self.method, need_cont=need_cont, jac_fn=jac_fn,
                          const_jac=const_jac, n=self.n, **dict(self.options))

    def params(self, need_cont: bool = False):
        from . import get_engine
        return get_engine(self.method, need_cont=need_cont,
                          jac_fn=_no_jac, const_jac=self.const_jac, n=self.n,
                          **dict(self.options))[1]

    @property
    def const_jac(self) -> bool:
        return self.jac is not None and not callable(self.jac)


def _no_jac(t, y):
    raise RuntimeError("the spec's params carry no Jacobian")


def stiff_spec(method, n, jac, solver_options) -> StiffSpec:
    """The spec of a Radau or BDF solve; builds its params once, so an
    unknown or unported option raises here, before anything is placed."""
    so = dict(solver_options or {})
    spec = StiffSpec(method.upper(), int(n), tuple(sorted(so.items())), jac)
    spec.params()
    return spec
