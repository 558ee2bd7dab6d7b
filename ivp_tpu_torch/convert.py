"""State carried across from ``ivp_tpu`` to the port and back, and results.

No jax import: the ``ivp_tpu`` objects come in with numpy leaves (e.g.
``jax.tree.map(np.asarray, carry)``) and are read by field name.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.driver import Carry
from .methods.bdf import BDFState
from .methods.erk import ERKParams, ERKState
from .methods.radau import RadauState

# The engine state of each canonical method's carry.
_STATE = {"RADAU": RadauState, "BDF": BDFState}


def erk_params_from_jax(p) -> ERKParams:
    """The port's ERKParams from an ``ivp_tpu.methods.erk.ERKParams`` of any
    of the four explicit methods."""
    return ERKParams(**{f.name: getattr(p, f.name)
                        for f in dataclasses.fields(ERKParams)})


def carry_from_numpy(carry, device=None) -> Carry:
    """The port's driver Carry from an ``ivp_tpu`` driver Carry, lean, in
    sample mode or in record mode (``rec_scan=False``), whose leaves are
    numpy arrays, ``ERKState`` included.  Vmapped (every leaf has a leading
    batch axis) or a single IVP's (``solve_ivp``'s driver; it comes across
    as one lane).  The sample cursor and buffer, the carried segment and the
    record cursor and buffers (``s_cursor``, ``sample_y``, ``seg_*``,
    ``n_rec``, ``rec_*``, ``rec_cont`` in its flat ``(cap, C*n)`` rows) come
    across as they are: zero-size where the mode is off, mid-solve
    otherwise.  dtypes are kept; tensors land on ``device`` (default: CPU).
    The restart count and the Jacobian and decomposition counters come
    across; the event state does not (``ev`` is None: a carry without
    events)."""
    return carry_from_ivp_tpu(carry, "DOPRI5", device)


def carry_from_ivp_tpu(carry, method, device=None) -> Carry:
    """The port's Carry for ``method``'s engine from an ``ivp_tpu`` driver
    Carry whose leaves are numpy arrays (``jax.tree.map(np.asarray,
    carry)``): any of the six methods, vmapped or a single IVP's (one lane);
    the method state (ERKState, RadauState or BDFState, the linear
    backend's ``lin`` tuple as it is) field by field, dtypes kept.  The
    event state does not come across (``ev`` is None)."""
    single = np.ndim(carry.t) == 0

    def tt(x):
        if isinstance(x, tuple):
            return tuple(tt(v) for v in x)
        a = np.array(x)
        return torch.as_tensor(a[None] if single else a, device=device)

    state = _STATE.get(str(method).upper(), ERKState)
    ms = state(*(tt(getattr(carry.ms, f)) for f in state._fields))
    return Carry(**{f: ms if f == "ms" else None if f == "ev"
                    else tt(getattr(carry, f)) for f in Carry._fields})


def carry_to_numpy(carry: Carry) -> tuple:
    """``(fields, ms)``: the port's Carry as numpy arrays keyed by field
    name (``ms`` apart, keyed by its own fields, the ``lin`` tuple as it
    is; ``ev`` left out), to build an ``ivp_tpu`` Carry of the same engine
    from (``ivp_tpu.core.driver.Carry(**fields, ms=State(**ms), ev=...)``),
    which ``ivp_tpu``'s resumable solver resumes."""
    def nn(x):
        if isinstance(x, tuple):
            return tuple(nn(v) for v in x)
        return x.detach().cpu().numpy()

    fields = {f: nn(getattr(carry, f)) for f in Carry._fields
              if f not in ("ms", "ev")}
    return fields, {f: nn(getattr(carry.ms, f)) for f in carry.ms._fields}


def result_to_numpy(res):
    """An EnsembleResult with every tensor field as a numpy array (a field
    the solve did not fill stays None; ``sol`` stays as it is)."""
    return type(res)(*(x.detach().cpu().numpy() if torch.is_tensor(x) else x
                       for x in res))
