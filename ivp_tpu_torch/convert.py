"""State carried across from ``ivp_tpu`` to the port, and results back.

No jax import: the ``ivp_tpu`` objects come in with numpy leaves (e.g.
``jax.tree.map(np.asarray, carry)``) and are read by field name.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.driver import Carry
from .methods.erk import ERKParams, ERKState


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
    The restart count comes across; the event state does not (``ev`` is
    None: a carry without events), nor do the fields the port's driver
    does not carry (njev, nlu)."""
    single = np.ndim(carry.t) == 0

    def tt(x):
        a = np.array(x)
        return torch.as_tensor(a[None] if single else a, device=device)

    ms = ERKState(*(tt(getattr(carry.ms, f)) for f in ERKState._fields))
    return Carry(**{f: ms if f == "ms" else None if f == "ev"
                    else tt(getattr(carry, f)) for f in Carry._fields})


def result_to_numpy(res):
    """An EnsembleResult with every tensor field as a numpy array (a field
    the solve did not fill stays None; ``sol`` stays as it is)."""
    return type(res)(*(x.detach().cpu().numpy() if torch.is_tensor(x) else x
                       for x in res))
