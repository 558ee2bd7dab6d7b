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
    """The port's driver Carry from an ``ivp_tpu`` driver Carry, lean or in
    sample mode (vmapped: every leaf has a leading batch axis), whose leaves
    are numpy arrays, ``ERKState`` included.  The sample cursor and buffer
    and the carried segment (``s_cursor``, ``sample_y``, ``seg_*``) come
    across as they are: zero-size in lean mode, mid-solve otherwise.  dtypes
    are kept; tensors land on ``device`` (default: CPU).  Fields the port's
    driver does not carry (njev, nlu, record and event buffers) are
    dropped."""
    def tt(x):
        return torch.as_tensor(np.array(x), device=device)

    ms = ERKState(*(tt(getattr(carry.ms, f)) for f in ERKState._fields))
    return Carry(**{f: ms if f == "ms" else tt(getattr(carry, f))
                    for f in Carry._fields})


def result_to_numpy(res):
    """An EnsembleResult with every field as a numpy array (``y_samples``
    and ``n_samples`` stay None where the solve had no grid)."""
    return type(res)(*(None if x is None else x.detach().cpu().numpy()
                       for x in res))
