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
    """The port's ERKParams from an ``ivp_tpu.methods.erk.ERKParams``."""
    return ERKParams(**{f.name: getattr(p, f.name)
                        for f in dataclasses.fields(ERKParams)})


def carry_from_numpy(carry, device=None) -> Carry:
    """The port's lean driver Carry from an ``ivp_tpu`` lean driver Carry
    (vmapped: every leaf has a leading batch axis) whose leaves are numpy
    arrays, ``ERKState`` included.  dtypes are kept; tensors land on
    ``device`` (default: CPU).  Fields the lean driver does not carry
    (njev, nlu, record/event/sample buffers) are dropped."""
    def tt(x):
        return torch.as_tensor(np.array(x), device=device)

    ms = ERKState(*(tt(getattr(carry.ms, f)) for f in ERKState._fields))
    return Carry(**{f: ms if f == "ms" else tt(getattr(carry, f))
                    for f in Carry._fields})


def result_to_numpy(res):
    """An EnsembleResult with every field as a numpy array."""
    return type(res)(*(x.detach().cpu().numpy() for x in res))
