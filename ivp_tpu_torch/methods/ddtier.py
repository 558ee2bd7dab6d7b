"""Precision-tier routing (``ivp_tpu.methods.ddtier.resolve_auto_dtype``).

``ivp_tpu`` routes f64-class requests to its double-float tier only where
float64 is emulated (TPUs); on native-f64 devices it resolves them to
float64.  CPUs and NVIDIA GPUs have native f64, so here ``None``, ``"auto"``
and ``"dd"`` all resolve to ``torch.float64``.
"""
from __future__ import annotations

import torch

_F64_CLASS = ("auto", "dd", "ddf32", "double-float")


def resolve_auto_dtype(dtype) -> torch.dtype:
    """Resolve a dtype request to a concrete torch dtype."""
    if dtype is None:
        return torch.float64
    if isinstance(dtype, str):
        if dtype.lower() in _F64_CLASS:
            return torch.float64
        raise ValueError(f"unknown dtype {dtype!r}")
    if dtype in (torch.float32, torch.float64):
        return dtype
    raise ValueError(f"unsupported dtype {dtype!r}: use torch.float32 or "
                     f"torch.float64")
