"""Bounded solver cache with GC-safe keys (``ivp_tpu.core.cache``).

``solve_ivp`` and ``solve_ivp_ensemble`` keep built solvers keyed by the
caller's callables and constant arrays.  An ``id()`` key is unsound: once
the object is collected, another can take its address and fetch a solver
built for the old one.  So:

* arrays (numpy and torch tensors) are keyed by a **digest of their
  content**: equal content hits, an edit in place misses;
* a callable (a :class:`~ivp_tpu_torch.rhs.CudaRHS` included) and any
  other unhashable object is wrapped in an identity token that holds a
  **strong reference**, so its id cannot be reused while the entry lives;
  the LRU bound drops the reference with the entry.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch


class IdToken:
    """Identity-keyed token that pins its object (prevents id reuse)."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, IdToken) and other.obj is self.obj

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"IdToken({type(self.obj).__name__}@{id(self.obj):#x})"


def _array_token(a: np.ndarray):
    a = np.ascontiguousarray(a)
    return ("ndarray", a.shape, str(a.dtype), hashlib.sha1(a).hexdigest())


def cache_token(obj: Any):
    """A hashable, GC-safe cache key component for an arbitrary object.
    A tensor's digest is taken from a CPU copy of its content, with its
    dtype and device in the key."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().contiguous()
        raw = a.reshape(-1).view(torch.uint8).numpy() if a.numel() else b""
        return ("tensor", tuple(a.shape), str(a.dtype), str(obj.device),
                hashlib.sha1(raw).hexdigest())
    if isinstance(obj, np.ndarray):
        if obj.dtype == object:  # cannot digest; fall through to identity
            return IdToken(obj)
        return _array_token(obj)
    if callable(obj):
        return IdToken(obj)
    try:
        hash(obj)
        return obj
    except TypeError:
        return IdToken(obj)


class LRUCache:
    """Tiny LRU: bounds the built solvers and the lifetime of the strong
    references held inside IdToken keys."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = int(maxsize)
        self._data: OrderedDict = OrderedDict()

    def get_or_build(self, key, make: Callable[[], Any]):
        entry = self._data.get(key, _MISSING)
        if entry is not _MISSING:
            self._data.move_to_end(key)
            return entry
        entry = make()
        self._data[key] = entry
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)
        return entry

    def __len__(self):
        return len(self._data)

    def clear(self):
        self._data.clear()


_MISSING = object()
