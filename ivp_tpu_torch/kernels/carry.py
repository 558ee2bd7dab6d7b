"""The carry a kernel launch stores, on the card: which fields of the plain
driver's :class:`~ivp_tpu_torch.core.driver.Carry` (and of the method
state in ``carry.ms``) a launch writes, with their per-lane shapes and
dtypes, and where they lie: one buffer per dtype, each field a contiguous
run of it, so a carry costs a few tensor operations and its fields'
addresses follow from the buffers' (:class:`Layout`).  The fields no
launch writes (the lean solve's zero-size record, sample and segment
fields, the restart count; ``njev`` and ``nlu`` of the explicit methods)
are zeroed in a solve's first carry and shared by its later ones.  Used by
the stiff final-state solve (kernels/stiff_ensemble.py) and the resumable
solver (kernels/resumable.py)."""
from __future__ import annotations

import functools
import itertools
import math

import torch

from ..core.driver import Carry
from ..methods.bdf import BDFState, ROWS as BDF_ROWS
from ..methods.erk import ERKState
from ..methods.radau import RadauState

STIFF = ("RADAU", "BDF")
F64, I32, BOOL = torch.float64, torch.int32, torch.bool


def driver_specs(n, stiff):
    """``[(field, per-lane shape, dtype)]`` of the driver fields a launch
    writes (``njev`` and ``nlu`` only the stiff kernels)."""
    out = [("t", (), F64), ("y", (n,), F64), ("status", (), I32),
           ("done", (), BOOL), ("nfev", (), I32)]
    if stiff:
        out += [("njev", (), I32), ("nlu", (), I32)]
    return out + [(f, (), I32) for f in ("nstep", "naccpt", "nrejct")]


def state_specs(method, n, cdt):
    """``[(field, per-lane shape, dtype)]`` of the method state a launch
    writes (``lin`` spelt out as stiff_ensemble._ms_fields does)."""
    if method == "RADAU":
        f = [("h", (), F64), ("hold", (), F64), ("posneg", (), F64),
             ("f0", (n,), F64), ("cont", (4, n), F64), ("scal", (n,), F64),
             ("first", (), BOOL), ("reject", (), BOOL), ("last", (), BOOL),
             ("faccon", (), cdt), ("theta", (), cdt), ("hhfac", (), F64),
             ("h_acc", (), F64), ("err_acc", (), cdt),
             ("call_jac", (), BOOL), ("call_decomp", (), BOOL),
             ("singular", (), I32)]
        return f + [(k, (n, n), F64) for k in ("jac", "inv1", "br", "bi")]
    if method == "BDF":
        return [("h_abs", (), F64), ("posneg", (), F64),
                ("D", (BDF_ROWS, n), F64), ("order", (), I32),
                ("n_equal", (), I32), ("jac", (n, n), F64),
                ("inv", (n, n), F64), ("lu_current", (), BOOL),
                ("current_c", (), F64)]
    return [("h", (), F64), ("k1", (n,), F64), ("facold", (), cdt),
            ("hlamb", (), cdt), ("reject", (), BOOL), ("iasti", (), I32),
            ("nonstiff", (), I32), ("posneg", (), F64)]


def shared_specs(stiff):
    """The fields no resumable launch writes that hold data (the
    zero-size record, sample and segment fields: :func:`empty_fields`)."""
    out = [] if stiff else [("njev", (), I32), ("nlu", (), I32)]
    return out + [("n_rec", (), I32), ("s_cursor", (), I32),
                  ("n_restarts", (), I32), ("seg_xold", (), F64),
                  ("seg_h", (), F64), ("seg_valid", (), BOOL)]


def empty_fields(B, n, device) -> dict:
    """The lean carry's zero-size fields, one tensor for each shape."""
    rows = torch.empty((B, 0), dtype=F64, device=device)
    states = torch.empty((B, 0, n), dtype=F64, device=device)
    return dict(rec_t=rows, rec_xold=rows, rec_h=rows, rec_y=states,
                sample_y=states, seg_cont=states,
                rec_cont=torch.empty((B, 0, 0), dtype=F64, device=device))


class Layout:
    """Where the fields ``specs`` ``[(field, per-lane shape, dtype)]`` of
    ``B`` lanes lie: one buffer per dtype, each field a contiguous run of
    it.  :meth:`alloc` makes the buffers and hands out the views and each
    field's address."""

    def __init__(self, specs, B):
        groups = {}
        for f, shape, dt in specs:
            groups.setdefault(dt, []).append((f, shape))
        self.groups = []
        for dt, fields in groups.items():
            sizes = [B * math.prod(shape) for _, shape in fields]
            offsets = [dt.itemsize * k for k in
                       itertools.accumulate([0] + sizes[:-1])]
            self.groups.append((
                dt, sum(sizes), sizes, [f for f, _ in fields],
                [(B,) + tuple(shape) if len(shape) else None
                 for _, shape in fields], offsets))

    def alloc(self, device, zero=False):
        """``({field: tensor}, {field: address})`` of fresh buffers (zeroed
        with ``zero``)."""
        make = torch.zeros if zero else torch.empty
        views, ptrs = {}, {}
        for dt, total, sizes, names, shapes, offsets in self.groups:
            buf = make(total, dtype=dt, device=device)
            base = buf.data_ptr()
            for f, x, shape, at in zip(names, buf.split_with_sizes(sizes),
                                       shapes, offsets):
                views[f] = x if shape is None else x.view(shape)
                ptrs[f] = base + at
        return views, ptrs


@functools.lru_cache(maxsize=64)
def layout(method, n, cdt, B, first=False) -> Layout:
    """The :class:`Layout` of the fields a launch writes, and with
    ``first`` of the fields a solve's later carries share with its
    first."""
    stiff = method in STIFF
    return Layout(driver_specs(n, stiff) + state_specs(method, n, cdt)
                  + (shared_specs(stiff) if first else []), B)


def state(method, f: dict):
    """The method state of a dict of its fields."""
    if method == "RADAU":
        return RadauState(lin=(f.pop("inv1"), f.pop("br"), f.pop("bi")), **f)
    if method == "BDF":
        return BDFState(lin=(f.pop("inv"),), **f)
    return ERKState(**f)


def new(method, B, n, cdt, device):
    """``(carry, {field: address})``: a solve's first carry of ``B`` lanes
    of ``n`` components with ``method``'s state (controller type ``cdt``),
    zeroed, for its init launch to fill."""
    f, ptrs = layout(method, n, cdt, B, True).alloc(device, zero=True)
    ms = state(method, {k: f.pop(k) for k, *_ in state_specs(method, n, cdt)})
    return Carry(ms=ms, ev=None, **f, **empty_fields(B, n, device)), ptrs
