"""The stiff kernels' launch as the CUDA sources declare it (read from the
source text, as test_torch_tableaus.py reads the tableau headers): each
lane's shared-memory slots and each block's against an H100's limits, the
threads and min blocks of every entry, the slots against the carry, the
wrapper's reading of the library's layout report, and the option, run and
carry structures the wrapper passes, whose layout the checkpoints and
convert.py depend on."""
import ctypes
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from ivp_tpu_torch import rhs  # noqa: E402
from ivp_tpu_torch.kernels import stiff_ensemble as S  # noqa: E402

CSRC = Path(S.__file__).resolve().parent.parent / "csrc"
# Each kernel's source: its template (<kernel>.cuh) and its entry lines
# without events (<kernel>.cu).
SOURCE = {k: (CSRC / f"{k}.cuh", CSRC / f"{k}.cu") for k in ("radau", "bdf")}
FUNS = (rhs.decay, rhs.vdp, rhs.robertson)          # N = 1, 2, 3
CONTROLLERS = ("float32", "state")
# The shared memory of one H100 SM, what one block may use of it, and what
# the runtime keeps of it a block.
SM_SMEM, BLOCK_MAX, BLOCK_RESERVED = 233472, 232448, 1024


def _text(path):
    """A source's text; of a tuple of paths, their texts one after
    another."""
    if isinstance(path, tuple):
        return "".join(_text(p) for p in path)
    return Path(path).read_text()


def _bdf_rows():
    mo = int(re.search(r"constexpr int MAX_ORDER = (\d+);",
                       _text(CSRC / "stiff_tableaus.cuh")).group(1))
    assert re.search(r"constexpr int BDF_ROWS = bdf::MAX_ORDER \+ 3;",
                     _text(SOURCE["bdf"]))
    return mo + 3


def _cold_doubles(kernel, n):
    """The source's ``<Kernel>Cold<N>::DOUBLES`` at N = n."""
    struct = {"radau": "RadauCold", "bdf": "BDFCold"}[kernel]
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", _text(SOURCE[kernel]),
                     re.S).group(1)
    expr = re.search(r"static constexpr int DOUBLES = ([^;]+);", body).group(1)
    assert re.fullmatch(r"[\sN0-9*+()A-Z_]+", expr), expr
    return eval(expr, {"N": n, "BDF_ROWS": _bdf_rows()})


def _entries(kernel):
    """{rhs name: (threads, min blocks, one-round min blocks or None)} of
    the entry lines."""
    macro = {"radau": "IVP_RADAU_ENTRY", "bdf": "IVP_BDF_ENTRY"}[kernel]
    out = {}
    for m in re.finditer(rf"^{macro}\((\w+), (\w+)((?:, \d+)+)\)$",
                         _text(SOURCE[kernel]), re.M):
        nums = [int(v) for v in m.group(3).split(",")[1:]]
        assert len(nums) == (3 if kernel == "bdf" else 2), m.group(0)
        out[m.group(1)] = (nums[0], nums[1],
                           nums[2] if kernel == "bdf" else None)
    return out


def _struct_fields(path, name):
    """The member names of ``struct name`` in a source, in order."""
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", _text(path),
                     re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"//[^\n]*", "", decl).strip()
        if decl and not decl.startswith(("static", "template")):
            names += [re.sub(r"^.*[\s*]", "", v.strip())
                      for v in decl.split(",")]
    return names


def test_block_limit_is_the_h100s():
    """The limit the sources' static_assert holds each block's slots to."""
    m = re.search(r"constexpr int SLOTS_BLOCK_MAX = (\d+) \* 1024;",
                  _text(CSRC / "stiff_common.cuh"))
    assert int(m.group(1)) * 1024 == BLOCK_MAX
    for path in SOURCE.values():
        assert "static_assert(bytes <= SLOTS_BLOCK_MAX" in _text(path)


@pytest.mark.parametrize("kernel", sorted(SOURCE))
@pytest.mark.parametrize("fun", FUNS, ids=lambda f: f.name)
def test_slot_bytes_fit_an_sm(kernel, fun):
    """Each entry's slots, 8 bytes a double of the lane's cold state times
    the entry's threads, fit the 227 KB a block may use, and the min blocks
    the entry asks for (and BDF's one-round instantiation) fit one SM."""
    threads, min_blocks, one_round = _entries(kernel)[fun.name]
    lane = 8 * _cold_doubles(kernel, fun.n)
    block = lane * threads
    assert block <= BLOCK_MAX
    for mb in (min_blocks, one_round or min_blocks):
        assert mb * (block + BLOCK_RESERVED) <= SM_SMEM


def _event_entries(kernel):
    """{(rhs name, set): (threads, min blocks, one-round min blocks or
    None)} of the event entry lines of <kernel>_ev.cu, and the event sets'
    event counts (csrc/events/<set>.cuh)."""
    macro = {"radau": "IVP_RADAU_EVENT_ENTRY",
             "bdf": "IVP_BDF_EVENT_ENTRY"}[kernel]
    out = {}
    for m in re.finditer(rf"^{macro}\((\w+), (\w+), (\w+), (\w+)((?:, \d+)+)\)$",
                         _text(CSRC / f"{kernel}_ev.cu"), re.M):
        nums = [int(v) for v in m.group(5).split(",")[1:]]
        ne = int(re.search(r"static constexpr int E = (\d+);",
                           _text(CSRC / "events" / f"{m.group(3)}.cuh"))
                 .group(1))
        out[m.group(1), m.group(3)] = (*nums, None)[:3], ne
    return out


@pytest.mark.parametrize("kernel", sorted(SOURCE))
def test_event_slot_bytes_fit_an_sm(kernel):
    """Each event entry takes its functor's threads and min blocks (the
    entry line without events), and its slots, the lane's cold state and
    its event state (stiff_events.cuh's EvSlots: 4 doubles an event and
    2), fit a block and the min blocks (and BDF's one-round ones) one SM;
    the stiff event sets each have one: VdP's crossing, decay's
    replenish."""
    ev = _event_entries(kernel)
    assert sorted(ev) == [("decay", "replenish"), ("vdp", "crossing")]
    slots = re.search(r"DOUBLES = NE > 0 \? (\d+) \* NE \+ (\d+) : 0;",
                      _text(CSRC / "stiff_events.cuh"))
    per_event, fixed = int(slots.group(1)), int(slots.group(2))
    funs = {f.name: f for f in FUNS}
    for (name, _), (bounds, ne) in ev.items():
        assert bounds == _entries(kernel)[name]
        threads, min_blocks, one_round = bounds
        lane = 8 * (_cold_doubles(kernel, funs[name].n) + per_event * ne
                    + fixed)
        assert lane * threads <= BLOCK_MAX
        for mb in (min_blocks, one_round or min_blocks):
            assert mb * (lane * threads + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("kernel", sorted(SOURCE))
def test_entry_lines(kernel):
    """One entry a functor with a Jacobian; whole warps, at most an SM's
    2048 threads; BDF's one-round instantiation asks for fewer blocks an
    SM than its other, so it has more registers a thread."""
    entries = _entries(kernel)
    assert sorted(entries) == sorted(f.name for f in FUNS)
    for threads, min_blocks, one_round in entries.values():
        assert threads % 32 == 0 and threads * min_blocks <= 2048
        assert (one_round is None) == (kernel == "radau")
        assert one_round is None or one_round < min_blocks


@pytest.mark.parametrize("kernel", sorted(SOURCE))
def test_slots_hold_the_cold_carry(kernel):
    """The slots hold one lane's cold carry fields (their per-lane sizes
    from the carry the wrapper allocates) and the launch constants the
    source keeps there."""
    for fun in FUNS:
        n = fun.n
        c = S.empty_carry(kernel.upper(), 3, n, torch.float32, "cpu")
        ms = S._ms_fields(kernel.upper(), c.ms)
        cold = (("jac", "inv1", "br", "bi", "cont", "f0", "scal")
                if kernel == "radau" else ("D", "jac", "inv"))
        per_lane = sum(ms[f][0].numel() for f in cold)
        extra = 2 * n + 3 if kernel == "radau" else 0   # rtol, atol, tend..
        assert _cold_doubles(kernel, n) == per_lane + extra


def test_layout_keys_follow_source():
    """layout()'s keys in the order slots_layout fills info[]."""
    src = _text(CSRC / "stiff_common.cuh")
    body = re.search(r"int slots_layout\(.*?\n\}", src, re.S).group(0)
    filled = [v.strip() for v in re.findall(r"info\[\d\] = ([^;]+);", body)]
    assert len(filled) == len(S.LAYOUT_KEYS)
    assert filled[:4] == ["threads", "min_blocks", "lane_bytes", "bytes"]
    assert filled[4:] == ["blocks", "fa.numRegs", "(int)fa.localSizeBytes"]


class _FakeLibrary:
    """A library whose layout entries record their arguments and report
    seven distinct numbers derived from them."""

    def __init__(self, kernel):
        self.calls = []
        proto = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p)
        for fun in FUNS:
            def report(state_precision, B, info, name=fun.name):
                self.calls.append((name, state_precision, B))
                out = ctypes.cast(info, ctypes.POINTER(ctypes.c_int))
                for k in range(len(S.LAYOUT_KEYS)):
                    out[k] = 10 * k + state_precision + B
                return 0
            setattr(self, f"ivp_{kernel}_layout_{fun.name}", proto(report))


_FAKES = {k: _FakeLibrary(k) for k in SOURCE}


@pytest.mark.parametrize("kernel", sorted(SOURCE))
@pytest.mark.parametrize("controller", CONTROLLERS)
def test_layout_reads_the_library(kernel, controller):
    """layout() hands the library the controller type ("state" as 1) and
    the lanes, and names the seven numbers it reports."""
    lib = _FAKES[kernel]
    sp = int(controller == "state")
    for fun, B in zip(FUNS, (1, 50689, 131072)):
        del lib.calls[:]
        lay = S.layout(kernel.upper(), fun, controller, B, lib=lib)
        assert lib.calls == [(fun.name, sp, B)]
        assert lay == {k: 10 * i + sp + B
                       for i, k in enumerate(S.LAYOUT_KEYS)}


@pytest.mark.parametrize("name, fields", [
    ("RadauOptions", [("uround", 0), ("safety", 8), ("facl", 16),
                      ("facr", 24), ("cfac", 32), ("thet", 40),
                      ("quot1", 48), ("quot2", 56), ("newton_tol", 64),
                      ("newton_maxiter", 72), ("predictive", 76),
                      ("const_jac", 80), ("state_precision", 84)]),
    ("BDFOptions", [("newton_tol", 0), ("newton_maxiter", 8),
                    ("const_jac", 12), ("state_precision", 16)]),
])
def test_options_layout_unchanged(name, fields):
    """The options' ctypes layout: the names and offsets the kernels have
    always taken, in the member order of the C structs."""
    cls = getattr(S, name)
    assert [(f, getattr(cls, f).offset) for f, _ in cls._fields_] == fields
    src = SOURCE["radau" if name.startswith("Radau") else "bdf"]
    assert _struct_fields(src, name) == [f for f, _ in fields]


def test_carry_layouts_unchanged():
    """The carry fields a launch passes, in the order of the C structs and
    the carry has always had (checkpoints and convert.py read them by
    these names)."""
    assert S.RADAU_FIELDS == (
        "h", "hold", "posneg", "f0", "cont", "scal", "first", "reject",
        "last", "faccon", "theta", "hhfac", "h_acc", "err_acc", "call_jac",
        "call_decomp", "singular", "jac", "inv1", "br", "bi")
    assert S.BDF_FIELDS == ("h_abs", "posneg", "D", "order", "n_equal", "jac",
                            "inv", "lu_current", "current_c")
    assert _struct_fields(SOURCE["radau"], "RadauCarry") == list(S.RADAU_FIELDS)
    assert _struct_fields(SOURCE["bdf"], "BDFCarry") == list(S.BDF_FIELDS)
    for arg, fields in ((S.RadauCarryArg, S.RADAU_FIELDS),
                        (S.BDFCarryArg, S.BDF_FIELDS)):
        assert [f for f, _ in arg._fields_] == list(fields)
        assert ctypes.sizeof(arg) == 8 * len(fields)
    common = CSRC / "stiff_common.cuh"
    assert _struct_fields(common, "StiffRun") == [
        f for f, _ in S.KernelRun._fields_]
    assert _struct_fields(common, "StiffDriver") == [
        f for f, _ in S.KernelDriver._fields_]
