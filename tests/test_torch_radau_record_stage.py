"""Radau's staged record rows on the CPU: a g++ build of ``csrc/radau.cu``
alone (gxx.py, its ``ENTRIES`` only) launched through
``kernels/erk_record.py::stiff_record_launches`` on CPU tensors with stream
0.

A RECORD lane of Radau stages its rows in the block's shared memory past its
slots, K rows a lane (``csrc/stiff_common.cuh``: ``SlotsStage``,
``stage_plan``; ``csrc/radau.cu``: ``radau_stage``), and writes each run of K
with one bulk copy (in the g++ build a ``memcpy``), the partial run at its
exit.  The cases: VdP mu=1000, ``LANES`` lanes (no whole block), t in [0,
1000] (about 250 rows a lane), rtol 1e-4, atol 1e-6, under both controller
types, with and without coefficients, in chunks of ``CAPS`` rows: 1, 3 and 7
(under K, so a lane's rows fill mid-run), 37 (full runs without
coefficients' K, then the rows fill mid-run) and one chunk that holds every
row (full runs, the partial one at the lane's end).  Here a block of a few
lanes is alone on its SM, so K is the most rows that fit beside the slots at
one block an SM: 13 with coefficients (14 doubles a row), 31 without (6).

Against one chunk every row, sample and count and the final state are bit
for bit; the rows a lane wrote are its accepted steps; against the plain
version (the driver's record mode) rows and counters within
test_torch_stiff_modes.py's ``TOL``; against the build's LEAN mode the final
state and counters bit for bit.  The rows' stride is even and its pad never
read: a buffer poisoned with NaN drains to the same finite rows; a staged
launch refuses the unpadded stride.  The stage's K and bytes a lane follow
the blocks an SM a launch needs, for each functor with a Jacobian (Robertson
with coefficients at two blocks an SM where it needs three).  Skipped
without g++.
"""
import functools
import importlib.util
import shutil

import pytest

torch = pytest.importorskip("torch")

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch.kernels import build  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as E  # noqa: E402
from ivp_tpu_torch.kernels import stiff_ensemble as S  # noqa: E402
from test_torch_stiff_modes import (  # noqa: E402
    FINAL, MU, ROOT, ROWS, TOL, assert_bitwise, assert_matches, inputs,
    kernel_lean, kernel_record, plain_record, shared_grid, spec_of, stiff_y0)

LANES, TF = 12, 1000.0
CAPS = (1, 3, 7, 37)
ALL_ROWS = 4096    # a chunk that holds every row of the span
CONTROLLERS = ("state", "float32")
ENTRIES = ("vdp", "decay", "robertson")   # the functors the build keeps


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel sources as host code")
    tmp = tmp_path_factory.mktemp("gxx_radau_stage")
    spec = importlib.util.spec_from_file_location("gxx", ROOT / "gxx.py")
    gxx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gxx)
    src = tmp / "csrc"
    shutil.copytree(build.SRC_DIR, src)
    cu, macro = src / "radau.cu", "IVP_RADAU_ENTRY("
    keep = tuple(f"{macro}{e}," for e in ENTRIES)
    cu.write_text("".join(
        ln for ln in cu.read_text().splitlines(keepends=True)
        if not ln.startswith(macro) or ln.startswith(keep)))
    return build.load(gxx.build_all(src, tmp / "out", ["radau"])["radau"])


def vdp():
    return inputs(it.rhs.vdp, stiff_y0(LANES), TF, 1e-4, 1e-6, (MU,))


def rows_of(cont):
    return ROWS if cont else ROWS[:-1]


@functools.lru_cache(maxsize=None)
def plain_one_chunk(controller, cont):
    return plain_record("RADAU", vdp(), spec_of("RADAU", controller),
                        ALL_ROWS, cont)


@pytest.mark.parametrize("cont", (True, False), ids=("cont", "steps"))
@pytest.mark.parametrize("controller", CONTROLLERS)
def test_chunks_bitwise_with_one_chunk(lib, controller, cont):
    """Chunks of 1, 3, 7 and 37 rows with the grid's samples: every row,
    sample and count and the final state as one chunk's, and each lane's
    rows its accepted steps."""
    spec = spec_of("RADAU", controller)
    grid = shared_grid(TF, LANES)
    one, n1 = kernel_record(lib, "RADAU", vdp(), spec, ALL_ROWS, cont, grid)
    assert n1 == 1
    assert torch.equal(one["n_rec"], one["naccpt"].to(torch.int64))
    fields = FINAL + rows_of(cont) + ("n_rec", "y_samples", "n_samples")
    for cap in CAPS:
        many, chunks = kernel_record(lib, "RADAU", vdp(), spec, cap, cont,
                                     grid)
        assert chunks >= -(-int(one["n_rec"].max()) // cap), cap
        assert_bitwise(many, one, fields)


@pytest.mark.parametrize("cont", (True, False), ids=("cont", "steps"))
@pytest.mark.parametrize("controller", CONTROLLERS)
def test_one_chunk_matches_plain_and_lean(lib, controller, cont):
    """One chunk's rows and counters against the plain version's, the
    final state and counters as the LEAN mode's bit for bit, and each
    lane's last row its final state."""
    spec = spec_of("RADAU", controller)
    got, chunks = kernel_record(lib, "RADAU", vdp(), spec, ALL_ROWS, cont)
    ref, ref_chunks = plain_one_chunk(controller, cont)
    assert_matches(got, ref, 1.0, ("n_rec",), ("y",) + rows_of(cont),
                   TOL["RADAU", controller])
    assert chunks == ref_chunks == 1
    assert_bitwise(got, kernel_lean(lib, "RADAU", vdp(), spec), FINAL)
    k = got["n_rec"] - 1
    assert torch.equal(got["rec_y"][torch.arange(LANES), k], got["y"])


@pytest.mark.parametrize("cont", (True, False), ids=("cont", "steps"))
def test_pad_is_never_read(lib, monkeypatch, cont):
    """Rows allocated at the even stride and poisoned with NaN before each
    launch drain to finite rows equal to an unpoisoned run's: the kernel
    writes the row's fields and the drain reads nothing past them."""
    spec = spec_of("RADAU", "state")
    clean, _ = kernel_record(lib, "RADAU", vdp(), spec, 37, cont)
    made = []

    class Poisoned(S.Modes):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.rows.fill_(float("nan"))
            made.append(self)

    monkeypatch.setattr(S, "Modes", Poisoned)
    got, chunks = kernel_record(lib, "RADAU", vdp(), spec, 37, cont)
    assert len(made) == 1 and chunks > 1
    stride = made[0].rows.shape[-1]
    assert stride % 2 == 0
    assert stride == E.record_width("RADAU", 2, cont) + 1
    assert made[0].arg.stride == stride
    for f in rows_of(cont):
        assert bool(torch.isfinite(got[f]).all()), f
    assert_bitwise(got, clean, FINAL + rows_of(cont) + ("n_rec",))


@pytest.mark.parametrize("cont", (True, False), ids=("cont", "steps"))
def test_staged_launch_refuses_another_stride(lib, monkeypatch, cont):
    """A staged Radau launch handed rows of the unpadded (odd) stride
    returns cudaErrorInvalidValue, which the wrapper raises: no launch
    falls back to storing the rows a double at a time."""
    monkeypatch.setattr(E, "record_stride", E.record_width)
    name = f"radau_record{'_cont' if cont else ''} kernel launch"
    with pytest.raises(RuntimeError, match=name):
        kernel_record(lib, "RADAU", vdp(), spec_of("RADAU", "state"), 37,
                      cont)


# (functor, B, record_cont) -> (stage rows K, blocks an SM the stage
# keeps): up to 16896 lanes (132 SMs of 128 lanes) one block an SM, VdP at
# 40000 three, at 131072 the entry's min blocks (4; Robertson's 3).
# Robertson's row with coefficients (18 doubles) does not fit beside its
# slots (504 B a lane) at three blocks an SM: above 33792 lanes it runs at
# two.
STAGE = {("vdp", 12, True): (13, 1), ("vdp", 12, False): (31, 1),
         ("vdp", 16384, True): (13, 1), ("vdp", 16384, False): (31, 1),
         ("vdp", 40000, True): (2, 3), ("vdp", 40000, False): (6, 3),
         ("vdp", 131072, True): (1, 4), ("vdp", 131072, False): (3, 4),
         ("decay", 16384, True): (26, 1), ("decay", 16384, False): (52, 1),
         ("decay", 131072, True): (4, 4), ("decay", 131072, False): (9, 4),
         ("robertson", 16384, True): (9, 1),
         ("robertson", 16384, False): (27, 1),
         ("robertson", 33792, True): (2, 2),
         ("robertson", 40000, True): (2, 2),
         ("robertson", 131072, True): (2, 2),
         ("robertson", 131072, False): (1, 3)}
MIN_BLOCKS = {"vdp": 4, "decay": 4, "robertson": 3}   # IVP_RADAU_ENTRY's
# An H100's SMs, an SM's shared memory and what the runtime keeps of it a
# block.
SMS, SM_SMEM, BLOCK_RESERVED = 132, 233472, 1024


def stage_stride(k, wp):
    """Doubles from one lane's stage of k rows of wp doubles to the next:
    even, and 2 mod 4 (a half-warp's stores of one field meet at most
    2-way bank conflicts)."""
    return k * wp + (2 if k * wp % 4 == 0 else 0)


@pytest.mark.parametrize("fun", ENTRIES)
def test_stage_rows_follow_the_residency(lib, fun):
    """The layout the g++ build reports (its SM count an H100's 132): the
    stage's rows and bytes a lane, the slots' beside them, and the blocks
    an SM those bytes allow against the blocks the launch needs: fewer
    only where not one row fits there."""
    f = getattr(it.rhs, fun)
    slots = 8 * (4 * f.n * f.n + 8 * f.n + 3)
    for (name, B, cont), (k, blocks) in STAGE.items():
        if name != fun:
            continue
        lay = S.layout("RADAU", f, "float32", B, lib=lib, mode=S.RECORD,
                       record_cont=cont)
        wp = E.record_stride("RADAU", f.n, cont)
        assert (lay["stage_rows"], lay["stage_lane_bytes"]) == (
            k, 8 * stage_stride(k, wp)), (B, cont)
        assert lay["lane_bytes"] == slots + 8 * stage_stride(k, wp)
        assert lay["block_bytes"] == 128 * lay["lane_bytes"]
        assert blocks * (lay["block_bytes"] + BLOCK_RESERVED) <= SM_SMEM
        more = 128 * (slots + 8 * stage_stride(k + 1, wp))
        assert blocks * (more + BLOCK_RESERVED) > SM_SMEM
        need = min(-(-(-(-B // 128)) // SMS), MIN_BLOCKS[fun])
        assert blocks <= need
        if blocks < need:
            one = 128 * (slots + 8 * stage_stride(1, wp))
            assert need * (one + BLOCK_RESERVED) > SM_SMEM
        sampled = S.layout("RADAU", f, "float32", B, lib=lib,
                           mode=S.SAMPLED)
        assert (sampled["stage_rows"], sampled["lane_bytes"]) == (0, slots)
