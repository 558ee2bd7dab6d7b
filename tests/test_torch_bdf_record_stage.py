"""BDF's staged record rows on the CPU: a g++ build of ``csrc/bdf.cu``
(gxx.py, through test_torch_stiff_modes.py's ``build_libs``) launched
through ``kernels/erk_record.py::stiff_record_launches`` on CPU tensors with
stream 0.

A RECORD lane of BDF stages its rows in the block's shared memory past its
slots, K rows a lane (``csrc/stiff_common.cuh``: ``SlotsStage``,
``stage_plan``), and writes each run of K with one bulk copy (in the g++
build a ``memcpy``), the partial run at its exit.  The cases: VdP mu=1000,
``LANES`` lanes (no whole block), t in [0, 1000] (about 300 rows a lane),
rtol 1e-4, atol 1e-6, under both controller types, with and without
coefficients, in chunks of ``CAPS`` rows: 1, 3 and 7 (under K, so a lane's
rows fill mid-run), 37 (full runs, then the rows fill mid-run) and one
chunk that holds every row (full runs, the partial one at the lane's end).
Here a block of a few lanes is alone on its SM, so K is the most rows that
fit beside the slots at one block an SM: 10 with coefficients (20 doubles
a row), 33 without (6).

Against one chunk every row, sample and count and the final state are bit
for bit; the rows a lane wrote are its accepted steps; against the plain
version (the driver's record mode) rows and counters within
test_torch_stiff_modes.py's ``TOL`` and ``BDF_F32_SHARE`` (the float32
controller's log and exp round apart between the host's libm and torch's,
ROADMAP §3 fault 1); against the build's LEAN mode the final state and
counters bit for bit.  The rows' stride is even and its pad never read: a
buffer poisoned with NaN drains to the same finite rows.  Radau's rows are
staged too (tests/test_torch_radau_record_stage.py holds them): at the even
stride its chunks equal one chunk, and handed its row's width it raises, as
a staged BDF launch refuses any other stride.  Skipped without g++.
"""
import functools
import shutil

import pytest

torch = pytest.importorskip("torch")

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as E  # noqa: E402
from ivp_tpu_torch.kernels import stiff_ensemble as S  # noqa: E402
from test_torch_stiff_modes import (  # noqa: E402
    FINAL, MU, ROWS, TOL, assert_bitwise, assert_matches, build_libs,
    inputs, kernel_lean, kernel_record, plain_record, share_of,
    shared_grid, spec_of, stiff_y0)

LANES, TF = 12, 1000.0
CAPS = (1, 3, 7, 37)
ALL_ROWS = 4096    # a chunk that holds every row of the span
CONTROLLERS = ("state", "float32")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel sources as host code")
    return build_libs(tmp_path_factory.mktemp("gxx_bdf_stage"))


def vdp():
    return inputs(it.rhs.vdp, stiff_y0(LANES), TF, 1e-4, 1e-6, (MU,))


@functools.lru_cache(maxsize=None)
def plain_one_chunk(controller, cont):
    return plain_record("BDF", vdp(), spec_of("BDF", controller), ALL_ROWS,
                        cont)


@pytest.mark.parametrize("cont", (True, False), ids=("cont", "steps"))
@pytest.mark.parametrize("controller", CONTROLLERS)
def test_chunks_bitwise_with_one_chunk(libs, controller, cont):
    """Chunks of 1, 3, 7 and 37 rows with the grid's samples: every row,
    sample and count and the final state as one chunk's, and each lane's
    rows its accepted steps."""
    spec = spec_of("BDF", controller)
    grid = shared_grid(TF, LANES)
    one, n1 = kernel_record(libs["BDF"], "BDF", vdp(), spec, ALL_ROWS, cont,
                            grid)
    assert n1 == 1
    assert torch.equal(one["n_rec"], one["naccpt"].to(torch.int64))
    fields = FINAL + (ROWS if cont else ROWS[:-1]) + (
        "n_rec", "y_samples", "n_samples")
    for cap in CAPS:
        many, chunks = kernel_record(libs["BDF"], "BDF", vdp(), spec, cap,
                                     cont, grid)
        assert chunks >= -(-int(one["n_rec"].max()) // cap), cap
        assert_bitwise(many, one, fields)


@pytest.mark.parametrize("cont", (True, False), ids=("cont", "steps"))
@pytest.mark.parametrize("controller", CONTROLLERS)
def test_one_chunk_matches_plain_and_lean(libs, controller, cont):
    """One chunk's rows and counters against the plain version's, the
    final state and counters as the LEAN mode's bit for bit, and each
    lane's last row its final state."""
    spec = spec_of("BDF", controller)
    got, chunks = kernel_record(libs["BDF"], "BDF", vdp(), spec, ALL_ROWS,
                                cont)
    ref, ref_chunks = plain_one_chunk(controller, cont)
    frac = assert_matches(got, ref, share_of("BDF", controller), ("n_rec",),
                          ("y",) + (ROWS if cont else ROWS[:-1]),
                          TOL["BDF", controller])
    if frac == 1.0:
        assert chunks == ref_chunks == 1
    assert_bitwise(got, kernel_lean(libs["BDF"], "BDF", vdp(), spec), FINAL)
    k = got["n_rec"] - 1
    assert torch.equal(got["rec_y"][torch.arange(LANES), k], got["y"])


@pytest.mark.parametrize("cont", (True, False), ids=("cont", "steps"))
def test_pad_is_never_read(libs, monkeypatch, cont):
    """Rows allocated at the even stride and poisoned with NaN before each
    launch drain to finite rows equal to an unpoisoned run's: the kernel
    writes the row's fields and the drain reads nothing past them."""
    spec = spec_of("BDF", "state")
    clean, _ = kernel_record(libs["BDF"], "BDF", vdp(), spec, 37, cont)
    made = []

    class Poisoned(S.Modes):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.rows.fill_(float("nan"))
            made.append(self)

    monkeypatch.setattr(S, "Modes", Poisoned)
    got, chunks = kernel_record(libs["BDF"], "BDF", vdp(), spec, 37, cont)
    assert len(made) == 1 and chunks > 1
    stride = made[0].rows.shape[-1]
    assert stride % 2 == 0
    assert stride == E.record_width("BDF", 2, cont) + 1
    assert made[0].arg.stride == stride
    rows = ROWS if cont else ROWS[:-1]
    for f in rows:
        assert bool(torch.isfinite(got[f]).all()), f
    assert_bitwise(got, clean, FINAL + rows + ("n_rec",))


@pytest.mark.parametrize("cont", (True, False), ids=("cont", "steps"))
def test_radau_rows_same_at_either_stride(libs, monkeypatch, cont):
    """Radau's RECORD lanes stage their rows as BDF's do: at the even
    stride its rows in chunks of 37 equal one chunk's bit for bit; handed
    its row's width (odd here) instead, the staged launch raises, and no
    launch stores the rows a double at a time at that stride."""
    spec = spec_of("RADAU", "state")
    one, _ = kernel_record(libs["RADAU"], "RADAU", vdp(), spec, ALL_ROWS,
                           cont)
    made = []

    class Kept(S.Modes):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(S, "Modes", Kept)
    many, chunks = kernel_record(libs["RADAU"], "RADAU", vdp(), spec, 37,
                                 cont)
    w = E.record_width("RADAU", 2, cont)
    assert w % 2 == 1 and made[0].rows.shape[-1] == w + 1 and chunks > 1
    assert_bitwise(many, one,
                   FINAL + (ROWS if cont else ROWS[:-1]) + ("n_rec",))
    monkeypatch.setattr(E, "record_stride", E.record_width)
    name = f"radau_record{'_cont' if cont else ''} kernel launch"
    with pytest.raises(RuntimeError, match=name):
        kernel_record(libs["RADAU"], "RADAU", vdp(), spec, 37, cont)
    assert made[-1].rows.shape[-1] == w


def test_staged_launch_refuses_another_stride(libs, monkeypatch):
    """A staged BDF launch handed rows of the unpadded (odd) stride
    returns cudaErrorInvalidValue, which the wrapper raises."""
    monkeypatch.setattr(E, "record_stride", E.record_width)
    with pytest.raises(RuntimeError, match="bdf_record_cont kernel launch"):
        kernel_record(libs["BDF"], "BDF", vdp(), spec_of("BDF", "state"), 37,
                      True)


# (functor, B, record_cont) -> (stage rows K, blocks an SM the stage keeps):
# B=16384 runs one block an SM (128 blocks on 132 SMs), B=40000 three (the
# one-round instantiation's), B=131072 four (the other's), where VdP's row
# with coefficients fits once; Robertson's (28 doubles) fits at no more
# than three.
STAGE = {("vdp", 12, True): (10, 1), ("vdp", 12, False): (33, 1),
         ("vdp", 16384, True): (10, 1), ("vdp", 16384, False): (33, 1),
         ("vdp", 40000, True): (2, 3), ("vdp", 40000, False): (8, 3),
         ("vdp", 131072, True): (1, 4), ("vdp", 131072, False): (5, 4),
         ("robertson", 131072, True): (1, 3),
         ("robertson", 131072, False): (2, 4)}
# An H100 SM's shared memory and what the runtime keeps of it a block.
SM_SMEM, BLOCK_RESERVED = 233472, 1024


def stage_stride(k, wp):
    """Doubles from one lane's stage of k rows of wp doubles to the next:
    even, and 2 mod 4 (a half-warp's stores of one field meet at most
    2-way bank conflicts)."""
    return k * wp + (2 if k * wp % 4 == 0 else 0)


@pytest.mark.parametrize("fun", ("vdp", "robertson"))
def test_stage_rows_follow_the_residency(libs, fun):
    """The layout the g++ build reports (its SM count an H100's 132): the
    stage's rows and bytes a lane, the slots' beside them, and the blocks
    an SM those bytes allow against the blocks the launch needs."""
    f = getattr(it.rhs, fun)
    slots = 8 * (8 * f.n + 2 * f.n * f.n)
    for (name, B, cont), (k, blocks) in STAGE.items():
        if name != fun:
            continue
        lay = S.layout("BDF", f, "float32", B, lib=libs["BDF"],
                       mode=S.RECORD, record_cont=cont)
        wp = E.record_stride("BDF", f.n, cont)
        assert (lay["stage_rows"], lay["stage_lane_bytes"]) == (
            k, 8 * stage_stride(k, wp))
        assert lay["lane_bytes"] == slots + 8 * stage_stride(k, wp)
        assert lay["block_bytes"] == 128 * lay["lane_bytes"]
        assert blocks * (lay["block_bytes"] + BLOCK_RESERVED) <= SM_SMEM
        more = 128 * (slots + 8 * stage_stride(k + 1, wp))
        assert blocks * (more + BLOCK_RESERVED) > SM_SMEM
        sampled = S.layout("BDF", f, "float32", B, lib=libs["BDF"],
                           mode=S.SAMPLED)
        assert (sampled["stage_rows"], sampled["lane_bytes"]) == (0, slots)
