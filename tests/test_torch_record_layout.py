"""The record kernels' chunk buffer layout (kernels/erk_record.py): each lane
stages its rows in shared memory and writes a run of them with one bulk
copy, which wants whole 16 bytes, so a row's stride is its width rounded up
to an even number of doubles, the pad at the row's end.  Held here on the
CPU:

* the stride rule for every method, both record modes and n = 2, 3, 6;
* ``_assemble`` (the drain) on a padded buffer equals, bit for bit,
  ``_assemble`` on the same rows unpadded, across several chunks and with
  lanes of unequal counts: its views skip the pad;
* a record launch hands a build with staged stores (one with the layout
  entry) rows of that stride and the stride, and a build from before them
  its unpadded rows and no stride.

The kernels themselves run on the card only (chip_smoke.py and
measure_kernel.py's ``ab`` phase hold them to the plain version and to the
unstaged build).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ivp_tpu_torch import rhs  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as E  # noqa: E402
from ivp_tpu_torch.kernels import erk_record as R  # noqa: E402

METHODS = ["DOPRI5", "DOP853", "RK23", "RK4"]
# (method, n, record_cont) -> width, stride: the Lorenz rows (n = 3) and the
# steps rows of n = 2 and n = 6 that the stride pads.
KNOWN = {("DOPRI5", 3, True): (21, 22), ("DOP853", 3, True): (30, 30),
         ("RK23", 3, True): (18, 18), ("RK4", 3, True): (18, 18),
         ("DOP853", 3, False): (6, 6), ("RK23", 2, False): (5, 6),
         ("DOPRI5", 6, False): (9, 10)}


@pytest.mark.parametrize("n", [2, 3, 6])
@pytest.mark.parametrize("cont", [False, True], ids=["steps", "cont"])
@pytest.mark.parametrize("method", METHODS)
def test_row_stride_is_the_width_rounded_up_to_even(method, n, cont):
    w = R.record_width(method, n, cont)
    s = R.record_stride(method, n, cont)
    assert w == 3 + n + (R.record_coeffs(method) * n if cont else 0)
    assert s % 2 == 0 and w <= s <= w + 1
    assert (8 * s) % 16 == 0
    if (method, n, cont) in KNOWN:
        assert (w, s) == KNOWN[(method, n, cont)]


def _chunks(rng, B, n, C, ks, stride):
    """Per chunk the (B, k, stride) rows of random values, the pad columns
    NaN, and the same rows unpadded."""
    W = 3 + n + C * n
    padded, plain = [], []
    for k in ks:
        rows = torch.as_tensor(rng.standard_normal((B, k, W)))
        pad = torch.full((B, k, stride - W), float("nan"), dtype=torch.float64)
        padded.append(torch.cat([rows, pad], dim=2))
        plain.append(rows.clone())
    return padded, plain


@pytest.mark.parametrize("ks", [(5,), (7, 7, 3), (4, 4, 4, 1)],
                         ids=["one_chunk", "three_chunks", "four_chunks"])
@pytest.mark.parametrize("method,n,cont", [("DOPRI5", 3, True),
                                           ("RK23", 2, False),
                                           ("DOP853", 6, True)])
def test_assemble_skips_the_pad(method, n, cont, ks):
    rng = np.random.default_rng(sum(ks) + n)
    B = 9
    C = R.record_coeffs(method) if cont else 0
    stride = R.record_stride(method, n, cont)
    padded, plain = _chunks(rng, B, n, C, ks, stride + 2)
    # Unequal counts: a lane that ran through every chunk, lanes that
    # stopped early, one that recorded nothing.
    counts = torch.as_tensor(rng.integers(0, sum(ks) + 1, B))
    counts[0], counts[1] = sum(ks), 0
    last = (torch.zeros(B, dtype=torch.float64),
            torch.zeros((B, n), dtype=torch.float64)) + (None,) * 7
    a = R._assemble(padded, B, n, C, counts, last, len(ks))
    b = R._assemble(plain, B, n, C, counts, last, len(ks))
    for f in ("rec_t", "rec_y", "rec_xold", "rec_h", "rec_cont"):
        x, y = getattr(a, f), getattr(b, f)
        if not C and f == "rec_cont":
            assert x is None and y is None
            continue
        assert x.shape == y.shape, f
        assert not torch.isnan(x).any(), f
        assert torch.equal(x, y), f
    S = sum(ks)
    assert tuple(a.rec_y.shape) == (B, S, n)
    past = torch.arange(S)[None, :] >= counts[:, None]
    assert bool((a.rec_t[past] == 0).all())


class _Library:
    """An empty library object, given its entries as attributes."""


def _fake_build(method, fun, staged):
    """A stand-in for a record library: its functor's shape, a record entry
    that keeps its arguments and returns success, and with ``staged`` the
    layout entry that marks a build with staged stores."""
    kernel = E.KERNELS[method][0]
    lib = _Library()
    lib.calls = []
    nargs = fun.kernel_args((), 1, "cpu").shape[1]
    setattr(lib, f"ivp_rhs_n_{fun.name}", lambda: fun.n)
    setattr(lib, f"ivp_rhs_nargs_{fun.name}", lambda: nargs)
    setattr(lib, f"ivp_{kernel}_record_{fun.name}",
            lambda *a: lib.calls.append(a) or 0)
    if staged:
        setattr(lib, f"ivp_{kernel}_record_layout_{fun.name}",
                lambda rec, info: 0)
    return lib


@pytest.mark.parametrize("fun", [rhs.lorenz, rhs.cr3bp],
                         ids=["lorenz", "cr3bp"])
@pytest.mark.parametrize("staged", [True, False], ids=["staged", "unstaged"])
@pytest.mark.parametrize("cont", [False, True], ids=["steps", "cont"])
@pytest.mark.parametrize("method", METHODS)
def test_a_launch_gives_each_build_its_row_stride(method, cont, staged, fun,
                                                  monkeypatch):
    B, cap, n = 5, 16, fun.n
    T = lambda v: torch.full((B,), v, dtype=torch.float64)
    tol = torch.full((B, n), 1e-6, dtype=torch.float64)
    lib = _fake_build(method, fun, staged)
    r = R.RecordLaunch(method, fun, torch.ones((B, n), dtype=torch.float64),
                       T(0.0), T(1.0), T(1.0), None, tol, tol, (), 1000, None,
                       None, cap, cont, lib, 0)
    name = R.record_kernel(method, cont)
    monkeypatch.setitem(R.LAUNCHES, name, 0)
    r.launch()
    assert R.LAUNCHES[name] == 1
    stride = (R.record_stride if staged else R.record_width)(method, n, cont)
    assert tuple(r.rows.shape) == (B, cap, stride)
    (a,) = lib.calls
    # ... rows, n_rec, cap, [stride,] record mode, stream
    tail = (r.rows.data_ptr(), r.n_rec.data_ptr(), cap,
            *((stride,) if staged else ()), 2 if cont else 1, 0)
    assert a[-len(tail):] == tail
    assert a[-len(tail) - 1] is r.carry
