"""The ensemble tier's default event capacity and ``lane_chunk="auto"``
against ``ivp_tpu``'s, and one chunked ensemble with events.

``ivp_tpu`` sizes the event buffers of each sub-batch from ``min(B,
lane_chunk)`` lanes (``ivp_tpu/batch.py::_auto_event_capacity``, called
once ``lane_chunk`` is resolved), and its ``lane_chunk="auto"`` chunks
Radau and BDF at ``n >= 16`` off the TPU (``_auto_lane_chunk``'s base
table).  The port keeps both: the functions are held to the reference's
over a grid of sizes, and a chunked solve whose sub-batches each need more
occurrences a lane than a whole-batch capacity would hold keeps every one
that ``ivp_tpu`` keeps.
"""
import itertools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402,F401  (enables x64)
from ivp_tpu.batch import _auto_event_capacity as jax_capacity  # noqa: E402
from ivp_tpu.batch import _auto_lane_chunk as jax_lane_chunk  # noqa: E402
from ivp_tpu.batch import solve_ivp_ensemble as jax_ensemble  # noqa: E402

from ivp_tpu_torch import batch as tb  # noqa: E402
from ivp_tpu_torch import solve_ivp_ensemble  # noqa: E402

SIZES = (1, 4, 2730, 8192, 131072, 2000000)
STATE = (1, 2, 6, 64)


def _events(k):
    return None if k == 0 else [lambda t, y: y[0]] * k


@pytest.mark.parametrize("lane_chunk, dtype", list(itertools.product(
    (None, 1, 512, 8192, 100000), (torch.float32, torch.float64))))
def test_auto_event_capacity_matches_ivp_tpu(lane_chunk, dtype):
    """Every (B, n, E) of the grid: the port's default capacity equals
    ivp_tpu's for the same lane_chunk and dtype."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    for B, n, k in itertools.product(SIZES, STATE, (0, 1, 3)):
        got = tb._auto_event_capacity((B, n), _events(k), dtype, lane_chunk)
        ref = jax_capacity((B, n), _events(k), jdt, lane_chunk)
        assert got == ref, (B, n, k, got, ref)


@pytest.mark.parametrize("method", ["RK45", "DOP853", "Radau", "BDF", "bdf",
                                    "auto"])
def test_auto_lane_chunk_matches_ivp_tpu(method):
    """Every (n, B, dtype, solver_options) of the grid: the port's auto
    lane chunk equals ivp_tpu's off the TPU (device_kind "")."""
    dtypes = ((None, None), ("dd", "dd"), (torch.float32, jnp.float32),
              (torch.float64, jnp.float64))
    options = (None, {"newton_precision": "mixed"}, {"factor_f32": True})
    for n, B, (dt, jdt), so in itertools.product(
            (2, 8, 15, 16, 47, 48, 95, 96, 128),
            (256, 257, 1024, 1025, 2048, 2049, 8192, 8193, 131072),
            dtypes, options):
        got = tb._auto_lane_chunk(method, n, B, dt, so)
        ref = jax_lane_chunk(method, n, B, jdt, so, device_kind="")
        assert got == ref, (n, B, dt, so, got, ref)


def test_auto_lane_chunk_is_the_table():
    """The table itself: explicit methods and small systems never chunk;
    n < 48 chunks at 8192, n < 96 at 1024 (2048 with float32 factors), and
    beyond at 256, only where B exceeds the chunk."""
    assert tb._auto_lane_chunk("RK45", 64, 65536, None, None) is None
    assert tb._auto_lane_chunk("Radau", 8, 131072, None, None) is None
    assert tb._auto_lane_chunk("Radau", 32, 16384, None, None) == 8192
    assert tb._auto_lane_chunk("Radau", 32, 8192, None, None) is None
    assert tb._auto_lane_chunk("BDF", 64, 4096, None, None) == 1024
    assert tb._auto_lane_chunk("BDF", 64, 4096, torch.float32, None) == 2048
    assert tb._auto_lane_chunk("Radau", 128, 4096, None, None) == 256


# Lanes, the sub-batch, the state size and the span of the chunked solve:
# 32 harmonic oscillators a lane, the event the first one's zeros (19 in
# [0, 60]).  The whole batch's capacity would be 16 a lane; a sub-batch's
# is 126, as ivp_tpu sizes it.
B_CHUNKED, LANE_CHUNK, N_OSC, TF = 4096, 512, 64, 60.0


def _oscillators_np():
    rng = np.random.default_rng(3)
    y0 = np.zeros((B_CHUNKED, N_OSC))
    y0[:, 0::2] = rng.uniform(0.5, 1.5, (B_CHUNKED, N_OSC // 2))
    return y0


def _torch_fun(t, y):
    dy = torch.empty_like(y)
    dy[:, 0::2] = y[:, 1::2]
    dy[:, 1::2] = -y[:, 0::2]
    return dy


def _jax_fun(t, y):
    return jnp.stack([y[1::2], -y[0::2]], axis=-1).reshape(-1)


def test_chunked_ensemble_keeps_every_occurrence():
    """A chunked solve with events (the default capacity): the port's
    buffers are ivp_tpu's size, no lane overflows on either, and every
    lane's occurrences equal ivp_tpu's (counts and counters exactly,
    times within 1e-10 of max(1, |t|), states within 1e-8)."""
    assert (tb._auto_event_capacity((B_CHUNKED, N_OSC), [None], torch.float64)
            == 16)
    y0 = _oscillators_np()
    kw = dict(rtol=1e-6, atol=1e-9, lane_chunk=LANE_CHUNK)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # an overflow would warn
        got = solve_ivp_ensemble(_torch_fun, (0.0, TF), y0, "RK45",
                                 events=[lambda t, y: y[:, 0]],
                                 device="cpu", **kw)
    ref = jax_ensemble(_jax_fun, (0.0, TF), jnp.asarray(y0), "RK45",
                       events=[lambda t, y: y[0]], **kw)
    assert tuple(got.t_events.shape) == tuple(np.shape(ref.t_events))
    assert got.t_events.shape[2] == 126
    assert not bool(got.event_overflow.any())
    assert not bool(np.asarray(ref.event_overflow).any())
    n_ev = got.n_events.numpy()
    assert (n_ev == np.asarray(ref.n_events)).all()
    assert n_ev.min() > 16
    for f in ("status", "nfev", "nstep", "naccpt", "nrejct"):
        assert (getattr(got, f).numpy() == np.asarray(getattr(ref, f))).all(), f
    k = np.arange(got.t_events.shape[2])[None, None] < n_ev[..., None]
    t_ref = np.asarray(ref.t_events)
    dt = np.abs(got.t_events.numpy() - t_ref) / np.maximum(np.abs(t_ref), 1)
    assert dt[k].max() < 1e-10
    dy = np.abs(got.y_events.numpy() - np.asarray(ref.y_events)).max(-1)
    assert dy[k].max() < 1e-8
