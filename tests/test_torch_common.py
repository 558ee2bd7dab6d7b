"""core/common.py of the port against ivp_tpu's, on random (n,) inputs.

The port's functions are batched; each (n,) input goes in as a (1, n) batch.
Bound: 1e-14 relative (a few ulps: the operations are the same, but XLA may
contract a multiply and an add into one FMA where PyTorch rounds twice).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402,F401  (enables x64)
from ivp_tpu.core import common as jc  # noqa: E402
from ivp_tpu_torch.core import common as tc  # noqa: E402

RTOL = 1e-14
CASES = [(seed, n) for seed in range(4) for n in (1, 2, 5)]


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    return dict(
        y=rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3),
        c=rng.uniform(-3.0, 3.0, n),
        t=float(rng.uniform(-5.0, 5.0)),
        posneg=float(rng.choice([-1.0, 1.0])),
        hmax=float(rng.uniform(0.1, 10.0)),
        rtol=10.0 ** rng.uniform(-10, -3, n),
        atol=10.0 ** rng.uniform(-12, -6, n),
    )


def _b(x):
    """(n,) numpy -> (1, n) torch; scalar -> (1,)."""
    a = torch.as_tensor(np.asarray(x, dtype=np.float64))
    return a[None] if a.ndim else a.reshape(1)


@pytest.mark.parametrize("seed,n", CASES)
def test_scaled_rms(seed, n):
    d = _inputs(seed, n)
    sk = d["atol"] + d["rtol"] * np.abs(d["y"])
    ref = np.asarray(jc.scaled_rms(jnp.asarray(d["c"]), jnp.asarray(sk)))
    got = tc.scaled_rms(_b(d["c"]), _b(sk)).numpy()[0]
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    ref_s = np.asarray(jc.error_scale(jnp.asarray(d["atol"]),
                                      jnp.asarray(d["rtol"]),
                                      jnp.asarray(d["y"])))
    got_s = tc.error_scale(_b(d["atol"]), _b(d["rtol"]), _b(d["y"])).numpy()[0]
    np.testing.assert_allclose(got_s, ref_s, rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed,n", CASES)
def test_hinit(seed, n):
    d = _inputs(seed, n)
    c = d["c"]

    def jrhs(t, y):
        return jnp.asarray(c) * y + jnp.sin(t)

    ct = torch.as_tensor(c)[None]

    def trhs(t, y):
        return ct * y + torch.sin(t)[:, None]

    jy = jnp.asarray(d["y"])
    h_ref, f1_ref = jc.hinit(jrhs, d["t"], jy, d["posneg"],
                             jrhs(d["t"], jy), 5, d["hmax"],
                             jnp.asarray(d["atol"]), jnp.asarray(d["rtol"]))
    t = _b(d["t"])
    y = _b(d["y"])
    h, f1 = tc.hinit(trhs, t, y, _b(d["posneg"]), trhs(t, y), 5,
                     _b(d["hmax"]), _b(d["atol"]), _b(d["rtol"]))
    np.testing.assert_allclose(h.numpy()[0], np.asarray(h_ref), rtol=RTOL, atol=0)
    np.testing.assert_allclose(f1.numpy()[0], np.asarray(f1_ref), rtol=RTOL,
                               atol=1e-300)
