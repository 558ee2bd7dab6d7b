"""The port's small dense linear algebra (ivp_tpu_torch/core/linalg.py)
against ``ivp_tpu.core.linalg`` on seeded batches: n = 1..8, entries over
scales 1e-3..1e12, the singular flags, the pivoting cases and the Radau E2
matrix with large entries (tests/test_linalg.py's cases, batched).

Tolerance: every result equals the reference's to the last bit (the port
follows its operations one for one) wherever the matrices are finite and
not singular; a singular lane's flag is equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ivp_tpu  # noqa: E402,F401
from ivp_tpu import tableaus as jtab  # noqa: E402
from ivp_tpu.core import linalg as J  # noqa: E402
from ivp_tpu_torch.core import linalg as L  # noqa: E402

B = 16
NS = list(range(1, 9))
SCALES = [1e-3, 1.0, 1e6, 1e12]
# The adjugate path (n <= 3) at every scale, the LU path (n > 3) at two.
CASES = [(n, s) for n in NS for s in SCALES if n <= 3 or s in (1.0, 1e6)]


def _mats(n, scale, seed, shift=2.0):
    rng = np.random.default_rng(1000 * n + seed)
    a = rng.standard_normal((B, n, n)) + shift * np.eye(n)
    a[0] = np.eye(n)
    if n >= 2:
        a[1, 0, 0] = 0.0     # a pivot exchange at k = 0
        a[2, :, 0] *= 1e-6   # a small first column
    return scale * a


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(torch.as_tensor(g).numpy(),
                                      np.asarray(w))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("n, scale", CASES)
def test_inv_equals_reference(n, scale):
    a = _mats(n, scale, 0)
    want, wsing = jax.vmap(J.inv)(jnp.asarray(a))
    got, sing = L.inv(_t(a))
    _same([got, sing], [want, wsing])
    assert not sing.any()


@pytest.mark.parametrize("n, scale", CASES)
def test_inv_complex_equals_reference(n, scale):
    ar = _mats(n, scale, 1, shift=3.0)
    ai = scale * np.random.default_rng(n).standard_normal((B, n, n))
    (wr, wi), wsing = jax.vmap(J.inv_complex)(jnp.asarray(ar), jnp.asarray(ai))
    (gr, gi), sing = L.inv_complex(_t(ar), _t(ai))
    _same([gr, gi, sing], [wr, wi, wsing])


@pytest.mark.parametrize("n", NS)
def test_lu_factor_and_solves_equal_reference(n):
    a = _mats(n, 1.0, 2)
    rng = np.random.default_rng(n + 50)
    b = rng.standard_normal((B, n))
    (wlu, wP), ws = jax.vmap(J.lu_factor)(jnp.asarray(a))
    (glu, gP), gs = L.lu_factor(_t(a))
    _same([glu, gP, gs], [wlu, wP, ws])
    want = jax.vmap(J.lu_solve)((wlu, wP), jnp.asarray(b))
    _same([L.lu_solve((glu, gP), _t(b))], [want])
    cols = rng.standard_normal((B, n, 3))
    want = jax.vmap(J._lu_solve_cols)((wlu, wP), jnp.asarray(cols))
    _same([L._lu_solve_cols((glu, gP), _t(cols))], [want])
    np.testing.assert_allclose(
        np.einsum("bij,bj->bi", a, L.lu_solve((glu, gP), _t(b)).numpy()), b,
        atol=1e-9)


@pytest.mark.parametrize("n", NS)
def test_lu_cpair_equals_reference(n):
    rng = np.random.default_rng(n + 7)
    ar = rng.standard_normal((B, n, n))
    ai = rng.standard_normal((B, n, n))
    if n >= 2:
        ar[:, 0, 0] = ai[:, 0, 0] = 0.0   # a pivot exchange at k = 0
    br, bi = rng.standard_normal((2, B, n))
    wrep, ws = jax.vmap(J.lu_factor_cpair)(jnp.asarray(ar), jnp.asarray(ai))
    grep, gs = L.lu_factor_cpair(_t(ar), _t(ai))
    _same([*grep, gs], [*wrep, ws])
    want = jax.vmap(J.lu_solve_cpair)(wrep, jnp.asarray(br), jnp.asarray(bi))
    _same(L.lu_solve_cpair(grep, _t(br), _t(bi)), want)
    z = np.linalg.solve(ar + 1j * ai, (br + 1j * bi)[..., None])[..., 0]
    xr, xi = L.lu_solve_cpair(grep, _t(br), _t(bi))
    np.testing.assert_allclose(xr.numpy() + 1j * xi.numpy(), z, atol=1e-9)


@pytest.mark.parametrize("n", NS)
def test_matvec_and_complex_apply_equal_reference(n):
    rng = np.random.default_rng(n + 11)
    a, ai = rng.standard_normal((2, B, n, n))
    x, xi = rng.standard_normal((2, B, n))
    _same([L.matvec(_t(a), _t(x))],
          [jax.vmap(J.matvec)(jnp.asarray(a), jnp.asarray(x))])
    want = jax.vmap(J.solve_complex_inv)(
        (jnp.asarray(a), jnp.asarray(ai)), jnp.asarray(x), jnp.asarray(xi))
    _same(L.solve_complex_inv((_t(a), _t(ai)), _t(x), _t(xi)), want)


@pytest.mark.parametrize("n", NS)
def test_singular_flags_equal_reference(n):
    a = _mats(n, 1.0, 3)
    a[3] = 0.0                          # zero
    a[4, :, -1] = a[4, :, 0]            # two equal columns
    a[5, 0, 0] = np.inf                 # not finite
    (_, _), ws = jax.vmap(J.lu_factor)(jnp.asarray(a))
    (_, _), gs = L.lu_factor(_t(a))
    _same([gs], [ws])
    _, ws = jax.vmap(J.inv)(jnp.asarray(a))
    _, gs = L.inv(_t(a))
    _same([gs], [ws])
    assert bool(gs[3]) and bool(gs[5])
    _, ws = jax.vmap(J.inv_complex)(jnp.asarray(a), jnp.asarray(a))
    _, gs = L.inv_complex(_t(a), _t(a))
    _same([gs], [ws])
    assert bool(gs[3])


def test_inv_radau_e2_large_entries():
    """The Radau E2 matrix at h = 1e-6, whose |det|^2 is beyond the float32
    range (tests/test_linalg.py::test_inv_radau_e2_large_entries): equal to
    the reference bit for bit, and to numpy within rtol 1e-12, atol 1e-18
    (the reference test's tolerance)."""
    h = 1e-6
    Jm = np.array([[-0.04, 0, 0], [0.04, 0, 0], [0, 0, 0.0]])
    e2r = (jtab.RADAU_ALPH / h) * np.eye(3) - Jm
    e2i = (jtab.RADAU_BETA / h) * np.eye(3)
    (wr, wi), ws = J.inv_complex(jnp.asarray(e2r), jnp.asarray(e2i))
    (gr, gi), gs = L.inv_complex(_t(e2r)[None], _t(e2i)[None])
    _same([gr[0], gi[0], gs[0]], [wr, wi, ws])
    c = np.linalg.inv(e2r + 1j * e2i)
    np.testing.assert_allclose(gr[0].numpy(), c.real, rtol=1e-12, atol=1e-18)
    np.testing.assert_allclose(gi[0].numpy(), c.imag, rtol=1e-12, atol=1e-18)
