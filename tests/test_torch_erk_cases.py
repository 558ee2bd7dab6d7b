"""Shared by tests/test_torch_erk_*.py and test_torch_samples.py: the same
inputs through ``ivp_tpu`` on the CPU and through the port.  It holds helpers
only: pytest collects no test from it.

JAX compiles dominate these tests, so each method gets one jitted ``ivp_tpu``
solver per mode (lean, sampled) that takes everything per lane: VdP with a
per-lane ``mu`` (``args_batched``), per-lane ``t0``/``tf``, ``(B, n)``
tolerances and, in sample mode, a ``(B, m)`` grid passed at the call.  The
cases differ only in the arrays they hand it; the port gets each case's
arguments in the shape the case is about.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402,F401  (enables x64)
from ivp_tpu.batch import build_ensemble_solver as jax_build
from ivp_tpu.core.driver import DriverConfig as JaxDriverConfig
from ivp_tpu.core.driver import make_driver as jax_make_driver
from ivp_tpu.core.driver import run_args as jax_run_args
from ivp_tpu.methods import get_engine as jax_get_engine

import ivp_tpu_torch as it
from ivp_tpu_torch import convert
from ivp_tpu_torch.core.driver import run_args
from ivp_tpu_torch.methods import get_engine

COUNTERS = ("status", "nfev", "nstep", "naccpt", "nrejct")
B = 32          # lanes of every ensemble case
M = 6           # samples of every sampled case
# RK4 takes this fixed step in every case that does not say otherwise.
RK4_STEP = 5e-3


def jvdp_mu(t, y, mu):
    return jnp.array([y[1], mu * (1.0 - y[0] ** 2) * y[1] - y[0]])


def jlorenz(t, y):
    return jnp.array([10.0 * (y[1] - y[0]), y[0] * (28.0 - y[2]) - y[1],
                      y[0] * y[1] - (8.0 / 3.0) * y[2]])


def jdecay(t, y):
    return -0.7 * y


def vdp_y0(seed=0, lanes=B):
    rng = np.random.default_rng(seed)
    return np.array([2.0, 0.0]) + 0.05 * rng.standard_normal((lanes, 2))


def lorenz_y0(seed=0, lanes=B):
    rng = np.random.default_rng(seed)
    return np.array([1.0, 1.0, 1.0]) + 1e-3 * rng.standard_normal((lanes, 3))


def build_options(method, **kw):
    """RK4 needs its step; the others take hinit's."""
    if method == "RK4":
        kw.setdefault("first_step", RK4_STEP)
    return kw


def _freeze(kw):
    return tuple(sorted((k, tuple(sorted(v.items())) if isinstance(v, dict)
                         else v) for k, v in kw.items()))


@functools.lru_cache(maxsize=None)
def _jax_vdp_solver(method, sampled, frozen):
    kw = {k: dict(v) if isinstance(v, tuple) else v for k, v in frozen}
    return jax.jit(jax_build(
        jvdp_mu, method, n=2, args_batched=True, args=(np.ones(B),),
        t_eval=np.zeros(M) if sampled else None, **kw))


def full(v, shape):
    return np.broadcast_to(np.asarray(v, float), shape).copy()


def jax_vdp(method, y0, t0, tf, rtol, atol, mu=1.0, grid=None, **build):
    """ivp_tpu on per-lane VdP inputs; ``grid``: (M,) or (B, M) or None."""
    solver = _jax_vdp_solver(method, grid is not None,
                             _freeze(build_options(method, **build)))
    rtol = np.asarray(rtol, float)
    rtol = rtol[:, None] if rtol.shape == (B,) else rtol
    kw = {} if grid is None else dict(t_grid=full(grid, (B, M)))
    return solver(y0, full(t0, (B,)), full(tf, (B,)), full(rtol, (B, 2)),
                  full(atol, (B, 2)), batched_args=(full(mu, (B,)),), **kw)


def assert_matches(ref, got, tol=1e-9):
    """Status and every counter equal on every lane (and ``n_samples``);
    final t and y, and ``y_samples``, within ``tol``; sample rows past a
    lane's ``n_samples`` zero.  ``got``: an EnsembleResult of tensors or of
    numpy arrays."""
    if torch.is_tensor(got.y):
        got = convert.result_to_numpy(got)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.y, np.asarray(ref.y), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.t, np.asarray(ref.t), rtol=tol, atol=tol)
    if ref.y_samples is None:
        assert got.y_samples is None and got.n_samples is None
        return
    np.testing.assert_array_equal(got.n_samples, np.asarray(ref.n_samples))
    np.testing.assert_allclose(got.y_samples, np.asarray(ref.y_samples),
                               rtol=tol, atol=tol)
    m = got.y_samples.shape[1]
    past = np.arange(m)[None, :] >= got.n_samples[:, None]
    assert not got.y_samples[past].any()


# ---------------------------------------------------------------------------
# One attempt from the same carry
# ---------------------------------------------------------------------------

def one_attempt_both(method, need_cont=True, lanes=8, tf=2.0, rtol=1e-8,
                     atol=1e-10):
    """One attempt of ``method`` on VdP lanes from the same carry in both
    packages: ivp_tpu's init_carry (vmapped) gives the carry, which goes
    through convert.py into the port.  Half of the lanes start with a first
    step of 1e-3 (accepted), half with 1.5 (rejected by the adaptive
    methods).  Returns ``(ivp_tpu's StepProposal as numpy, the port's)``."""
    y0 = vdp_y0(11, lanes)
    first = np.where(np.arange(lanes) % 2 == 0, 1e-3, 1.5)
    jengine, jp = jax_get_engine(method, need_cont=need_cont)

    def jrhs(t, y):
        return jvdp_mu(t, y, 1.0)

    def one(y, fs):
        ra = jax_run_args(tf, jnp.full(2, rtol), jnp.full(2, atol), tf, 0.0,
                          1000, y.dtype)
        init = jax_make_driver(jengine, jp, JaxDriverConfig(), jrhs)[0]
        c = init(0.0, y, fs, ra)
        return c, jengine.attempt(jrhs, c.t, c.y, c.naccpt, c.ms, ra, jp)

    carry, ref = jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(y0, first))

    engine, p = get_engine(method, need_cont=need_cont)
    assert convert.erk_params_from_jax(jp) == p
    c = convert.carry_from_numpy(carry)
    ra = run_args(tf, rtol, atol, tf, 0.0, 1000, c.y)
    got = engine.attempt(it.rhs.vdp, c.t, c.y, c.naccpt, c.ms, ra, p)
    return ref, got


def assert_proposal_matches(ref, got, rel=1e-13):
    """Every StepProposal field, the method state and ``cont`` included:
    bools and ints exactly, floats within ``rel``.  Two stated exceptions.
    float32 controller fields, and the next step size they give, within
    1e-4: XLA's float32 log/exp are 1-ulp approximations, it contracts
    a*b - c*d and turns x / c into x * (1/c) (ROADMAP §3), and on a
    rejected attempt with err ~ 1e9 the controller's exp amplifies those
    ulps (measured: 3.2e-5 in DOPRI5's next h; DOP853's square-root chain
    and RK23 agree to the last bit).  ``cont``: its higher rows are sums of
    terms hundreds of times their result (DOP853's D rows), so they are held
    to ``rel`` of the largest row entry of the lane, not of themselves."""
    def check(name, r, g):
        if g is None:
            assert r.size == 0, name
            return
        g = np.asarray(g) if isinstance(g, int) else g.numpy()
        g = np.broadcast_to(g, r.shape) if r.shape != g.shape else g
        if g.dtype.kind in "bi":
            np.testing.assert_array_equal(g, r, err_msg=name)
        elif g.dtype == np.float32 or name == "ms.h":
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-30,
                                       err_msg=name)
        elif name == "cont":
            scale = 1e3 * np.abs(r).max(axis=(1, 2), keepdims=True)
            assert np.all(np.abs(g - r) <= rel * scale), name
        else:
            np.testing.assert_allclose(g, r, rtol=rel, atol=1e-300,
                                       err_msg=name)

    for f in ref._fields:
        if f == "ms":
            for q in ref.ms._fields:
                check(f"ms.{q}", getattr(ref.ms, q), getattr(got.ms, q))
        else:
            check(f, getattr(ref, f), getattr(got, f))


def interp_both(method, seed=3, lanes=16):
    """An engine's interpolant on random ``cont`` in both packages."""
    jengine, _ = jax_get_engine(method, need_cont=True)
    engine, _ = get_engine(method, need_cont=True)
    rng = np.random.default_rng(seed)
    cont = rng.standard_normal((lanes, engine.ncoeff, 3))
    xold = rng.uniform(-1.0, 1.0, lanes)
    h = rng.uniform(0.1, 0.5, lanes) * np.where(np.arange(lanes) % 2, -1, 1)
    ti = xold + h * rng.uniform(0.0, 1.0, lanes)
    ref = np.asarray(jax.vmap(jengine.interp)(cont, xold, h, ti))
    got = engine.interp(*(torch.as_tensor(a) for a in (cont, xold, h, ti)))
    return ref, got.numpy()
