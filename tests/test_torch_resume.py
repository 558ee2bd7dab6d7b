"""The resumable tier (``batch.build_resumable_solver``, an integer
``lane_chunk``, ``ChunkedBatchSolution``) against ``ivp_tpu``'s and against
the uninterrupted solve, on the CPU (tests/test_resume.py's cases, ported);
the refusals of what the card does not run yet.

Tolerances: a resumed solve equals the uninterrupted one (counters and y
exactly: the same driver runs the same attempts); against ``ivp_tpu`` the
counters are equal (controller_precision="state" for the stiff methods) and
y within 1e-9 of max(1, |y|)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ivp_tpu  # noqa: E402,F401
from ivp_tpu.batch import build_resumable_solver as jax_resumable  # noqa: E402
from ivp_tpu.core.driver import Carry as JCarry  # noqa: E402
from ivp_tpu.methods.radau import RadauState as JRadauState  # noqa: E402

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch import convert  # noqa: E402
from ivp_tpu_torch import events as EV  # noqa: E402
from ivp_tpu_torch.batch import build_resumable_solver  # noqa: E402

import test_torch_stiff_cases as C  # noqa: E402

FIELDS = ("t", "y", "status", "nfev", "nstep", "naccpt", "nrejct")
# (method, span, rtol, atol, mu, solver_options)
CASES = {"RK45": (20.0, 1e-6, 1e-8, 1.0, None),
         "DOP853": (20.0, 1e-8, 1e-10, 1.0, None),
         "Radau": (500.0, 1e-4, 1e-6, 1000.0, {"controller_precision": "state"}),
         "BDF": (500.0, 1e-4, 1e-6, 1000.0, {"controller_precision": "state"})}


def y0s(B=8, seed=3):
    rng = np.random.default_rng(seed)
    return np.array([2.0, 0.0]) + 0.1 * rng.standard_normal((B, 2))


def host_roundtrip(carry):
    """The carry through numpy and back, as a checkpointer would."""
    def rt(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            vals = [rt(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return torch.as_tensor(np.array(x.numpy()))
    return rt(carry)


@pytest.mark.parametrize("method", sorted(CASES))
def test_resume_matches_uninterrupted(method):
    tf, rt, at, mu, so = CASES[method]
    y0 = y0s()
    start, resume, extract = build_resumable_solver(
        it.rhs.vdp, method, n=2, args=(mu,), chunk_steps=10,
        solver_options=so)
    carry, ra = start(y0, 0.0, tf, rt, at, device="cpu")
    n = 0
    while not bool(carry.done.all()):
        carry = resume(host_roundtrip(carry), ra)
        n += 1
        assert n < 1000
    assert n > 2
    res = extract(carry)
    ref = it.build_ensemble_solver(it.rhs.vdp, method, n=2, args=(mu,),
                                   solver_options=so)(y0, 0.0, tf, rt, at,
                                                      device="cpu")
    for f in FIELDS + (("njev", "nlu") if method in ("Radau", "BDF") else ()):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    assert set(res.status.tolist()) == {it.Status.SUCCESS}


@pytest.mark.parametrize("method", ["RK45", "Radau"])
def test_ivp_tpu_carry_resumed_by_the_port(method):
    """Start and one chunk in ivp_tpu, the rest in the port through
    convert.carry_from_ivp_tpu; the counters (njev and nlu too) and y equal
    ivp_tpu's own finish."""
    tf, rt, at, mu, so = CASES[method]
    y0 = y0s()
    jf = C.jvdp
    jstart, jresume, _ = jax_resumable(jf, method, n=2, args=(mu,),
                                       chunk_steps=25, solver_options=so)
    jc, jra = jstart(y0, 0.0, tf, rt, at)
    jc = jresume(jc, jra)
    mid = jax.tree.map(np.asarray, jc)
    while not bool(np.all(np.asarray(jc.done))):
        jc = jresume(jc, jra)
    ref = jax.tree.map(np.asarray, jc)

    start, resume, extract = build_resumable_solver(
        it.rhs.vdp, method, n=2, args=(mu,), chunk_steps=25,
        solver_options=so)
    _, ra = start(y0, 0.0, tf, rt, at, device="cpu")
    carry = convert.carry_from_ivp_tpu(mid, method)
    while not bool(carry.done.all()):
        carry = resume(carry, ra)
    for f in FIELDS[2:] + ("njev", "nlu"):
        np.testing.assert_array_equal(getattr(carry, f).numpy(),
                                      getattr(ref, f), err_msg=f)
    np.testing.assert_allclose(carry.y.numpy(), ref.y, rtol=1e-9, atol=1e-9)


def test_port_carry_resumed_by_ivp_tpu():
    """The other way: the port's Radau carry after one chunk, as numpy
    (convert.carry_to_numpy), finished by ivp_tpu's resume."""
    tf, rt, at, mu, so = CASES["Radau"]
    y0 = y0s()
    start, resume, _ = build_resumable_solver(
        it.rhs.vdp, "Radau", n=2, args=(mu,), chunk_steps=25,
        solver_options=so)
    carry, ra = start(y0, 0.0, tf, rt, at, device="cpu")
    carry = resume(carry, ra)
    fields, ms = convert.carry_to_numpy(carry)
    jstart, jresume, _ = jax_resumable(C.jvdp, "Radau", n=2, args=(mu,),
                                       chunk_steps=25, solver_options=so)
    jc0, jra = jstart(y0, 0.0, tf, rt, at)
    jc = JCarry(ms=JRadauState(**ms), ev=jc0.ev,
                **{f: fields[f] for f in JCarry._fields
                   if f not in ("ms", "ev")})
    jc = jax.tree.map(jnp.asarray, jc)
    while not bool(np.all(np.asarray(jc.done))):
        jc = jresume(jc, jra)
    while not bool(carry.done.all()):
        carry = resume(carry, ra)
    for f in FIELDS[2:] + ("njev", "nlu"):
        np.testing.assert_array_equal(getattr(carry, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)


def test_per_lane_t0_matches_ivp_tpu():
    tf, rt, at, mu, so = CASES["Radau"]
    y0 = y0s()
    t0 = np.linspace(0.0, 50.0, len(y0))
    ref = C.jax_stiff("RADAU", "vdp", y0, t0, tf, rt, at, "state", chunk=25)
    start, resume, extract = build_resumable_solver(
        it.rhs.vdp, "Radau", n=2, args=(mu,), chunk_steps=25,
        solver_options=so)
    carry, ra = start(y0, t0, tf, rt, at, device="cpu")
    while not bool(carry.done.all()):
        carry = resume(carry, ra)
    C.assert_stiff_matches(C.port_dict(extract(carry)), ref, y_tol=1e-9)


@pytest.mark.parametrize("method", ["RK45", "Radau"])
def test_integer_lane_chunk_matches_unchunked(method):
    tf, rt, at, mu, so = CASES[method]
    y0 = y0s(B=7)
    kw = dict(args=(mu,), rtol=rt, atol=at, solver_options=so, device="cpu")
    whole = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, tf), y0, method,
                                  lane_chunk=None, **kw)
    parts = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, tf), y0, method,
                                  lane_chunk=3, **kw)
    for f in it.EnsembleResult._fields:
        a, b = getattr(whole, f), getattr(parts, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f


def test_chunked_batch_solution():
    """dense_output with an integer lane_chunk: a ChunkedBatchSolution that
    answers as the unchunked BatchOdeSolution at scalar, shared and per-lane
    times."""
    y0 = y0s(B=5)
    kw = dict(rtol=1e-6, atol=1e-8, dense_output=True, device="cpu")
    whole = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 5.0), y0, "DOP853",
                                  lane_chunk=None, **kw)
    parts = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 5.0), y0, "DOP853",
                                  lane_chunk=2, **kw)
    assert isinstance(parts.sol, it.batch.ChunkedBatchSolution)
    q = np.linspace(0.0, 5.0, 9)
    per_lane = np.stack([np.linspace(0.0, 5.0 - 0.5 * i, 4) for i in range(5)])
    for t in (2.5, q, per_lane):
        assert torch.equal(parts.sol(t), whole.sol(t))
    assert torch.equal(parts.sol.t_span()[1], whole.sol.t_span()[1])
    assert torch.equal(parts.ts, whole.ts) and torch.equal(parts.ys, whole.ys)


# What the card does not run yet: each raises NotImplementedError naming its
# ROADMAP item, before anything is placed (a numpy y0 with device="cuda" has
# no card here, so a placement would fail otherwise).  What it runs now
# ("placed": samples, records) gets past every option check to the
# placement, which the monkeypatched _place marks with Placed.
ST = dict(method="Radau")


class Placed(Exception):
    pass


def _placed(*a, **k):
    raise Placed


@pytest.mark.parametrize("kw, item", [
    (dict(ST, t_eval=np.linspace(0.0, 1.0, 3)), "placed"),
    # A declared event set runs on the card (the kernels' event entries); a
    # plain callable event refuses there (item 12).
    (dict(ST, events=[lambda t, y: y[:, 0]]), "item 12"),
    (dict(ST, events=[EV.vdp_crossing]), "placed"),
    (dict(ST, dense_output=True), "placed"),
    (dict(ST, record_trajectories=True), "placed"),
    (dict(ST, jac=lambda t, y: None), "item 15"),
    (dict(ST, jac=np.eye(2)), "item 15"),
    (dict(ST, solver_options={"linear_mode": "lu"}), "item 15"),
    (dict(ST, solver_options={"newton_precision": "mixed"}), "item 15"),
    (dict(ST, solver_options={"linear_mode": "banded", "band": (1, 1)}),
     "item 15"),
    (dict(ST, jac_sparsity=np.ones((2, 2))), "item 15"),
    (dict(method="BDF", solver_options={"jac_precision": "float32"}),
     "item 15"),
], ids=lambda v: "-".join(f"{k}" for k in v) if isinstance(v, dict) else v)
def test_stiff_card_refusals_before_placement(kw, item, monkeypatch):
    if item == "placed":
        monkeypatch.setattr(it.batch, "_place", _placed)
        with pytest.raises(Placed):
            it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 1.0), np.ones((4, 2)),
                                  device="cuda", **kw)
        return
    monkeypatch.setattr(it.batch, "_place", lambda *a, **k: pytest.fail(
        "placed before the options were checked"))
    with pytest.raises(NotImplementedError, match=f"ROADMAP §1 {item}"):
        it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 1.0), np.ones((4, 2)),
                              device="cuda", **kw)


def test_stiff_card_refuses_a_plain_rhs_and_large_n(monkeypatch):
    monkeypatch.setattr(it.batch, "_place", lambda *a, **k: pytest.fail(
        "placed before the options were checked"))
    with pytest.raises(NotImplementedError, match="item 15"):
        it.build_ensemble_solver(C.tvdp, "Radau", n=2)(
            np.ones((4, 2)), 0.0, 1.0, 1e-6, 1e-8, device="cuda")
    with pytest.raises(NotImplementedError, match="item 15"):
        it.build_ensemble_solver(it.rhs.lorenz, "BDF", n=3)(
            np.ones((4, 3)), 0.0, 1.0, 1e-6, 1e-8, device="cuda")
    # solve_ivp with BDF runs on the card now, with a declared event set
    # too: past its checks to placement; with a plain callable event it
    # refuses (item 12).
    monkeypatch.setattr(it.solve, "_place", _placed)
    with pytest.raises(Placed):
        it.solve_ivp(it.rhs.vdp, (0.0, 1.0), [2.0, 0.0], method="BDF",
                     device="cuda")
    with pytest.raises(Placed):
        it.solve_ivp(it.rhs.vdp, (0.0, 1.0), [2.0, 0.0], method="BDF",
                     device="cuda", events=[EV.vdp_crossing])
    with pytest.raises(NotImplementedError, match="item 12"):
        it.solve_ivp(it.rhs.vdp, (0.0, 1.0), [2.0, 0.0], method="BDF",
                     device="cuda", events=lambda t, y: y[0])
    start, _, _ = build_resumable_solver(it.rhs.vdp, "RK45", n=2,
                                         t_eval=[0.0, 1.0])
    with pytest.raises(NotImplementedError, match="item 16"):
        start(np.ones((4, 2)), 0.0, 1.0, 1e-6, 1e-8, device="cuda")
