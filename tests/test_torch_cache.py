"""The port's solver cache (core/cache.py, after tests/test_cache.py, with
tensors), the caches of the facades' per-call work, and the refusals of
this slice: each option a later slice brings raises NotImplementedError
naming its ROADMAP item before anything is placed on a device, float32 on
the card included.  CPU only; no kernel runs."""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ivp_tpu_torch as it  # noqa: E402
from ivp_tpu_torch.core.cache import IdToken, LRUCache, cache_token  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as K  # noqa: E402
from ivp_tpu_torch.kernels import erk_record as R  # noqa: E402


def test_array_and_tensor_tokens_are_content_keyed():
    for make in (np.array, lambda a: torch.tensor(a, dtype=torch.float64)):
        a = make([[1.0, 2.0], [3.0, 4.0]])
        b = make([[1.0, 2.0], [3.0, 4.0]])
        c = make([[1.0, 2.0], [3.0, 5.0]])
        assert cache_token(a) == cache_token(b)
        assert cache_token(a) != cache_token(c)
        t0 = cache_token(a)
        a[0, 0] = 99.0      # an edit in place misses, not a stale hit
        assert cache_token(a) != t0
    # dtype and shape are part of a tensor's key
    assert cache_token(torch.zeros(4)) != cache_token(torch.zeros(4).double())
    assert cache_token(torch.zeros(4)) != cache_token(torch.zeros(2, 2))
    assert cache_token(torch.zeros(0)) == cache_token(torch.zeros(0))


def test_callables_and_unhashables_are_pinned_identity_tokens():
    cache = LRUCache(maxsize=8)
    obj1 = {"rhs": "first"}
    tok1 = cache_token(obj1)
    assert isinstance(tok1, IdToken) and tok1.obj is obj1
    cache.get_or_build(("k", tok1), lambda: "solver-for-first")
    addr = id(obj1)
    del obj1
    gc.collect()
    others = [{"rhs": f"other{i}"} for i in range(1000)]
    assert all(id(o) != addr for o in others)
    toks = {("k", cache_token(o)) for o in others[:10]}
    assert len(toks) == 10 and ("k", tok1) not in toks

    def f(t, y):
        return -y

    for fn in (f, it.rhs.vdp, lambda t, y: y):
        tok = cache_token(fn)
        assert isinstance(tok, IdToken) and tok == cache_token(fn)
    assert cache_token(it.rhs.vdp) != cache_token(it.rhs.lorenz)
    assert cache_token("RK45") == "RK45" and cache_token(None) is None
    assert cache_token((1.0, 2)) == (1.0, 2)


def test_lru_bound_evicts_oldest():
    cache = LRUCache(maxsize=3)
    built = []

    def make(i):
        def b():
            built.append(i)
            return f"v{i}"
        return b

    for i in range(5):
        cache.get_or_build(i, make(i))
    assert len(cache) == 3
    cache.get_or_build(0, make(0))
    assert built == [0, 1, 2, 3, 4, 0]
    cache.get_or_build(4, lambda: pytest.fail("4 should be cached"))
    cache.clear()
    assert len(cache) == 0


def test_ensemble_solver_cache_keys_on_content_and_options():
    """One solver per configuration: equal arg tensors hit, other content,
    another first_step or another grid miss."""
    it.batch._ENSEMBLE_CACHE.clear()
    y0 = np.ones((3, 2))
    run = lambda **kw: it.solve_ivp_ensemble(
        it.rhs.vdp, (0.0, 0.5), y0, device="cpu", **kw)
    run(args=(torch.tensor(1.0),))
    run(args=(torch.tensor(1.0),))
    assert len(it.batch._ENSEMBLE_CACHE) == 1
    run(args=(torch.tensor(2.0),))
    run(args=(torch.tensor(1.0),), first_step=1e-3)
    run(args=(torch.tensor(1.0),), t_eval=np.linspace(0.0, 0.5, 3))
    run(args=(torch.tensor(1.0),), t_eval=np.linspace(0.0, 0.5, 4))
    assert len(it.batch._ENSEMBLE_CACHE) == 5


def test_per_call_work_is_cached():
    """The build-time grid is placed once per device, the default options
    are built once per method, and a library's functor shape is asked once
    (fake library: counts its calls)."""
    solver = it.build_ensemble_solver(it.rhs.vdp, "RK45", n=2,
                                      t_eval=np.linspace(0.0, 1.0, 4))
    calls = []
    real = torch.as_tensor

    def counting(x, *a, **kw):
        if isinstance(x, np.ndarray) and x.shape == (4,):
            calls.append(1)
        return real(x, *a, **kw)

    torch.as_tensor = counting
    try:
        a = solver(np.ones((2, 2)), 0.0, 1.0, 1e-6, 1e-8, device="cpu")
        b = solver(np.ones((2, 2)), 0.0, 1.0, 1e-6, 1e-8, device="cpu")
    finally:
        torch.as_tensor = real
    assert len(calls) == 1
    assert torch.equal(a.y_samples, b.y_samples)

    p = it.methods.get_engine("DOPRI5", need_cont=False)[1]
    K._default_params.cache_clear()
    for _ in range(3):
        assert K.is_default(p)
    assert K._default_params.cache_info().misses == 1

    class FakeLib:
        asked = 0

        def __getattr__(self, name):
            def fn():
                FakeLib.asked += 1
                return {"n": 2, "nargs": 1}[name.split("_")[2]]
            return fn

    lib = FakeLib()
    kargs = torch.zeros((4, 1))
    for _ in range(3):
        K.check_functor(lib, it.rhs.vdp, kargs)
    assert FakeLib.asked == 2
    with pytest.raises(RuntimeError, match="functor"):
        K.check_functor(lib, it.rhs.lorenz, torch.zeros((4, 3)))


@pytest.mark.parametrize("entry", ["ensemble", "solver", "recording",
                                   "solve_ivp"])
def test_float32_on_the_card_raises_before_placement(entry, monkeypatch):
    """float32 asked for on the card (device="cuda", or a numpy y0 and no
    device) raises NotImplementedError naming §2 open item 3, before the
    state is placed and before the card is looked for."""
    def no_placement(*a, **k):
        raise AssertionError("placed before the float32 check")

    monkeypatch.setattr(it.batch, "_place", no_placement)
    monkeypatch.setattr(it.batch, "_as_state", no_placement)
    monkeypatch.setattr(it.solve, "_place", no_placement)
    y0 = np.ones((4, 2))
    f32 = torch.float32
    calls = {
        "ensemble": lambda d: it.solve_ivp_ensemble(
            it.rhs.vdp, (0.0, 1.0), y0, dtype=f32, device=d),
        "solver": lambda d: it.build_ensemble_solver(
            it.rhs.vdp, "RK45", n=2, dtype=f32)(y0, 0.0, 1.0, 1e-6, 1e-8,
                                                device=d),
        "recording": lambda d: it.solve_ivp_ensemble(
            it.rhs.vdp, (0.0, 1.0), y0, dtype=f32, dense_output=True,
            device=d),
        "solve_ivp": lambda d: it.solve_ivp(
            it.rhs.vdp, (0.0, 1.0), y0[0], dtype=f32, device=d),
    }
    for device in ("cuda", None):
        with pytest.raises(NotImplementedError, match="§2 open item 3"):
            calls[entry](device)


# Events and restarts (item 5) and the stiff tier's dense core (item 7: jac,
# Radau, BDF) are ported: those cases give a result on the CPU.  The stiff
# tier's remainder (mass, DAE, jac_sparsity) is item 15.
@pytest.mark.parametrize("kw, item", [
    (dict(events=[lambda t, y: y[0]]), None),
    (dict(max_restarts=2), None),
    (dict(jac=lambda t, y: -torch.eye(2, dtype=y.dtype), method="Radau"),
     None),
    (dict(jac_sparsity=np.ones((2, 2))), "item 15"),
    (dict(mass=np.eye(2)), "item 15"),
    (dict(nind1=1), "item 15"),
    (dict(method="Radau"), None),
    (dict(method="BDF"), None),
    (dict(method="auto"), "item 8"),
    (dict(time_dtype=torch.float64), "item 14"),
], ids=lambda v: "-".join(v) if isinstance(v, dict) else v)
def test_solve_ivp_refusals_name_their_item(kw, item, monkeypatch):
    if item is None:
        res = it.solve_ivp(lambda t, y: -y, (0.0, 1.0), [1.0, 2.0],
                           device="cpu", **kw)
        assert res.success and res.status == 0 and res.n_restarts == 0
        assert (res.t_events is None) == ("events" not in kw)
        assert (res.nlu > 0) == (kw.get("method") in ("Radau", "BDF"))
        return
    monkeypatch.setattr(it.solve, "_place", lambda *a, **k: pytest.fail(
        "placed before the options were checked"))
    for device in (None, "cuda", "cpu"):
        with pytest.raises(NotImplementedError, match=f"ROADMAP §1 {item}"):
            it.solve_ivp(lambda t, y: -y, (0.0, 1.0), [1.0, 2.0],
                         device=device, **kw)


def test_solve_ivp_on_the_card_refuses_a_plain_callable(monkeypatch):
    monkeypatch.setattr(it.solve, "_place", lambda *a, **k: pytest.fail(
        "placed before the callable was checked"))
    with pytest.raises(NotImplementedError, match="item 12"):
        it.solve_ivp(lambda t, y: -y, (0.0, 1.0), [1.0], device="cuda")
    with pytest.raises(NotImplementedError, match="item 12"):
        it.solve_ivp(lambda t, y: -y, (0.0, 1.0), [1.0])


class Placed(Exception):
    """Raised by a monkeypatched ``_place``: the options got past every
    check to the placement."""


def _placed(*a, **k):
    raise Placed


# Events with records (item 5) are ported: that case gives a result.  An
# integer lane_chunk (item 6) is ported; Radau and BDF record and sample on
# the card too, so on a CUDA placement those cases get past the option
# checks to the placement ("placed").
@pytest.mark.parametrize("kw, item", [
    (dict(lane_chunk=16, method="Radau", t_eval=[0.0, 1.0]), "placed"),
    (dict(dense_output=True, events=[lambda t, y: y[:, 0]]), None),
    (dict(record_trajectories=True, time_dtype=torch.float64), "item 14"),
    (dict(dense_output=True, method="BDF"), "placed"),
], ids=["lane_chunk", "record-events", "record-time_dtype", "record-BDF"])
def test_ensemble_refusals_name_their_item(kw, item, monkeypatch):
    if item is None:
        res = it.solve_ivp_ensemble(it.rhs.vdp, (0.0, 1.0), np.ones((4, 2)),
                                    device="cpu", **kw)
        assert set(res.status.tolist()) == {it.Status.SUCCESS}
        assert tuple(res.n_events.shape) == (4, 1) and res.sol is not None
        return
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


def test_resumable_tier_refuses():
    """The resumable solver (item 6) is ported; on the card its samples and
    events refuse, naming item 16, before anything is placed."""
    start, _, _ = it.batch.build_resumable_solver(
        it.rhs.vdp, "RK45", n=2, events=[lambda t, y: y[:, 0]])
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 16"):
        start(np.ones((4, 2)), 0.0, 1.0, 1e-6, 1e-8, device="cuda")


def test_interp_registry_refuses_the_stiff_methods():
    """Every method's interpolant is registered now (Radau, BDF: item 7);
    an unknown name raises."""
    from ivp_tpu_torch.methods.interp import get_interp

    for m, c in (("RK4", 4), ("RK23", 4), ("DOPRI5", 5), ("DOP853", 8),
                 ("RADAU", 4), ("BDF", 7)):
        fn, ncoeff = get_interp(m)
        assert ncoeff == c and callable(fn)
    with pytest.raises(ValueError, match="unknown method"):
        get_interp("RADAU7")


@pytest.mark.parametrize("method", sorted(K.KERNELS))
def test_record_kernel_launch_refuses_a_cpu_tensor(method):
    y0 = torch.ones((4, 3), dtype=torch.float64)
    lane = torch.zeros(4, dtype=torch.float64)
    before = dict(R.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        R.erk_record_cuda(method, it.rhs.lorenz, y0, lane, lane + 1,
                          lane + 1, None, torch.ones_like(y0),
                          torch.ones_like(y0))
    with pytest.raises(TypeError, match="CudaRHS"):
        R.erk_record_cuda(method, lambda t, y: y, y0, lane, lane + 1,
                          lane + 1, None, torch.ones_like(y0),
                          torch.ones_like(y0))
    assert R.LAUNCHES == before
