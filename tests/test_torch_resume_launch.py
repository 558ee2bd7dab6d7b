"""The resumable tier's launches (kernels/resumable.py, kernels/
stiff_ensemble.py::StiffLaunch) against a stand-in library on CPU tensors:
each launch stores a new carry and never writes the one it is given, the
fields no launch writes are shared, what each launch passes the same is
made once a solve, one ``resume`` dispatches a bounded number of tensor
operations, and the carry and entry arguments the wrappers pass are those
the CUDA sources declare.  No JAX, no kernel: the stand-in records the
pointers each entry gets and writes recognisable values through the ones it
stores to."""
import ctypes
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from ivp_tpu_torch import rhs  # noqa: E402
from ivp_tpu_torch.batch import _solver_params  # noqa: E402
from ivp_tpu_torch.core.driver import run_args  # noqa: E402
from ivp_tpu_torch.kernels import carry as K  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as E  # noqa: E402
from ivp_tpu_torch.kernels import resumable as RES  # noqa: E402
from ivp_tpu_torch.kernels import stiff_ensemble as S  # noqa: E402
from ivp_tpu_torch.methods.jacobian import stiff_spec  # noqa: E402

CSRC = Path(RES.__file__).resolve().parent.parent / "csrc"
B = 5
# The most tensor operations one explicit ``resume`` dispatches: an empty
# buffer and its split for each of the four dtypes it stores (float64,
# int32, bool, the controller's float32), and the views of y and k1.
RESUME_OPS = 10
# What a lane's status turns to, and on which launch (the init is launch 0).
DONE_AT = 3
_CT = {torch.float64: ctypes.c_double, torch.float32: ctypes.c_float,
       torch.int32: ctypes.c_int32, torch.bool: ctypes.c_uint8}


def _struct_fields(path, name):
    """The member names of ``struct name`` in a source, in order."""
    body = re.search(rf"struct {name} \{{(.*?)\n\}};", path.read_text(),
                     re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"//[^\n]*", "", decl).strip()
        if decl:
            names += [re.sub(r"^.*[\s*]", "", v.strip())
                      for v in decl.split(",")]
    return names


def _macro_params(text, name):
    """The parameter names of a ``#define name ...`` parameter list."""
    lines = text.split("\n")
    i = next(k for k, ln in enumerate(lines)
             if ln.startswith(f"#define {name}"))
    body = []
    for ln in lines[i + 1:]:
        body.append(ln.rstrip().rstrip("\\"))
        if not ln.rstrip().endswith("\\"):
            break
    return [re.sub(r"^.*[\s*]", "", p.strip())
            for p in " ".join(body).split(",")]


def _erk_specs(cdt):
    """The dtype and per-lane element count of each ERK_FIELDS pointer."""
    n = 3
    per = dict(y=n, k1=n)
    dt = dict(t=torch.float64, y=torch.float64, status=torch.int32,
              done=torch.bool, nfev=torch.int32, nstep=torch.int32,
              naccpt=torch.int32, nrejct=torch.int32, k1=torch.float64,
              h=torch.float64, facold=cdt, hlamb=cdt, reject=torch.bool,
              iasti=torch.int32, nonstiff=torch.int32, posneg=torch.float64)
    return {f: (dt[f], per.get(f, 1)) for f in RES.ERK_FIELDS}


def _fill(ptr, dtype, count, value):
    arr = ctypes.cast(ptr, ctypes.POINTER(_CT[dtype]))
    for i in range(count):
        arr[i] = value


# Every stand-in stays alive, so that no later one takes its id (the
# entries are cached by the library's id).
_KEEP = []


def _entry(fn):
    """A plain function around ``fn``, which takes ``argtypes``."""
    def entry(*a):
        return fn(*a)
    return entry


class _StandIn:
    """A library whose resumable entries record their pointers and store,
    through the carry they are given to store to, field number k as the
    value 10 k + the launch (status RUNNING until launch ``DONE_AT``, then
    SUCCESS, and done to match)."""

    def __init__(self, fun, cdt):
        self.calls = []
        self.specs = _erk_specs(cdt)
        for name in ("dopri5_sampled", "dop853", "rk23", "rk4"):
            setattr(self, f"ivp_{name}_resume_{fun.name}",
                    _entry(self._resume))
        setattr(self, f"ivp_rhs_n_{fun.name}", lambda: fun.n)
        setattr(self, f"ivp_rhs_nargs_{fun.name}", lambda: len(fun.defaults))
        _KEEP.append(self)

    def _resume(self, B_, y0, t0, tf, hmax, fs, rtol, atol, args, max_steps,
                opts, k_in, k_out, init, max_attempts, stream):
        launch = len(self.calls)
        self.calls.append(dict(
            B=B_, init=init, max_attempts=max_attempts, stream=stream,
            y0=y0, t0=t0, first_step=fs,
            k_in={f: getattr(k_in, f) for f in RES.ERK_FIELDS},
            k_out={f: getattr(k_out, f) for f in RES.ERK_FIELDS}))
        for k, f in enumerate(RES.ERK_FIELDS):
            dt, per = self.specs[f]
            value = 10 * k + launch
            if f == "status":
                value = 0 if launch >= DONE_AT else -1
            elif f == "done":
                value = int(launch >= DONE_AT)
            _fill(getattr(k_out, f), dt, B_ * per, value)
        return 0


def _solve(cdt=torch.float32, method="DOPRI5"):
    fun = rhs.lorenz
    so = None if cdt == torch.float32 else {"controller_precision": "state"}
    params = _solver_params(method, 3, None, so, False)
    g = torch.Generator().manual_seed(0)
    y0 = 1.0 + torch.rand((B, 3), generator=g, dtype=torch.float64)
    t0 = torch.zeros(B, dtype=torch.float64)
    ra = run_args(torch.full((B,), 2.0, dtype=torch.float64),
                  torch.full((B, 3), 1e-6, dtype=torch.float64),
                  torch.full((B, 3), 1e-8, dtype=torch.float64), 2.0, 0.0,
                  1000, y0)
    lib = _StandIn(fun, cdt)
    return RES.CardSolve(method, fun, (), params, lib=lib), y0, t0, ra, lib


def _ranges(c):
    """The byte ranges of every non-empty tensor of a carry."""
    out = []

    def walk(x):
        if torch.is_tensor(x):
            if x.numel():
                p = x.data_ptr()
                out.append((p, p + x.numel() * x.element_size()))
        elif isinstance(x, tuple):
            for v in x:
                walk(v)
    walk(c)
    return out


def _tensors(c):
    out = {}

    def walk(prefix, x):
        if torch.is_tensor(x):
            out[prefix] = x
        elif isinstance(x, tuple):
            for k, v in zip(getattr(x, "_fields", range(len(x))), x):
                walk(f"{prefix}.{k}", v)
    walk("c", c)
    return out


@pytest.mark.parametrize("cdt", [torch.float32, torch.float64])
def test_resume_writes_a_new_carry(cdt):
    """Five resumes: each stores to fresh tensors, reads the carry it is
    given, leaves it as it was, and shares the fields no launch writes."""
    solve, y0, t0, ra, lib = _solve(cdt)
    c = solve.start(y0, t0, None, ra, stream=0)
    first = lib.calls[0]
    assert first["init"] == 1 and first["max_attempts"] == 0
    assert first["k_in"] == first["k_out"]   # not read at init
    assert first["y0"] == y0.data_ptr() and first["t0"] == t0.data_ptr()
    assert c.ms.facold.dtype == cdt and c.ms.reject.dtype == torch.bool
    assert torch.equal(c.ms.posneg, torch.full((B,), 10.0 * 15))
    for r in range(1, 6):
        given = c
        before = {k: v.clone() for k, v in _tensors(given).items()}
        c = solve.resume(given, ra, 64, stream=0)
        call = lib.calls[r]
        assert call["init"] == 0 and call["max_attempts"] == 64
        assert call["y0"] == call["t0"] == call["first_step"] == 0
        mine = _ranges(given)
        for f, p in call["k_out"].items():
            assert not any(lo <= p < hi for lo, hi in mine), f
        for f, p in call["k_in"].items():
            x = getattr(given, f) if hasattr(given, f) else getattr(
                given.ms, f)
            assert p == x.data_ptr(), f
        for k, v in _tensors(given).items():
            assert torch.equal(v, before[k]), k
        for f in ("njev", "nlu", "n_rec", "rec_t", "rec_y", "s_cursor",
                  "sample_y", "seg_xold", "seg_valid", "n_restarts"):
            assert getattr(c, f) is getattr(given, f), f
        assert c.ev is None
        assert torch.equal(c.ms.posneg, torch.full((B,), 10.0 * 15 + r))
        assert torch.equal(c.t, torch.full((B,), 10.0 * 0 + r))
        assert torch.equal(c.ms.k1, torch.full((B, 3), 10.0 * 8 + r))
        assert torch.equal(c.ms.facold, torch.full((B,), 10.0 * 10 + r,
                                                   dtype=cdt))
        assert torch.equal(c.ms.nonstiff, torch.full((B,), 10 * 14 + r,
                                                  dtype=torch.int32))
        assert bool(c.done.all()) == (r >= DONE_AT)
        assert bool((c.status == 0).all()) == (r >= DONE_AT)


def test_per_solve_constants_made_once(monkeypatch):
    """The functor's arguments, the checked run arguments, the entry and the
    options are made at start and not again over five resumes; a new
    ``ra`` is checked anew, and one of another size makes the functor's
    arguments anew."""
    solve, y0, t0, ra, lib = _solve()
    fun = solve.fun
    made = {"kernel_args": 0, "kernel_options": 0, "entry": 0, "check": 0}

    def counted(name, fn):
        def f(*a, **kw):
            if name != "entry" or "_resume_" in a[0]:
                made[name] += 1
            return fn(*a, **kw)
        return f
    monkeypatch.setattr(type(fun), "kernel_args",
                        counted("kernel_args", type(fun).kernel_args))
    monkeypatch.setattr(E, "kernel_options",
                        counted("kernel_options", E.kernel_options))
    monkeypatch.setattr(RES.build, "entry", counted("entry", RES.build.entry))
    monkeypatch.setattr(RES, "_check", counted("check", RES._check))
    solve = RES.CardSolve("DOPRI5", fun, (), solve.p, lib=lib)
    c = solve.start(y0, t0, None, ra, stream=0)
    at_start = dict(made)
    assert at_start["kernel_args"] == at_start["kernel_options"] == 1
    assert at_start["entry"] == 1
    for _ in range(5):
        c = solve.resume(c, ra, 64, stream=0)
    assert made == at_start
    ra2 = ra._replace(max_steps=ra.max_steps)
    solve.resume(c, ra2, 64, stream=0)
    assert made["check"] > at_start["check"]
    assert made["kernel_args"] == 1 and len(lib.calls) == 7
    ra3 = run_args(ra.tend[:2], ra.rtol[:2], ra.atol[:2], 2.0, 0.0, 1000,
                   y0[:2])
    solve.start(y0[:2], t0[:2], None, ra3, stream=0)
    assert made["kernel_args"] == 2 and made["entry"] == 1


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("cdt", [torch.float32, torch.float64])
def test_resume_dispatch_budget(cdt):
    """One ``resume`` of a well-formed carry dispatches at most
    ``RESUME_OPS`` tensor operations, none of them a copy."""
    solve, y0, t0, ra, lib = _solve(cdt)
    c = solve.start(y0, t0, None, ra, stream=0)
    c = solve.resume(c, ra, 64, stream=0)
    with _Ops() as mode:
        solve.resume(c, ra, 64, stream=0)
    assert len(mode.ops) <= RESUME_OPS, mode.ops
    assert not [o for o in mode.ops if "clone" in o or "copy" in o
                or "_to_copy" in o], mode.ops


def test_converted_carry_read_not_changed():
    """A carry whose fields are not as the kernel reads them (float64
    controller values under the float controller, a transposed y) is read
    through copies, and stays as it was."""
    solve, y0, t0, ra, lib = _solve()
    c = solve.start(y0, t0, None, ra, stream=0)
    odd = c._replace(y=c.y.t().contiguous().t(),
                     ms=c.ms._replace(facold=c.ms.facold.double()))
    before = {k: v.clone() for k, v in _tensors(odd).items()}
    solve.resume(odd, ra, 64, stream=0)
    call = lib.calls[-1]
    assert call["k_in"]["facold"] != odd.ms.facold.data_ptr()
    assert call["k_in"]["y"] != odd.y.data_ptr()
    for k, v in _tensors(odd).items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("odd", ["float32", "strided"])
def test_converted_carry_resumed_twice(odd):
    """A carry whose posneg is not as the kernel reads it (float32, or a
    strided view) resumes to a carry of the kernel's own fields, and
    resuming that one again reads only tensors it holds."""
    solve, y0, t0, ra, lib = _solve()
    c = solve.start(y0, t0, None, ra, stream=0)
    posneg = (c.ms.posneg.float() if odd == "float32"
              else torch.stack([c.ms.posneg] * 2, 1)[:, 0])
    assert posneg.dtype != torch.float64 or not posneg.is_contiguous()
    c1 = solve.resume(c._replace(ms=c.ms._replace(posneg=posneg)), ra, 64,
                      stream=0)
    assert c1.ms.posneg.dtype == torch.float64
    assert c1.ms.posneg.is_contiguous()
    solve.resume(c1, ra, 64, stream=0)
    live = _ranges(c1)
    for f, p in lib.calls[-1]["k_in"].items():
        assert any(lo <= p < hi for lo, hi in live), f


def test_resume_carry_matches_source():
    """``ResumeCarry`` is ``ErkResumeCarry`` field for field, the entry's
    arguments are ``IVP_RESUME_PARAMS`` and the stream, and the fields the
    wrapper allocates are the ones the kernel stores."""
    src = (CSRC / "erk_common.cuh")
    assert _struct_fields(src, "ErkResumeCarry") == list(RES.ERK_FIELDS)
    assert [f for f, _ in RES.ResumeCarry._fields_] == list(RES.ERK_FIELDS)
    assert ctypes.sizeof(RES.ResumeCarry) == 8 * len(RES.ERK_FIELDS)
    assert _struct_fields(src, "ErkResume") == ["in", "out", "init"]
    params = _macro_params(src.read_text(), "IVP_RESUME_PARAMS")
    assert params[-4:] == ["in", "out", "init", "max_attempts"]
    assert len(RES._ARGTYPES) == len(params) + 1
    stored = set(re.findall(r"\bco\.(\w+)\b", src.read_text()))
    assert stored == set(RES.ERK_FIELDS)
    specs = K.driver_specs(3, False) + K.state_specs(
        "DOPRI5", 3, torch.float32)
    assert {f for f, *_ in specs} == set(RES.ERK_FIELDS)
    for method, fields in (("RADAU", S.RADAU_FIELDS), ("BDF", S.BDF_FIELDS)):
        specs = K.driver_specs(3, True) + K.state_specs(
            method, 3, torch.float32)
        names = [f for f, *_ in specs]
        nd = len(S.DRIVER_FIELDS)
        assert names[:nd] == list(S.DRIVER_FIELDS)
        assert set(names[nd:]) == set(fields)


@pytest.mark.parametrize("kernel", ["radau", "bdf"])
def test_stiff_entries_take_two_carries(kernel):
    """The stiff entries load one carry (d_in, c_in) and store another (d,
    c), as StiffLaunch passes them."""
    text = (CSRC / f"{kernel}.cuh").read_text()   # the entry macro
    entry = re.search(rf'extern "C" int ivp_{kernel}_##NAME\((.*?)\)\s*\{{',
                      text, re.S).group(1).replace("\\", " ")
    names = [re.sub(r"^.*[\s*]", "", p.strip()) for p in entry.split(",")]
    assert names == ["B", "y0", "t0", "first_step", "ra", "args", "o",
                     "d_in", "c_in", "d", "c", "init", "max_attempts",
                     "stream"]
    assert len(S._ARGTYPES) == len(names)


class _StiffStandIn:
    """A stiff library whose entries record their driver and carry
    pointers."""

    def __init__(self, kernel, fun):
        self.calls = []
        setattr(self, f"ivp_{kernel}_{fun.name}", _entry(self._launch))
        setattr(self, f"ivp_rhs_n_{fun.name}", lambda: fun.n)
        setattr(self, f"ivp_rhs_nargs_{fun.name}", lambda: len(fun.defaults))
        _KEEP.append(self)

    def _launch(self, B_, y0, t0, fs, run, args, opts, d_in, c_in, d, c,
                init, max_attempts, stream):
        fields = lambda s: [getattr(s, f) for f, _ in s._fields_]
        self.calls.append(dict(d_in=fields(d_in), c_in=fields(c_in),
                               d=fields(d), c=fields(c), init=init))
        return 0


@pytest.mark.parametrize("method", ["RADAU", "BDF"])
def test_stiff_resume_writes_a_new_carry(method):
    """The stiff resume loads the carry given and stores to a new one (the
    init launch, and the final-state solve, to the same one), and leaves
    the given one as it was."""
    fun = rhs.vdp
    lib = _StiffStandIn(method.lower(), fun)
    spec = stiff_spec(method, 2, None, None)
    y0 = torch.tensor([[2.0, 0.0]] * B, dtype=torch.float64)
    t0 = torch.zeros(B, dtype=torch.float64)
    ra = run_args(torch.full((B,), 3.0, dtype=torch.float64), 1e-4, 1e-6, 3.0,
                  0.0, 1000, y0)
    solve = RES.CardSolve(method, fun, (1000.0,), spec, lib=lib)
    c = solve.start(y0, t0, None, ra, stream=0)
    init = lib.calls[0]
    assert init["init"] == 1 and init["d_in"] == init["d"] \
        and init["c_in"] == init["c"]
    before = {k: v.clone() for k, v in _tensors(c).items()}
    c2 = solve.resume(c, ra, 64, stream=0)
    call = lib.calls[1]
    mine = _ranges(c)
    assert not any(lo <= p < hi for p in call["d"] + call["c"]
                   for lo, hi in mine)
    assert call["d_in"] == [getattr(c, f).data_ptr()
                            for f in S.DRIVER_FIELDS]
    for k, v in _tensors(c).items():
        assert torch.equal(v, before[k]), k
    assert c2.n_rec is c.n_rec and c2.sample_y is c.sample_y
    assert c2.njev is not c.njev and c2.ms.jac is not c.ms.jac
    assert tuple(c2.ms.jac.shape) == (B, 2, 2)
    S.stiff_ensemble_cuda(method, fun, y0, t0, ra.tend, ra.hmax, None,
                          ra.rtol, ra.atol, (1000.0,), 1000, spec.params(),
                          ra.hmin, lib=lib, stream=0)
    last = lib.calls[-1]
    assert last["d_in"] == last["d"] and last["c_in"] == last["c"]
