"""The port's copied constants and types equal ivp_tpu's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ivp_tpu  # noqa: E402,F401
from ivp_tpu import tableaus as jtab  # noqa: E402
from ivp_tpu import types as jtypes  # noqa: E402
from ivp_tpu_torch import tableaus as ttab  # noqa: E402
from ivp_tpu_torch import types as ttypes  # noqa: E402


def _public(mod):
    return sorted(k for k in vars(mod) if k.isupper() and not k.startswith("_"))


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_same_constant_names():
    assert _public(ttab) == _public(jtab)


@pytest.mark.parametrize("name", _public(jtab))
def test_constant_equal(name):
    _equal(getattr(ttab, name), getattr(jtab, name))


def test_status_codes_equal():
    codes = {k: v for k, v in vars(jtypes.Status).items() if k.isupper()}
    assert codes == {k: v for k, v in vars(ttypes.Status).items()
                     if k.isupper()}
    for c in list(codes.values()) + [99]:
        assert ttypes.Status.to_scipy(c) == jtypes.Status.to_scipy(c)


def test_ncoeff_and_scipy_messages_equal():
    assert ttypes.NCOEFF == jtypes.NCOEFF
    for c in list(jtypes.Status.MESSAGES) + [-1, 99]:
        assert ttypes.scipy_message(c) == jtypes.scipy_message(c)


@pytest.mark.parametrize("method", sorted(jtypes.METHOD_ALIASES)
                         + ["rk45", "dopri5", None])
def test_canonical_method_equal(method):
    assert ttypes.canonical_method(method) == jtypes.canonical_method(method)


def test_unknown_method_warns_then_raises_when_strict():
    with pytest.warns(UserWarning):
        assert ttypes.canonical_method("Rdau") == "DOPRI5"
    ttypes.strict_methods(True)
    try:
        with pytest.raises(ValueError):
            ttypes.canonical_method("Rdau")
    finally:
        ttypes.strict_methods(False)


# ---------------------------------------------------------------------------
# The CUDA kernels' copy of the tableaus (csrc/erk_tableaus.cuh)
# ---------------------------------------------------------------------------

def _header_constants():
    """``{namespace: {name: value}}`` of every ``constexpr double`` of the
    header, and the nonzero entries of a Python table as ``{index: value}``."""
    import re
    from pathlib import Path

    text = (Path(ttab.__file__).parent / "csrc" / "erk_tableaus.cuh").read_text()
    out, space = {}, None
    for line in text.splitlines():
        m = re.match(r"namespace (\w+) \{", line)
        if m and m.group(1) != "ivp":
            space = out.setdefault(m.group(1), {})
        m = re.match(r"constexpr double (\w+) = (\S+);", line)
        if m:
            space[m.group(1)] = float(m.group(2))
    return out


def _nonzero(table):
    items = table.items() if isinstance(table, dict) else enumerate(table)
    return {int(i): float(v) for i, v in items if float(v) != 0.0}


def _expected_header():
    exp = {"dop853": {}, "dopri5": {}, "rk23": {}, "rk4": {}}
    d = exp["dop853"]
    for r, row in enumerate(ttab.DOP853_A):
        d[f"C{r + 1}"] = float(ttab.DOP853_C[r + 1])
        d.update({f"A{r}_{i}": v for i, v in _nonzero(row).items()})
    d.update({f"B_{i}": v for i, v in _nonzero(ttab.DOP853_B).items()})
    d.update({f"BH{j + 1}": float(v) for j, v in enumerate(ttab.DOP853_BH)})
    d.update({f"ER_{i}": v for i, v in _nonzero(ttab.DOP853_ER).items()})
    for nm in ("14", "15", "16"):
        d[f"C{nm}"] = float(getattr(ttab, f"DOP853_C{nm}"))
        d.update({f"A{nm}_{i}": v for i, v in
                  _nonzero(getattr(ttab, f"DOP853_A{nm}")).items()})
    for r in range(4, 8):
        d.update({f"D{r}_{i}": v for i, v in
                  _nonzero(ttab.DOP853_D[r]).items()})
    d = exp["dopri5"]
    for r, row in enumerate(ttab.DOPRI5_A):
        d[f"C{r + 1}"] = float(ttab.DOPRI5_C[r + 1])
        d.update({f"A{r}_{i}": v for i, v in _nonzero(row).items()})
    d.update({f"E_{i}": v for i, v in _nonzero(ttab.DOPRI5_E).items()})
    d.update({f"D_{i}": v for i, v in _nonzero(ttab.DOPRI5_D).items()})
    for name in ("B", "E", "D2", "D3"):
        exp["rk23"].update({f"{name}_{i}": v for i, v in
                            _nonzero(getattr(ttab, f"RK23_{name}")).items()})
    exp["rk4"].update({f"B_{i}": v for i, v in _nonzero(ttab.RK4_B).items()})
    return exp


@pytest.mark.parametrize("space", ["dop853", "dopri5", "rk23", "rk4"])
def test_cuda_tableau_header_equals_the_python_tables(space):
    """Every constant the kernels read is the Python table's value to the
    last bit, and none is missing or left over."""
    assert _header_constants()[space] == _expected_header()[space]


# ---------------------------------------------------------------------------
# The stiff kernels' copy (csrc/stiff_tableaus.cuh)
# ---------------------------------------------------------------------------

def _stiff_header():
    """``{name: value}`` of the header's scalars and ``{name: array}`` of
    its tables, by namespace."""
    import re
    from pathlib import Path

    text = (Path(ttab.__file__).parent / "csrc"
            / "stiff_tableaus.cuh").read_text()
    out, space = {}, None
    for m in re.finditer(r"namespace (\w+) \{|(?:constexpr|__constant__) "
                         r"(?:double|int) (\w+)((?:\[\d+\])*) = ([^;]+);",
                         text):
        if m.group(1):
            if m.group(1) != "ivp":
                space = out.setdefault(m.group(1), {})
            continue
        vals = [float(v) for v in re.findall(r"[-+0-9.eE]+", m.group(4))]
        shape = [int(d) for d in re.findall(r"\d+", m.group(3))]
        space[m.group(2)] = (np.array(vals).reshape(shape) if shape
                             else vals[0])
    return out


def test_stiff_tableau_header_equals_the_python_tables():
    """Every constant the stiff kernels read is the Python table's value to
    the last bit: Radau IIA(5)'s nodes, T, TI, DD and eigenvalues, BDF's
    kappa, gamma, alpha, error constants and change_d's matrices."""
    from ivp_tpu_torch.methods.bdf import CHANGE_D_C

    h = _stiff_header()
    r = {k: getattr(ttab, f"RADAU_{k}") for k in (
        "C1", "C2", "C1M1", "C2M1", "C1MC2", "U1", "ALPH", "BETA")}
    r.update({f"DD_{i}": v for i, v in enumerate(ttab.RADAU_DD)})
    for name in ("T", "TI"):
        tab = getattr(ttab, f"RADAU_{name}")
        r.update({f"{name}_{i}_{j}": tab[i, j] for i in range(3)
                  for j in range(3)})
    assert sorted(h["radau"]) == sorted(r)
    for k, v in r.items():
        assert h["radau"][k] == float(v), k
    b = h["bdf"]
    assert b["MAX_ORDER"] == ttab.BDF_MAX_ORDER
    for name in ("KAPPA", "GAMMA", "ALPHA", "ERROR_CONST"):
        np.testing.assert_array_equal(b[name], getattr(ttab, f"BDF_{name}"))
    np.testing.assert_array_equal(b["CHANGE_D_C"], CHANGE_D_C)
    from ivp_tpu.methods.bdf import _CHANGE_D_C as JC
    np.testing.assert_array_equal(CHANGE_D_C, JC)
