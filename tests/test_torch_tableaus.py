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
