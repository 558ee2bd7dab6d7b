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
