"""``ivp_tpu_torch.solve_ivp`` on the explicit-method, event-free cases of
tests/test_accuracy.py, tests/test_scipy_suite.py and tests/test_vs_scipy.py,
against closed forms and ``scipy.integrate.solve_ivp``, on the CPU (the
plain driver, one lane).  The bounds are those files' own: SciPy's
``compute_error < 5`` for the suite's rational problem, the per-method
end-state tolerances after one SHO period, 1e-6 (1e-5 on dense points)
against SciPy's integrators at rtol 1e-9, and so on; each case says which.
No JAX here.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose, assert_equal
from scipy.integrate import solve_ivp as scipy_solve_ivp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ivp_tpu_torch as it  # noqa: E402

PI = np.pi
METHODS = ["RK23", "RK45", "DOP853"]


def solve(*a, **kw):
    return it.solve_ivp(*a, device="cpu", **kw)


def fun_rational(t, y):
    return torch.stack([y[1] / t,
                        y[1] * (y[0] + 2 * y[1] - 1) / (t * (y[0] - 1))])


def sol_rational(t):
    t = np.asarray(t)
    return np.asarray((t / (t + 10), 10 * t / (t + 10) ** 2))


def compute_error(y, y_true, rtol, atol):
    e = (y - y_true) / (atol + rtol * np.abs(y_true))
    return np.linalg.norm(e, axis=0) / np.sqrt(e.shape[0])


def sho(t, y):
    return torch.stack([y[1], -y[0]])


# --- tests/test_scipy_suite.py ---------------------------------------------

@pytest.mark.parametrize("vectorized", [False, True])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("t_span", [[5, 9], [5, 1]])
def test_integration(vectorized, method, t_span):
    rtol, atol = 1e-3, 1e-6
    res = solve(fun_rational, t_span, [1 / 3, 2 / 9], rtol=rtol, atol=atol,
                method=method, dense_output=True, vectorized=vectorized)
    assert_equal(res.t[0], t_span[0])
    assert res.t_events is None and res.y_events is None
    assert res.success and res.status == 0
    if method == "DOP853":
        assert res.nfev < 50
    assert res.njev == 0 and res.nlu == 0
    e = compute_error(res.y, sol_rational(res.t), rtol, atol)
    assert np.all(e < 5)
    tc = np.linspace(*t_span)
    assert np.all(compute_error(res.sol(tc), sol_rational(tc), rtol, atol) < 5)
    tc = (t_span[0] + t_span[-1]) / 2
    assert np.all(compute_error(res.sol(tc), sol_rational(tc), rtol, atol) < 5)
    assert_allclose(res.sol(res.t), res.y, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("first_step", [None, 0.1], ids=["max_step",
                                                         "first_step"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("t_span", [[5, 9], [5, 1]])
def test_max_step_and_first_step(method, t_span, first_step):
    rtol, atol = 1e-3, 1e-6
    res = solve(fun_rational, t_span, [1 / 3, 2 / 9], rtol=rtol, atol=atol,
                max_step=0.5, method=method, dense_output=True,
                first_step=first_step)
    assert_equal(res.t[0], t_span[0])
    assert_equal(res.t[-1], t_span[-1])
    if first_step is None:
        assert np.all(np.abs(np.diff(res.t)) <= 0.5 + 1e-15)
    else:
        assert_allclose(first_step, np.abs(res.t[1] - 5))
    assert res.success and res.status == 0
    assert np.all(compute_error(res.y, sol_rational(res.t), rtol, atol) < 5)
    tc = np.linspace(*t_span)
    assert np.all(compute_error(res.sol(tc), sol_rational(tc), rtol, atol) < 5)
    assert_allclose(res.sol(res.t), res.y, rtol=1e-13, atol=1e-13)


def test_t_eval():
    rtol, atol = 1e-3, 1e-6
    y0 = [1 / 3, 2 / 9]
    for t_span in ([5, 9], [5, 1]):
        t_eval = np.linspace(t_span[0], t_span[1], 10)
        res = solve(fun_rational, t_span, y0, rtol=rtol, atol=atol,
                    t_eval=t_eval)
        assert_equal(res.t, t_eval)
        assert res.success and res.status == 0
        assert np.all(compute_error(res.y, sol_rational(res.t), rtol,
                                    atol) < 5)
    for span, t_eval in (([5, 9], [5, 5.01, 7, 8, 8.01, 9]),
                         ([5, 1], [5, 4.99, 3, 1.5, 1.1, 1.01, 1]),
                         ([5, 9], [5.01, 7, 8, 8.01]),
                         ([5, 1], [4.99, 3, 1.5, 1.1, 1.01])):
        res = solve(fun_rational, span, y0, rtol=rtol, atol=atol,
                    t_eval=t_eval)
        assert_equal(res.t, t_eval)
        assert res.success
        assert np.all(compute_error(res.y, sol_rational(res.t), rtol,
                                    atol) < 5)
    with pytest.raises(ValueError):
        solve(fun_rational, [5, 9], y0, rtol=rtol, atol=atol, t_eval=[4, 6])


def test_t_eval_dense_output():
    t_eval = np.linspace(5, 9, 10)
    kw = dict(rtol=1e-3, atol=1e-6, t_eval=t_eval)
    res = solve(fun_rational, [5, 9], [1 / 3, 2 / 9], **kw)
    res_d = solve(fun_rational, [5, 9], [1 / 3, 2 / 9], dense_output=True,
                  **kw)
    assert_equal(res.t, t_eval)
    assert_equal(res.t, res_d.t)
    assert_equal(res.y, res_d.y)
    assert res_d.success and res_d.status == 0


@pytest.mark.parametrize("method", METHODS + ["RK4"])
def test_no_integration_and_empty(method):
    sol = solve(lambda t, y: -y, [4, 4], [2, 3], method=method,
                dense_output=True)
    assert_equal(sol.sol(4), [2, 3])
    assert_equal(sol.sol([4, 5, 6]), [[2, 2, 2], [3, 3, 3]])
    for span in ([0, 10], [0, np.inf]):
        sol = solve(lambda t, y: torch.zeros(0), span, np.zeros((0,)),
                    method=method, dense_output=True)
        assert_equal(sol.sol(10), np.zeros((0,)))
        assert_equal(sol.sol([1, 2, 3]), np.zeros((0, 3)))


def test_array_rtol():
    f = lambda t, y: torch.stack([y[0], y[1]])
    sol = solve(f, (0, 1), [1., 1.], rtol=[1e-1, 1e-1])
    err1 = np.abs(np.linalg.norm(sol.y[:, -1] - np.exp(1)))
    sol = solve(f, (0, 1), [1., 1.], rtol=[1e-1, 1e-16])
    err2 = np.abs(np.linalg.norm(sol.y[:, -1] - np.exp(1)))
    assert err2 < err1


@pytest.mark.parametrize("method", METHODS + ["RK4"])
def test_zero_rhs_and_zero_interval(method):
    res = solve(lambda t, y: torch.zeros_like(y), [0, 10], np.ones(3),
                method=method)
    assert res.success and res.status == 0
    assert_allclose(res.y, 1.0, rtol=1e-15)
    res = solve(lambda t, y: 2 * y, (0.0, 0.0), np.array([1.0]),
                method=method)
    assert res.success
    assert_allclose(res.y[0, -1], 1.0)


def test_args_single_value():
    sol = solve(lambda t, y, a: a * y, (0, 0.1), [1], args=(-1,))
    assert_allclose(sol.y[0, -1], np.exp(-0.1))


@pytest.mark.parametrize("method", METHODS)
def test_tbound_respected(method):
    """The RHS is NaN outside the span: any evaluation beyond it would
    poison the (finite) result."""
    SMALL = 1e-4
    res = solve(lambda t, y: torch.where(t > SMALL * (1 + 1e-12),
                                         torch.nan, 2 * y),
                (0.0, SMALL), np.array([1.0]), method=method)
    assert res.success and np.all(np.isfinite(res.y))

    def reactions_func(t, y):
        yp = torch.tensor([1.73307544e-02, 6.49376470e-06, 0.0, 0.0],
                          dtype=y.dtype)
        return torch.where(t > 200.0000001, torch.nan, yp)

    result = solve(reactions_func, (100.0, 200.0),
                   np.array([134.08298555, 138.82348612, 100., 0.]),
                   dense_output=True, max_step=100.0, method=method)
    assert result.success and np.all(np.isfinite(result.y))


# --- tests/test_accuracy.py -------------------------------------------------

# End-state tolerance after one SHO period at rtol = atol = 1e-9 (RK4 fixed
# step), as tests/test_accuracy.py states them.
SHO_TOLS = {"RK4": 1e-5, "RK23": 1e-5, "RK45": 1e-7, "DOP853": 1e-9}


@pytest.mark.parametrize("method", ["RK4", "RK45", "DOP853"])
def test_sho_one_period(method):
    kwargs = dict(rtol=1e-9, atol=1e-9)
    if method == "RK4":
        kwargs = dict(first_step=2 * PI / 5000.0)
    res = solve(sho, (0.0, 2 * PI), [1.0, 0.0], method=method, **kwargs)
    assert res.success, res.message
    yf = res.y[:, -1]
    assert abs(yf[0] - 1.0) < SHO_TOLS[method]
    assert abs(yf[1] - 0.0) < SHO_TOLS[method]
    assert np.isclose(res.t[-1], 2 * PI, atol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_exponential_decay(method):
    res = solve(lambda t, y: -0.5 * y, (0.0, 10.0), [2.0, 4.0, 8.0],
                method=method, rtol=1e-8, atol=1e-10)
    assert res.success
    assert_allclose(res.y[:, -1], np.array([2.0, 4.0, 8.0]) * np.exp(-5.0),
                    rtol=1e-6)


@pytest.mark.parametrize("method", ["RK45", "DOP853"])
def test_t_eval_exact_points_and_backward(method):
    t_eval = np.linspace(0.0, 2 * PI, 17)
    res = solve(sho, (0.0, 2 * PI), [1.0, 0.0], method=method, rtol=1e-9,
                atol=1e-9, t_eval=t_eval)
    assert res.success
    np.testing.assert_array_equal(res.t, t_eval)
    assert_allclose(res.y[0], np.cos(t_eval), atol=2e-4)
    assert_allclose(res.y[1], -np.sin(t_eval), atol=2e-4)
    res = solve(sho, (2 * PI, 0.0), [1.0, 0.0], method=method, rtol=1e-9,
                atol=1e-9, dense_output=True)
    assert res.success and res.t[0] == 2 * PI
    assert np.isclose(res.t[-1], 0.0, atol=1e-12)
    assert_allclose(res.y[:, -1], [1.0, 0.0], atol=1e-4)
    assert_allclose(res.sol(PI / 2), [0.0, -1.0], atol=1e-4)
    res = solve(lambda t, y: -0.5 * y, (0.0, 1.0), [1.0], method=method)
    assert res.nfev > 0 and res.naccpt > 0 and res.nstep >= res.naccpt
    assert res.status == 0


# --- tests/test_vs_scipy.py ------------------------------------------------

@pytest.mark.parametrize("method, rtol, comp_tol", [
    ("RK45", 1e-9, 1e-6), ("DOP853", 1e-9, 1e-6),
    # RK23 at rtol 1e-9 takes ~25 s through the plain driver: run at 1e-7,
    # where the two global errors stay within 1e-4.
    ("RK23", 1e-7, 1e-4)])
def test_vdp_nonstiff_against_scipy(method, rtol, comp_tol):
    """VdP to t = 20: final state within ``comp_tol`` of SciPy's, and the
    dense output within 10 ``comp_tol`` at two times."""
    def f_np(t, y):
        return [y[1], (1.0 - y[0] ** 2) * y[1] - y[0]]

    ours = solve(lambda t, y: torch.stack([y[1], (1.0 - y[0] ** 2) * y[1]
                                           - y[0]]),
                 (0.0, 20.0), [2.0, 0.0], method=method, rtol=rtol,
                 atol=rtol / 100, dense_output=True)
    ref = scipy_solve_ivp(f_np, (0.0, 20.0), [2.0, 0.0], method=method,
                          rtol=rtol, atol=rtol / 100, dense_output=True)
    assert ours.success and ref.success
    assert_allclose(ours.y[:, -1], ref.y[:, -1], rtol=0, atol=comp_tol)
    for tq in (5.0, 13.7):
        assert_allclose(ours.sol(tq), ref.sol(tq), rtol=0, atol=10 * comp_tol)


def test_backward_linear_against_scipy():
    A = np.array([[-0.2, 1.0], [-1.0, -0.2]])
    At = torch.as_tensor(A)
    ours = solve(lambda t, y: At @ y, (5.0, 0.0), [0.3, -0.7], method="RK45",
                 rtol=1e-9, atol=1e-12, dense_output=True)
    ref = scipy_solve_ivp(lambda t, y: A @ y, (5.0, 0.0), [0.3, -0.7],
                          method="RK45", rtol=1e-9, atol=1e-12,
                          dense_output=True)
    assert ours.success and ref.success
    assert_allclose(ours.y[:, -1], ref.y[:, -1], rtol=0, atol=1e-7)
    assert_allclose(ours.sol(2.5), ref.sol(2.5), rtol=0, atol=1e-6)
