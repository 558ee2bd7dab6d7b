"""The port's BDF (methods/bdf.py) against ivp_tpu's on the CPU: VdP
mu=1000, Robertson with its budgets, the constant-Jacobian system, a
callable and a differentiated Jacobian, the singular retry, t_eval samples,
an event, solve_ivp and the recording ensemble.  Bodies and tolerances:
tests/test_torch_stiff_cases.py (every counter equal under
controller_precision="state"; a stated share under float32)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import test_torch_stiff_cases as C  # noqa: E402

METHOD = "BDF"


@pytest.mark.parametrize("controller", ["state", "float32"])
def test_vdp_mu1000_matches_ivp_tpu(controller):
    share = C.check_vdp(METHOD, controller)
    print(f"{METHOD} {controller}: {share:.3f} of lanes with every counter "
          f"equal")


def test_jac_none_differentiates_a_plain_rhs():
    C.check_jacfwd(METHOD)


def test_callable_jac():
    C.check_callable_jac(METHOD)


def test_robertson_budgets():
    C.check_robertson(METHOD)


def test_constant_jacobian_has_no_jacobian_evaluations():
    C.check_constant_jac(METHOD)


def test_singular_decomposition_retry():
    C.check_singular(METHOD)


def test_t_eval_samples():
    C.check_t_eval(METHOD)


def test_terminal_event():
    C.check_event(METHOD)


def test_solve_ivp():
    C.check_solve_ivp(METHOD)


def test_recording_ensemble():
    C.check_recording(METHOD)
