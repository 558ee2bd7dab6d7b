"""The explicit tier's CUDA kernel wrapper (kernels/erk_ensemble.py::
erk_ensemble_cuda) on the CPU: it launches only on a CUDA tensor and
refuses any other, for every method's kernel, before it builds or loads a
library.  Runs no kernel, so it needs no card."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ivp_tpu_torch import rhs  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as K  # noqa: E402


@pytest.mark.parametrize("method", sorted(K.KERNELS))
def test_kernel_launch_refuses_a_cpu_tensor(method):
    y0 = torch.ones((4, 3), dtype=torch.float64)
    lane = torch.zeros(4, dtype=torch.float64)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.erk_ensemble_cuda(method, rhs.lorenz, y0, lane, lane + 1, lane + 1,
                            None, torch.ones_like(y0), torch.ones_like(y0))
    assert K.LAUNCHES == before
