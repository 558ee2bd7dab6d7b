"""RK23 on a lane whose error estimate is not finite (ROADMAP §3 fault 7, a
stated deviation from ``ivp_tpu``): decay at rate 20 from y0 = 1e300
integrated backward, where the state overflows on the first attempt and
every error estimate after it is NaN.  ``ivp_tpu``'s RK23 counts only its
accepted attempts toward ``max_steps``, so it never ends such a lane; the
port's RK23 also counts an attempt whose estimate is not finite (and whose
step is not too small), as DOPRI5 counts every attempt, so the lane ends at
``max_steps`` with NEED_LARGER_NMAX.

The plain version (``erk_ensemble_torch``) and a g++ build of
``csrc/erk_rk23.cu`` (gxx.py; the decay entries only, launched through
``erk_ensemble.ensemble_launch`` on CPU tensors with stream 0) each run in
a process of their own under a time limit of its own, beside an ordinary
forward decay lane; each must end, with the status and every counter equal
between the two.  The g++ build is skipped without g++.
"""
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from ivp_tpu_torch import Status  # noqa: E402
from ivp_tpu_torch.kernels import build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MAX_STEPS = 500
LIMIT = 120   # seconds a route may take (each runs in well under 10)

# One route's solve of the two lanes, printed as JSON: the plain version,
# or the library at argv[2].
SCRIPT = r"""
import json, sys
import numpy as np, torch
import ivp_tpu_torch as it
from ivp_tpu_torch.kernels import build, erk_ensemble as E
T = lambda a: torch.tensor(np.asarray(a, float), dtype=torch.float64)
a = (it.rhs.decay, T([[1e300], [1.0]]), T([0.0, 0.0]), T([-5.0, 5.0]),
     T([5.0, 5.0]), None, T([[1e-6], [1e-6]]), T([[1e-9], [1e-9]]), (20.0,),
     int(sys.argv[1]))
if len(sys.argv) > 2:
    out = E.ensemble_launch("RK23", *a, None, None,
                            build.load(sys.argv[2]), 0)
else:
    out = E.erk_ensemble_torch("RK23", *a)
print(json.dumps([x.tolist() for x in out[:7]]))
"""


def run(*extra):
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(MAX_STEPS),
                        *extra], capture_output=True, text=True,
                       timeout=LIMIT, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def plain():
    return run()


def test_plain_ends_nan_lane_at_max_steps(plain):
    t, y, status, nfev, nstep, naccpt, nrejct = plain
    assert status == [Status.NEED_LARGER_NMAX, Status.SUCCESS]
    assert nstep[0] == MAX_STEPS + 1 and naccpt[0] == 0
    assert nrejct[0] == MAX_STEPS + 1 and t[0] == 0.0
    assert t[1] == 5.0 and nstep[1] == naccpt[1]


def test_kernel_ends_nan_lane_as_plain(plain, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel source as host code")
    spec = importlib.util.spec_from_file_location("gxx", ROOT / "gxx.py")
    gxx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gxx)
    src = tmp_path / "csrc"
    shutil.copytree(build.SRC_DIR, src)
    cu = src / "erk_rk23.cu"
    cu.write_text("".join(
        ln for ln in cu.read_text().splitlines(keepends=True)
        if not ln.startswith("IVP_ERK_") or ln.startswith(
            ("IVP_ERK_ENTRY(rk23, decay,", "IVP_ERK_LIBRARY"))))
    lib = gxx.build_all(src, tmp_path / "out", ["erk_rk23"])["erk_rk23"]
    got = run(str(lib))
    # The status and every counter equal; t and y within
    # tests/test_torch_rk23_fast.py's TOL of their scale (the NaN lane's
    # exactly: it never moves).
    assert got[2:] == plain[2:]
    assert got[0][0] == plain[0][0] and got[1][0] == plain[1][0]
    for g, r in ((got[0][1], plain[0][1]), (got[1][1][0], plain[1][1][0])):
        assert abs(g - r) <= 1e-10 * max(1.0, abs(r))
