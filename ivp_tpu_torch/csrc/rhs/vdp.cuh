// Van der Pol: y0' = y1, y1' = mu (1 - y0^2) y1 - y0.  args = (mu).
// Torch counterpart: ivp_tpu_torch/rhs.py::vdp (jac: _vdp_jac).
#pragma once

struct VdP {
  static constexpr int N = 2;
  static constexpr int NARGS = 1;
  __device__ __forceinline__ void operator()(double t, const double* y,
                                             double* dy,
                                             const double* args) const {
    const double mu = args[0];
    dy[0] = y[1];
    dy[1] = mu * (1.0 - y[0] * y[0]) * y[1] - y[0];
  }
  // The Jacobian, row-major, each entry as forward-mode differentiation of
  // the line above produces it.
  __device__ __forceinline__ void jac(double t, const double* y, double* J,
                                      const double* args) const {
    const double mu = args[0];
    J[0] = 0.0;
    J[1] = 1.0;
    J[2] = mu * (-(y[0] + y[0])) * y[1] - 1.0;
    J[3] = mu * (1.0 - y[0] * y[0]);
  }
};
