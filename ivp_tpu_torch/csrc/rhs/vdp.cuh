// Van der Pol: y0' = y1, y1' = mu (1 - y0^2) y1 - y0.  args = (mu).
// Torch counterpart: ivp_tpu_torch/rhs.py::vdp.
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
};
