// Exponential decay: y' = -k y.  args = (k).
// Torch counterpart: ivp_tpu_torch/rhs.py::decay (jac: _decay_jac).
#pragma once

struct Decay {
  static constexpr int N = 1;
  static constexpr int NARGS = 1;
  __device__ __forceinline__ void operator()(double t, const double* y,
                                             double* dy,
                                             const double* args) const {
    dy[0] = -args[0] * y[0];
  }
  __device__ __forceinline__ void jac(double t, const double* y, double* J,
                                      const double* args) const {
    J[0] = -args[0];
  }
};
