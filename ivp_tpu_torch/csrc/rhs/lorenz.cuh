// Lorenz 63.  args = (sigma, rho, beta).
// Torch counterpart: ivp_tpu_torch/rhs.py::lorenz.
#pragma once

struct Lorenz {
  static constexpr int N = 3;
  static constexpr int NARGS = 3;
  __device__ __forceinline__ void operator()(double t, const double* y,
                                             double* dy,
                                             const double* args) const {
    const double sigma = args[0], rho = args[1], beta = args[2];
    dy[0] = sigma * (y[1] - y[0]);
    dy[1] = y[0] * (rho - y[2]) - y[1];
    dy[2] = y[0] * y[1] - beta * y[2];
  }
};
