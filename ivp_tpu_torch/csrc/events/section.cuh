// The event set "section" of Lorenz 63 (rhs/lorenz.cuh): one event, the
// Poincaré section z - (rho - 1), args = (sigma, rho, beta) (the solve passes
// direction -1); no restart map.
// Torch counterpart: ivp_tpu_torch/events.py::lorenz_section.
#pragma once

struct Section {
  static constexpr int E = 1;
  static constexpr unsigned RESTARTS = 0u;
  __device__ __forceinline__ double value(int e, double t, const double* y,
                                          const double* args) const {
    return y[2] - (args[1] - 1.0);
  }
  __device__ __forceinline__ void restart(int e, double t, const double* y,
                                          const double* args,
                                          double* y_new) const {
    for (int j = 0; j < 3; ++j) y_new[j] = y[j];
  }
};
