// Robertson's chemical kinetics, stiff over [0, 1e8]: x' = -0.04 x + 1e4 u z,
// u' = 0.04 x - 1e4 u z - 3e7 u^2, z' = 3e7 u^2.  No args.
// Torch counterpart: ivp_tpu_torch/rhs.py::robertson (jac: _robertson_jac).
#pragma once

struct Robertson {
  static constexpr int N = 3;
  static constexpr int NARGS = 0;
  __device__ __forceinline__ void operator()(double t, const double* y,
                                             double* dy,
                                             const double* args) const {
    dy[0] = -0.04 * y[0] + 1e4 * y[1] * y[2];
    dy[1] = 0.04 * y[0] - 1e4 * y[1] * y[2] - 3e7 * y[1] * y[1];
    dy[2] = 3e7 * y[1] * y[1];
  }
  // Row-major; (3e7 u) u differentiates to 3e7 u + 3e7 u, as forward-mode
  // differentiation of the lines above produces it.
  __device__ __forceinline__ void jac(double t, const double* y, double* J,
                                      const double* args) const {
    const double du = 3e7 * y[1] + 3e7 * y[1];
    J[0] = -0.04;
    J[1] = 1e4 * y[2];
    J[2] = 1e4 * y[1];
    J[3] = 0.04;
    J[4] = -(1e4 * y[2]) - du;
    J[5] = -(1e4 * y[1]);
    J[6] = 0.0;
    J[7] = du;
    J[8] = 0.0;
  }
};
