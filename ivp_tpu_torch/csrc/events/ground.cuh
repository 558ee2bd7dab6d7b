// The event set "ground" of the ball (rhs/ball.cuh): one event, the height
// y[0] (the solve passes direction -1 and terminal 1), with the bounce as
// its restart map, y_new = (0, -0.8 v).
// Torch counterpart: ivp_tpu_torch/events.py::ground.
#pragma once

struct Ground {
  static constexpr int E = 1;
  // Bit e: event e has a restart map.
  static constexpr unsigned RESTARTS = 1u;
  __device__ __forceinline__ double value(int e, double t, const double* y,
                                          const double* args) const {
    return y[0];
  }
  __device__ __forceinline__ void restart(int e, double t, const double* y,
                                          const double* args,
                                          double* y_new) const {
    y_new[0] = 0.0;
    y_new[1] = -0.8 * y[1];
  }
};
