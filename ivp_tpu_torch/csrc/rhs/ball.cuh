// A ball in free fall, y = (height, velocity): y' = (v, -g).  args = (g).
// Torch counterpart: ivp_tpu_torch/rhs.py::ball.  It runs with its event
// set, events/ground.cuh (the bounce), only: no lean or record entry of its
// own.
#pragma once

struct Ball {
  static constexpr int N = 2;
  static constexpr int NARGS = 1;
  __device__ __forceinline__ void operator()(double t, const double* y,
                                             double* dy,
                                             const double* args) const {
    dy[0] = y[1];
    dy[1] = -args[0];
  }
};
