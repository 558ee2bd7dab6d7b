// The event set "crossing" of Van der Pol (rhs/vdp.cuh): one event, the
// position y[0] (the solve passes direction -1, not terminal), with no
// restart map: a relaxation oscillator's downward zero crossings, whose
// times give its period and phase.
// Torch counterpart: ivp_tpu_torch/events.py::vdp_crossing.
#pragma once

struct Crossing {
  static constexpr int E = 1;
  // Bit e: event e has a restart map.
  static constexpr unsigned RESTARTS = 0u;
  __device__ __forceinline__ double value(int e, double t, const double* y,
                                          const double* args) const {
    return y[0];
  }
  __device__ __forceinline__ void restart(int e, double t, const double* y,
                                          const double* args,
                                          double* y_new) const {}
};
