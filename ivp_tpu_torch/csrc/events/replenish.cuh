// The event set "replenish" of the decay (rhs/decay.cuh): one event,
// y[0] - 0.5 (the solve passes direction -1 and terminal 1), with its
// restart map y_new = 1: a store that decays to half and is refilled (a
// dosing or replenishment model's sawtooth).
// Torch counterpart: ivp_tpu_torch/events.py::replenish.
#pragma once

struct Replenish {
  static constexpr int E = 1;
  // Bit e: event e has a restart map.
  static constexpr unsigned RESTARTS = 1u;
  __device__ __forceinline__ double value(int e, double t, const double* y,
                                          const double* args) const {
    return y[0] - 0.5;
  }
  __device__ __forceinline__ void restart(int e, double t, const double* y,
                                          const double* args,
                                          double* y_new) const {
    y_new[0] = 1.0;
  }
};
