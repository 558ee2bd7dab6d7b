// Circular restricted three-body problem in the rotating frame, state
// (x, y, z, vx, vy, vz).  args = (mu).
// Torch counterpart: ivp_tpu_torch/rhs.py::cr3bp.  The operations and
// their order are those of the jnp RHS of tests/test_gates.py: each square
// a product, r**3 as r * (r * r) (lax.integer_pow), sums left to right.
#pragma once

#include <math.h>

struct Cr3bp {
  static constexpr int N = 6;
  static constexpr int NARGS = 1;
  __device__ __forceinline__ void operator()(double t, const double* s,
                                             double* ds,
                                             const double* args) const {
    const double mu = args[0];
    const double x = s[0], y = s[1], z = s[2];
    const double xm = x + mu, xm1 = (x - 1.0) + mu;
    const double y2 = y * y, z2 = z * z;
    const double r1 = sqrt((xm * xm + y2) + z2);
    const double r2 = sqrt((xm1 * xm1 + y2) + z2);
    const double r13 = r1 * (r1 * r1), r23 = r2 * (r2 * r2);
    const double om = 1.0 - mu;
    ds[0] = s[3];
    ds[1] = s[4];
    ds[2] = s[5];
    ds[3] = ((x + 2.0 * s[4]) - (om * xm) / r13) - (mu * xm1) / r23;
    ds[4] = ((y - 2.0 * s[3]) - (om * y) / r13) - (mu * y) / r23;
    ds[5] = ((-om) * z) / r13 - (mu * z) / r23;
  }
};
