// Classical RK4 ensemble solve with a fixed step, lean and with in-loop
// samples, float64: the attempt and interpolant of
// methods/erk.py::rk4_attempt / rk4_interp in the driver loop of
// erk_common.cuh (which says what these kernels replace, what bounds them
// and which semantics they keep).
//
// Kept from the engine: every attempt is accepted and takes the full h, so
// the last step may overshoot tend; `last` is decided before the step, on
// sign(h); 4 RHS evaluations an attempt (k2, k3, k4 and the next k1); the
// dense output is the cubic Hermite on the start slope k1.  The step is
// first_step, or hinit's with order 5 when none is given.
//
// The Hermite interpolant needs no rows of its own: it reads the segment's
// ends (y and k1 at its start, which the driver drains before it moves the
// carry on, and the step's ynew and knew), so a sampled attempt copies
// nothing and keeps no more values live than a lean one.
#include "erk_common.cuh"

namespace ivp {

struct Rk4 {
  static constexpr int NCOEFF = 0;   // interp reads the segment's ends
  static constexpr bool HAS_CONTROLLER = false;   // nothing to run in CT
  template <class F>
  static constexpr bool DEFERS = true;   // erk_common.cuh's DEFER
  static constexpr bool DEFERS_SAMPLES = false;   // it has no rows

  template <class F, int DENSE, class CT, bool EVENTS, bool SAMPLED, int REC,
            class W>
  static __device__ double attempt(const F& f, const double* a, double t,
                                   const double* y, const double* k1,
                                   Lane<F::N, CT>& c, const ErkOptions& o,
                                   Step<F::N, DENSE ? NCOEFF : 0>& s,
                                   const W&) {
    using namespace rk4;
    constexpr int N = F::N;
    const double h = c.h;
    const bool last = (t + 1.01 * h - c.tend) * sgn(h) > 0.0;

    double k2[N], k3[N], k4[N], ys[N];
    IVP_EACH(j) ys[j] = y[j] + 0.5 * h * k1[j];
    f(t + 0.5 * h, ys, k2, a);
    IVP_EACH(j) ys[j] = y[j] + 0.5 * h * k2[j];
    f(t + 0.5 * h, ys, k3, a);
    IVP_EACH(j) ys[j] = y[j] + h * k3[j];
    f(t + h, ys, k4, a);
    IVP_EACH(j) s.ynew[j] =
        y[j] + h * (B_0 * k1[j] + B_1 * k2[j] + B_2 * k3[j] + B_3 * k4[j]);
    s.t_new = t + h;
    f(s.t_new, s.ynew, s.knew, a);

    s.accepted = true;
    s.advance = true;
    s.finished = last;
    s.status = RUNNING;
    s.h_used = h;
    s.nfev = 4;
    s.count_step = true;
    s.count_reject = false;
    return h;
  }

  // The segment from xold: y, k1 at its start, st.ynew, st.knew at its end.
  template <int N>
  static __device__ void interp(const Step<N, NCOEFF>& st, const double* y,
                                const double* k1, double xold, double ti,
                                double* yi) {
    interp_at<N>(st, y, k1, (ti - xold) / st.h_used, yi);
  }
  // The interpolant at the time ratio s = (ti - xold) / h.
  template <int N>
  static __device__ __forceinline__ void interp_at(const Step<N, NCOEFF>& st,
                                                   const double* y,
                                                   const double* k1, double s,
                                                   double* yi) {
    const double h = st.h_used;
    const double s2 = s * s, s3 = s2 * s;
    const double h00 = 2.0 * s3 - 3.0 * s2 + 1.0;
    const double h10 = s3 - 2.0 * s2 + s;
    const double h01 = -2.0 * s3 + 3.0 * s2;
    const double h11 = s3 - s2;
    IVP_EACH(j)
    yi[j] = h00 * y[j] + h10 * h * k1[j] + h01 * st.ynew[j] +
            h11 * h * st.knew[j];
  }
};

}  // namespace ivp

// Launch bounds: 64 threads a block, 8 blocks an SM (up to 128 registers).
IVP_ERK_ENTRY(rk4, vdp, ivp::Rk4, VdP, 64, 8, 64, 8)
IVP_ERK_ENTRY(rk4, decay, ivp::Rk4, Decay, 64, 8, 64, 8)
IVP_ERK_ENTRY(rk4, lorenz, ivp::Rk4, Lorenz, 64, 8, 64, 8)
IVP_ERK_ENTRY(rk4, cr3bp, ivp::Rk4, Cr3bp, 64, 8, 64, 8)
// The event modes, for the declared event sets (ivp_tpu_torch/events.py).
IVP_ERK_EVENT_ENTRY(rk4, ball, ground, ivp::Rk4, Ball, Ground, 64, 8, 64, 8)
IVP_ERK_EVENT_ENTRY(rk4, lorenz, section, ivp::Rk4, Lorenz, Section, 64, 8, 64, 8)
IVP_ERK_LIBRARY()
