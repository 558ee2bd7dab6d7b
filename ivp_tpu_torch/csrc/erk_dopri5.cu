// DOPRI5 ensemble solve with in-loop samples, and lean with non-default
// controller options, float64: the attempt and interpolant of
// methods/erk.py::dopri5_attempt / dopri5_interp in the driver loop of
// erk_common.cuh (which says what these kernels replace, what bounds them
// and which semantics they keep).  The lean solve with default options runs
// dopri5_ensemble.cu, which compiles the defaults in; this source reads the
// options from its launch argument and adds the five dense coefficients.
//
// What an attempt issues beyond the stages is what dopri5_ensemble.cu's
// does: one exponential whose argument the acceptance selects and one f64
// division of h; |(CT)y| carried across an accepted step (Lane::ay); the
// stiffness denominator only where the test is due, counted down
// (Lane::stiff_in) where the reference takes (naccpt + 1) % stiff_test;
// `last` with each operation rounded once, as the reference does.  The five
// dense rows are built only on a step that covers a grid time, about one
// accepted step in eight at 100 samples of a Lorenz solve to t = 20.  The
// weights come from the constant bank when lean (an immediate double costs
// two UMOVs an attempt: the Lorenz loop issues 392 instructions against
// 463, 3.5% faster on an H100 at B=262144) and are immediates when sampled:
// read from the bank, the D row's weights move nvcc's FMAs and change
// y_samples in the last bits (PERF.md).
#include "erk_common.cuh"

namespace ivp {

namespace dopri5 {
// The too_small factor and the `last` slack: t + 1.01 h past tend.
constexpr double TENTH = 0.1, SLACK = 1.01;
// The weights a lean instantiation reads from the constant bank.  Not const,
// so that nvcc cannot fold them back into immediates.
#define IVP_DOPRI5_WEIGHTS(X)                                                 \
  X(A0_0) X(A1_0) X(A1_1) X(A2_0) X(A2_1) X(A2_2) X(A3_0) X(A3_1) X(A3_2)     \
  X(A3_3) X(A4_0) X(A4_1) X(A4_2) X(A4_3) X(A4_4) X(A5_0) X(A5_2) X(A5_3)     \
  X(A5_4) X(A5_5) X(E_0) X(E_2) X(E_3) X(E_4) X(E_5) X(E_6) X(D_0) X(D_2)     \
  X(D_3) X(D_4) X(D_5) X(D_6) X(TENTH) X(SLACK)
#define IVP_WEIGHT_FIELD(name) double name;
#define IVP_WEIGHT_VALUE(name) name,
struct Weights {
  IVP_DOPRI5_WEIGHTS(IVP_WEIGHT_FIELD)
};
__constant__ Weights weights = {IVP_DOPRI5_WEIGHTS(IVP_WEIGHT_VALUE)};
}  // namespace dopri5

struct Dopri5 {
  static constexpr int NCOEFF = 5;
  static constexpr bool HAS_CONTROLLER = true;
  template <class F>
  static constexpr bool DEFERS = true;   // erk_common.cuh's DEFER
  // Its five rows cost no RHS evaluation and are built under covers().
  static constexpr bool DEFERS_SAMPLES = false;

  template <class F, int DENSE, class CT, bool EVENTS, bool SAMPLED, int REC,
            class W>
  static __device__ double attempt(const F& f, const double* a, double t,
                                   const double* y, const double* k1,
                                   Lane<F::N, CT>& c, const ErkOptions& o,
                                   Step<F::N, DENSE ? NCOEFF : 0>& s,
                                   const W& want) {
    constexpr bool CONT = DENSE != DENSE_NONE;
    using namespace dopri5;
    using C = Ctl<CT>;
    constexpr int N = F::N;
    // Weight `name` as this instantiation reads it: from the constant bank
    // when lean, an immediate when sampled (see the head).
    constexpr bool BANK = !CONT;
#define W(name) (BANK ? weights.name : dopri5::name)
    double h = c.h;
    const bool too_small = W(TENTH) * fabs(h) <= fabs(t) * o.uround;
    const bool last =
        __dmul_rn(__dadd_rn(__dadd_rn(t, __dmul_rn(W(SLACK), h)), -c.tend),
                  c.posneg) > 0.0;
    if (last) h = c.tend - t;
    const double t_new = last ? c.tend : t + h;
    // Whether the dense rows are built if this step advances: on every step
    // when they are recorded, else only on a step that emits a sample (with
    // events: where the kernel's test of the step's end wants them).
    const bool due = DENSE == DENSE_EVERY ||
                     (DENSE == DENSE_SAMPLES && covers(c, t_new));
    // The stiffness test runs on this attempt if it is accepted.
    const bool stiff_due = stiff_test_due(c);

    // k[0..6] = k1..k7; ys ends as the stage-6 state of the stiffness test.
    double k[7][N], ys[N];
    IVP_EACH(j) k[0][j] = k1[j];
    IVP_EACH(j) ys[j] = y[j] + h * (W(A0_0) * k[0][j]);
    f(t + C1 * h, ys, k[1], a);
    IVP_EACH(j) ys[j] = y[j] + h * (W(A1_0) * k[0][j] + W(A1_1) * k[1][j]);
    f(t + C2 * h, ys, k[2], a);
    IVP_EACH(j) ys[j] = y[j] + h * (W(A2_0) * k[0][j] + W(A2_1) * k[1][j] +
                                    W(A2_2) * k[2][j]);
    f(t + C3 * h, ys, k[3], a);
    IVP_EACH(j) ys[j] = y[j] + h * (W(A3_0) * k[0][j] + W(A3_1) * k[1][j] +
                                    W(A3_2) * k[2][j] + W(A3_3) * k[3][j]);
    f(t + C4 * h, ys, k[4], a);
    IVP_EACH(j) ys[j] =
        y[j] + h * (W(A4_0) * k[0][j] + W(A4_1) * k[1][j] + W(A4_2) * k[2][j] +
                    W(A4_3) * k[3][j] + W(A4_4) * k[4][j]);
    f(t + h, ys, k[5], a);
    IVP_EACH(j) s.ynew[j] =
        y[j] + h * (W(A5_0) * k[0][j] + W(A5_2) * k[2][j] + W(A5_3) * k[3][j] +
                    W(A5_4) * k[4][j] + W(A5_5) * k[5][j]);
    // Stiffness denominator |ynew - ysti|^2, only where the test may run.
    CT stden = (CT)0;
    if (stiff_due) {
      IVP_EACH(j) {
        const CT dy = (CT)(s.ynew[j] - ys[j]);
        stden = C::add(stden, C::mul(dy, dy));
      }
    }
    f(t + h, s.ynew, k[6], a);

    // Error norm in CT: err_vec in double, cast; sk and the mean in CT.
    CT ssum = (CT)0, aynew[N];
    IVP_EACH(j) {
      const double ev =
          h * (W(E_0) * k[0][j] + W(E_2) * k[2][j] + W(E_3) * k[3][j] +
               W(E_4) * k[4][j] + W(E_5) * k[5][j] + W(E_6) * k[6][j]);
      aynew[j] = C::abs((CT)s.ynew[j]);
      const CT sk =
          C::add(c.atol[j], C::mul(c.rtol[j], C::vmax(c.ay[j], aynew[j])));
      const CT r = (CT)ev / sk;
      ssum = C::add(ssum, C::mul(r, r));
    }
    const CT err = C::sqrt(ssum / (CT)N);
    const bool accepted = (err <= (CT)1) && !too_small;

    bool stiff_fail = false;
    if (accepted && stiff_due) {
      CT stnum = (CT)0;
      IVP_EACH(j) {
        const CT dk = (CT)(k[6][j] - k[5][j]);
        stnum = C::add(stnum, C::mul(dk, dk));
      }
      stiff_fail = stiffness(c, o, stnum, stden, h);
    }
    const bool advance = accepted && !stiff_fail;
    IVP_EACH(j) s.knew[j] = k[6][j];
    if (advance) {
      IVP_EACH(j) c.ay[j] = aynew[j];
    }

    if constexpr (CONT) {
      if (DENSE == DENSE_EVENTS ? advance && want(t_new, s.ynew)
                                : due && advance) {
        IVP_EACH(j) {
          const double ydiff = s.ynew[j] - y[j];
          const double bspl = h * k[0][j] - ydiff;
          s.cont[0][j] = y[j];
          s.cont[1][j] = ydiff;
          s.cont[2][j] = bspl;
          s.cont[3][j] = -h * k[6][j] + ydiff - bspl;
          s.cont[4][j] =
              h * (W(D_0) * k[0][j] + W(D_2) * k[2][j] + W(D_3) * k[3][j] +
                   W(D_4) * k[4][j] + W(D_5) * k[5][j] + W(D_6) * k[6][j]);
        }
      }
    }
#undef W

    // Controller (Lund-stabilised PI on log(facold)), in CT.  One
    // exponential and one division of h: the PI factor if accepted, the
    // plain factor if rejected.
    const CT log_err = C::log(C::vmax(err, (CT)1e-35));
    const CT e1 = C::mul((CT)o.expo1, log_err);
    const CT q =
        C::exp(accepted ? C::sub(e1, C::mul((CT)o.beta, c.facold)) : e1) /
        (CT)o.safety;
    const CT facc1 = (CT)o.facc1;
    const CT fac = accepted ? C::vmax((CT)o.facc2, C::vmin(facc1, q))
                            : C::vmin(facc1, q);
    double h_next = h / (double)fac;
    if (accepted) {
      if (fabs(h_next) > c.hmax) h_next = c.posneg * c.hmax;
      if (c.reject) h_next = c.posneg * nmin(fabs(h_next), fabs(h));
      c.facold = C::vmax(log_err, (CT)LOG_FACOLD_FLOOR);
      count_down_stiff(c, o);
    }

    s.accepted = accepted;
    s.advance = advance;
    s.finished = advance && last;
    s.status = too_small ? STEP_SIZE_TOO_SMALL
                         : (stiff_fail ? PROBABLY_STIFF : RUNNING);
    s.t_new = t_new;
    s.h_used = h;
    s.nfev = 6;
    s.count_step = !too_small;
    s.count_reject = !accepted && c.naccpt > 1 && !too_small;
    return h_next;
  }

  // The interpolant at the time ratio th = (ti - xold) / h.
  template <int N>
  static __device__ __forceinline__ void interp_at(const Step<N, NCOEFF>& st,
                                                   const double*,
                                                   const double*, double th,
                                                   double* yi) {
    const auto& cont = st.cont;
    const double th1 = 1.0 - th;
    IVP_EACH(j)
    yi[j] = cont[0][j] +
            th * (cont[1][j] +
                  th1 * (cont[2][j] + th * (cont[3][j] + th1 * cont[4][j])));
  }
  template <int N>
  static __device__ void interp(const Step<N, NCOEFF>& st, const double* y,
                                const double* k1, double xold, double ti,
                                double* yi) {
    interp_at<N>(st, y, k1, (ti - xold) / st.h_used, yi);
  }
};

}  // namespace ivp

// Launch bounds (measured on an H100): 64 threads a block; lean, 12 blocks
// an SM for VdP (80 registers, 12 bytes spilled: 1.5% faster than 8 blocks
// on the headline) and 8 for the rest; sampled, 4 (at 8 the Lorenz
// instantiation takes all 128 registers, spills 124 bytes and runs 18%
// slower at B=16384).  Events: lean on the ball, 10 (96 registers; 0.87 of
// 4 blocks' time at B=524288, PERF.md §6); else 4, as sampled.
IVP_ERK_ENTRY(dopri5_sampled, vdp, ivp::Dopri5, VdP, 64, 12, 64, 4)
IVP_ERK_ENTRY(dopri5_sampled, decay, ivp::Dopri5, Decay, 64, 8, 64, 4)
IVP_ERK_ENTRY(dopri5_sampled, lorenz, ivp::Dopri5, Lorenz, 64, 8, 64, 4)
IVP_ERK_ENTRY(dopri5_sampled, cr3bp, ivp::Dopri5, Cr3bp, 64, 8, 64, 4)
// The event modes, for the declared event sets (ivp_tpu_torch/events.py).
IVP_ERK_EVENT_ENTRY(dopri5_sampled, ball, ground, ivp::Dopri5, Ball, Ground, 64, 10, 64, 4)
IVP_ERK_EVENT_ENTRY(dopri5_sampled, lorenz, section, ivp::Dopri5, Lorenz, Section, 64, 4, 64, 4)
IVP_ERK_LIBRARY()
