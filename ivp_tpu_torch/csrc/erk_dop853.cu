// DOP853 ensemble solve, lean and with in-loop samples, float64: the attempt
// and interpolant of methods/erk.py::dop853_attempt / dop853_interp in the
// driver loop of erk_common.cuh (which says what these kernels replace, what
// bounds them and which semantics they keep).
//
// Kept from the engine: the dual 8(5,3) error norm with deno <= 0 -> 1 and
// sqrt(1 / (n * deno)) in the controller's type; nfev 11 + (4 if sampled
// else 1) on accept and 11 on reject; the stiffness test on f(ynew) - k12
// and ynew - y12 at the reference's cadence, counted down (Lane::stiff_in,
// as DOPRI5 does) where the reference takes (naccpt + 1) % stiff_test; the
// default controller (beta == 0) as three square roots with no log or exp
// and facold left alone, the DOPRI5 controller otherwise; the dense stages
// on accepted attempts only.
//
// The attempt's chain.  At the main path's B=16384 each scheduler holds one
// warp, which waits on its own dependent chain: on an H100 the twelve stages
// took about 590 cycles of a 2490-cycle attempt, the norm with f(ynew) 1040
// and the controller 700 (PERF.md §6), where ptxas had cut the attempt's
// tail into small blocks: a fast path, a test and a branch to a slow-path
// subroutine for each of the norm's and the controller's divisions and
// square roots, f(ynew) behind the acceptance, the stiffness test's modulo
// and its sums.  So everything after the twelfth stage is one straight-line
// block for each form of the controller (o.sqrt_chain, the same on every
// lane; the branch between the two comes before it): ynew, the error
// vectors, f(ynew) on every attempt (counted on an accepted one only), and
// the norm and the controller on their fast paths (FastCtl), done once more
// through the library's operations, behind one branch, on a lane where an
// input leaves their range; the stiffness test's sums run with the test,
// where it is due on an accepted attempt.  Every output is the same, bit for
// bit; the attempt takes about 1600 cycles there.
//
// A sampled solve (no events, no records) builds the dense stages and rows
// of no step in its loop: a step that covers a grid time is queued, and the
// warp rebuilds its queued steps together with the rows built and emits
// their samples (erk_common.cuh's DEFER_SAMPLES, DEFERS_SAMPLES below).  On
// the Lorenz main path the rows ran on about 97% of a lane's steps that
// emit nothing; covers() alone would still run them on most of a warp's
// iterations.  nfev keeps ivp_tpu's 11 + 4 on each accepted step and does
// not count the rebuild.
//
// Registers: twelve stage vectors (sixteen where rows are built) of n
// doubles each sit beside the state, so the entries ask for 64 x 4 launch
// bounds, which leave ptxas all 255 registers a thread may have: with the
// float controller Lorenz (n = 3) takes 115 lean and 219 sampled (the
// rebuild's attempt with its rows beside the loop's state) and spills
// nothing (kernels/build.py keeps ptxas's report; PERF.md states it).
#include "erk_common.cuh"

namespace ivp {

struct Dop853 {
  static constexpr int NCOEFF = 8;
  static constexpr bool HAS_CONTROLLER = true;
  template <class F>
  static constexpr bool DEFERS = true;   // erk_common.cuh's DEFER
  static constexpr bool DEFERS_SAMPLES = true;   // and DEFER_SAMPLES

  // What the error norm and the controller give the attempt: the error, the
  // acceptance, the facold memory after the attempt, and the next step size
  // before the accepted attempt's hmax and reject clamps.
  template <class CT>
  struct Control {
    CT err, facold;
    double h_next;
    bool accepted;
  };

  // The dual 8(5,3) error norm of (e2, e5) and the controller (the three
  // square roots where SQRT, else the DOPRI5 form), in the operations of O:
  // FastCtl<CT> (the fast paths, which clear op.ok where an input leaves
  // their range) or Ctl<CT>.
  template <bool SQRT, int N, class CT, class O>
  static __device__ __forceinline__ Control<CT> control(
      O&& op, const Lane<N, CT>& c, const ErkOptions& o, const double* y,
      const double* ynew, const double* e2, const double* e5, double h,
      bool too_small) {
    CT err2 = (CT)0, err5 = (CT)0;
    IVP_EACH(j) {
      const CT sk = op.add(
          c.atol[j],
          op.mul(c.rtol[j], op.vmax(op.abs((CT)y[j]), op.abs((CT)ynew[j]))));
      const Divisor<CT> d = op.divisor(sk);
      const CT r2 = op.div_by((CT)e2[j], d), r5 = op.div_by((CT)e5[j], d);
      err2 = op.add(err2, op.mul(r2, r2));
      err5 = op.add(err5, op.mul(r5, r5));
    }
    CT deno = op.add(err5, op.mul((CT)0.01, err2));
    if (deno <= (CT)0) deno = (CT)1;
    Control<CT> r;
    r.err = op.mul(op.mul((CT)fabs(h), err5),
                   op.sqrt(op.div((CT)1, op.mul((CT)N, deno))));
    r.accepted = (r.err <= (CT)1) && !too_small;
    // The controller factors: fac with the facold memory, for an accepted
    // attempt; fac11 without.
    CT fac, fac11;
    r.facold = c.facold;
    if constexpr (SQRT) {
      fac11 = op.sqrt(op.sqrt(op.sqrt(r.err)));
      fac = fac11;
    } else {
      const CT log_err = op.log(op.vmax(r.err, (CT)1e-35));
      const CT e1 = op.mul((CT)o.expo1, log_err);
      fac11 = op.exp(e1);
      fac = op.exp(op.sub(e1, op.mul((CT)o.beta, c.facold)));
      if (r.accepted) r.facold = op.vmax(log_err, (CT)LOG_FACOLD_FLOOR);
    }
    const CT facc1 = (CT)o.facc1;
    const CT q = op.div(r.accepted ? fac : fac11, (CT)o.safety);
    r.h_next = op.hdiv(h, r.accepted ? op.vmax((CT)o.facc2, op.vmin(facc1, q))
                                     : op.vmin(facc1, q));
    return r;
  }

  template <class F, int DENSE, class CT, bool EVENTS, bool SAMPLED, int REC,
            class W>
  static __device__ double attempt(const F& f, const double* a, double t,
                                   const double* y, const double* k1,
                                   Lane<F::N, CT>& c, const ErkOptions& o,
                                   Step<F::N, DENSE ? NCOEFF : 0>& s,
                                   const W& want) {
    constexpr bool CONT = DENSE != DENSE_NONE;
    using namespace dop853;
    using C = Ctl<CT>;
    constexpr int N = F::N;
    double h = c.h;
    const bool too_small = 0.1 * fabs(h) <= fabs(t) * o.uround;
    const bool last = (t + 1.01 * h - c.tend) * c.posneg > 0.0;
    if (last) h = c.tend - t;
    // The stiffness test runs on this attempt if it is accepted.
    const bool stiff_due = stiff_test_due(c);

    // k[0..11] = k1..k12, k[12] = f(ynew), k[13..15] = dense stages 14-16.
    double k[CONT ? 16 : 13][N], ys[N], kb[N];
    IVP_EACH(j) k[0][j] = k1[j];
    IVP_EACH(j) ys[j] = y[j] + h * (A0_0 * k[0][j]);
    f(t + C1 * h, ys, k[1], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A1_0 * k[0][j] + A1_1 * k[1][j]);
    f(t + C2 * h, ys, k[2], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A2_0 * k[0][j] + A2_2 * k[2][j]);
    f(t + C3 * h, ys, k[3], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A3_0 * k[0][j] + A3_2 * k[2][j]
        + A3_3 * k[3][j]);
    f(t + C4 * h, ys, k[4], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A4_0 * k[0][j] + A4_3 * k[3][j]
        + A4_4 * k[4][j]);
    f(t + C5 * h, ys, k[5], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A5_0 * k[0][j] + A5_3 * k[3][j]
        + A5_4 * k[4][j] + A5_5 * k[5][j]);
    f(t + C6 * h, ys, k[6], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A6_0 * k[0][j] + A6_3 * k[3][j]
        + A6_4 * k[4][j] + A6_5 * k[5][j] + A6_6 * k[6][j]);
    f(t + C7 * h, ys, k[7], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A7_0 * k[0][j] + A7_3 * k[3][j]
        + A7_4 * k[4][j] + A7_5 * k[5][j] + A7_6 * k[6][j] + A7_7 * k[7][j]);
    f(t + C8 * h, ys, k[8], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A8_0 * k[0][j] + A8_3 * k[3][j]
        + A8_4 * k[4][j] + A8_5 * k[5][j] + A8_6 * k[6][j] + A8_7 * k[7][j]
        + A8_8 * k[8][j]);
    f(t + C9 * h, ys, k[9], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A9_0 * k[0][j] + A9_3 * k[3][j]
        + A9_4 * k[4][j] + A9_5 * k[5][j] + A9_6 * k[6][j] + A9_7 * k[7][j]
        + A9_8 * k[8][j] + A9_9 * k[9][j]);
    f(t + C10 * h, ys, k[10], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A10_0 * k[0][j] + A10_3 * k[3][j]
        + A10_4 * k[4][j] + A10_5 * k[5][j] + A10_6 * k[6][j]
        + A10_7 * k[7][j] + A10_8 * k[8][j] + A10_9 * k[9][j]
        + A10_10 * k[10][j]);
    f(t + C11 * h, ys, k[11], a);
    // ys is now the stage-12 state y12 of the stiffness test.  The rest of
    // the attempt up to the next step size, one block for each form of the
    // controller (see the head).
    const auto tail = [&](auto sqrt_chain) {
      constexpr bool SQRT = decltype(sqrt_chain)::value;
      IVP_EACH(j) kb[j] = B_0 * k[0][j] + B_5 * k[5][j] + B_6 * k[6][j]
          + B_7 * k[7][j] + B_8 * k[8][j] + B_9 * k[9][j] + B_10 * k[10][j]
          + B_11 * k[11][j];
      IVP_EACH(j) s.ynew[j] = y[j] + h * kb[j];
      double e2[N], e5[N];
      IVP_EACH(j) {
        e2[j] = kb[j] - BH1 * k[0][j] - BH2 * k[8][j] - BH3 * k[11][j];
        e5[j] = ER_0 * k[0][j] + ER_5 * k[5][j] + ER_6 * k[6][j]
            + ER_7 * k[7][j] + ER_8 * k[8][j] + ER_9 * k[9][j]
            + ER_10 * k[10][j] + ER_11 * k[11][j];
      }
      f(t + h, s.ynew, k[12], a);
      FastCtl<CT> fast;
      Control<CT> r =
          control<SQRT, N>(fast, c, o, y, s.ynew, e2, e5, h, too_small);
      if (!fast.ok)
        r = control<SQRT, N>(C{}, c, o, y, s.ynew, e2, e5, h, too_small);
      return r;
    };
    Control<CT> ctl;
    if (o.sqrt_chain) ctl = tail(std::true_type{});
    else ctl = tail(std::false_type{});
    const bool accepted = ctl.accepted;
    c.facold = ctl.facold;
    double h_next = ctl.h_next;

    bool stiff_fail = false;
    if (accepted) {
      if (fabs(h_next) > c.hmax) h_next = c.posneg * c.hmax;
      if (c.reject) h_next = c.posneg * nmin(fabs(h_next), fabs(h));
      if (stiff_due) {
        CT stnum = (CT)0, stden = (CT)0;
        IVP_EACH(j) {
          const CT dk = (CT)(k[12][j] - k[11][j]);
          const CT dy = (CT)(s.ynew[j] - ys[j]);
          stnum = C::add(stnum, C::mul(dk, dk));
          stden = C::add(stden, C::mul(dy, dy));
        }
        stiff_fail = stiffness(c, o, stnum, stden, h);
      }
      count_down_stiff(c, o);
    }
    // ivp_tpu's count (methods/erk.py: 11 + 4 on an accepted step with
    // dense output), also where DENSE_EVENTS builds no rows on the step.
    s.nfev = accepted ? (CONT ? 15 : 12) : 11;
    IVP_EACH(j) s.knew[j] = k[12][j];
    const bool advance = accepted && !stiff_fail;

    if constexpr (CONT) {
      if (DENSE == DENSE_EVENTS ? advance && want(last ? c.tend : t + h, s.ynew)
                                : advance) {
        double yd[N];
        IVP_EACH(j) yd[j] = y[j] + h * (A14_0 * k[0][j] + A14_6 * k[6][j]
            + A14_7 * k[7][j] + A14_8 * k[8][j] + A14_9 * k[9][j]
            + A14_10 * k[10][j] + A14_11 * k[11][j] + A14_12 * k[12][j]);
        f(t + C14 * h, yd, k[13], a);
        IVP_EACH(j) yd[j] = y[j] + h * (A15_0 * k[0][j] + A15_5 * k[5][j]
            + A15_6 * k[6][j] + A15_7 * k[7][j] + A15_10 * k[10][j]
            + A15_11 * k[11][j] + A15_12 * k[12][j] + A15_13 * k[13][j]);
        f(t + C15 * h, yd, k[14], a);
        IVP_EACH(j) yd[j] = y[j] + h * (A16_0 * k[0][j] + A16_5 * k[5][j]
            + A16_6 * k[6][j] + A16_7 * k[7][j] + A16_8 * k[8][j]
            + A16_12 * k[12][j] + A16_13 * k[13][j] + A16_14 * k[14][j]);
        f(t + C16 * h, yd, k[15], a);
        IVP_EACH(j) {
          const double ydiff = s.ynew[j] - y[j];
          const double bspl = h * k[0][j] - ydiff;
          s.cont[0][j] = y[j];
          s.cont[1][j] = ydiff;
          s.cont[2][j] = bspl;
          s.cont[3][j] = ydiff - h * k[12][j] - bspl;
          s.cont[4][j] = h * (D4_0 * k[0][j] + D4_5 * k[5][j]
            + D4_6 * k[6][j] + D4_7 * k[7][j] + D4_8 * k[8][j]
            + D4_9 * k[9][j] + D4_10 * k[10][j] + D4_11 * k[11][j]
            + D4_12 * k[12][j] + D4_13 * k[13][j] + D4_14 * k[14][j]
            + D4_15 * k[15][j]);
          s.cont[5][j] = h * (D5_0 * k[0][j] + D5_5 * k[5][j]
            + D5_6 * k[6][j] + D5_7 * k[7][j] + D5_8 * k[8][j]
            + D5_9 * k[9][j] + D5_10 * k[10][j] + D5_11 * k[11][j]
            + D5_12 * k[12][j] + D5_13 * k[13][j] + D5_14 * k[14][j]
            + D5_15 * k[15][j]);
          s.cont[6][j] = h * (D6_0 * k[0][j] + D6_5 * k[5][j]
            + D6_6 * k[6][j] + D6_7 * k[7][j] + D6_8 * k[8][j]
            + D6_9 * k[9][j] + D6_10 * k[10][j] + D6_11 * k[11][j]
            + D6_12 * k[12][j] + D6_13 * k[13][j] + D6_14 * k[14][j]
            + D6_15 * k[15][j]);
          s.cont[7][j] = h * (D7_0 * k[0][j] + D7_5 * k[5][j]
            + D7_6 * k[6][j] + D7_7 * k[7][j] + D7_8 * k[8][j]
            + D7_9 * k[9][j] + D7_10 * k[10][j] + D7_11 * k[11][j]
            + D7_12 * k[12][j] + D7_13 * k[13][j] + D7_14 * k[14][j]
            + D7_15 * k[15][j]);
        }
      }
    }

    s.accepted = accepted;
    s.advance = advance;
    s.finished = advance && last;
    s.status = too_small ? STEP_SIZE_TOO_SMALL
                         : (stiff_fail ? PROBABLY_STIFF : RUNNING);
    s.t_new = last ? c.tend : t + h;
    s.h_used = h;
    s.count_step = !too_small;
    s.count_reject = !accepted && c.naccpt > 1 && !too_small;
    return h_next;
  }

  template <int N>
  static __device__ void interp(const Step<N, NCOEFF>& st, const double* y,
                                const double* k1, double xold, double ti,
                                double* yi) {
    interp_at<N>(st, y, k1, (ti - xold) / st.h_used, yi);
  }
  // The interpolant at the time ratio s = (ti - xold) / h.
  template <int N>
  static __device__ __forceinline__ void interp_at(const Step<N, NCOEFF>& st,
                                                   const double*,
                                                   const double*, double s,
                                                   double* yi) {
    const auto& cont = st.cont;
    const double s1 = 1.0 - s;
    IVP_EACH(j) {
      const double conpar =
          cont[4][j] + s * (cont[5][j] + s1 * (cont[6][j] + s * cont[7][j]));
      yi[j] = cont[0][j] +
              s * (cont[1][j] +
                   s1 * (cont[2][j] + s * (cont[3][j] + s1 * conpar)));
    }
  }
};

}  // namespace ivp

// Launch bounds: 64 threads a block, 4 blocks an SM (see the head).
IVP_ERK_ENTRY(dop853, vdp, ivp::Dop853, VdP, 64, 4, 64, 4)
IVP_ERK_ENTRY(dop853, decay, ivp::Dop853, Decay, 64, 4, 64, 4)
IVP_ERK_ENTRY(dop853, lorenz, ivp::Dop853, Lorenz, 64, 4, 64, 4)
IVP_ERK_ENTRY(dop853, cr3bp, ivp::Dop853, Cr3bp, 64, 4, 64, 4)
// The event modes, for the declared event sets (ivp_tpu_torch/events.py).
IVP_ERK_EVENT_ENTRY(dop853, ball, ground, ivp::Dop853, Ball, Ground, 64, 4, 64, 4)
IVP_ERK_EVENT_ENTRY(dop853, lorenz, section, ivp::Dop853, Lorenz, Section, 64, 4, 64, 4)
IVP_ERK_LIBRARY()
