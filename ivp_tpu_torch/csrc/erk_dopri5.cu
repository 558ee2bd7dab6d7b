// DOPRI5 ensemble solve with in-loop samples, and lean with non-default
// controller options, float64: the attempt and interpolant of
// methods/erk.py::dopri5_attempt / dopri5_interp in the driver loop of
// erk_common.cuh (which says what these kernels replace, what bounds them
// and which semantics they keep).  The lean solve with default options runs
// dopri5_ensemble.cu, which compiles the defaults in; this source reads the
// options from its launch argument and adds the five dense coefficients.
#include "erk_common.cuh"

namespace ivp {

struct Dopri5 {
  static constexpr int NCOEFF = 5;
  static constexpr bool HAS_CONTROLLER = true;

  template <class F, bool CONT, class CT>
  static __device__ double attempt(const F& f, const double* a, double t,
                                   const double* y, const double* k1,
                                   Lane<F::N, CT>& c, const ErkOptions& o,
                                   Step<F::N, CONT ? NCOEFF : 0>& s) {
    using namespace dopri5;
    using C = Ctl<CT>;
    constexpr int N = F::N;
    double h = c.h;
    const bool too_small = 0.1 * fabs(h) <= fabs(t) * o.uround;
    const bool last = (t + 1.01 * h - c.tend) * c.posneg > 0.0;
    if (last) h = c.tend - t;

    // k[0..6] = k1..k7; ys ends as the stage-6 state of the stiffness test.
    double k[7][N], ys[N];
    IVP_EACH(j) k[0][j] = k1[j];
    IVP_EACH(j) ys[j] = y[j] + h * (A0_0 * k[0][j]);
    f(t + C1 * h, ys, k[1], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A1_0 * k[0][j] + A1_1 * k[1][j]);
    f(t + C2 * h, ys, k[2], a);
    IVP_EACH(j) ys[j] =
        y[j] + h * (A2_0 * k[0][j] + A2_1 * k[1][j] + A2_2 * k[2][j]);
    f(t + C3 * h, ys, k[3], a);
    IVP_EACH(j) ys[j] = y[j] + h * (A3_0 * k[0][j] + A3_1 * k[1][j] +
                                    A3_2 * k[2][j] + A3_3 * k[3][j]);
    f(t + C4 * h, ys, k[4], a);
    IVP_EACH(j) ys[j] =
        y[j] + h * (A4_0 * k[0][j] + A4_1 * k[1][j] + A4_2 * k[2][j] +
                    A4_3 * k[3][j] + A4_4 * k[4][j]);
    f(t + h, ys, k[5], a);
    IVP_EACH(j) s.ynew[j] =
        y[j] + h * (A5_0 * k[0][j] + A5_2 * k[2][j] + A5_3 * k[3][j] +
                    A5_4 * k[4][j] + A5_5 * k[5][j]);
    f(t + h, s.ynew, k[6], a);

    // Error norm in CT: err_vec in double, cast; sk and the mean in CT.
    CT ssum = (CT)0;
    IVP_EACH(j) {
      const double ev =
          h * (E_0 * k[0][j] + E_2 * k[2][j] + E_3 * k[3][j] + E_4 * k[4][j] +
               E_5 * k[5][j] + E_6 * k[6][j]);
      const CT sk = C::add(
          c.atol[j], C::mul(c.rtol[j], C::vmax(C::abs((CT)y[j]),
                                               C::abs((CT)s.ynew[j]))));
      const CT r = (CT)ev / sk;
      ssum = C::add(ssum, C::mul(r, r));
    }
    const CT err = C::sqrt(ssum / (CT)N);
    const bool accepted = (err <= (CT)1) && !too_small;

    bool stiff_fail = false;
    if (accepted &&
        ((c.naccpt + 1) % o.stiff_test == 0 || c.iasti > 0)) {
      CT stnum = (CT)0, stden = (CT)0;
      IVP_EACH(j) {
        const CT dk = (CT)(k[6][j] - k[5][j]);
        const CT dy = (CT)(s.ynew[j] - ys[j]);
        stnum = C::add(stnum, C::mul(dk, dk));
        stden = C::add(stden, C::mul(dy, dy));
      }
      stiff_fail = stiffness(c, o, stnum, stden, h);
    }
    const bool advance = accepted && !stiff_fail;
    IVP_EACH(j) s.knew[j] = k[6][j];

    if constexpr (CONT) {
      if (advance) {
        IVP_EACH(j) {
          const double ydiff = s.ynew[j] - y[j];
          const double bspl = h * k[0][j] - ydiff;
          s.cont[0][j] = y[j];
          s.cont[1][j] = ydiff;
          s.cont[2][j] = bspl;
          s.cont[3][j] = -h * k[6][j] + ydiff - bspl;
          s.cont[4][j] =
              h * (D_0 * k[0][j] + D_2 * k[2][j] + D_3 * k[3][j] +
                   D_4 * k[4][j] + D_5 * k[5][j] + D_6 * k[6][j]);
        }
      }
    }

    // Controller (Lund-stabilised PI on log(facold)), in CT.
    const CT log_err = C::log(C::vmax(err, (CT)1e-35));
    const CT e1 = C::mul((CT)o.expo1, log_err);
    const CT fac11 = C::exp(e1);
    const CT fac = C::exp(C::sub(e1, C::mul((CT)o.beta, c.facold)));
    const double h_next = pi_next_step(c, o, h, accepted, fac, fac11);
    if (accepted) c.facold = C::vmax(log_err, (CT)LOG_FACOLD_FLOOR);

    s.accepted = accepted;
    s.advance = advance;
    s.finished = advance && last;
    s.status = too_small ? STEP_SIZE_TOO_SMALL
                         : (stiff_fail ? PROBABLY_STIFF : RUNNING);
    s.t_new = last ? c.tend : t + h;
    s.h_used = h;
    s.nfev = 6;
    s.count_step = !too_small;
    s.count_reject = !accepted && c.naccpt > 1 && !too_small;
    return h_next;
  }

  template <int N>
  static __device__ void interp(const double (*cont)[N], double xold, double h,
                                double ti, double* yi) {
    const double th = (ti - xold) / h, th1 = 1.0 - th;
    IVP_EACH(j)
    yi[j] = cont[0][j] +
            th * (cont[1][j] +
                  th1 * (cont[2][j] + th * (cont[3][j] + th1 * cont[4][j])));
  }
};

}  // namespace ivp

// Launch bounds: 64 threads a block; 8 blocks an SM lean (up to 128
// registers), 4 sampled: at 8 the sampled Lorenz instantiation takes all 128
// and spills 56 bytes.
IVP_ERK_ENTRY(dopri5_sampled, vdp, ivp::Dopri5, VdP, 64, 8, 64, 4)
IVP_ERK_ENTRY(dopri5_sampled, decay, ivp::Dopri5, Decay, 64, 8, 64, 4)
IVP_ERK_ENTRY(dopri5_sampled, lorenz, ivp::Dopri5, Lorenz, 64, 8, 64, 4)
IVP_ERK_LIBRARY()
