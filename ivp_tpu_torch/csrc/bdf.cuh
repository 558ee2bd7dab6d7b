// The variable-order BDF ensemble solve, float64, one thread a lane (the
// kernel template; bdf.cu and bdf_ev.cu instantiate its entries): the
// attempt of ivp_tpu_torch/methods/bdf.py (itself ivp_tpu/methods/bdf.py::
// make_bdf_attempt, :312, with change_d, :232) with its inverse backend, in
// the loop of core/driver.py: to the final state, or emitting samples on a
// t_grid or one record row per accepted step (the MODE of stiff_common.cuh).
//
// It replaces the XLA-fused, vmapped ivp_tpu/core/driver.py loop around
// make_bdf_attempt and the inverse of I - cJ (core/linalg.py::inv :280); no
// TPU kernel stands behind it.  The order-dependent sums are loops to the
// lane's order (the reference's masked sums over MAX_ORDER+3 rows add exact
// zeros past it); the Newton loop ends at the lane's exit; the iteration
// matrix is rebuilt and the Jacobian refreshed only where the lane asks.
// Same carry, init, budget and modes as radau.cu; no FMA contraction.  The
// attempt ends before change_d: the kernel's loop rescales D after it, and
// a SAMPLED or RECORD lane emits between the two, from the accepted step's
// D, off the attempt's register peak: its dense output is the Newton form
// over D[0..order] (bdf_interp), its row's coefficients [D0, D1..D5 past the
// order 0, order] (NCOEFF 7).  A RECORD lane stages its rows in shared
// memory past its slots and writes each run with one bulk copy
// (SlotsStage, stiff_common.cuh).
//
// The event mode (an event set EV, bdf_ev.cu's entries; the loop of
// ivp_tpu/core/driver.py::step_body :203-280 with events and restarts):
// after an accepted step, before change_d, the lane tests its events and
// refines each crossing on bdf_interp over D[0..order] (the accepted step's
// Newton form, which ivp_tpu's bdf_interp reads; stiff_events.cuh); a
// terminal or restarting event becomes the step's end, and a restart runs
// the method's init at the event point (bdf_init: D, order, n_equal and
// the LU state afresh, hinit's two RHS evaluations, and one Jacobian that
// counts in njev) in place of change_d.  With NoEvents, the instantiation of
// bdf.cu's entries, it compiles away.
//
// What bounds it on an H100: dependent float64 divisions and float32 log,
// exp and division chains, waiting on latency.  The design: (1) what only one
// path reads is computed on that path alone: the order selection's three
// error norms, logs and exps only on the (order+1)-th equal accepted step
// that adapts, the rejection factor only on an error rejection, the Newton
// rate's power and estimates only where the rate is checked, the rescale's
// division not when the step stays; none of it changes a bit of any output;
// (2) the difference array D, indexed by the lane's run-time order, and the
// matrices jac and inv live in the lane's shared-memory slots (BDFCold), not
// in a local-memory stack frame, so a thread needs fewer registers and more
// lanes are resident on an SM (bdf_pick: fewer, with more registers, when
// the batch fits the card at once); change_d builds only the columns of its
// transform that the order reaches, and of them the terms whose
// coefficient is not 0 (read from CHANGE_D_C at compile time); (3) the
// divisions and square roots run in four units (the head, the
// decomposition, each Newton iteration's rate, the tail with the error, the
// order selection and the step factor), each straight through FastCtl's
// fast paths with one branch to the library's (FastOps, stiff_common.cuh);
// the order selection's float32 log and exp stay the library's.
#pragma once

#include "stiff_common.cuh"
#include "stiff_events.cuh"

namespace ivp {

// The fields of methods/bdf.py::BDFParams a launch reads
// (kernels/stiff_ensemble.py::BDFOptions, same layout).
struct BDFOptions {
  double newton_tol;  // 0: from the tolerances
  int newton_maxiter, const_jac, state_precision;
};

// BDFState, struct of arrays (B leading).
struct BDFCarry {
  double* h_abs;
  double* posneg;
  double* D;       // (B, MAX_ORDER + 3, N)
  int* order;
  int* n_equal;
  double* jac;     // (B, N, N)
  double* inv;     // (B, N, N)
  unsigned char* lu_current;
  double* current_c;
};

constexpr int BDF_ROWS = bdf::MAX_ORDER + 3;
// The coefficient rows of a record row: [D0, D1..D5 past the order 0, order].
constexpr int BDF_COEFFS = bdf::MAX_ORDER + 2;
constexpr double BDF_EPS = 2.220446049250313e-16;

// A lane's cold state in its slots (doubles): the difference array D (row
// k, component j at D + k N + j), the Jacobian and the inverse of I - cJ
// (row-major).
// The lane's tolerances and span stay in registers: with them in slots too
// the kernel ran 6% slower on an H100 (PERF.md §6).
template <int N>
struct BDFCold {
  static constexpr int D = 0, JAC = BDF_ROWS * N, INV = JAC + N * N;
  static constexpr int DOUBLES = BDF_ROWS * N + 2 * N * N;
};

// The lane's warm state in registers, its cold state in slots s.
template <int N, int T>
struct BDFLane {
  double h_abs, posneg, current_c;
  int order, n_equal;
  bool lu_current;
  Slots<T> s;
  __device__ __forceinline__ double& d(int k, int j) const {
    return s[BDFCold<N>::D + k * N + j];
  }
};

// The RMS of w v scaled, in O's operations (a FastOps or LibOps member).
template <int N, class CT, class O>
__device__ __forceinline__ CT rms_scaled(O& op, const double* v, CT w,
                                         const CT* inv_scale) {
  CT s = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const CT q = op.mul(op.mul(w, (CT)v[j]), inv_scale[j]);
    s = j ? op.add(s, op.mul(q, q)) : op.mul(q, q);
  }
  return sqrt_wide(op, div_n<N>(op, s));
}

// fn(std::integral_constant<int, I>{}) for I in [I0, I1), unrolled at
// compile time, so that fn may read CHANGE_D_C at its indices.
template <int I, int I1, class Fn>
__device__ __forceinline__ void static_for(const Fn& fn) {
  if constexpr (I < I1) {
    fn(std::integral_constant<int, I>{});
    static_for<I + 1, I1>(fn);
  }
}

// CHANGE_D_C[DD][M][JR], in a constant expression.
template <int DD, int M, int JR>
__host__ __device__ constexpr double change_coef() {
  return bdf::CHANGE_D_C[DD][M][JR];
}

// Whether the transform's entry T[M][JR] is 0 whatever the factor.
template <int M, int JR, int DD = 0>
__host__ __device__ constexpr bool change_zero() {
  if constexpr (DD > M) return true;
  else return change_coef<DD, M, JR>() == 0.0 && change_zero<M, JR, DD + 1>();
}

// The transform's entry T[M][JR] = C[0][M][JR] + pw[1] C[1][M][JR] + ...
// + pw[M] C[M][M][JR], summed left to right; with SKIP the terms with a 0
// coefficient left out.  With pw finite such a term is +-0.0, and the sum is
// never -0.0 (it starts from C[0] >= 0, and an exact cancellation rounds to
// +0.0), so it adds nothing.
template <int M, int JR, bool SKIP>
__device__ __forceinline__ double change_entry(const double* pw) {
  double acc = change_coef<0, M, JR>();
  static_for<1, M + 1>([&](auto dd) {
    constexpr double c = change_coef<decltype(dd)::value, M, JR>();
    if constexpr (!SKIP || c != 0.0) acc = acc + pw[decltype(dd)::value] * c;
  });
  return acc;
}

// bdf.py::change_d on D[0..5] as the reference computes it: the 6 x 6
// transform (rows and columns past the order the identity) times D's first
// six rows, every product and its 0.0 added.  Taken where one of those rows
// holds an inf or a NaN, whose products with the identity's zeros are NaN,
// or where a power of the factor is not finite.
template <int N, int T>
__device__ __noinline__ void change_d_full(int order, double factor) {
  const Slots<T> D = lane_slots<T>().at(BDFCold<N>::D);
  const double f2 = factor * factor, f3 = f2 * factor;
  const double pw[6] = {0.0, factor, f2, f3, f2 * f2, f3 * f2};
  double Tm[6][6];
  static_for<0, 6>([&](auto i) {
    static_for<0, 6>([&](auto m) {
      constexpr int I = decltype(i)::value, M = decltype(m)::value;
      Tm[I][M] = (I <= order && M <= order) ? change_entry<I, M, false>(pw)
                                             : (I == M ? 1.0 : 0.0);
    });
  });
  double D6[6][N];
#pragma unroll
  for (int jr = 0; jr < 6; ++jr)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      double s = 0.0 + Tm[0][jr] * D[c];
#pragma unroll
      for (int m = 1; m < 6; ++m) s = s + Tm[m][jr] * D[m * N + c];
      D6[jr][c] = s;
    }
#pragma unroll
  for (int jr = 0; jr < 6; ++jr)
#pragma unroll
    for (int c = 0; c < N; ++c) D[jr * N + c] = D6[jr][c];
}

// bdf.py::change_d on D[0..5] for the lane's order and factor.  With D's
// first six rows and the factor's powers finite it gives the reference's
// bits from the order's rows alone and the transform's non-zero terms: a
// row r <= order sums its products over rows m <= order whose entry
// T[m][r] is not 0 for every factor (the others add +-0.0 to a sum that is
// never -0.0), each entry without its 0-coefficient terms (change_entry); a
// row past the order is D[r] + 0.0 (the identity's 1 * D[r] after +0.0).
template <int N, int T>
__device__ __forceinline__ void change_d(Slots<T> D, int order,
                                         double factor) {
  if (factor == 1.0) return;
  const double f2 = factor * factor, f3 = f2 * factor;
  const double pw[6] = {0.0, factor, f2, f3, f2 * f2, f3 * f2};
  bool finite = isfinite(pw[5]);
#pragma unroll
  for (int q = 0; q < 6 * N; ++q) finite = finite && isfinite(D[q]);
  if (!finite) {
    change_d_full<N, T>(order, factor);
    return;
  }
  double D6[6][N];
  static_for<0, 6>([&](auto jr) {
    constexpr int JR = decltype(jr)::value;
    if (JR > order) {
#pragma unroll
      for (int c = 0; c < N; ++c) D6[JR][c] = D[JR * N + c] + 0.0;
      return;
    }
    constexpr double t0 = change_coef<0, 0, JR>();
    double s[N];
#pragma unroll
    for (int c = 0; c < N; ++c) s[c] = t0 == 0.0 ? 0.0 : 0.0 + t0 * D[c];
    static_for<1, 6>([&](auto m) {
      constexpr int M = decltype(m)::value;
      if constexpr (!change_zero<M, JR>()) {
        if (M <= order) {
          const double t = change_entry<M, JR, true>(pw);
#pragma unroll
          for (int c = 0; c < N; ++c) s[c] = s[c] + t * D[M * N + c];
        }
      }
    });
#pragma unroll
    for (int c = 0; c < N; ++c) D6[JR][c] = s[c];
  });
#pragma unroll
  for (int jr = 0; jr < 6; ++jr)
#pragma unroll
    for (int c = 0; c < N; ++c) D[jr * N + c] = D6[jr][c];
}

// The Newton tolerance of a lane (lane-constant: its smallest rtol).
template <int N, class CT>
__device__ __forceinline__ CT bdf_newton_tol(const BDFOptions& o,
                                             const double* rtol) {
  double rtol_min = rtol[0];
#pragma unroll
  for (int j = 1; j < N; ++j) rtol_min = nmin(rtol_min, rtol[j]);
  rtol_min = nmax(rtol_min, BDF_EPS);
  return o.newton_tol > 0.0
             ? (CT)o.newton_tol
             : (CT)nmax((10.0 * BDF_EPS) / rtol_min, nmin(sqrt(rtol_min), 0.03));
}

// methods/bdf.py::bdf_interp: the Newton form of the step (xold, h) over
// the rows D[0..order] (a lane's Slots, row k at k N) at ti, every term
// past the order an exact 0.0 in the sum, as the reference's masked terms.
// Its divisions in O's (Ctl<double> or FastCtl<double>); the terms past the
// order, each 0.0, add as one 0.0 (which only turns a -0.0 sum into +0.0).
template <int N, class M, class O>
__device__ __forceinline__ void bdf_interp(O& op, const M& D, int order,
                                           double xold, double h, double ti,
                                           double* yi) {
  const double x_new = xold + h;
  double p = 0.0, sum[N];
#pragma unroll
  for (int j = 0; j < N; ++j) sum[j] = 0.0;
#pragma unroll
  for (int k = 0; k < bdf::MAX_ORDER; ++k) {
    if (k >= order) break;
    const double denom = h * (k + 1.0);
    const double t_shift = x_new - h * (double)k;
    const double xf = div_wide(op, ti - t_shift, denom);
    p = k == 0 ? xf : p * xf;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double term = D[(k + 1) * N + j] * p;
      sum[j] = k == 0 ? term : sum[j] + term;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (order < bdf::MAX_ORDER) sum[j] = sum[j] + 0.0;
    yi[j] = D[j] + sum[j];
  }
}

// bdf_interp on the fast paths, then once more through the library's
// divisions where an operand left their range.
template <int N, class M>
__device__ __forceinline__ void bdf_interp(const M& D, int order, double xold,
                                           double h, double ti, double* yi) {
  FastCtl<double> fast;
  bdf_interp<N>(fast, D, order, xold, h, ti, yi);
  if (!fast.ok) {
    Ctl<double> lib;
    bdf_interp<N>(lib, D, order, xold, h, ti, yi);
  }
}

// The head unit: the inverse scale at the prediction, psi and c, and
// whether the iteration matrix is rebuilt (c drifted).
template <int N, class CT>
struct BDFHead {
  CT inv_scale[N];
  double psi[N], c;
  bool rebuild;
  template <class P>
  __device__ __forceinline__ void run(P& op, const double* sc,
                                      const double* psum, double alpha_ord,
                                      double h_signed, bool lu_current,
                                      double current_c) {
    const auto da = op.d.divisor(alpha_ord);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      inv_scale[j] = (CT)op.d.div(1.0, sc[j]);
      psi[j] = div_by_wide(op.d, psum[j], da);
    }
    c = div_by_wide(op.d, h_signed, da);
    rebuild = !lu_current ||
              div_wide(op.d, fabs(c - current_c), nmax(fabs(c), 1.0)) > 0.1;
  }
};

// One Newton iteration's rate unit: the increment's norm, and whether the
// iteration converged or its rate is bad.
template <class CT>
struct BDFRate {
  CT dy_norm;
  bool converged, rate_bad;
  template <int N, class O>
  __device__ __forceinline__ void run(O& op, const double* dy,
                                      const CT* inv_scale, CT prev, int it,
                                      int maxit, CT newton_tol) {
    const CT tiny = tiny_of<CT>();
    dy_norm = rms_scaled<N, CT>(op, dy, (CT)1, inv_scale);
    const bool zero = dy_norm == (CT)0;
    // The rate is read only once there is a previous norm above 0; its
    // power (rem products from rate) only where the rate is below 1 and the
    // iteration has not converged.  Every operand that no output reads is a
    // constant in range.
    const bool use = !zero && prev >= (CT)0 && prev > (CT)0;
    const CT rate = div_wide(op, use ? dy_norm : (CT)0,
                             use ? op.vmax(prev, tiny) : (CT)1);
    const bool below = use && !(rate >= (CT)1);
    const CT one_m = below ? op.vmax(op.sub((CT)1, rate), tiny) : (CT)1;
    const CT est1 = op.mul(div_wide(op, below ? rate : (CT)0, one_m), dy_norm);
    const bool conv = rate < (CT)1 && est1 < newton_tol;
    const bool power = below && !conv;
    const int rem_i = power ? maxit - it : 0;
    CT rate_rem = rate;
    for (int k = 2; k <= rem_i; ++k) rate_rem = op.mul(rate_rem, rate);
    const CT est_rem =
        op.mul(div_wide(op, power ? rate_rem : (CT)0, one_m), dy_norm);
    converged = zero || (below && conv);
    rate_bad = use && (!below || (power && est_rem > newton_tol));
  }
};

// The tail unit after the Newton loop: the error and, after order+1 equal
// accepted steps, the order selection's norms, logs and exps (the
// library's on either path), the step factor of every outcome, the next
// step's clamps and change_d's factor.
template <int N, class CT>
struct BDFTail {
  CT error_norm;
  bool accepted, err_reject, adapt, clamp_changed;
  int new_order;
  double h1, factor;
  template <int T, class P>
  __device__ __forceinline__ void run(
      P& op, const BDFLane<N, T>& L, const double* y_new, const double* delta,
      const double* rtol, const double* atol, bool converged, bool last,
      CT n_iter, int maxit, double t, double x_new, double tend, double hmax,
      double hmin) {
    constexpr int MO = bdf::MAX_ORDER;
    const int order = L.order;
    const double h_abs = L.h_abs, posneg = L.posneg;
    CT inv_scale2[N];
    error_norm = 0;
    accepted = false;
    err_reject = false;
    if (converged) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        double sc = atol[j] + rtol[j] * fabs(y_new[j]);
        if (sc == 0.0) sc = BDF_EPS;
        inv_scale2[j] = (CT)op.d.div(1.0, sc);
      }
      const CT ec_ord = (CT)bdf::ERROR_CONST[order];
      error_norm = rms_scaled<N, CT>(op.c, delta, ec_ord, inv_scale2);
      accepted = error_norm <= (CT)1;
      err_reject = error_norm > (CT)1;
    }
    const auto safety = [&]() {
      return op.c.div((CT)(0.9 * (2.0 * maxit + 1.0)),
                      op.c.add(op.c.add((CT)(2.0 * maxit), n_iter), (CT)1));
    };
    const auto log_factor = [&](CT e, int k) {
      const CT ec = op.c.vmin(op.c.vmax(e, (CT)1e-30), (CT)1e30);
      return op.c.mul(op.c.div((CT)-1, op.c.add((CT)order, (CT)k)),
                      op.c.log(ec));
    };
    const bool finished = accepted && last;
    adapt = accepted && L.n_equal + 1 >= order + 1 && !finished;
    new_order = order;
    CT fac_case;
    if (adapt) {
      double row_ord[N], row_op2[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        row_ord[j] = (L.d(order, j) + 0.0) + delta[j];
        row_op2[j] = delta[j] - (L.d(order + 1, j) + 0.0);
      }
      const CT inf = (CT)INFINITY;
      const CT err_m = order > 1 ? rms_scaled<N, CT>(op.c, row_ord, (CT)bdf::ERROR_CONST[order - 1], inv_scale2) : inf;
      const CT err_p = order < MO ? rms_scaled<N, CT>(op.c, row_op2, (CT)bdf::ERROR_CONST[order + 1], inv_scale2) : inf;
      const CT errs[3] = {err_m, error_norm, err_p};
      CT lf[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) lf[k] = log_factor(errs[k], k);
      int best = 0;
      CT lmax = lf[0];
#pragma unroll
      for (int k = 1; k < 3; ++k) {
        const bool nan_k = lf[k] != lf[k], nan_b = lmax != lmax;
        if (!nan_b && (nan_k || lf[k] > lmax)) {
          lmax = lf[k];
          best = k;
        }
      }
      new_order = order + (best - 1);
      new_order = new_order < 1 ? 1 : (new_order > MO ? MO : new_order);
      fac_case = op.c.vmin(op.c.mul(safety(), op.c.exp(lmax)), (CT)10);
    } else if (accepted) {
      fac_case = (CT)1;
    } else if (!converged) {
      fac_case = (CT)0.5;
    } else {
      fac_case = op.c.vmax(
          op.c.mul(safety(), op.c.exp(log_factor(error_norm, 1))), (CT)0.2);
    }
    // One rescale for every outcome and the next step's clamps.
    const double t_next = accepted ? x_new : t;
    const double h_des = h_abs * (double)fac_case;
    h1 = nmin(h_des, hmax);
    if (h1 < hmin && hmin > 0.0) h1 = hmin;
    if (posneg * (t_next + posneg * h1 - tend) > 0.0) h1 = fabs(tend - t_next);
    clamp_changed = h1 != h_des;
    // A step that stays (h1 == h_abs, a normal finite number) has factor
    // h1 / h_abs == 1 exactly.
    const bool stays = h1 == h_abs && h_abs >= 1e-300 && h_abs < INFINITY;
    const double q = op.d.div(stays ? 1.0 : h1,
                              stays ? 1.0 : nmax(h_abs, 1e-300));
    factor = stays ? 1.0 : q;
  }
};

// One attempt of methods/bdf.py::make_bdf_attempt on lane L at (t, y), up to
// change_d: the caller rescales D by factor (change_d) after it has read
// the accepted step's dense output from D.  Its divisions and square roots
// run in four units (the head, the decomposition, each Newton iteration's
// rate, the tail), each on the fast paths with one branch to the library's
// (FastOps); the rest is the reference's order of operations.
template <class F, class CT, int T>
__device__ __forceinline__ int bdf_attempt(
    const F& f, const double* a, double& t, double* y, BDFLane<F::N, T>& L,
    const BDFOptions& o, const double* rtol, const double* atol,
    CT newton_tol, double tend, double hmax, double hmin, bool& accepted,
    bool& finished, bool& count_step, bool& count_reject, int& nfev,
    int& njev, int& nlu, double& factor) {
  constexpr int N = F::N;
  using K = BDFCold<N>;
  const Slots<T> s = L.s;
  slots_fence();
  const int maxit = o.newton_maxiter;
  const double posneg = L.posneg, h_abs = L.h_abs;
  const int order = L.order;
  const double h_signed = posneg * h_abs;
  const bool last = posneg * (t + h_signed - tend) >= 0.0;
  const double x_new = last ? tend : t + h_signed;
  const bool too_small = h_abs < 1e-290 || (t + 0.1 * fabs(h_signed)) == t;

  // ---- Predictor and psi ----
  double y_predict[N], sc[N], psum[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    double sp = L.d(0, j), p = 0.0;
    for (int k = 1; k <= order; ++k) {
      const double dk = L.d(k, j);
      sp = sp + dk;
      const double g = bdf::GAMMA[k] * dk;
      p = k == 1 ? g : p + g;
    }
    y_predict[j] = sp;
    sc[j] = atol[j] + rtol[j] * fabs(sp);
    if (sc[j] == 0.0) sc[j] = BDF_EPS;
    psum[j] = p;
  }
  BDFHead<N, CT> hd;
  run_unit<CT>([&](auto& op) {
    hd.run(op, sc, psum, bdf::ALPHA[order] + 0.0, h_signed, L.lu_current,
           L.current_c);
  });
  const double c = hd.c;
  const double* psi = hd.psi;
  const CT* inv_scale = hd.inv_scale;

  // ---- The iteration matrix, rebuilt when c drifts ----
  bool sing = false;
  nlu = 0;
  if (hd.rebuild) {
    double m[N * N], inv[N * N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        m[i * N + j] = (i == j ? 1.0 : 0.0) - c * s[K::JAC + i * N + j];
    sing = inv_real<N>(m, inv);
#pragma unroll
    for (int q = 0; q < N * N; ++q) s[K::INV + q] = inv[q];
    nlu = 1;
    L.current_c = c;
  }
  const bool lu_current = L.lu_current || hd.rebuild;

  // ---- Simplified Newton ----
  double y_new[N], delta[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    y_new[j] = y_predict[j];
    delta[j] = 0.0;
  }
  CT prev = (CT)-1;
  int it = 0;
  int done = (sing || too_small) ? 2 : 0;
  nfev = 0;
  while (done == 0) {
    if (it >= maxit) {
      done = 2;
      break;
    }
    double fv[N], rv[N], dy[N];
    f(x_new, y_new, fv, a);
#pragma unroll
    for (int j = 0; j < N; ++j) rv[j] = c * fv[j] - psi[j] - delta[j];
    matvec<N>(s.at(K::INV), rv, dy);
    BDFRate<CT> r;
    run_unit<CT>([&](auto& op) {
      r.template run<N>(op.c, dy, inv_scale, prev, it, maxit, newton_tol);
    });
    done = r.converged ? 1 : (r.rate_bad ? 2 : 0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      y_new[j] = y_new[j] + dy[j];
      delta[j] = delta[j] + dy[j];
    }
    prev = r.dy_norm;
    if (done == 0) it += 1;
    nfev += 1;
  }
  slots_fence();
  const bool converged = done == 1;
  const bool newton_fail = !converged;

  // ---- A Newton failure refreshes the Jacobian ----
  njev = 0;
  if (newton_fail && !too_small) {
    double J[N * N];
    f.jac(x_new, y_predict, J, a);
#pragma unroll
    for (int q = 0; q < N * N; ++q) s[K::JAC + q] = J[q];
    njev = o.const_jac ? 0 : 1;
  }
  // ---- The error, the order and step adaptation, the rescale ----
  BDFTail<N, CT> tl;
  run_unit<CT>([&](auto& op) {
    tl.run(op, L, y_new, delta, rtol, atol, converged, last, (CT)it, maxit, t,
           x_new, tend, hmax, hmin);
  });
  accepted = tl.accepted;
  finished = accepted && last;
  if (tl.adapt && tl.new_order != order) {
    double J[N * N];
    f.jac(x_new, y_new, J, a);
#pragma unroll
    for (int q = 0; q < N * N; ++q) s[K::JAC + q] = J[q];
    njev += o.const_jac ? 0 : 1;
  }
  if (accepted) {
    // The difference array: D[order+2] = delta - D[order+1],
    // D[order+1] = delta, and D[k] = D[k] + (D[k+1] + ... + (delta + 0.0))
    // for k <= order, the reference's suffix sums.
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double op1 = L.d(order + 1, j) + 0.0;
      L.d(order + 2, j) = delta[j] - op1;
      L.d(order + 1, j) = delta[j];
      double sk = delta[j] + 0.0;
      for (int k = order; k >= 0; --k) {
        sk = L.d(k, j) + sk;
        L.d(k, j) = sk;
      }
    }
  }
  factor = tl.factor;
  const double h1 = tl.h1;
  L.n_equal = (accepted && !tl.adapt && !tl.clamp_changed) ? L.n_equal + 1 : 0;
  L.lu_current = lu_current && !newton_fail && !tl.adapt && !tl.clamp_changed;
  L.order = tl.adapt ? tl.new_order : order;
  L.h_abs = h1;
  bool finite_y = true;
#pragma unroll
  for (int j = 0; j < N; ++j) finite_y = finite_y && isfinite(y_new[j]);
  const bool dead = !isfinite(h1) || (accepted && !finite_y);
  if (accepted) {
    t = x_new;
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = y_new[j];
  }
  count_step = !too_small;
  count_reject = (newton_fail || tl.err_reject) && !too_small;
  return (too_small || dead) ? STEP_SIZE_TOO_SMALL : RUNNING;
}

// methods/bdf.py::make_bdf_init on lane L at (t, y) with its first step fs
// (NaN: hinit's) and tolerances: a solve's first launch and an event
// restart (core/driver.py::step_body, first step NaN) run it.  Returns its
// RHS evaluations (1, or 2 with hinit's); its Jacobian is counted by the
// restart only (the driver's init_njev).
template <class F, int T>
__device__ __forceinline__ int bdf_init(const F& f, const double* a,
                                        double t, const double* y, double fs,
                                        double tend, double hmax,
                                        const double* rtol,
                                        const double* atol,
                                        BDFLane<F::N, T>& L) {
  constexpr int N = F::N;
  using K = BDFCold<N>;
  const Slots<T> s = L.s;
  int nfev;
  L.posneg = sgn(tend - t);
  double f0[N], J[N * N];
  f(t, y, f0, a);
  f.jac(t, y, J, a);
  if (!isnan(fs)) {
    L.h_abs = fabs(fs);
    nfev = 1;
  } else {
    L.h_abs =
        fabs(hinit<F, true>(f, t, y, L.posneg, f0, 1, hmax, atol, rtol, a));
    nfev = 2;
  }
  L.h_abs = nmin(nmin(L.h_abs, fabs(tend - t)), hmax);
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int k = 2; k < BDF_ROWS; ++k) L.d(k, j) = 0.0;
    L.d(0, j) = y[j];
    L.d(1, j) = f0[j] * (L.h_abs * L.posneg);
  }
#pragma unroll
  for (int q = 0; q < N * N; ++q) {
    s[K::JAC + q] = J[q];
    s[K::INV + q] = 0.0;
  }
  L.order = 1;
  L.n_equal = 0;
  L.lu_current = false;
  L.current_c = 0.0;
  return nfev;
}

// The doubles of a lane's slots: BDFCold's, and with an event set its event
// state (EvSlots).
template <class F, class EV>
__host__ __device__ constexpr int bdf_slots() {
  return BDFCold<F::N>::DOUBLES + EvSlots<EV::E, 0>::DOUBLES;
}

// The kernel of a mode, and with an event set EV (EV::E > 0) its event mode
// (stiff_events.cuh; ev its buffers, and in RECORD its carry between
// chunks); with NoEvents the event code compiles away.
template <class F, class CT, int T, int MB, int MODE, class EV = NoEvents>
__global__ void __launch_bounds__(T, MB) bdf_kernel(
    int B, const double* __restrict__ y0, const double* __restrict__ t0,
    const double* __restrict__ first_step, const StiffRun ra,
    const double* __restrict__ args, const BDFOptions o,
    const StiffDriver d_in, const BDFCarry c_in, StiffDriver d, BDFCarry c,
    int init, int max_attempts, const StiffModes md, const ErkEvents ev) {
  constexpr int N = F::N;
  constexpr int NE = EV::E;
  using K = BDFCold<N>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const F f{};
  double a[F::NARGS > 0 ? F::NARGS : 1];
#pragma unroll
  for (int j = 0; j < F::NARGS; ++j) a[j] = args[(size_t)i * F::NARGS + j];
  double rtol[N], atol[N], y[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    rtol[j] = ra.rtol[(size_t)i * N + j];
    atol[j] = ra.atol[(size_t)i * N + j];
  }
  const double tend = ra.tend[i], hmax = fabs(ra.hmax[i]), hmin = fabs(ra.hmin[i]);
  BDFLane<N, T> L;
  L.s = lane_slots<T>();
  const Slots<T> s = L.s;
  double t;
  int status, nfev, njev, nlu, nstep, naccpt, nrejct;
  if (init) {
    // methods/bdf.py::make_bdf_init, then the driver's init_carry.
    t = t0[i];
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = y0[(size_t)i * N + j];
    nfev = bdf_init<F, T>(f, a, t, y, first_step[i], tend, hmax, rtol, atol,
                          L);
    status = fabs(tend - t) < 1e-15 ? SUCCESS : RUNNING;
    njev = nlu = nstep = naccpt = nrejct = 0;
  } else {
    t = d_in.t[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      y[j] = d_in.y[(size_t)i * N + j];
#pragma unroll
      for (int k = 0; k < BDF_ROWS; ++k)
        L.d(k, j) = c_in.D[((size_t)i * BDF_ROWS + k) * N + j];
    }
#pragma unroll
    for (int q = 0; q < N * N; ++q) {
      s[K::JAC + q] = c_in.jac[(size_t)i * N * N + q];
      s[K::INV + q] = c_in.inv[(size_t)i * N * N + q];
    }
    L.h_abs = c_in.h_abs[i];
    L.posneg = c_in.posneg[i];
    L.order = c_in.order[i];
    L.n_equal = c_in.n_equal[i];
    L.lu_current = c_in.lu_current[i] != 0;
    L.current_c = c_in.current_c[i];
    status = d_in.status[i];
    nfev = d_in.nfev[i];
    njev = d_in.njev[i];
    nlu = d_in.nlu[i];
    nstep = d_in.nstep[i];
    naccpt = d_in.naccpt[i];
    nrejct = d_in.nrejct[i];
  }

  const CT newton_tol = bdf_newton_tol<N, CT>(o, rtol);
  const int nstep0 = nstep;
  const EV evf{};
  if constexpr (NE > 0) ev_load<EV, T, K::DOUBLES>(evf, ev, s, i, init, t, y, a);
  // RECORD stages its rows in the shared memory past the slots.
  using Stage = std::conditional_t<MODE == STIFF_RECORD,
                                   SlotsStage<T, bdf_slots<F, EV>()>, NoStage>;
  StiffOut<N, BDF_COEFFS, MODE, Stage> out(md, i, init);
  while (status == RUNNING && nstep - nstep0 < max_attempts && !out.full()) {
    bool accepted, finished, count_step, count_reject;
    int fe, je, le;
    double factor;
    const double xold = t, h_signed = L.posneg * L.h_abs;
    const int order = L.order;
    double y_old[NE > 0 ? N : 1];
    if constexpr (NE > 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) y_old[j] = y[j];
    }
    int st = bdf_attempt<F, CT, T>(f, a, t, y, L, o, rtol, atol, newton_tol,
                                   tend, hmax, hmin, accepted, finished,
                                   count_step, count_reject, fe, je, le,
                                   factor);
    const Slots<T> D = s.at(K::D);
    const auto interp = [&](double ti, double* yi) {
      bdf_interp<N>(D, order, xold, h_signed, ti, yi);
    };
    // ---- The accepted step's events from D, before change_d ----
    EvOutcome eo;
    if constexpr (NE > 0) {
      // A terminal or restarting event's time and state become the step's
      // end.
      if (accepted) {
        double yev[N];
        eo = ev_step<N, EV, T, K::DOUBLES>(evf, ev, s, i, a, xold, y_old, t,
                                            y, L.posneg, tend, interp, yev);
        if (eo.terminal || eo.restart) {
          t = eo.t_ev;
#pragma unroll
          for (int j = 0; j < N; ++j) y[j] = yev[j];
        }
      }
    }
    // ---- The accepted step's dense output from D, then change_d ----
    if constexpr (MODE != STIFF_LEAN) {
      if (accepted) {
        out.record(t, xold, h_signed, y, [&](int q, int j) {
          return q == 0 ? D[j]
                 : q <= bdf::MAX_ORDER ? (q <= order ? D[q * N + j] : 0.0)
                                       : (double)order;
        });
        out.samples(t, L.posneg, interp);
      }
    }
    // A restart's init at the event point replaces D (and the rest of the
    // method's state) whole, after the step's row and samples have read it.
    if (eo.restart) {
      if constexpr (NE > 0) {
        fe += bdf_init<F, T>(f, a, t, y, NAN, tend, hmax, rtol, atol, L);
        je += o.const_jac ? 0 : 1;
      }
    } else {
      change_d<N, T>(s.at(K::D), L.order, factor);
    }
    nstep += count_step ? 1 : 0;
    naccpt += accepted ? 1 : 0;
    nrejct += count_reject ? 1 : 0;
    nfev += fe;
    njev += je;
    nlu += le;
    if (st == RUNNING && eo.terminal) st = USER_INTERRUPT;
    if (st == RUNNING && finished && !eo.restart) st = SUCCESS;
    if (st == RUNNING && nstep > ra.max_steps) st = NEED_LARGER_NMAX;
    status = st;
  }
  out.store();
  if constexpr (NE > 0) ev_store<NE, T, K::DOUBLES>(ev, s, i);

  d.t[i] = t;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    d.y[(size_t)i * N + j] = y[j];
#pragma unroll
    for (int k = 0; k < BDF_ROWS; ++k)
      c.D[((size_t)i * BDF_ROWS + k) * N + j] = L.d(k, j);
  }
#pragma unroll
  for (int q = 0; q < N * N; ++q) {
    c.jac[(size_t)i * N * N + q] = s[K::JAC + q];
    c.inv[(size_t)i * N * N + q] = s[K::INV + q];
  }
  c.h_abs[i] = L.h_abs;
  c.posneg[i] = L.posneg;
  c.order[i] = L.order;
  c.n_equal[i] = L.n_equal;
  c.lu_current[i] = L.lu_current;
  c.current_c[i] = L.current_c;
  d.status[i] = status;
  d.done[i] = status != RUNNING;
  d.nfev[i] = nfev;
  d.njev[i] = njev;
  d.nlu[i] = nlu;
  d.nstep[i] = nstep;
  d.naccpt[i] = naccpt;
  d.nrejct[i] = nrejct;
}

// The instantiation a launch of B lanes takes: (T, MB1) when all its
// blocks are resident at once under it (ceil(B / T) <= MB1 x SMs), where
// more blocks an SM cannot shorten the launch and the registers MB allows
// would spill; else (T, MB).  In every mode.
using BDFKernelPtr = void (*)(int, const double*, const double*,
                              const double*, StiffRun, const double*,
                              BDFOptions, StiffDriver, BDFCarry, StiffDriver,
                              BDFCarry, int, int, StiffModes, ErkEvents);

template <class F, class CT, int T, int MB, int MB1, int MODE,
          class EV = NoEvents>
int bdf_pick(int B, int* min_blocks, BDFKernelPtr* kernel) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const bool one_round = (B + T - 1) / T <= MB1 * sms;
  *min_blocks = one_round ? MB1 : MB;
  *kernel = one_round ? bdf_kernel<F, CT, T, MB1, MODE, EV>
                      : bdf_kernel<F, CT, T, MB, MODE, EV>;
  return 0;
}

// A RECORD launch's stage, at the picked instantiation's min blocks, beside
// the slots of the event set EV's lanes.
template <class F, int T, class EV = NoEvents>
int bdf_stage(int B, int min_blocks, bool record_cont, int* bytes, int* k) {
  return record_stage<T, bdf_slots<F, EV>(), F::N, BDF_COEFFS>(
      B, min_blocks, record_cont, bytes, k);
}

template <class F, class CT, int T, int MB, int MB1, int MODE, class EV>
int bdf_launch_as(int B, const double* y0, const double* t0,
                  const double* first_step, StiffRun ra, const double* args,
                  BDFOptions o, StiffDriver d_in, BDFCarry c_in, StiffDriver d,
                  BDFCarry c, int init, int max_attempts, StiffModes md,
                  ErkEvents ev, void* stream) {
  constexpr int bytes = 8 * bdf_slots<F, EV>() * T;
  static_assert(bytes <= SLOTS_BLOCK_MAX, "the slots exceed a block's");
  int min_blocks = 0, smem = bytes, k = 0;
  BDFKernelPtr kernel = nullptr;
  int err = bdf_pick<F, CT, T, MB, MB1, MODE, EV>(B, &min_blocks, &kernel);
  if constexpr (MODE == STIFF_RECORD) {
    // The bulk copies take rows of the stride the stage has, 16-byte
    // aligned.
    if (md.stride != row_stride(F::N, BDF_COEFFS, md.record_cont != 0) ||
        ((uintptr_t)md.rows & 15) != 0)
      return (int)cudaErrorInvalidValue;
    if (!err)
      err = bdf_stage<F, T, EV>(B, min_blocks, md.record_cont != 0, &smem,
                                &k);
  }
  if (!err) err = allow_slots(kernel, smem);
  if (err) return err;
  kernel<<<(B + T - 1) / T, T, smem, (cudaStream_t)stream>>>(
      B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
      max_attempts, md, ev);
  return (int)cudaGetLastError();
}

// T, MB: threads a block and min blocks an SM; MB1: min blocks of the
// one-round instantiation (bdf_pick); under either controller type and in
// every mode, with the event set EV.
template <class F, int T, int MB, int MB1, int MODE, class EV = NoEvents>
int bdf_launch(int B, const double* y0, const double* t0,
               const double* first_step, StiffRun ra, const double* args,
               BDFOptions o, StiffDriver d_in, BDFCarry c_in, StiffDriver d,
               BDFCarry c, int init, int max_attempts, StiffModes md,
               ErkEvents ev, void* stream) {
  if (B <= 0) return 0;
  if (o.state_precision)
    return bdf_launch_as<F, double, T, MB, MB1, MODE, EV>(
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
        max_attempts, md, ev, stream);
  return bdf_launch_as<F, float, T, MB, MB1, MODE, EV>(
      B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
      max_attempts, md, ev, stream);
}

// A SAMPLED or RECORD launch: RECORD where md has rows (cap > 0); with an
// event set (EV::E > 0) also LEAN, where md has neither rows nor a grid.
template <class F, int T, int MB, int MB1, class EV = NoEvents>
int bdf_modes_launch(int B, const double* y0, const double* t0,
                     const double* first_step, StiffRun ra,
                     const double* args, BDFOptions o, StiffDriver d_in,
                     BDFCarry c_in, StiffDriver d, BDFCarry c, int init,
                     int max_attempts, StiffModes md, ErkEvents ev,
                     void* stream) {
  if (md.cap > 0)
    return bdf_launch<F, T, MB, MB1, STIFF_RECORD, EV>(
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
        max_attempts, md, ev, stream);
  if (EV::E > 0 && md.m == 0)
    return bdf_launch<F, T, MB, MB1, STIFF_LEAN, EV>(
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
        max_attempts, md, ev, stream);
  return bdf_launch<F, T, MB, MB1, STIFF_SAMPLED, EV>(
      B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
      max_attempts, md, ev, stream);
}

// slots_layout of the instantiation a launch of B lanes takes, with its
// RECORD stage (rows with coefficients or without) in the lane's and the
// block's bytes.
template <class F, class CT, int T, int MB, int MB1, int MODE>
int bdf_layout_as(int B, int record_cont, int* info) {
  int min_blocks = 0, bytes = 8 * BDFCold<F::N>::DOUBLES * T, k = 0;
  BDFKernelPtr kernel = nullptr;
  int err = bdf_pick<F, CT, T, MB, MB1, MODE>(B, &min_blocks, &kernel);
  if constexpr (MODE == STIFF_RECORD)
    if (!err)
      err = bdf_stage<F, T>(B, min_blocks, record_cont != 0, &bytes, &k);
  if (err) return err;
  return slots_layout(kernel, T, min_blocks, bytes / T, info);
}

template <class F, int T, int MB, int MB1, int MODE>
int bdf_layout(int state_precision, int B, int record_cont, int* info) {
  if (state_precision)
    return bdf_layout_as<F, double, T, MB, MB1, MODE>(B, record_cont, info);
  return bdf_layout_as<F, float, T, MB, MB1, MODE>(B, record_cont, info);
}

// The layout of a mode's instantiation, then info[7] the stage's rows a
// lane and info[8] its bytes a lane (0 and 0 unstaged).
template <class F, int T, int MB, int MB1>
int bdf_modes_layout(int mode, int state_precision, int B, int* info,
                     int record_cont) {
  const int err =
      mode == STIFF_RECORD
          ? bdf_layout<F, T, MB, MB1, STIFF_RECORD>(state_precision, B,
                                                    record_cont, info)
      : mode == STIFF_SAMPLED
          ? bdf_layout<F, T, MB, MB1, STIFF_SAMPLED>(state_precision, B, 0,
                                                     info)
          : bdf_layout<F, T, MB, MB1, STIFF_LEAN>(state_precision, B, 0,
                                                  info);
  if (err) return err;
  stage_info<BDFCold<F::N>::DOUBLES, F::N, BDF_COEFFS>(record_cont != 0,
                                                       info);
  return 0;
}

}  // namespace ivp

// One C entry per RHS functor with a Jacobian: ivp_bdf_<name> (the carry it
// loads, d_in and c_in, and the one it stores, d and c), ivp_bdf_modes_<name>
// (the same with the samples or rows of md), and ivp_bdf_layout_<name> /
// ivp_bdf_modes_layout_<name> (slots_layout of the instantiation a launch
// of B lanes under a controller type, in a mode, takes; RECORD with the
// stage of rows with coefficients or without, record_cont).  T, MB and MB1
// (one round, bdf_pick): threads a block and min blocks an SM under both
// controller types, from measure_kernel.py's stiff occupancy sweep on an
// H100 (PERF.md).
#define IVP_BDF_ENTRY(NAME, FUNCTOR, T, MB, MB1)                              \
  extern "C" int ivp_bdf_##NAME(                                              \
      int B, const double* y0, const double* t0, const double* first_step,    \
      ivp::StiffRun ra, const double* args, ivp::BDFOptions o,                \
      ivp::StiffDriver d_in, ivp::BDFCarry c_in, ivp::StiffDriver d,          \
      ivp::BDFCarry c, int init, int max_attempts, void* stream) {            \
    return ivp::bdf_launch<FUNCTOR, IVP_BDF_BOUNDS(T, MB, MB1),               \
                           ivp::STIFF_LEAN>(                                  \
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,           \
        max_attempts, ivp::StiffModes{}, ivp::ErkEvents{}, stream);           \
  }                                                                           \
  extern "C" int ivp_bdf_modes_##NAME(                                        \
      int B, const double* y0, const double* t0, const double* first_step,    \
      ivp::StiffRun ra, const double* args, ivp::BDFOptions o,                \
      ivp::StiffDriver d_in, ivp::BDFCarry c_in, ivp::StiffDriver d,          \
      ivp::BDFCarry c, int init, int max_attempts, ivp::StiffModes md,        \
      void* stream) {                                                         \
    return ivp::bdf_modes_launch<FUNCTOR, IVP_BDF_BOUNDS(T, MB, MB1)>(        \
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,           \
        max_attempts, md, ivp::ErkEvents{}, stream);                          \
  }                                                                           \
  extern "C" int ivp_bdf_layout_##NAME(int state_precision, int B,            \
                                       int* info) {                           \
    return ivp::bdf_layout<FUNCTOR, IVP_BDF_BOUNDS(T, MB, MB1),               \
                           ivp::STIFF_LEAN>(state_precision, B, 0, info);     \
  }                                                                           \
  extern "C" int ivp_bdf_modes_layout_##NAME(int mode, int state_precision,   \
                                             int B, int* info,                \
                                             int record_cont) {               \
    return ivp::bdf_modes_layout<FUNCTOR, IVP_BDF_BOUNDS(T, MB, MB1)>(        \
        mode, state_precision, B, info, record_cont);                         \
  }

// One C entry per RHS functor and event set (bdf_ev.cu):
// ivp_bdf_ev_<name>_<set>, the modes' entry with the set's event buffers ev
// (kernels/erk_ensemble.py::KernelEvents; the values and hit counts kept
// between a record solve's chunks), in LEAN where md has neither a grid nor
// rows.  T, MB, MB1 as the functor's IVP_BDF_ENTRY.
#define IVP_BDF_EVENT_ENTRY(NAME, FUNCTOR, SET, EVENTS, T, MB, MB1)           \
  extern "C" int ivp_bdf_ev_##NAME##_##SET(                                   \
      int B, const double* y0, const double* t0, const double* first_step,    \
      ivp::StiffRun ra, const double* args, ivp::BDFOptions o,                \
      ivp::StiffDriver d_in, ivp::BDFCarry c_in, ivp::StiffDriver d,          \
      ivp::BDFCarry c, int init, int max_attempts, ivp::StiffModes md,        \
      ivp::ErkEvents ev, void* stream) {                                      \
    return ivp::bdf_modes_launch<FUNCTOR, IVP_BDF_BOUNDS(T, MB, MB1),         \
                                 EVENTS>(                                     \
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,           \
        max_attempts, md, ev, stream);                                        \
  }
