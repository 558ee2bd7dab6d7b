// The variable-order BDF ensemble solve, float64, one thread a lane: the
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
// Same carry, init, budget and modes as radau.cu; no FMA contraction.  A
// SAMPLED or RECORD lane emits from inside the attempt, once the accepted
// step has updated D and before change_d rescales it: its dense output is
// the Newton form over D[0..order] (bdf_interp), its row's coefficients
// [D0, D1..D5 past the order 0, order] (NCOEFF 7).
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
// transform that the order reaches.
#include "stiff_common.cuh"

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

template <int N, class CT>
__device__ __forceinline__ CT rms_scaled(const double* v, CT w,
                                         const CT* inv_scale) {
  using C = Ctl<CT>;
  CT s = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const CT q = C::mul(C::mul(w, (CT)v[j]), inv_scale[j]);
    s = j ? C::add(s, C::mul(q, q)) : C::mul(q, q);
  }
  return C::sqrt(s / (CT)N);
}

// bdf.py::change_d on D[0..5] as the reference computes it: the 6 x 6
// transform (rows and columns past the order the identity) times D's first
// six rows, every product and its 0.0 added.  Taken where one of those rows
// holds an inf or a NaN, whose products with the identity's zeros are NaN.
template <int N, int T>
__device__ __noinline__ void change_d_full(int order, double factor) {
  const Slots<T> D = lane_slots<T>().at(BDFCold<N>::D);
  const double f2 = factor * factor, f3 = f2 * factor;
  const double pw[6] = {0.0, factor, f2, f3, f2 * f2, f3 * f2};
  double Tm[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      double acc = bdf::CHANGE_D_C[0][i][m];
#pragma unroll
      for (int dd = 1; dd <= i; ++dd) acc = acc + pw[dd] * bdf::CHANGE_D_C[dd][i][m];
      Tm[i][m] = (i <= order && m <= order) ? acc : (i == m ? 1.0 : 0.0);
    }
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
// first six rows finite it gives the reference's bits from the order's
// rows alone: a row r <= order sums its products over rows m <= order (the
// rows past the order add 0 * D = +-0 to a sum that is never -0.0), a row
// past the order is D[r] + 0.0 (the identity's 1 * D[r] after +0.0).  The
// transform is built a column at a time, each entry once.
template <int N, int T>
__device__ __forceinline__ void change_d(Slots<T> D, int order,
                                         double factor) {
  if (factor == 1.0) return;
  bool finite = true;
#pragma unroll
  for (int q = 0; q < 6 * N; ++q) finite = finite && isfinite(D[q]);
  if (!finite) {
    change_d_full<N, T>(order, factor);
    return;
  }
  const double f2 = factor * factor, f3 = f2 * factor;
  const double pw[6] = {0.0, factor, f2, f3, f2 * f2, f3 * f2};
  double D6[6][N];
#pragma unroll
  for (int jr = 0; jr < 6; ++jr) {
    if (jr > order) {
#pragma unroll
      for (int c = 0; c < N; ++c) D6[jr][c] = D[jr * N + c] + 0.0;
      continue;
    }
    double Tc[6];  // the transform's column jr: T[m][jr], m <= order
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      if (m > order) continue;
      double acc = bdf::CHANGE_D_C[0][m][jr];
#pragma unroll
      for (int dd = 1; dd <= m; ++dd)
        acc = acc + pw[dd] * bdf::CHANGE_D_C[dd][m][jr];
      Tc[m] = acc;
    }
#pragma unroll
    for (int c = 0; c < N; ++c) {
      double s = 0.0 + Tc[0] * D[c];
#pragma unroll
      for (int m = 1; m < 6; ++m)
        if (m <= order) s = s + Tc[m] * D[m * N + c];
      D6[jr][c] = s;
    }
  }
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
template <int N, class M>
__device__ __forceinline__ void bdf_interp(const M& D, int order, double xold,
                                           double h, double ti, double* yi) {
  const double x_new = xold + h;
  double p = 0.0, sum[N];
#pragma unroll
  for (int k = 0; k < bdf::MAX_ORDER; ++k) {
    const double denom = h * (k + 1.0);
    const double t_shift = x_new - h * (double)k;
    const double xf = (ti - t_shift) / denom;
    p = k == 0 ? xf : p * xf;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double term = k < order ? D[(k + 1) * N + j] * p : 0.0;
      sum[j] = k == 0 ? term : sum[j] + term;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) yi[j] = D[j] + sum[j];
}

// One attempt of methods/bdf.py::make_bdf_attempt on lane L at (t, y).  An
// accepted step calls emit(x_new, t, h_signed, y_new, order) with D updated
// and not yet rescaled.
template <class F, class CT, int T, class Emit>
__device__ __forceinline__ int bdf_attempt(
    const F& f, const double* a, double& t, double* y, BDFLane<F::N, T>& L,
    const BDFOptions& o, const double* rtol, const double* atol,
    CT newton_tol, double tend, double hmax,
    double hmin, bool& accepted, bool& finished, bool& count_step,
    bool& count_reject, int& nfev, int& njev, int& nlu, const Emit& emit) {
  constexpr int N = F::N;
  constexpr int MO = bdf::MAX_ORDER;
  using C = Ctl<CT>;
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
  double y_predict[N], psi[N];
  CT inv_scale[N];
  const double alpha_ord = bdf::ALPHA[order] + 0.0;
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
    double sc = atol[j] + rtol[j] * fabs(sp);
    if (sc == 0.0) sc = BDF_EPS;
    inv_scale[j] = (CT)(1.0 / sc);
    psi[j] = p / alpha_ord;
  }
  const double c = h_signed / alpha_ord;

  // ---- The iteration matrix, rebuilt when c drifts ----
  const bool rebuild =
      !L.lu_current || fabs(c - L.current_c) / nmax(fabs(c), 1.0) > 0.1;
  bool sing = false;
  nlu = 0;
  if (rebuild) {
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
  const bool lu_current = L.lu_current || rebuild;

  // ---- Simplified Newton ----
  double y_new[N], delta[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    y_new[j] = y_predict[j];
    delta[j] = 0.0;
  }
  CT prev = (CT)-1;
  const CT tiny = tiny_of<CT>();
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
    const CT dy_norm = rms_scaled<N, CT>(dy, (CT)1, inv_scale);
    const bool has_prev = prev >= (CT)0;
    // The rate is read only once there is a previous norm above 0; its
    // power (rem products from rate) only where the rate is below 1 and the
    // iteration has not converged.
    bool converged = dy_norm == (CT)0, rate_bad = false;
    if (!converged && has_prev && prev > (CT)0) {
      const CT rate = dy_norm / C::vmax(prev, tiny);
      if (rate >= (CT)1) {
        rate_bad = true;
      } else {
        const CT one_m = C::vmax(C::sub((CT)1, rate), tiny);
        const CT est1 = C::mul(rate / one_m, dy_norm);
        converged = rate < (CT)1 && est1 < newton_tol;
        if (!converged) {
          const int rem_i = maxit - it;
          CT rate_rem = rate;
          for (int k = 2; k <= rem_i; ++k) rate_rem = C::mul(rate_rem, rate);
          rate_bad = C::mul(rate_rem / one_m, dy_norm) > newton_tol;
        }
      }
    }
    done = converged ? 1 : (rate_bad ? 2 : 0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      y_new[j] = y_new[j] + dy[j];
      delta[j] = delta[j] + dy[j];
    }
    prev = dy_norm;
    if (done == 0) it += 1;
    nfev += 1;
  }
  slots_fence();
  const bool converged = done == 1;
  const bool newton_fail = !converged;
  const CT n_iter = (CT)it;

  // ---- A Newton failure refreshes the Jacobian ----
  njev = 0;
  if (newton_fail && !too_small) {
    double J[N * N];
    f.jac(x_new, y_predict, J, a);
#pragma unroll
    for (int q = 0; q < N * N; ++q) s[K::JAC + q] = J[q];
    njev = o.const_jac ? 0 : 1;
  }
  // ---- The error (read only after a converged iteration) ----
  CT inv_scale2[N], error_norm = 0;
  accepted = false;
  bool err_reject = false;
  if (converged) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      double sc = atol[j] + rtol[j] * fabs(y_new[j]);
      if (sc == 0.0) sc = BDF_EPS;
      inv_scale2[j] = (CT)(1.0 / sc);
    }
    const CT ec_ord = (CT)bdf::ERROR_CONST[order];
    error_norm = rms_scaled<N, CT>(delta, ec_ord, inv_scale2);
    accepted = error_norm <= (CT)1;
    err_reject = error_norm > (CT)1;
  }
  const auto safety = [&]() {
    return (CT)(0.9 * (2.0 * maxit + 1.0)) /
           C::add(C::add((CT)(2.0 * maxit), n_iter), (CT)1);
  };
  const auto log_factor = [&](CT e, int k) {
    const CT ec = C::vmin(C::vmax(e, (CT)1e-30), (CT)1e30);
    return C::mul((CT)-1 / C::add((CT)order, (CT)k), C::log(ec));
  };

  // ---- Order and step adaptation after order+1 equal steps ----
  const int n_equal_acc = L.n_equal + 1;
  finished = accepted && last;
  const bool adapt = accepted && n_equal_acc >= order + 1 && !finished;
  int new_order = order;
  CT fac_case;
  if (adapt) {
    double row_ord[N], row_op2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      row_ord[j] = (L.d(order, j) + 0.0) + delta[j];
      row_op2[j] = delta[j] - (L.d(order + 1, j) + 0.0);
    }
    const CT inf = (CT)INFINITY;
    const CT err_m = order > 1 ? rms_scaled<N, CT>(row_ord, (CT)bdf::ERROR_CONST[order - 1], inv_scale2) : inf;
    const CT err_p = order < MO ? rms_scaled<N, CT>(row_op2, (CT)bdf::ERROR_CONST[order + 1], inv_scale2) : inf;
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
    fac_case = C::vmin(C::mul(safety(), C::exp(lmax)), (CT)10);
    if (new_order != order) {
      double J[N * N];
      f.jac(x_new, y_new, J, a);
#pragma unroll
      for (int q = 0; q < N * N; ++q) s[K::JAC + q] = J[q];
      njev += o.const_jac ? 0 : 1;
    }
  } else if (accepted) {
    fac_case = (CT)1;
  } else if (newton_fail) {
    fac_case = (CT)0.5;
  } else {
    fac_case = C::vmax(C::mul(safety(), C::exp(log_factor(error_norm, 1))),
                       (CT)0.2);
  }

  // ---- One rescale for every outcome and the next step's clamps ----
  const double t_next = accepted ? x_new : t;
  const double h_des = h_abs * (double)fac_case;
  double h1 = nmin(h_des, hmax);
  if (h1 < hmin && hmin > 0.0) h1 = hmin;
  if (posneg * (t_next + posneg * h1 - tend) > 0.0) h1 = fabs(tend - t_next);
  const bool clamp_changed = h1 != h_des;
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
    emit(x_new, t, h_signed, y_new, order);
  }
  const int ord_in = adapt ? new_order : order;
  // A step that stays (h1 == h_abs, a normal finite number) has factor
  // h1 / h_abs == 1 exactly.
  const double factor = (h1 == h_abs && h_abs >= 1e-300 && h_abs < INFINITY)
                            ? 1.0
                            : h1 / nmax(h_abs, 1e-300);
  change_d<N, T>(s.at(K::D), ord_in, factor);
  L.n_equal = (accepted && !adapt && !clamp_changed) ? n_equal_acc : 0;
  L.lu_current = lu_current && !newton_fail && !adapt && !clamp_changed;
  L.order = ord_in;
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
  count_reject = (newton_fail || err_reject) && !too_small;
  return (too_small || dead) ? STEP_SIZE_TOO_SMALL : RUNNING;
}

template <class F, class CT, int T, int MB, int MODE>
__global__ void __launch_bounds__(T, MB) bdf_kernel(
    int B, const double* __restrict__ y0, const double* __restrict__ t0,
    const double* __restrict__ first_step, const StiffRun ra,
    const double* __restrict__ args, const BDFOptions o,
    const StiffDriver d_in, const BDFCarry c_in, StiffDriver d, BDFCarry c,
    int init, int max_attempts, const StiffModes md) {
  constexpr int N = F::N;
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
    L.posneg = sgn(tend - t);
    double f0[N], J[N * N];
    f(t, y, f0, a);
    f.jac(t, y, J, a);
    const double fs = first_step[i];
    if (!isnan(fs)) {
      L.h_abs = fabs(fs);
      nfev = 1;
    } else {
      L.h_abs = fabs(hinit<F, true>(f, t, y, L.posneg, f0, 1, hmax, atol,
                                    rtol, a));
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
  StiffOut<N, bdf::MAX_ORDER + 2, MODE> out(md, i, init);
  const auto emit = [&](double x_new, double xold, double h,
                        const double* y_new, int order) {
    if constexpr (MODE != STIFF_LEAN) {
      const Slots<T> D = s.at(K::D);
      out.record(x_new, xold, h, y_new, [&](int q, int j) {
        return q == 0 ? D[j]
               : q <= bdf::MAX_ORDER ? (q <= order ? D[q * N + j] : 0.0)
                                     : (double)order;
      });
      out.samples(x_new, L.posneg, [&](double ti, double* yi) {
        bdf_interp<N>(D, order, xold, h, ti, yi);
      });
    }
  };
  while (status == RUNNING && nstep - nstep0 < max_attempts && !out.full()) {
    bool accepted, finished, count_step, count_reject;
    int fe, je, le;
    int st = bdf_attempt<F, CT, T>(f, a, t, y, L, o, rtol, atol, newton_tol,
                                   tend, hmax, hmin, accepted, finished,
                                   count_step, count_reject, fe, je, le,
                                   emit);
    nstep += count_step ? 1 : 0;
    naccpt += accepted ? 1 : 0;
    nrejct += count_reject ? 1 : 0;
    nfev += fe;
    njev += je;
    nlu += le;
    if (st == RUNNING && finished) st = SUCCESS;
    if (st == RUNNING && nstep > ra.max_steps) st = NEED_LARGER_NMAX;
    status = st;
  }
  out.store();

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
                              BDFCarry, int, int, StiffModes);

template <class F, class CT, int T, int MB, int MB1, int MODE>
int bdf_pick(int B, int* min_blocks, BDFKernelPtr* kernel) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const bool one_round = (B + T - 1) / T <= MB1 * sms;
  *min_blocks = one_round ? MB1 : MB;
  *kernel = one_round ? bdf_kernel<F, CT, T, MB1, MODE>
                      : bdf_kernel<F, CT, T, MB, MODE>;
  return 0;
}

template <class F, class CT, int T, int MB, int MB1, int MODE>
int bdf_launch_as(int B, const double* y0, const double* t0,
                  const double* first_step, StiffRun ra, const double* args,
                  BDFOptions o, StiffDriver d_in, BDFCarry c_in, StiffDriver d,
                  BDFCarry c, int init, int max_attempts, StiffModes md,
                  void* stream) {
  constexpr int bytes = 8 * BDFCold<F::N>::DOUBLES * T;
  static_assert(bytes <= SLOTS_BLOCK_MAX, "the slots exceed a block's");
  int min_blocks = 0;
  BDFKernelPtr kernel = nullptr;
  int err = bdf_pick<F, CT, T, MB, MB1, MODE>(B, &min_blocks, &kernel);
  if (!err) err = allow_slots(kernel, bytes);
  if (err) return err;
  kernel<<<(B + T - 1) / T, T, bytes, (cudaStream_t)stream>>>(
      B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
      max_attempts, md);
  return (int)cudaGetLastError();
}

// T, MB: threads a block and min blocks an SM; MB1: min blocks of the
// one-round instantiation (bdf_pick); under either controller type and in
// every mode.
template <class F, int T, int MB, int MB1, int MODE>
int bdf_launch(int B, const double* y0, const double* t0,
               const double* first_step, StiffRun ra, const double* args,
               BDFOptions o, StiffDriver d_in, BDFCarry c_in, StiffDriver d,
               BDFCarry c, int init, int max_attempts, StiffModes md,
               void* stream) {
  if (B <= 0) return 0;
  if (o.state_precision)
    return bdf_launch_as<F, double, T, MB, MB1, MODE>(
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
        max_attempts, md, stream);
  return bdf_launch_as<F, float, T, MB, MB1, MODE>(
      B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
      max_attempts, md, stream);
}

// A SAMPLED or RECORD launch: RECORD where md has rows (cap > 0).
template <class F, int T, int MB, int MB1>
int bdf_modes_launch(int B, const double* y0, const double* t0,
                     const double* first_step, StiffRun ra,
                     const double* args, BDFOptions o, StiffDriver d_in,
                     BDFCarry c_in, StiffDriver d, BDFCarry c, int init,
                     int max_attempts, StiffModes md, void* stream) {
  if (md.cap > 0)
    return bdf_launch<F, T, MB, MB1, STIFF_RECORD>(
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
        max_attempts, md, stream);
  return bdf_launch<F, T, MB, MB1, STIFF_SAMPLED>(
      B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
      max_attempts, md, stream);
}

template <class F, class CT, int T, int MB, int MB1, int MODE>
int bdf_layout_as(int B, int* info) {
  int min_blocks = 0;
  BDFKernelPtr kernel = nullptr;
  const int err = bdf_pick<F, CT, T, MB, MB1, MODE>(B, &min_blocks, &kernel);
  if (err) return err;
  return slots_layout(kernel, T, min_blocks, 8 * BDFCold<F::N>::DOUBLES,
                      info);
}

template <class F, int T, int MB, int MB1, int MODE>
int bdf_layout(int state_precision, int B, int* info) {
  if (state_precision)
    return bdf_layout_as<F, double, T, MB, MB1, MODE>(B, info);
  return bdf_layout_as<F, float, T, MB, MB1, MODE>(B, info);
}

template <class F, int T, int MB, int MB1>
int bdf_modes_layout(int mode, int state_precision, int B, int* info) {
  if (mode == STIFF_RECORD)
    return bdf_layout<F, T, MB, MB1, STIFF_RECORD>(state_precision, B, info);
  if (mode == STIFF_SAMPLED)
    return bdf_layout<F, T, MB, MB1, STIFF_SAMPLED>(state_precision, B, info);
  return bdf_layout<F, T, MB, MB1, STIFF_LEAN>(state_precision, B, info);
}

}  // namespace ivp

// One C entry per RHS functor with a Jacobian: ivp_bdf_<name> (the carry it
// loads, d_in and c_in, and the one it stores, d and c), ivp_bdf_modes_<name>
// (the same with the samples or rows of md), and ivp_bdf_layout_<name> /
// ivp_bdf_modes_layout_<name> (slots_layout of the instantiation a launch
// of B lanes under a controller type, in a mode, takes).  T, MB and MB1
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
        max_attempts, ivp::StiffModes{}, stream);                             \
  }                                                                           \
  extern "C" int ivp_bdf_modes_##NAME(                                        \
      int B, const double* y0, const double* t0, const double* first_step,    \
      ivp::StiffRun ra, const double* args, ivp::BDFOptions o,                \
      ivp::StiffDriver d_in, ivp::BDFCarry c_in, ivp::StiffDriver d,          \
      ivp::BDFCarry c, int init, int max_attempts, ivp::StiffModes md,        \
      void* stream) {                                                         \
    return ivp::bdf_modes_launch<FUNCTOR, IVP_BDF_BOUNDS(T, MB, MB1)>(        \
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,           \
        max_attempts, md, stream);                                            \
  }                                                                           \
  extern "C" int ivp_bdf_layout_##NAME(int state_precision, int B,            \
                                       int* info) {                           \
    return ivp::bdf_layout<FUNCTOR, IVP_BDF_BOUNDS(T, MB, MB1),               \
                           ivp::STIFF_LEAN>(state_precision, B, info);        \
  }                                                                           \
  extern "C" int ivp_bdf_modes_layout_##NAME(int mode, int state_precision,   \
                                             int B, int* info) {              \
    return ivp::bdf_modes_layout<FUNCTOR, IVP_BDF_BOUNDS(T, MB, MB1)>(        \
        mode, state_precision, B, info);                                      \
  }

IVP_BDF_ENTRY(vdp, VdP, 128, 4, 3)
IVP_BDF_ENTRY(decay, Decay, 128, 4, 3)
IVP_BDF_ENTRY(robertson, Robertson, 128, 4, 3)

IVP_STIFF_LIBRARY()
