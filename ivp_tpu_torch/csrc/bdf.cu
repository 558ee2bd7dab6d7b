// The variable-order BDF ensemble solve, float64, one thread a lane: the
// attempt of ivp_tpu_torch/methods/bdf.py (itself ivp_tpu/methods/bdf.py::
// make_bdf_attempt, :312, with change_d, :232) with its inverse backend, in
// the loop of core/driver.py, final state only.
//
// It replaces the XLA-fused, vmapped ivp_tpu/core/driver.py loop around
// make_bdf_attempt and the inverse of I - cJ (core/linalg.py::inv :280); no
// TPU kernel stands behind it.  The order-dependent sums are loops to the
// lane's order (the reference's masked sums over MAX_ORDER+3 rows add exact
// zeros past it); the Newton loop ends at the lane's exit; the iteration
// matrix is rebuilt and the Jacobian refreshed only where the lane asks.
// Same carry, init and budget as radau.cu; no FMA contraction.
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

template <int N>
struct BDFLane {
  double h_abs, posneg, current_c;
  double D[BDF_ROWS][N];
  int order, n_equal;
  bool lu_current;
  double jac[N * N], inv[N * N];
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

// bdf.py::change_d on D[0..5] for the lane's order and factor.
template <int N>
__device__ void change_d(double (*D)[N], int order, double factor) {
  if (factor == 1.0) return;
  const double f2 = factor * factor, f3 = f2 * factor;
  const double pw[6] = {0.0, factor, f2, f3, f2 * f2, f3 * f2};
  double T[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      double acc = bdf::CHANGE_D_C[0][i][m];
#pragma unroll
      for (int dd = 1; dd <= i; ++dd) acc = acc + pw[dd] * bdf::CHANGE_D_C[dd][i][m];
      T[i][m] = (i <= order && m <= order) ? acc : (i == m ? 1.0 : 0.0);
    }
  double D6[6][N];
#pragma unroll
  for (int jr = 0; jr < 6; ++jr)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      double s = 0.0 + T[0][jr] * D[0][c];
#pragma unroll
      for (int m = 1; m < 6; ++m) s = s + T[m][jr] * D[m][c];
      D6[jr][c] = s;
    }
#pragma unroll
  for (int jr = 0; jr < 6; ++jr)
#pragma unroll
    for (int c = 0; c < N; ++c) D[jr][c] = D6[jr][c];
}

// One attempt of methods/bdf.py::make_bdf_attempt on lane L at (t, y).
template <class F, class CT>
__device__ int bdf_attempt(const F& f, const double* a, double& t, double* y,
                           BDFLane<F::N>& L, const BDFOptions& o,
                           const double* rtol, const double* atol,
                           double tend, double hmax, double hmin,
                           bool& accepted, bool& finished, bool& count_step,
                           bool& count_reject, int& nfev, int& njev,
                           int& nlu) {
  constexpr int N = F::N;
  constexpr int MO = bdf::MAX_ORDER;
  using C = Ctl<CT>;
  const int maxit = o.newton_maxiter;
  double rtol_min = rtol[0];
#pragma unroll
  for (int j = 1; j < N; ++j) rtol_min = nmin(rtol_min, rtol[j]);
  rtol_min = nmax(rtol_min, BDF_EPS);
  const CT newton_tol =
      o.newton_tol > 0.0
          ? (CT)o.newton_tol
          : (CT)nmax((10.0 * BDF_EPS) / rtol_min, nmin(sqrt(rtol_min), 0.03));
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
    double s = L.D[0][j], p = 0.0;
    for (int k = 1; k <= order; ++k) s = s + L.D[k][j];
    for (int k = 1; k <= order; ++k) {
      const double g = bdf::GAMMA[k] * L.D[k][j];
      p = k == 1 ? g : p + g;
    }
    y_predict[j] = s;
    double sc = atol[j] + rtol[j] * fabs(s);
    if (sc == 0.0) sc = BDF_EPS;
    inv_scale[j] = (CT)(1.0 / sc);
    psi[j] = p / alpha_ord;
  }
  const double c = h_signed / alpha_ord;

  // ---- The iteration matrix, rebuilt when c drifts ----
  const bool drift = fabs(c - L.current_c) / nmax(fabs(c), 1.0) > 0.1;
  const bool rebuild = !L.lu_current || drift;
  bool sing = false;
  nlu = 0;
  if (rebuild) {
    double m[N * N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        m[i * N + j] = (i == j ? 1.0 : 0.0) - c * L.jac[i * N + j];
    sing = inv_real<N>(m, L.inv);
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
    matvec<N>(L.inv, rv, dy);
    const CT dy_norm = rms_scaled<N, CT>(dy, (CT)1, inv_scale);
    const bool has_prev = prev >= (CT)0;
    const CT rate = dy_norm / C::vmax(prev, tiny);
    const int rem_i = maxit - it;
    CT pw = rate, rate_rem = rate;
    for (int k = 2; k <= maxit; ++k) {
      pw = C::mul(pw, rate);
      if (rem_i >= k) rate_rem = pw;
    }
    const CT one_m = C::vmax(C::sub((CT)1, rate), tiny);
    const CT estimate_full = C::mul(rate_rem / one_m, dy_norm);
    const bool rate_bad = has_prev && prev > (CT)0 &&
                          (rate >= (CT)1 || estimate_full > newton_tol);
    const CT est1 = C::mul(rate / one_m, dy_norm);
    const bool converged =
        dy_norm == (CT)0 ||
        (has_prev && prev > (CT)0 && rate < (CT)1 && est1 < newton_tol);
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
  const bool converged = done == 1;
  const bool newton_fail = !converged;
  const CT n_iter = (CT)it;

  // ---- A Newton failure refreshes the Jacobian ----
  njev = 0;
  if (newton_fail && !too_small) {
    f.jac(x_new, y_predict, L.jac, a);
    njev = o.const_jac ? 0 : 1;
  }
  const CT safety = (CT)(0.9 * (2.0 * maxit + 1.0)) /
                    C::add(C::add((CT)(2.0 * maxit), n_iter), (CT)1);
  CT inv_scale2[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    double sc = atol[j] + rtol[j] * fabs(y_new[j]);
    if (sc == 0.0) sc = BDF_EPS;
    inv_scale2[j] = (CT)(1.0 / sc);
  }
  const CT ec_ord = (CT)bdf::ERROR_CONST[order];
  const CT error_norm = rms_scaled<N, CT>(delta, ec_ord, inv_scale2);
  accepted = converged && error_norm <= (CT)1;
  const bool err_reject = converged && error_norm > (CT)1;

  // ---- Order and step adaptation after order+1 equal steps ----
  const int n_equal_acc = L.n_equal + 1;
  finished = accepted && last;
  const bool adapt = accepted && n_equal_acc >= order + 1 && !finished;
  double row_ord[N], row_op2[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    row_ord[j] = (L.D[order][j] + 0.0) + delta[j];
    row_op2[j] = delta[j] - (L.D[order + 1][j] + 0.0);
  }
  const CT inf = (CT)INFINITY;
  const CT err_m = order > 1 ? rms_scaled<N, CT>(row_ord, (CT)bdf::ERROR_CONST[order - 1], inv_scale2) : inf;
  const CT err_p = order < MO ? rms_scaled<N, CT>(row_op2, (CT)bdf::ERROR_CONST[order + 1], inv_scale2) : inf;
  const CT errs[3] = {err_m, error_norm, err_p};
  CT lf[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const CT e = C::vmin(C::vmax(errs[k], (CT)1e-30), (CT)1e30);
    lf[k] = C::mul((CT)-1 / C::add((CT)order, (CT)k), C::log(e));
  }
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
  int new_order = order + (best - 1);
  new_order = new_order < 1 ? 1 : (new_order > MO ? MO : new_order);
  const CT step_factor = C::vmin(C::mul(safety, C::exp(lmax)), (CT)10);
  const bool order_changed = adapt && new_order != order;
  if (order_changed) {
    f.jac(x_new, y_new, L.jac, a);
    njev += o.const_jac ? 0 : 1;
  }

  // ---- One rescale for every outcome and the next step's clamps ----
  const CT fac_rej = C::vmax(C::mul(safety, C::exp(lf[1])), (CT)0.2);
  const CT fac_case = adapt ? step_factor
                      : accepted ? (CT)1
                      : newton_fail ? (CT)0.5
                                    : fac_rej;
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
      const double op1 = L.D[order + 1][j] + 0.0;
      L.D[order + 2][j] = delta[j] - op1;
      L.D[order + 1][j] = delta[j];
      double s = delta[j] + 0.0;
      for (int k = order; k >= 0; --k) {
        s = L.D[k][j] + s;
        L.D[k][j] = s;
      }
    }
  }
  const int ord_in = adapt ? new_order : order;
  change_d<N>(L.D, ord_in, h1 / nmax(h_abs, 1e-300));
  L.n_equal = (accepted && !adapt && !clamp_changed) ? n_equal_acc : 0;
  L.lu_current = lu_current && !newton_fail && !adapt && !clamp_changed;
  L.order = adapt ? new_order : order;
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

template <class F, class CT>
__global__ void __launch_bounds__(128) bdf_kernel(
    int B, const double* __restrict__ y0, const double* __restrict__ t0,
    const double* __restrict__ first_step, const StiffRun ra,
    const double* __restrict__ args, const BDFOptions o, StiffDriver d,
    BDFCarry c, int init, int max_attempts) {
  constexpr int N = F::N;
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
  BDFLane<N> L;
  double t;
  int status, nfev, njev, nlu, nstep, naccpt, nrejct;
  if (init) {
    // methods/bdf.py::make_bdf_init, then the driver's init_carry.
    t = t0[i];
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = y0[(size_t)i * N + j];
    L.posneg = sgn(tend - t);
    double f0[N];
    f(t, y, f0, a);
    f.jac(t, y, L.jac, a);
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
      for (int k = 0; k < BDF_ROWS; ++k) L.D[k][j] = 0.0;
      L.D[0][j] = y[j];
      L.D[1][j] = f0[j] * (L.h_abs * L.posneg);
    }
#pragma unroll
    for (int q = 0; q < N * N; ++q) L.inv[q] = 0.0;
    L.order = 1;
    L.n_equal = 0;
    L.lu_current = false;
    L.current_c = 0.0;
    status = fabs(tend - t) < 1e-15 ? SUCCESS : RUNNING;
    njev = nlu = nstep = naccpt = nrejct = 0;
  } else {
    t = d.t[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      y[j] = d.y[(size_t)i * N + j];
#pragma unroll
      for (int k = 0; k < BDF_ROWS; ++k)
        L.D[k][j] = c.D[((size_t)i * BDF_ROWS + k) * N + j];
    }
#pragma unroll
    for (int q = 0; q < N * N; ++q) {
      L.jac[q] = c.jac[(size_t)i * N * N + q];
      L.inv[q] = c.inv[(size_t)i * N * N + q];
    }
    L.h_abs = c.h_abs[i];
    L.posneg = c.posneg[i];
    L.order = c.order[i];
    L.n_equal = c.n_equal[i];
    L.lu_current = c.lu_current[i] != 0;
    L.current_c = c.current_c[i];
    status = d.status[i];
    nfev = d.nfev[i];
    njev = d.njev[i];
    nlu = d.nlu[i];
    nstep = d.nstep[i];
    naccpt = d.naccpt[i];
    nrejct = d.nrejct[i];
  }

  const int nstep0 = nstep;
  while (status == RUNNING && nstep - nstep0 < max_attempts) {
    bool accepted, finished, count_step, count_reject;
    int fe, je, le;
    int st = bdf_attempt<F, CT>(f, a, t, y, L, o, rtol, atol, tend, hmax,
                                hmin, accepted, finished, count_step,
                                count_reject, fe, je, le);
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

  d.t[i] = t;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    d.y[(size_t)i * N + j] = y[j];
#pragma unroll
    for (int k = 0; k < BDF_ROWS; ++k)
      c.D[((size_t)i * BDF_ROWS + k) * N + j] = L.D[k][j];
  }
#pragma unroll
  for (int q = 0; q < N * N; ++q) {
    c.jac[(size_t)i * N * N + q] = L.jac[q];
    c.inv[(size_t)i * N * N + q] = L.inv[q];
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

constexpr int BDF_THREADS = 128;

template <class F>
int bdf_launch(int B, const double* y0, const double* t0,
               const double* first_step, StiffRun ra, const double* args,
               BDFOptions o, StiffDriver d, BDFCarry c, int init,
               int max_attempts, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + BDF_THREADS - 1) / BDF_THREADS;
  if (o.state_precision)
    bdf_kernel<F, double><<<blocks, BDF_THREADS, 0, (cudaStream_t)stream>>>(
        B, y0, t0, first_step, ra, args, o, d, c, init, max_attempts);
  else
    bdf_kernel<F, float><<<blocks, BDF_THREADS, 0, (cudaStream_t)stream>>>(
        B, y0, t0, first_step, ra, args, o, d, c, init, max_attempts);
  return (int)cudaGetLastError();
}

}  // namespace ivp

// One C entry per RHS functor with a Jacobian: ivp_bdf_<name>.
#define IVP_BDF_ENTRY(NAME, FUNCTOR)                                          \
  extern "C" int ivp_bdf_##NAME(                                              \
      int B, const double* y0, const double* t0, const double* first_step,    \
      ivp::StiffRun ra, const double* args, ivp::BDFOptions o,                \
      ivp::StiffDriver d, ivp::BDFCarry c, int init, int max_attempts,        \
      void* stream) {                                                         \
    return ivp::bdf_launch<FUNCTOR>(B, y0, t0, first_step, ra, args, o, d, c, \
                                    init, max_attempts, stream);              \
  }

IVP_BDF_ENTRY(vdp, VdP)
IVP_BDF_ENTRY(decay, Decay)
IVP_BDF_ENTRY(robertson, Robertson)

IVP_STIFF_LIBRARY()
