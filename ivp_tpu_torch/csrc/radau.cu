// The Radau IIA(5) ensemble solve, float64, one thread a lane: the
// attempt of ivp_tpu_torch/methods/radau.py (itself ivp_tpu/methods/
// radau.py::make_radau_attempt, :348) with its inverse backend, in the loop
// of core/driver.py, final state only.
//
// It replaces the XLA-fused, vmapped ivp_tpu/core/driver.py loop around
// make_radau_attempt and its inverse backend (core/linalg.py::inv :280,
// inv_complex :327); no TPU kernel stands behind it.  What XLA masks is a
// branch here: the Newton loop ends at each lane's own exit, and the
// Jacobian (the functor's jac) and the decomposition are computed only where
// the lane asks for them.  The arithmetic is the plain version's, operation
// for operation, with no FMA contraction (stiff_common.cuh), the controller
// in CT (float under controller_precision="float32", double under "state")
// through Ctl<CT>.
//
// The carry.  Each launch loads the lane's whole carry from device memory
// (the plain driver's Carry and RadauState, struct of arrays, the tensors the
// port's resumable solver holds) and stores it at the end; a solve's first
// launch (init) instead runs the method's init from y0 and t0.  A launch
// runs until the lane is done or has made max_attempts counted attempts
// (nstep) since it began, as core/driver.py::run_bounded counts them.
#include "stiff_common.cuh"

namespace ivp {

// The numeric fields of methods/radau.py::RadauParams, as Python's floats
// (kernels/stiff_ensemble.py::RadauOptions, same layout).
struct RadauOptions {
  double uround, safety, facl, facr, cfac, thet, quot1, quot2, newton_tol;
  int newton_maxiter, predictive, const_jac, state_precision;
};

// RadauState, struct of arrays (B leading); CT fields are float or double.
struct RadauCarry {
  double* h;
  double* hold;
  double* posneg;
  double* f0;    // (B, N)
  double* cont;  // (B, 4, N)
  double* scal;  // (B, N)
  unsigned char* first;
  unsigned char* reject;
  unsigned char* last;
  void* faccon;
  void* theta;
  double* hhfac;
  double* h_acc;
  void* err_acc;
  unsigned char* call_jac;
  unsigned char* call_decomp;
  int* singular;
  double* jac;   // (B, N, N)
  double* inv1;  // (B, N, N)
  double* br;
  double* bi;
};

constexpr int NEWTON_CONTINUE = 0, NEWTON_CONVERGED = 1, NEWTON_DIVERGED = 2,
              NEWTON_BAD_THETA = 3, NEWTON_MAXITER = 4;

template <int N, class CT>
struct RadauLane {
  double h, hold, posneg;
  double f0[N], cont[4][N], scal[N];
  bool first, reject, last;
  CT faccon, theta;
  double hhfac, h_acc;
  CT err_acc;
  bool call_jac, call_decomp;
  int singular;
  double jac[N * N], inv1[N * N], br[N * N], bi[N * N];
};

template <int N, class CT>
__device__ __forceinline__ CT rms_c(const double* v, const CT* inv_scal) {
  using C = Ctl<CT>;
  CT s = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const CT q = C::mul((CT)v[j], inv_scal[j]);
    s = j ? C::add(s, C::mul(q, q)) : C::mul(q, q);
  }
  return C::vmax(C::sqrt(s / (CT)N), (CT)1e-10);
}

template <int N, class CT>
__device__ __forceinline__ CT sumsq_c(const double* v, const CT* inv_scal) {
  using C = Ctl<CT>;
  CT s = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const CT q = C::mul((CT)v[j], inv_scal[j]);
    s = j ? C::add(s, C::mul(q, q)) : C::mul(q, q);
  }
  return s;
}

// One attempt of methods/radau.py::make_radau_attempt on lane L at (t, y)
// (advanced in place when accepted).  Returns the engine's status; the
// step's flags and counts go to the references.
template <class F, class CT>
__device__ int radau_attempt(const F& f, const double* a, double& t,
                             double* y, int naccpt, RadauLane<F::N, CT>& L,
                             const RadauOptions& o, const double* rtol_t,
                             const double* atol_t, double tend, double hmax,
                             double hmin, bool& accepted, bool& finished,
                             bool& count_step, bool& count_reject, int& nfev,
                             int& njev, int& nlu) {
  constexpr int N = F::N;
  using C = Ctl<CT>;
  using namespace radau;
  const int maxit = o.newton_maxiter;
  CT newton_tol;
  if (!isnan(o.newton_tol)) {
    newton_tol = (CT)o.newton_tol;
  } else {
    const double tolst = rtol_t[0];
    newton_tol = (CT)nmax((10.0 * o.uround) / tolst, nmin(sqrt(tolst), 0.03));
  }
  const double h = L.h, posneg = L.posneg;

  // ---- Jacobian (reused while theta stays small) ----
  njev = 0;
  if (L.call_jac) {
    f.jac(t, y, L.jac, a);
    njev = o.const_jac ? 0 : 1;
  }
  // ---- Decompositions (reused when the step ratio stays near 1) ----
  const double fac1 = U1 / h, alphn = ALPH / h, betan = BETA / h;
  bool sing = false;
  nlu = 0;
  if (L.call_decomp) {
    double e1[N * N], e2r[N * N], e2i[N * N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const double eye = i == j ? 1.0 : 0.0;
        e1[i * N + j] = fac1 * eye - L.jac[i * N + j];
        e2r[i * N + j] = alphn * eye - L.jac[i * N + j];
        e2i[i * N + j] = betan * eye;
      }
    const bool s1 = inv_real<N>(e1, L.inv1);
    const bool s2 = inv_cplx<N>(e2r, e2i, L.br, L.bi);
    sing = s1 || s2;
    nlu = 2;
  }
  const bool too_small = 0.1 * fabs(h) <= fabs(t) * o.uround;

  // ---- Newton starting values: the last collocation polynomial ----
  double z1[N], z2[N], z3[N], f1[N], f2[N], f3[N];
  if (L.first) {
#pragma unroll
    for (int j = 0; j < N; ++j) z1[j] = z2[j] = z3[j] = f1[j] = f2[j] = f3[j] = 0.0;
  } else {
    const double c3q = h / L.hold;
    const double c1q = C1 * c3q, c2q = C2 * c3q;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double ak1 = L.cont[1][j], ak2 = L.cont[2][j], ak3 = L.cont[3][j];
      z1[j] = c1q * (ak1 + (c1q - C2M1) * (ak2 + (c1q - C1M1) * ak3));
      z2[j] = c2q * (ak1 + (c2q - C2M1) * (ak2 + (c2q - C1M1) * ak3));
      z3[j] = c3q * (ak1 + (c3q - C2M1) * (ak2 + (c3q - C1M1) * ak3));
      f1[j] = TI_0_0 * z1[j] + TI_0_1 * z2[j] + TI_0_2 * z3[j];
      f2[j] = TI_1_0 * z1[j] + TI_1_1 * z2[j] + TI_1_2 * z3[j];
      f3[j] = TI_2_0 * z1[j] + TI_2_1 * z2[j] + TI_2_2 * z3[j];
    }
  }

  // ---- Simplified Newton iteration ----
  CT faccon = C::pow(C::vmax(L.faccon, (CT)o.uround), (CT)0.8);
  CT inv_scal[N];
#pragma unroll
  for (int j = 0; j < N; ++j) inv_scal[j] = (CT)(1.0 / L.scal[j]);
  CT dyno = 0, dynold = 0, thqold = 0, theta = (CT)fabs(o.thet);
  double hhfac = L.hhfac;
  int code = (sing || too_small) ? NEWTON_MAXITER : NEWTON_CONTINUE;
  int it = 0;
  nfev = 0;
  const CT tiny = tiny_of<CT>();
  while (code == NEWTON_CONTINUE) {
    if (it >= maxit) {
      code = NEWTON_MAXITER;
      break;
    }
    double g1[N], g2[N], g3[N], yy[N];
#pragma unroll
    for (int j = 0; j < N; ++j) yy[j] = y[j] + z1[j];
    f(t + C1 * h, yy, g1, a);
#pragma unroll
    for (int j = 0; j < N; ++j) yy[j] = y[j] + z2[j];
    f(t + C2 * h, yy, g2, a);
#pragma unroll
    for (int j = 0; j < N; ++j) yy[j] = y[j] + z3[j];
    f(t + h, yy, g3, a);
    double r1[N], r2[N], r3[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      r1[j] = TI_0_0 * g1[j] + TI_0_1 * g2[j] + TI_0_2 * g3[j];
      r2[j] = TI_1_0 * g1[j] + TI_1_1 * g2[j] + TI_1_2 * g3[j];
      r3[j] = TI_2_0 * g1[j] + TI_2_1 * g2[j] + TI_2_2 * g3[j];
      r1[j] = r1[j] - fac1 * f1[j];
      r2[j] = r2[j] - alphn * f2[j] + betan * f3[j];
      r3[j] = r3[j] - alphn * f3[j] - betan * f2[j];
    }
    double x1[N], x2[N], x3[N], p1[N], p2[N];
    matvec<N>(L.inv1, r1, x1);
    matvec<N>(L.br, r2, p1);
    matvec<N>(L.bi, r3, p2);
#pragma unroll
    for (int j = 0; j < N; ++j) x2[j] = p1[j] - p2[j];
    matvec<N>(L.bi, r2, p1);
    matvec<N>(L.br, r3, p2);
#pragma unroll
    for (int j = 0; j < N; ++j) x3[j] = p1[j] + p2[j];

    const int it_n = it + 1;
    const CT dyno_n = C::sqrt(
        C::add(C::add(sumsq_c<N, CT>(x1, inv_scal), sumsq_c<N, CT>(x2, inv_scal)),
               sumsq_c<N, CT>(x3, inv_scal)) /
        (CT)(3.0 * N));
    const bool check = it_n > 1 && it_n < maxit;
    const CT thq = dyno_n / C::vmax(dynold, tiny);
    CT theta_n = theta, thqold_n = thqold;
    if (check) {
      theta_n = it_n == 2 ? thq : C::sqrt(C::mul(thq, C::vmax(thqold, tiny)));
      thqold_n = thq;
    }
    const bool ok_theta = theta_n < (CT)0.99;
    const CT faccon_n =
        (check && ok_theta) ? theta_n / C::sub((CT)1, theta_n) : faccon;
    const CT rem = C::sub((CT)(maxit - 1), (CT)it_n);
    const int rem_i = maxit - 1 - it_n;
    CT theta_rem = 1, pw = 1;
    for (int k = 1; k < (maxit - 1 > 1 ? maxit - 1 : 1); ++k) {
      pw = C::mul(pw, theta_n);
      if (rem_i >= k) theta_rem = pw;
    }
    const CT dyth = C::mul(C::mul(faccon_n, dyno_n), theta_rem) / newton_tol;
    const bool diverged = check && ok_theta && dyth >= (CT)1;
    const CT qnewt = C::vmin(C::vmax(dyth, (CT)1e-4), (CT)20);
    const double hhfac_div = (double)C::mul(
        (CT)0.8, C::pow(qnewt, (CT)-1 / C::add((CT)4, rem)));
    const double hhfac_n = diverged ? hhfac_div : hhfac;
    const bool bad_theta = check && !ok_theta;
    const CT dynold_n = C::vmax(dyno_n, (CT)o.uround);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      f1[j] = f1[j] + x1[j];
      f2[j] = f2[j] + x2[j];
      f3[j] = f3[j] + x3[j];
      z1[j] = T_0_0 * f1[j] + T_0_1 * f2[j] + T_0_2 * f3[j];
      z2[j] = T_1_0 * f1[j] + T_1_1 * f2[j] + T_1_2 * f3[j];
      z3[j] = T_2_0 * f1[j] + f2[j];
    }
    const bool converged = C::mul(faccon_n, dyno_n) <= newton_tol;
    code = bad_theta   ? NEWTON_BAD_THETA
           : diverged  ? NEWTON_DIVERGED
           : converged ? NEWTON_CONVERGED
                       : NEWTON_CONTINUE;
    it = it_n;
    dyno = dyno_n;
    dynold = dynold_n;
    thqold = thqold_n;
    theta = theta_n;
    faccon = faccon_n;
    hhfac = hhfac_n;
    nfev += 3;
  }
  const CT newt = (CT)it;
  const bool converged = code == NEWTON_CONVERGED;

  // ---- Error estimation ----
  const double hee0 = DD_0 / h, hee1 = DD_1 / h, hee2 = DD_2 / h;
  double f1e[N], ev[N], err_vec[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    f1e[j] = hee0 * z1[j] + hee1 * z2[j] + hee2 * z3[j];
    ev[j] = f1e[j] + L.f0[j];
  }
  matvec<N>(L.inv1, ev, err_vec);
  CT err = rms_c<N, CT>(err_vec, inv_scal);
  if (converged && err >= (CT)1 && (L.first || L.reject)) {
    double yy[N], fr[N], e2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) yy[j] = err_vec[j] + y[j];
    f(t, yy, fr, a);
#pragma unroll
    for (int j = 0; j < N; ++j) fr[j] = fr[j] + f1e[j];
    matvec<N>(L.inv1, fr, e2);
    err = rms_c<N, CT>(e2, inv_scal);
    nfev += 1;
  }

  // ---- Step-size controller ----
  const CT fac = C::vmin((CT)o.cfac / C::add(newt, (CT)(2.0 * maxit)),
                         (CT)o.safety);
  CT quot = C::vmax(C::vmin(C::sqrt(C::sqrt(err)) / fac, (CT)o.facl),
                    (CT)o.facr);
  double hnew = h / (double)quot;
  accepted = converged && err <= (CT)1 && !sing && !too_small;
  double h_acc = L.h_acc;
  CT err_acc = L.err_acc;
  if (o.predictive) {
    const bool can_pred = accepted && naccpt + 1 > 1;
    const CT ratio =
        C::vmin(C::mul(err, err) / C::vmax(L.err_acc, (CT)1e-30), (CT)1e30);
    CT facgus = C::mul((CT)(L.h_acc / h), C::sqrt(C::sqrt(ratio))) /
                (CT)o.safety;
    facgus = C::vmax(C::vmin(facgus, (CT)o.facl), (CT)o.facr);
    if (can_pred) quot = C::vmax(quot, facgus);
    hnew = h / (double)quot;
    if (accepted) {
      h_acc = h;
      err_acc = C::vmax(err, (CT)1e-2);
    }
  }

  // ---- Accept and reject paths ----
  const bool diverged = code == NEWTON_DIVERGED;
  const bool broke =
      code == NEWTON_MAXITER || code == NEWTON_BAD_THETA || sing;
  finished = accepted && L.last;
  count_step = !sing;
  count_reject = !accepted && !sing &&
                 (diverged || (converged && err > (CT)1 && !L.first));
  double h_next, hhfac_next;
  if (accepted) {
    const double t_new = L.last ? tend : t + h;
    double ynew[N], c1r[N], c2r[N], c3r[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      ynew[j] = y[j] + z3[j];
      const double ak = (z1[j] - z2[j]) / C1MC2;
      const double acont3 = (ak - z1[j] / C1) / C2;
      c1r[j] = (z2[j] - z3[j]) / C2M1;
      c2r[j] = (ak - c1r[j]) / C1M1;
      c3r[j] = c2r[j] - acont3;
    }
    f(t_new, ynew, L.f0, a);
    nfev += 1;
    double hnew_acc = nmin(nmax(fabs(hnew), hmin), hmax) * posneg;
    if (L.reject) hnew_acc = posneg * nmin(fabs(hnew_acc), fabs(h));
    const bool hit_end = (t_new + hnew_acc / o.quot1 - tend) * posneg >= 0.0;
    const double qt = hnew_acc / h;
    const bool reuse = !hit_end && theta < (CT)o.thet && qt > o.quot1 &&
                       qt < o.quot2;
    h_next = hit_end ? tend - t_new : (reuse ? h : hnew_acc);
    hhfac_next = reuse ? L.hhfac : h_next;
    L.call_jac = !reuse && theta >= (CT)o.thet;
    L.call_decomp = !reuse;
    L.singular = 0;
    L.hold = h;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      L.cont[0][j] = ynew[j];
      L.cont[1][j] = c1r[j];
      L.cont[2][j] = c2r[j];
      L.cont[3][j] = c3r[j];
      L.scal[j] = atol_t[j] + rtol_t[j] * fabs(ynew[j]);
      y[j] = ynew[j];
    }
    L.first = false;
    L.reject = false;
    L.last = hit_end;
    t = t_new;
  } else {
    const double h_rej = L.first ? h * 0.1 : hnew;
    const double hhfac_rej = L.first ? 0.1 : hnew / h;
    h_next = diverged ? h * hhfac : (broke ? h * 0.5 : h_rej);
    hhfac_next = diverged ? hhfac : (broke ? 0.5 : hhfac_rej);
    L.call_decomp = true;
    if (broke) L.singular += 1;
    L.reject = L.reject || diverged || err > (CT)1 || broke;
    L.last = false;
  }
  L.faccon = faccon;
  L.theta = theta;
  L.hhfac = hhfac_next;
  L.h_acc = h_acc;
  L.err_acc = err_acc;
  L.h = h_next;
  if (too_small) return STEP_SIZE_TOO_SMALL;
  if (broke && L.singular > 5) return SINGULAR_MATRIX;
  return RUNNING;
}

template <class F, class CT>
__global__ void __launch_bounds__(128) radau_kernel(
    int B, const double* __restrict__ y0, const double* __restrict__ t0,
    const double* __restrict__ first_step, const StiffRun ra,
    const double* __restrict__ args, const RadauOptions o, StiffDriver d,
    RadauCarry c, int init, int max_attempts) {
  constexpr int N = F::N;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const F f{};
  double a[F::NARGS > 0 ? F::NARGS : 1];
#pragma unroll
  for (int j = 0; j < F::NARGS; ++j) a[j] = args[(size_t)i * F::NARGS + j];

  // methods/radau.py::transform_tols
  double rtol_t[N], atol_t[N], y[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const double rt = ra.rtol[(size_t)i * N + j], at = ra.atol[(size_t)i * N + j];
    const double quot = at / rt;
    rtol_t[j] = 0.1 * pow(rt, 2.0 / 3.0);
    atol_t[j] = rtol_t[j] * quot;
  }
  const double tend = ra.tend[i], hmax = fabs(ra.hmax[i]), hmin = fabs(ra.hmin[i]);
  RadauLane<N, CT> L;
  double t;
  int status, nfev, njev, nlu, nstep, naccpt, nrejct;
  CT* faccon_p = (CT*)c.faccon;
  CT* theta_p = (CT*)c.theta;
  CT* err_acc_p = (CT*)c.err_acc;
  if (init) {
    // methods/radau.py::make_radau_init, then the driver's init_carry.
    t = t0[i];
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = y0[(size_t)i * N + j];
    L.posneg = sgn(tend - t);
    const double fs = first_step[i];
    double h = isnan(fs) ? 1.0e-6 * L.posneg : fabs(fs) * L.posneg;
    h = nmin(nmax(h, -hmax), hmax);
    L.h = L.hold = L.hhfac = h;
    f(t, y, L.f0, a);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      L.scal[j] = atol_t[j] + rtol_t[j] * fabs(y[j]);
#pragma unroll
      for (int q = 0; q < 4; ++q) L.cont[q][j] = 0.0;
    }
    L.first = true;
    L.reject = L.last = false;
    L.faccon = (CT)1;
    L.theta = (CT)o.thet;
    L.h_acc = 0.0;
    L.err_acc = (CT)0;
    L.call_jac = L.call_decomp = true;
    L.singular = 0;
#pragma unroll
    for (int q = 0; q < N * N; ++q) L.jac[q] = L.inv1[q] = L.br[q] = L.bi[q] = 0.0;
    status = fabs(tend - t) < 1e-15 ? SUCCESS : RUNNING;
    nfev = 1;
    njev = nlu = nstep = naccpt = nrejct = 0;
  } else {
    t = d.t[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const size_t q = (size_t)i * N + j;
      y[j] = d.y[q];
      L.f0[j] = c.f0[q];
      L.scal[j] = c.scal[q];
#pragma unroll
      for (int r = 0; r < 4; ++r) L.cont[r][j] = c.cont[((size_t)i * 4 + r) * N + j];
    }
#pragma unroll
    for (int q = 0; q < N * N; ++q) {
      const size_t g = (size_t)i * N * N + q;
      L.jac[q] = c.jac[g];
      L.inv1[q] = c.inv1[g];
      L.br[q] = c.br[g];
      L.bi[q] = c.bi[g];
    }
    L.h = c.h[i];
    L.hold = c.hold[i];
    L.posneg = c.posneg[i];
    L.first = c.first[i] != 0;
    L.reject = c.reject[i] != 0;
    L.last = c.last[i] != 0;
    L.faccon = faccon_p[i];
    L.theta = theta_p[i];
    L.hhfac = c.hhfac[i];
    L.h_acc = c.h_acc[i];
    L.err_acc = err_acc_p[i];
    L.call_jac = c.call_jac[i] != 0;
    L.call_decomp = c.call_decomp[i] != 0;
    L.singular = c.singular[i];
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
    int st = radau_attempt<F, CT>(f, a, t, y, naccpt, L, o, rtol_t, atol_t,
                                  tend, hmax, hmin, accepted, finished,
                                  count_step, count_reject, fe, je, le);
    // ---- core/driver.py: counters, then status priority ----
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
    const size_t q = (size_t)i * N + j;
    d.y[q] = y[j];
    c.f0[q] = L.f0[j];
    c.scal[q] = L.scal[j];
#pragma unroll
    for (int r = 0; r < 4; ++r) c.cont[((size_t)i * 4 + r) * N + j] = L.cont[r][j];
  }
#pragma unroll
  for (int q = 0; q < N * N; ++q) {
    const size_t g = (size_t)i * N * N + q;
    c.jac[g] = L.jac[q];
    c.inv1[g] = L.inv1[q];
    c.br[g] = L.br[q];
    c.bi[g] = L.bi[q];
  }
  c.h[i] = L.h;
  c.hold[i] = L.hold;
  c.posneg[i] = L.posneg;
  c.first[i] = L.first;
  c.reject[i] = L.reject;
  c.last[i] = L.last;
  faccon_p[i] = L.faccon;
  theta_p[i] = L.theta;
  c.hhfac[i] = L.hhfac;
  c.h_acc[i] = L.h_acc;
  err_acc_p[i] = L.err_acc;
  c.call_jac[i] = L.call_jac;
  c.call_decomp[i] = L.call_decomp;
  c.singular[i] = L.singular;
  d.status[i] = status;
  d.done[i] = status != RUNNING;
  d.nfev[i] = nfev;
  d.njev[i] = njev;
  d.nlu[i] = nlu;
  d.nstep[i] = nstep;
  d.naccpt[i] = naccpt;
  d.nrejct[i] = nrejct;
}

constexpr int RADAU_THREADS = 128;

template <class F>
int radau_launch(int B, const double* y0, const double* t0,
                 const double* first_step, StiffRun ra, const double* args,
                 RadauOptions o, StiffDriver d, RadauCarry c, int init,
                 int max_attempts, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + RADAU_THREADS - 1) / RADAU_THREADS;
  if (o.state_precision)
    radau_kernel<F, double><<<blocks, RADAU_THREADS, 0, (cudaStream_t)stream>>>(
        B, y0, t0, first_step, ra, args, o, d, c, init, max_attempts);
  else
    radau_kernel<F, float><<<blocks, RADAU_THREADS, 0, (cudaStream_t)stream>>>(
        B, y0, t0, first_step, ra, args, o, d, c, init, max_attempts);
  return (int)cudaGetLastError();
}

}  // namespace ivp

// One C entry per RHS functor with a Jacobian: ivp_radau_<name>.
#define IVP_RADAU_ENTRY(NAME, FUNCTOR)                                        \
  extern "C" int ivp_radau_##NAME(                                            \
      int B, const double* y0, const double* t0, const double* first_step,    \
      ivp::StiffRun ra, const double* args, ivp::RadauOptions o,              \
      ivp::StiffDriver d, ivp::RadauCarry c, int init, int max_attempts,      \
      void* stream) {                                                         \
    return ivp::radau_launch<FUNCTOR>(B, y0, t0, first_step, ra, args, o, d,  \
                                      c, init, max_attempts, stream);         \
  }

IVP_RADAU_ENTRY(vdp, VdP)
IVP_RADAU_ENTRY(decay, Decay)
IVP_RADAU_ENTRY(robertson, Robertson)

IVP_STIFF_INVERSES()
IVP_STIFF_LIBRARY()
