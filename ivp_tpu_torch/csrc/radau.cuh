// The Radau IIA(5) ensemble solve, float64, one thread a lane (the kernel
// template; radau.cu and radau_ev.cu instantiate its entries): the
// attempt of ivp_tpu_torch/methods/radau.py (itself ivp_tpu/methods/
// radau.py::make_radau_attempt, :348) with its inverse backend, in the loop
// of core/driver.py: to the final state, or emitting samples on a t_grid or
// one record row per accepted step (the MODE of stiff_common.cuh).
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
// What bounds it on an H100: each attempt is a chain of dependent float64
// divisions and square roots and float32 pow, so the FP64 pipe waits on
// latency unless many lanes are in flight.  The design: (1) a value that
// only one path reads is computed on that path alone (the divergence
// factor's pow, the convergence power theta^rem), which changes no bit of
// any output; (2) the lane's cold state (jac, inv1, br, bi, cont, f0, scal
// and its launch constants: RadauCold) lives in its shared-memory slots, so
// a thread needs fewer registers and more lanes are resident on an SM
// (IVP_RADAU_ENTRY's threads and min blocks); (3) the divisions, square
// roots and faccon's power run in four units (the decomposition, the head,
// each Newton iteration's rate, the tail with the error, the controller and
// the accepted step's rows), each straight through FastCtl's fast paths with
// one branch to the library's (FastOps, stiff_common.cuh), where ptxas gave
// every one of them its own test and slow-path call.
//
// The sampled and record modes (SAMPLED, RECORD) replace the same loop in
// core/driver.py's sample and record modes (ivp_tpu/core/driver.py
// :312-434, run_chunk :286-310, :448-457).  After an accepted step has
// written the collocation rows to the lane's slots, the lane evaluates them
// at every grid time the step covers (radau_interp) and writes its row
// [t, xold, h, y, cont], straight to global memory (StiffOut); nothing else
// of the step changes, so their steps, counters and final states are the
// LEAN kernel's.
//
// The event mode (an event set EV, radau_ev.cu's entries; the loop of
// ivp_tpu/core/driver.py::step_body :203-280 with events and restarts):
// after an accepted step the lane tests its events and refines each
// crossing on radau_interp over its cont slots (stiff_events.cuh); a
// terminal or restarting event becomes the step's end, whose row and
// samples are written from the step's collocation rows before a restart's
// init (radau_init, as a solve's first launch runs it) clears them.  With
// NoEvents, the instantiation of radau.cu's entries, it compiles away.
//
// The carry.  Each launch loads the lane's whole carry from device memory
// (the plain driver's Carry and RadauState, struct of arrays, the tensors the
// port's resumable solver holds) and stores it at the end; a solve's first
// launch (init) instead runs the method's init from y0 and t0.  A launch
// runs until the lane is done or has made max_attempts counted attempts
// (nstep) since it began, as core/driver.py::run_bounded counts them.
#pragma once

#include "stiff_common.cuh"
#include "stiff_events.cuh"

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

// A lane's cold state in its slots (doubles): the Jacobian and the three
// inverses (row-major N x N each), the collocation rows cont[4][N], f0 and
// scal, and the launch's constants of the lane: the transformed rtol and
// atol, tend, hmax and hmin.
template <int N>
struct RadauCold {
  static constexpr int JAC = 0, INV1 = N * N, BR = 2 * N * N, BI = 3 * N * N,
                       CONT = 4 * N * N, F0 = CONT + 4 * N, SCAL = F0 + N,
                       RTOL = SCAL + N, ATOL = RTOL + N, TEND = ATOL + N,
                       HMAX = TEND + 1, HMIN = TEND + 2;
  static constexpr int DOUBLES = 4 * N * N + 8 * N + 3;
};

constexpr int NEWTON_CONTINUE = 0, NEWTON_CONVERGED = 1, NEWTON_DIVERGED = 2,
              NEWTON_BAD_THETA = 3, NEWTON_MAXITER = 4;

// The lane's warm state in registers, its cold state in slots s.
template <int N, class CT, int T>
struct RadauLane {
  double h, hold, posneg;
  bool first, reject, last;
  CT faccon, theta;
  double hhfac, h_acc;
  CT err_acc;
  bool call_jac, call_decomp;
  int singular;
  Slots<T> s;
};

// The scaled sum of squares of v, in O's operations (a FastOps or LibOps
// member).
template <int N, class CT, class O>
__device__ __forceinline__ CT sumsq_c(O& op, const double* v,
                                      const CT* inv_scal) {
  CT s = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const CT q = op.mul((CT)v[j], inv_scal[j]);
    s = j ? op.add(s, op.mul(q, q)) : op.mul(q, q);
  }
  return s;
}

// The error norm: the RMS of v, floored at 1e-10.
template <int N, class CT, class O>
__device__ __forceinline__ CT rms_c(O& op, const double* v,
                                    const CT* inv_scal) {
  return op.vmax(sqrt_wide(op, div_n<N>(op, sumsq_c<N, CT>(op, v, inv_scal))),
                 (CT)1e-10);
}

// The Newton tolerance of a lane (lane-constant: its transformed rtol).
template <class CT>
__device__ __forceinline__ CT radau_newton_tol(const RadauOptions& o,
                                               double tolst) {
  if (!isnan(o.newton_tol)) return (CT)o.newton_tol;
  return (CT)nmax((10.0 * o.uround) / tolst, nmin(sqrt(tolst), 0.03));
}

// The decomposition unit: E1 = fac1 I - J and E2 = (alphn + i betan) I - J
// inverted into the slots' INV1, BR, BI; returns the singular flag.
template <int N, int T, class P>
__device__ __forceinline__ bool radau_decompose(P& op, double h,
                                                const Slots<T> s,
                                                double* inv1, double* br,
                                                double* bi) {
  using K = RadauCold<N>;
  using namespace radau;
  const auto dh = op.divisor(h);
  const double fac1 = op.div_by(U1, dh), alphn = op.div_by(ALPH, dh),
               betan = op.div_by(BETA, dh);
  double e1[N * N], e2r[N * N], e2i[N * N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double eye = i == j ? 1.0 : 0.0;
      const double jij = s[K::JAC + i * N + j];
      e1[i * N + j] = fac1 * eye - jij;
      e2r[i * N + j] = alphn * eye - jij;
      e2i[i * N + j] = betan * eye;
    }
  const bool s1 = inv_real_op<N>(op, e1, inv1);
  const bool s2 = inv_cplx_op<N>(op, e2r, e2i, br, bi);
  return s1 || s2;
}

// The head unit: h's quotients, the step ratio of the starting values, the
// Newton rate's starting faccon and the inverse scale.
template <int N, class CT, int T>
struct RadauHead {
  double fac1, alphn, betan, c3q;
  CT faccon, inv_scal[N];
  template <class P>
  __device__ __forceinline__ void run(P& op, const RadauLane<N, CT, T>& L,
                                      double uround) {
    using namespace radau;
    const auto dh = op.d.divisor(L.h);
    fac1 = op.d.div_by(U1, dh);
    alphn = op.d.div_by(ALPH, dh);
    betan = op.d.div_by(BETA, dh);
    c3q = op.d.div(L.h, L.hold);
    faccon = op.c.pow(op.c.vmax(L.faccon, (CT)uround), (CT)0.8);
#pragma unroll
    for (int j = 0; j < N; ++j)
      inv_scal[j] = (CT)op.d.div(1.0, L.s[RadauCold<N>::SCAL + j]);
  }
};

// One Newton iteration's rate unit: the increment's norm, the contraction
// rate theta and faccon, and whether the iteration converged, may go on,
// or diverges (dyth >= 1; read only where the rate was checked and is
// below 0.99).
template <class CT>
struct RadauRate {
  CT dyno, theta, thqold, faccon, dyth;
  bool check, ok_theta, diverged, converged;
  template <int N, class O>
  __device__ __forceinline__ void run(O& op, const double* x1,
                                      const double* x2, const double* x3,
                                      const CT* inv_scal, int it_n, int maxit,
                                      CT dynold, CT thqold_in, CT theta_in,
                                      CT faccon_in, CT newton_tol) {
    const CT tiny = tiny_of<CT>();
    dyno = sqrt_wide(
        op, div_wide(op, op.add(op.add(sumsq_c<N, CT>(op, x1, inv_scal),
                                       sumsq_c<N, CT>(op, x2, inv_scal)),
                                sumsq_c<N, CT>(op, x3, inv_scal)),
                     (CT)(3.0 * N)));
    check = it_n > 1 && it_n < maxit;
    // Every operand below that no output reads is a constant in range.
    const CT thq = div_wide(op, check ? dyno : (CT)0,
                            check ? op.vmax(dynold, tiny) : (CT)1);
    const bool root = check && it_n != 2;
    const CT th = sqrt_wide(op, root ? op.mul(thq, op.vmax(thqold_in, tiny))
                                     : (CT)1);
    theta = check ? (it_n == 2 ? thq : th) : theta_in;
    thqold = check ? thq : thqold_in;
    ok_theta = theta < (CT)0.99;
    const bool rate = check && ok_theta;
    const CT fq = div_wide(op, rate ? theta : (CT)0,
                           rate ? op.sub((CT)1, theta) : (CT)1);
    faccon = rate ? fq : faccon_in;
    // theta^rem as rem products from 1, then dyth; a product below 2^-62
    // over a tolerance from 2^-60 up is below 1/4, so it cannot diverge and
    // its quotient is not taken.
    const int rem_i = rate ? maxit - 1 - it_n : 0;
    CT theta_rem = 1;
    for (int k = 1; k <= rem_i; ++k) theta_rem = op.mul(theta_rem, theta);
    const CT num = op.mul(op.mul(faccon, dyno), theta_rem);
    const bool small = num < (CT)0x1p-62 && newton_tol >= (CT)0x1p-60;
    dyth = div_wide(op, rate && !small ? num : (CT)0, newton_tol);
    diverged = rate && !small && dyth >= (CT)1;
    converged = op.mul(faccon, dyno) <= newton_tol;
  }
};

// The error and controller unit after the Newton loop: the error estimate
// (with AGAIN, the second one of a first or rejected step whose first is
// above 1, an RHS call: the library's run only), the step-size
// controller and its predictive guess, the clamps and end test of an
// accepted step and the quotients of a rejected one, and the collocation
// rows an accepted step writes (cont[1..3]; cont[0] is ynew).
template <int N, class CT>
struct RadauTail {
  CT err, err_acc;
  double h_acc, hnew, hnew_acc, qt, hhfac_rej, t_new;
  bool accepted, hit_end, again;
  double ynew[N], c1r[N], c2r[N], c3r[N];
  template <bool AGAIN, class F, int T, class P>
  __device__ __forceinline__ void run(
      P& op, const F& f, const double* a, double t, const double* y,
      const double* z1, const double* z2, const double* z3,
      const RadauLane<N, CT, T>& L, const CT* inv_scal, const RadauOptions& o,
      bool converged, bool sing, bool too_small, CT newt, int naccpt,
      int& nfev) {
    using K = RadauCold<N>;
    using namespace radau;
    const Slots<T> s = L.s;
    const double h = L.h, posneg = L.posneg;
    const auto dh = op.d.divisor(h);
    const double hee0 = op.d.div_by(DD_0, dh), hee1 = op.d.div_by(DD_1, dh),
                 hee2 = op.d.div_by(DD_2, dh);
    double f1e[N], ev[N], err_vec[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      f1e[j] = hee0 * z1[j] + hee1 * z2[j] + hee2 * z3[j];
      ev[j] = f1e[j] + s[K::F0 + j];
    }
    matvec<N>(s.at(K::INV1), ev, err_vec);
    err = rms_c<N, CT>(op.c, err_vec, inv_scal);
    again = converged && err >= (CT)1 && (L.first || L.reject);
    if constexpr (AGAIN) {
      if (again) {
        double yy[N], fr[N], e2[N];
#pragma unroll
        for (int j = 0; j < N; ++j) yy[j] = err_vec[j] + y[j];
        f(t, yy, fr, a);
#pragma unroll
        for (int j = 0; j < N; ++j) fr[j] = fr[j] + f1e[j];
        matvec<N>(s.at(K::INV1), fr, e2);
        err = rms_c<N, CT>(op.c, e2, inv_scal);
        nfev += 1;
      }
    }
    const int maxit = o.newton_maxiter;
    const CT fac = op.c.vmin(
        op.c.div((CT)o.cfac, op.c.add(newt, (CT)(2.0 * maxit))),
        (CT)o.safety);
    CT quot = op.c.vmax(
        op.c.vmin(div_wide(op.c, sqrt_wide(op.c, sqrt_wide(op.c, err)), fac),
                  (CT)o.facl),
        (CT)o.facr);
    accepted = converged && err <= (CT)1 && !sing && !too_small;
    // The predictive guess, which counts only from the second accepted step
    // on; where it does not count, its operands are constants in range.
    const bool pred = o.predictive && accepted, guess = pred && naccpt + 1 > 1;
    const CT ratio = op.c.vmin(
        div_wide(op.c, guess ? op.c.mul(err, err) : (CT)1,
                 guess ? op.c.vmax(L.err_acc, (CT)1e-30) : (CT)1),
        (CT)1e30);
    CT facgus = div_wide(
        op.c,
        op.c.mul((CT)op.d.div_by(guess ? L.h_acc : h, dh),
                 sqrt_wide(op.c, sqrt_wide(op.c, ratio))),
        (CT)o.safety);
    facgus = op.c.vmax(op.c.vmin(facgus, (CT)o.facl), (CT)o.facr);
    quot = guess ? op.c.vmax(quot, facgus) : quot;
    h_acc = pred ? h : L.h_acc;
    err_acc = pred ? op.c.vmax(err, (CT)1e-2) : L.err_acc;
    hnew = hdiv_wide(op.c, h, quot);
    // The accepted step's end, clamps and rows.
    const double tend = s[K::TEND];
    t_new = L.last ? tend : t + h;
    const double clamped =
        nmin(nmax(fabs(hnew), s[K::HMIN]), s[K::HMAX]) * posneg;
    hnew_acc = L.reject ? posneg * nmin(fabs(clamped), fabs(h)) : clamped;
    hit_end =
        (t_new + div_wide(op.d, hnew_acc, o.quot1) - tend) * posneg >= 0.0;
    qt = div_by_wide(op.d, hnew_acc, dh);
    hhfac_rej = div_by_wide(op.d, hnew, dh);
    constexpr double R_C1MC2 = 1.0 / C1MC2, R_C1 = 1.0 / C1, R_C2 = 1.0 / C2,
                     R_C2M1 = 1.0 / C2M1, R_C1M1 = 1.0 / C1M1;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      ynew[j] = y[j] + z3[j];
      const double ak = div_known(op.d, z1[j] - z2[j], C1MC2, R_C1MC2);
      const double acont3 =
          div_known(op.d, ak - div_known(op.d, z1[j], C1, R_C1), C2, R_C2);
      c1r[j] = div_known(op.d, z2[j] - z3[j], C2M1, R_C2M1);
      c2r[j] = div_known(op.d, ak - c1r[j], C1M1, R_C1M1);
      c3r[j] = c2r[j] - acont3;
    }
  }
};

// One attempt of methods/radau.py::make_radau_attempt on lane L at (t, y)
// (advanced in place when accepted).  Returns the engine's status; the
// step's flags and counts go to the references.  Its divisions, square
// roots and powers run in four units (the decomposition, the head, each
// Newton iteration's rate, the tail), each on the fast paths with one
// branch to the library's (FastOps); the rest is the reference's order of
// operations.
template <class F, class CT, int T>
__device__ __forceinline__ int radau_attempt(
    const F& f, const double* a, double& t, double* y, int naccpt,
    RadauLane<F::N, CT, T>& L, const RadauOptions& o, CT newton_tol,
    bool& accepted, bool& finished, bool& count_step, bool& count_reject,
    int& nfev, int& njev, int& nlu) {
  constexpr int N = F::N;
  using C = Ctl<CT>;
  using K = RadauCold<N>;
  using namespace radau;
  const int maxit = o.newton_maxiter;
  const double h = L.h, posneg = L.posneg;
  const Slots<T> s = L.s;
  slots_fence();

  // ---- Jacobian (reused while theta stays small) ----
  njev = 0;
  if (L.call_jac) {
    double J[N * N];
    f.jac(t, y, J, a);
#pragma unroll
    for (int q = 0; q < N * N; ++q) s[K::JAC + q] = J[q];
    njev = o.const_jac ? 0 : 1;
  }
  // ---- Decompositions (reused when the step ratio stays near 1) ----
  bool sing = false;
  nlu = 0;
  if (L.call_decomp) {
    double inv1[N * N], br[N * N], bi[N * N];
    FastCtl<double> fast;
    sing = radau_decompose<N, T>(fast, h, s, inv1, br, bi);
    if (!fast.ok) {
      Ctl<double> lib;
      sing = radau_decompose<N, T>(lib, h, s, inv1, br, bi);
    }
#pragma unroll
    for (int q = 0; q < N * N; ++q) {
      s[K::INV1 + q] = inv1[q];
      s[K::BR + q] = br[q];
      s[K::BI + q] = bi[q];
    }
    nlu = 2;
  }
  const bool too_small = 0.1 * fabs(h) <= fabs(t) * o.uround;
  RadauHead<N, CT, T> hd;
  run_unit<CT>([&](auto& op) { hd.run(op, L, o.uround); });
  const double fac1 = hd.fac1, alphn = hd.alphn, betan = hd.betan;

  // ---- Newton starting values: the last collocation polynomial ----
  double z1[N], z2[N], z3[N], f1[N], f2[N], f3[N];
  if (L.first) {
#pragma unroll
    for (int j = 0; j < N; ++j) z1[j] = z2[j] = z3[j] = f1[j] = f2[j] = f3[j] = 0.0;
  } else {
    const double c3q = hd.c3q;
    const double c1q = C1 * c3q, c2q = C2 * c3q;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double ak1 = s[K::CONT + N + j], ak2 = s[K::CONT + 2 * N + j],
                   ak3 = s[K::CONT + 3 * N + j];
      z1[j] = c1q * (ak1 + (c1q - C2M1) * (ak2 + (c1q - C1M1) * ak3));
      z2[j] = c2q * (ak1 + (c2q - C2M1) * (ak2 + (c2q - C1M1) * ak3));
      z3[j] = c3q * (ak1 + (c3q - C2M1) * (ak2 + (c3q - C1M1) * ak3));
      f1[j] = TI_0_0 * z1[j] + TI_0_1 * z2[j] + TI_0_2 * z3[j];
      f2[j] = TI_1_0 * z1[j] + TI_1_1 * z2[j] + TI_1_2 * z3[j];
      f3[j] = TI_2_0 * z1[j] + TI_2_1 * z2[j] + TI_2_2 * z3[j];
    }
  }

  // ---- Simplified Newton iteration ----
  CT faccon = hd.faccon;
  const CT* inv_scal = hd.inv_scal;
  CT dynold = 0, thqold = 0, theta = (CT)fabs(o.thet);
  double hhfac = L.hhfac;
  int code = (sing || too_small) ? NEWTON_MAXITER : NEWTON_CONTINUE;
  int it = 0;
  nfev = 0;
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
    matvec<N>(s.at(K::INV1), r1, x1);
    matvec<N>(s.at(K::BR), r2, p1);
    matvec<N>(s.at(K::BI), r3, p2);
#pragma unroll
    for (int j = 0; j < N; ++j) x2[j] = p1[j] - p2[j];
    matvec<N>(s.at(K::BI), r2, p1);
    matvec<N>(s.at(K::BR), r3, p2);
#pragma unroll
    for (int j = 0; j < N; ++j) x3[j] = p1[j] + p2[j];

    const int it_n = it + 1;
    RadauRate<CT> r;
    run_unit<CT>([&](auto& op) {
      r.template run<N>(op.c, x1, x2, x3, inv_scal, it_n, maxit, dynold,
                        thqold, theta, faccon, newton_tol);
    });
    if (r.diverged) {
      // The step's new factor, only where the iteration diverges.
      const CT rem = C::sub((CT)(maxit - 1), (CT)it_n);
      const CT qnewt = C::vmin(C::vmax(r.dyth, (CT)1e-4), (CT)20);
      hhfac = (double)C::mul((CT)0.8,
                             C::pow(qnewt, (CT)-1 / C::add((CT)4, rem)));
    }
    const bool bad_theta = r.check && !r.ok_theta;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      f1[j] = f1[j] + x1[j];
      f2[j] = f2[j] + x2[j];
      f3[j] = f3[j] + x3[j];
      z1[j] = T_0_0 * f1[j] + T_0_1 * f2[j] + T_0_2 * f3[j];
      z2[j] = T_1_0 * f1[j] + T_1_1 * f2[j] + T_1_2 * f3[j];
      z3[j] = T_2_0 * f1[j] + f2[j];
    }
    code = bad_theta     ? NEWTON_BAD_THETA
           : r.diverged  ? NEWTON_DIVERGED
           : r.converged ? NEWTON_CONVERGED
                         : NEWTON_CONTINUE;
    it = it_n;
    dynold = C::vmax(r.dyno, (CT)o.uround);
    thqold = r.thqold;
    theta = r.theta;
    faccon = r.faccon;
    nfev += 3;
  }
  slots_fence();
  const bool converged = code == NEWTON_CONVERGED;

  // ---- Error estimation and step-size controller ----
  RadauTail<N, CT> tl;
  {
    // As run_unit; a second error estimate (again) takes the library's run,
    // the one with the RHS call.
    FastOps<CT> fast;
    tl.template run<false>(fast, f, a, t, y, z1, z2, z3, L, inv_scal, o,
                           converged, sing, too_small, (CT)it, naccpt, nfev);
    bool done = fast.ok() && !tl.again;
    if (!fast.ok() && !tl.again) {
      WideOps<CT> wide;
      tl.template run<false>(wide, f, a, t, y, z1, z2, z3, L, inv_scal, o,
                             converged, sing, too_small, (CT)it, naccpt,
                             nfev);
      done = wide.ok() && !tl.again;
    }
    if (!done) {
      LibOps<CT> lib;
      tl.template run<true>(lib, f, a, t, y, z1, z2, z3, L, inv_scal, o,
                            converged, sing, too_small, (CT)it, naccpt, nfev);
    }
  }
  accepted = tl.accepted;

  // ---- Accept and reject paths ----
  const bool diverged = code == NEWTON_DIVERGED;
  const bool broke =
      code == NEWTON_MAXITER || code == NEWTON_BAD_THETA || sing;
  finished = accepted && L.last;
  count_step = !sing;
  count_reject = !accepted && !sing &&
                 (diverged || (converged && tl.err > (CT)1 && !L.first));
  double h_next, hhfac_next;
  if (accepted) {
    const double tend = s[K::TEND];
    const double t_new = tl.t_new;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      s[K::CONT + j] = tl.ynew[j];
      s[K::CONT + N + j] = tl.c1r[j];
      s[K::CONT + 2 * N + j] = tl.c2r[j];
      s[K::CONT + 3 * N + j] = tl.c3r[j];
    }
    double f0[N];
    f(t_new, tl.ynew, f0, a);
    nfev += 1;
    const bool hit_end = tl.hit_end;
    const double qt = tl.qt;
    const bool reuse = !hit_end && theta < (CT)o.thet && qt > o.quot1 &&
                       qt < o.quot2;
    h_next = hit_end ? tend - t_new : (reuse ? h : tl.hnew_acc);
    hhfac_next = reuse ? L.hhfac : h_next;
    L.call_jac = !reuse && theta >= (CT)o.thet;
    L.call_decomp = !reuse;
    L.singular = 0;
    L.hold = h;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      s[K::F0 + j] = f0[j];
      s[K::SCAL + j] = s[K::ATOL + j] + s[K::RTOL + j] * fabs(tl.ynew[j]);
      y[j] = tl.ynew[j];
    }
    L.first = false;
    L.reject = false;
    L.last = hit_end;
    t = t_new;
  } else {
    const double h_rej = L.first ? h * 0.1 : tl.hnew;
    const double hhfac_rej = L.first ? 0.1 : tl.hhfac_rej;
    h_next = diverged ? h * hhfac : (broke ? h * 0.5 : h_rej);
    hhfac_next = diverged ? hhfac : (broke ? 0.5 : hhfac_rej);
    L.call_decomp = true;
    if (broke) L.singular += 1;
    L.reject = L.reject || diverged || tl.err > (CT)1 || broke;
    L.last = false;
  }
  L.faccon = faccon;
  L.theta = theta;
  L.hhfac = hhfac_next;
  L.h_acc = tl.h_acc;
  L.err_acc = tl.err_acc;
  L.h = h_next;
  if (too_small) return STEP_SIZE_TOO_SMALL;
  if (broke && L.singular > 5) return SINGULAR_MATRIX;
  return RUNNING;
}

// methods/radau.py::radau_interp: the collocation polynomial of the step
// (xold, h) (rows cont[4][N], an array or a lane's Slots) at ti, in s = (ti -
// (xold + h)) / h.
template <int N, class M>
__device__ __forceinline__ void radau_interp(const M& cont, double xold,
                                             double h, double ti, double* yi) {
  const double s = (ti - (xold + h)) / h;
#pragma unroll
  for (int j = 0; j < N; ++j)
    yi[j] = cont[j] + s * (cont[N + j] + (s - radau::C2M1) * (
        cont[2 * N + j] + (s - radau::C1M1) * cont[3 * N + j]));
}

// methods/radau.py::make_radau_init on lane L at (t, y), its first step fs
// (NaN: the method's) and its tolerances in the slots: a solve's first
// launch and an event restart (core/driver.py::step_body, first step NaN)
// run it.  One RHS evaluation.
template <class F, class CT, int T>
__device__ __forceinline__ void radau_init(const F& f, const double* a,
                                           double t, const double* y,
                                           double fs, double tend,
                                           double hmax,
                                           RadauLane<F::N, CT, T>& L,
                                           const RadauOptions& o) {
  constexpr int N = F::N;
  using K = RadauCold<N>;
  const Slots<T> s = L.s;
  L.posneg = sgn(tend - t);
  double h = isnan(fs) ? 1.0e-6 * L.posneg : fabs(fs) * L.posneg;
  h = nmin(nmax(h, -hmax), hmax);
  L.h = L.hold = L.hhfac = h;
  double f0[N];
  f(t, y, f0, a);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[K::F0 + j] = f0[j];
    s[K::SCAL + j] = s[K::ATOL + j] + s[K::RTOL + j] * fabs(y[j]);
#pragma unroll
    for (int q = 0; q < 4; ++q) s[K::CONT + q * N + j] = 0.0;
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
  for (int q = 0; q < 4 * N * N; ++q) s[K::JAC + q] = 0.0;
}

// The doubles of a lane's slots: RadauCold's, and with an event set its
// event state (EvSlots).
template <class F, class EV>
__host__ __device__ constexpr int radau_slots() {
  return RadauCold<F::N>::DOUBLES + EvSlots<EV::E, 0>::DOUBLES;
}

// The kernel of a mode, and with an event set EV (EV::E > 0) its event mode
// (stiff_events.cuh; ev its buffers, and in RECORD its carry between
// chunks); with NoEvents the event code compiles away.
template <class F, class CT, int T, int MB, int MODE, class EV = NoEvents>
__global__ void __launch_bounds__(T, MB) radau_kernel(
    int B, const double* __restrict__ y0, const double* __restrict__ t0,
    const double* __restrict__ first_step, const StiffRun ra,
    const double* __restrict__ args, const RadauOptions o,
    const StiffDriver d_in, const RadauCarry c_in, StiffDriver d, RadauCarry c,
    int init, int max_attempts, const StiffModes md, const ErkEvents ev) {
  constexpr int N = F::N;
  constexpr int NE = EV::E;
  using K = RadauCold<N>;
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
  RadauLane<N, CT, T> L;
  L.s = lane_slots<T>();
  const Slots<T> s = L.s;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[K::RTOL + j] = rtol_t[j];
    s[K::ATOL + j] = atol_t[j];
  }
  s[K::TEND] = tend;
  s[K::HMAX] = hmax;
  s[K::HMIN] = hmin;
  double t;
  int status, nfev, njev, nlu, nstep, naccpt, nrejct;
  CT* faccon_p = (CT*)c.faccon;
  CT* theta_p = (CT*)c.theta;
  CT* err_acc_p = (CT*)c.err_acc;
  const CT* faccon_in = (const CT*)c_in.faccon;
  const CT* theta_in = (const CT*)c_in.theta;
  const CT* err_acc_in = (const CT*)c_in.err_acc;
  if (init) {
    // methods/radau.py::make_radau_init, then the driver's init_carry.
    t = t0[i];
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = y0[(size_t)i * N + j];
    radau_init<F, CT, T>(f, a, t, y, first_step[i], tend, hmax, L, o);
    status = fabs(tend - t) < 1e-15 ? SUCCESS : RUNNING;
    nfev = 1;
    njev = nlu = nstep = naccpt = nrejct = 0;
  } else {
    t = d_in.t[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const size_t q = (size_t)i * N + j;
      y[j] = d_in.y[q];
      s[K::F0 + j] = c_in.f0[q];
      s[K::SCAL + j] = c_in.scal[q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s[K::CONT + r * N + j] = c_in.cont[((size_t)i * 4 + r) * N + j];
    }
#pragma unroll
    for (int q = 0; q < N * N; ++q) {
      const size_t g = (size_t)i * N * N + q;
      s[K::JAC + q] = c_in.jac[g];
      s[K::INV1 + q] = c_in.inv1[g];
      s[K::BR + q] = c_in.br[g];
      s[K::BI + q] = c_in.bi[g];
    }
    L.h = c_in.h[i];
    L.hold = c_in.hold[i];
    L.posneg = c_in.posneg[i];
    L.first = c_in.first[i] != 0;
    L.reject = c_in.reject[i] != 0;
    L.last = c_in.last[i] != 0;
    L.faccon = faccon_in[i];
    L.theta = theta_in[i];
    L.hhfac = c_in.hhfac[i];
    L.h_acc = c_in.h_acc[i];
    L.err_acc = err_acc_in[i];
    L.call_jac = c_in.call_jac[i] != 0;
    L.call_decomp = c_in.call_decomp[i] != 0;
    L.singular = c_in.singular[i];
    status = d_in.status[i];
    nfev = d_in.nfev[i];
    njev = d_in.njev[i];
    nlu = d_in.nlu[i];
    nstep = d_in.nstep[i];
    naccpt = d_in.naccpt[i];
    nrejct = d_in.nrejct[i];
  }

  const CT newton_tol = radau_newton_tol<CT>(o, rtol_t[0]);
  const int nstep0 = nstep;
  const EV evf{};
  if constexpr (NE > 0) ev_load<EV, T, K::DOUBLES>(evf, ev, s, i, init, t, y, a);
  // RECORD stages its rows in the shared memory past the slots, in 16-byte
  // pairs.
  using Stage = std::conditional_t<MODE == STIFF_RECORD,
                                   SlotsStage<T, radau_slots<F, EV>(), true>,
                                   NoStage>;
  StiffOut<N, 4, MODE, Stage> out(md, i, init);
  while (status == RUNNING && nstep - nstep0 < max_attempts && !out.full()) {
    bool accepted, finished, count_step, count_reject;
    int fe, je, le;
    const double xold = t, h_used = L.h;
    double y_old[NE > 0 ? N : 1];
    if constexpr (NE > 0) {
#pragma unroll
      for (int j = 0; j < N; ++j) y_old[j] = y[j];
    }
    int st = radau_attempt<F, CT, T>(f, a, t, y, naccpt, L, o, newton_tol,
                                     accepted, finished, count_step,
                                     count_reject, fe, je, le);
    // ---- core/driver.py: counters, events, then status priority ----
    nstep += count_step ? 1 : 0;
    naccpt += accepted ? 1 : 0;
    nrejct += count_reject ? 1 : 0;
    nfev += fe;
    njev += je;
    nlu += le;
    const Slots<T> cont = s.at(K::CONT);
    const auto interp = [&](double ti, double* yi) {
      radau_interp<N>(cont, xold, h_used, ti, yi);
    };
    EvOutcome eo;
    if constexpr (NE > 0) {
      // The step's events from its collocation rows; a terminal or
      // restarting event's time and state become the step's end.
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
    if (st == RUNNING && eo.terminal) st = USER_INTERRUPT;
    if (st == RUNNING && finished && !eo.restart) st = SUCCESS;
    if (st == RUNNING && nstep > ra.max_steps) st = NEED_LARGER_NMAX;
    status = st;
    if constexpr (MODE != STIFF_LEAN) {
      if (accepted) {
        out.record(t, xold, h_used, y,
                   [&](int q, int j) { return cont[q * N + j]; });
        out.samples(t, L.posneg, interp);
      }
    }
    if constexpr (NE > 0) {
      // The restart: the method's init at the event point, after the
      // step's row and samples have read its collocation rows.
      if (eo.restart) {
        radau_init<F, CT, T>(f, a, t, y, NAN, tend, hmax, L, o);
        nfev += 1;
      }
    }
  }
  out.store();
  if constexpr (NE > 0) ev_store<NE, T, K::DOUBLES>(ev, s, i);

  d.t[i] = t;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const size_t q = (size_t)i * N + j;
    d.y[q] = y[j];
    c.f0[q] = s[K::F0 + j];
    c.scal[q] = s[K::SCAL + j];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      c.cont[((size_t)i * 4 + r) * N + j] = s[K::CONT + r * N + j];
  }
#pragma unroll
  for (int q = 0; q < N * N; ++q) {
    const size_t g = (size_t)i * N * N + q;
    c.jac[g] = s[K::JAC + q];
    c.inv1[g] = s[K::INV1 + q];
    c.br[g] = s[K::BR + q];
    c.bi[g] = s[K::BI + q];
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

// A RECORD launch's stage, at the entry's min blocks, beside the slots of
// the event set EV's lanes.
template <class F, int T, int MB, class EV = NoEvents>
int radau_stage(int B, bool record_cont, int* bytes, int* k) {
  return record_stage<T, radau_slots<F, EV>(), F::N, 4>(B, MB, record_cont,
                                                        bytes, k);
}

template <class F, class CT, int T, int MB, int MODE, class EV>
int radau_launch_as(int B, const double* y0, const double* t0,
                    const double* first_step, StiffRun ra, const double* args,
                    RadauOptions o, StiffDriver d_in, RadauCarry c_in,
                    StiffDriver d, RadauCarry c, int init, int max_attempts,
                    StiffModes md, ErkEvents ev, void* stream) {
  constexpr int bytes = 8 * radau_slots<F, EV>() * T;
  static_assert(bytes <= SLOTS_BLOCK_MAX, "the slots exceed a block's");
  auto kernel = radau_kernel<F, CT, T, MB, MODE, EV>;
  int smem = bytes, k = 0, err = 0;
  if constexpr (MODE == STIFF_RECORD) {
    // The bulk copies take rows of the stride the stage has, 16-byte
    // aligned.
    if (md.stride != row_stride(F::N, 4, md.record_cont != 0) ||
        ((uintptr_t)md.rows & 15) != 0)
      return (int)cudaErrorInvalidValue;
    err = radau_stage<F, T, MB, EV>(B, md.record_cont != 0, &smem, &k);
  }
  if (!err) err = allow_slots(kernel, smem);
  if (err) return err;
  kernel<<<(B + T - 1) / T, T, smem, (cudaStream_t)stream>>>(
      B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
      max_attempts, md, ev);
  return (int)cudaGetLastError();
}

// T, MB: threads a block and min blocks an SM, under either controller type
// and in every mode, with the event set EV.
template <class F, int T, int MB, int MODE, class EV = NoEvents>
int radau_launch(int B, const double* y0, const double* t0,
                 const double* first_step, StiffRun ra, const double* args,
                 RadauOptions o, StiffDriver d_in, RadauCarry c_in,
                 StiffDriver d, RadauCarry c, int init, int max_attempts,
                 StiffModes md, ErkEvents ev, void* stream) {
  if (B <= 0) return 0;
  if (o.state_precision)
    return radau_launch_as<F, double, T, MB, MODE, EV>(
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
        max_attempts, md, ev, stream);
  return radau_launch_as<F, float, T, MB, MODE, EV>(
      B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
      max_attempts, md, ev, stream);
}

// A SAMPLED or RECORD launch: RECORD where md has rows (cap > 0); with an
// event set (EV::E > 0) also LEAN, where md has neither rows nor a grid.
template <class F, int T, int MB, class EV = NoEvents>
int radau_modes_launch(int B, const double* y0, const double* t0,
                       const double* first_step, StiffRun ra,
                       const double* args, RadauOptions o, StiffDriver d_in,
                       RadauCarry c_in, StiffDriver d, RadauCarry c, int init,
                       int max_attempts, StiffModes md, ErkEvents ev,
                       void* stream) {
  if (md.cap > 0)
    return radau_launch<F, T, MB, STIFF_RECORD, EV>(
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
        max_attempts, md, ev, stream);
  if (EV::E > 0 && md.m == 0)
    return radau_launch<F, T, MB, STIFF_LEAN, EV>(
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
        max_attempts, md, ev, stream);
  return radau_launch<F, T, MB, STIFF_SAMPLED, EV>(
      B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,
      max_attempts, md, ev, stream);
}

// slots_layout of the instantiation a launch of B lanes takes, with its
// RECORD stage (rows with coefficients or without) in the lane's and the
// block's bytes.
template <class F, int T, int MB, int MODE>
int radau_layout(int state_precision, int B, int record_cont, int* info) {
  int bytes = 8 * RadauCold<F::N>::DOUBLES * T, k = 0;
  if constexpr (MODE == STIFF_RECORD) {
    const int err = radau_stage<F, T, MB>(B, record_cont != 0, &bytes, &k);
    if (err) return err;
  }
  if (state_precision)
    return slots_layout(radau_kernel<F, double, T, MB, MODE>, T, MB,
                        bytes / T, info);
  return slots_layout(radau_kernel<F, float, T, MB, MODE>, T, MB, bytes / T,
                      info);
}

// The layout of a mode's instantiation, then info[7] the stage's rows a
// lane and info[8] its bytes a lane (0 and 0 unstaged).
template <class F, int T, int MB>
int radau_modes_layout(int mode, int state_precision, int B, int* info,
                       int record_cont) {
  const int err =
      mode == STIFF_RECORD
          ? radau_layout<F, T, MB, STIFF_RECORD>(state_precision, B,
                                                 record_cont, info)
      : mode == STIFF_SAMPLED
          ? radau_layout<F, T, MB, STIFF_SAMPLED>(state_precision, B, 0, info)
          : radau_layout<F, T, MB, STIFF_LEAN>(state_precision, B, 0, info);
  if (err) return err;
  stage_info<RadauCold<F::N>::DOUBLES, F::N, 4>(record_cont != 0, info);
  return 0;
}

}  // namespace ivp

// One C entry per RHS functor with a Jacobian: ivp_radau_<name> (the carry
// it loads, d_in and c_in, and the one it stores, d and c),
// ivp_radau_modes_<name> (the same with the samples or rows of md), and
// ivp_radau_layout_<name> / ivp_radau_modes_layout_<name> (slots_layout of
// the instantiation a launch of B lanes under a controller type, in a mode,
// takes; RECORD with the stage of rows with coefficients or without,
// record_cont).  T, MB: threads a block and min
// blocks an SM under both controller types, from measure_kernel.py's stiff
// occupancy sweep on an H100 (PERF.md); one instantiation serves every B,
// since at (128, 3) Radau spills nothing either and runs no faster at
// B=16384.  Robertson's slots (504 bytes a lane) leave room for 3 blocks.
#define IVP_RADAU_ENTRY(NAME, FUNCTOR, T, MB)                                 \
  extern "C" int ivp_radau_##NAME(                                            \
      int B, const double* y0, const double* t0, const double* first_step,    \
      ivp::StiffRun ra, const double* args, ivp::RadauOptions o,              \
      ivp::StiffDriver d_in, ivp::RadauCarry c_in, ivp::StiffDriver d,        \
      ivp::RadauCarry c, int init, int max_attempts, void* stream) {          \
    return ivp::radau_launch<FUNCTOR, IVP_RADAU_BOUNDS(T, MB),              \
                             ivp::STIFF_LEAN>(                                \
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,           \
        max_attempts, ivp::StiffModes{}, ivp::ErkEvents{}, stream);           \
  }                                                                           \
  extern "C" int ivp_radau_modes_##NAME(                                      \
      int B, const double* y0, const double* t0, const double* first_step,    \
      ivp::StiffRun ra, const double* args, ivp::RadauOptions o,              \
      ivp::StiffDriver d_in, ivp::RadauCarry c_in, ivp::StiffDriver d,        \
      ivp::RadauCarry c, int init, int max_attempts, ivp::StiffModes md,      \
      void* stream) {                                                         \
    return ivp::radau_modes_launch<FUNCTOR, IVP_RADAU_BOUNDS(T, MB)>(         \
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,           \
        max_attempts, md, ivp::ErkEvents{}, stream);                          \
  }                                                                           \
  extern "C" int ivp_radau_layout_##NAME(int state_precision, int B,        \
                                         int* info) {                         \
    return ivp::radau_layout<FUNCTOR, IVP_RADAU_BOUNDS(T, MB),                \
                             ivp::STIFF_LEAN>(state_precision, B, 0, info);   \
  }                                                                           \
  extern "C" int ivp_radau_modes_layout_##NAME(int mode, int state_precision, \
                                               int B, int* info,              \
                                               int record_cont) {             \
    return ivp::radau_modes_layout<FUNCTOR, IVP_RADAU_BOUNDS(T, MB)>(         \
        mode, state_precision, B, info, record_cont);                         \
  }

// One C entry per RHS functor and event set (radau_ev.cu):
// ivp_radau_ev_<name>_<set>, the modes' entry with the set's event buffers
// ev (kernels/erk_ensemble.py::KernelEvents; the values and hit counts kept
// between a record solve's chunks), in LEAN where md has neither a grid nor
// rows.  T, MB as the functor's IVP_RADAU_ENTRY.
#define IVP_RADAU_EVENT_ENTRY(NAME, FUNCTOR, SET, EVENTS, T, MB)              \
  extern "C" int ivp_radau_ev_##NAME##_##SET(                                 \
      int B, const double* y0, const double* t0, const double* first_step,    \
      ivp::StiffRun ra, const double* args, ivp::RadauOptions o,              \
      ivp::StiffDriver d_in, ivp::RadauCarry c_in, ivp::StiffDriver d,        \
      ivp::RadauCarry c, int init, int max_attempts, ivp::StiffModes md,      \
      ivp::ErkEvents ev, void* stream) {                                      \
    return ivp::radau_modes_launch<FUNCTOR, IVP_RADAU_BOUNDS(T, MB), EVENTS>( \
        B, y0, t0, first_step, ra, args, o, d_in, c_in, d, c, init,           \
        max_attempts, md, ev, stream);                                        \
  }
