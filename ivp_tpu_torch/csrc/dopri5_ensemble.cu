// Fused adaptive DOPRI5 ensemble solve, final-state mode, float64.
//
// Replaces attic/pallas_erk.py::dopri5_ensemble_pallas (the TPU kernel that
// ran the whole DOPRI5 loop of a block of lanes with its carry in VMEM) and,
// through it, the live main path of ivp_tpu: the XLA-fused, vmapped
// core/driver.py::run_chunk around methods/erk.py::dopri5_attempt.  It
// computes what that live path computes (not the attic's f32 subset): per-lane
// hinit, the 7-stage FSAL step, the 5(4) RMS error norm, the stiffness
// detector, the Lund-stabilised PI controller on log(facold) in float32, the
// driver's counters and its status priority, per-lane t0/tf/hmax/first_step,
// per-lane rtol/atol per component and per-lane RHS parameters.
//
// What bounds it on an H100: float64 arithmetic (six RHS evaluations and ~30
// n-vector axpys per attempt) and divergence between lanes of a warp that need
// different numbers of steps: a warp runs until its slowest lane is done.
// Device memory is touched once per lane: the inputs are read at the start
// and the final state and counters written at the end.
//
// What the design does about it: one thread per lane, the whole carry (t, y,
// h, k1, the controller memory and the counters) in registers, one launch per
// solve and no host synchronisation per step.  Lane compaction and persistent
// blocks, to cut the divergence, are later work.
//
// Semantics kept line for line with methods/erk.py and core/driver.py (each
// can change a step count):
//   * controller_precision="float32": the error norm, stiffness detector and
//     controller run in float with float literals; err_vec is formed in
//     double and cast; h / fac promotes fac to double only at the division.
//     The float mul/add chains use __f*_rn intrinsics so nvcc cannot contract
//     them into FMAs the reference does not have.
//   * nfev = 2 at init (1 with first_step), +6 per attempt.
//   * nrejct counts ~accepted & (naccpt > 1) & ~too_small, with the naccpt
//     from before the attempt.
//   * NEED_LARGER_NMAX when nstep > max_steps after the increment.
//   * status priority: engine failure, then reached tend, then step budget.
//   * a lane with |tf - t0| < 1e-15 is done at init with SUCCESS.
//   * k1 advances only on advance; facold updates on accepted.
//   * jnp.minimum/maximum propagate NaN, so min/max here do too.
// Built without --use_fast_math (kernels/build.py).
#include <cuda_runtime.h>
#include <math.h>

#include "rhs/decay.cuh"
#include "rhs/lorenz.cuh"
#include "rhs/vdp.cuh"

namespace {

// ivp_tpu_torch/types.py::Status
constexpr int RUNNING = -1;
constexpr int SUCCESS = 0;
constexpr int NEED_LARGER_NMAX = 2;
constexpr int STEP_SIZE_TOO_SMALL = 3;
constexpr int PROBABLY_STIFF = 4;

// DOPRI5 tableau (tableaus.py), evaluated as the reference does in double.
constexpr double C2 = 0.2, C3 = 0.3, C4 = 0.8, C5 = 8.0 / 9.0;
constexpr double A21 = 0.2;
constexpr double A31 = 3.0 / 40.0, A32 = 9.0 / 40.0;
constexpr double A41 = 44.0 / 45.0, A42 = -56.0 / 15.0, A43 = 32.0 / 9.0;
constexpr double A51 = 19372.0 / 6561.0, A52 = -25360.0 / 2187.0,
                 A53 = 64448.0 / 6561.0, A54 = -212.0 / 729.0;
constexpr double A61 = 9017.0 / 3168.0, A62 = -355.0 / 33.0,
                 A63 = 46732.0 / 5247.0, A64 = 49.0 / 176.0,
                 A65 = -5103.0 / 18656.0;
constexpr double A71 = 35.0 / 384.0, A73 = 500.0 / 1113.0,
                 A74 = 125.0 / 192.0, A75 = -2187.0 / 6784.0,
                 A76 = 11.0 / 84.0;
constexpr double E1 = 71.0 / 57600.0, E3 = -71.0 / 16695.0,
                 E4 = 71.0 / 1920.0, E5 = -17253.0 / 339200.0,
                 E6 = 22.0 / 525.0, E7 = -1.0 / 40.0;

// ERKParams defaults for DOPRI5 (methods/erk.py), as the float32 controller
// sees them: Python floats rounded to float.
constexpr double UROUND = 2.3e-16;
constexpr float SAFETY = 0.9f;
constexpr float FACC1 = (float)(1.0 / 0.2);
constexpr float FACC2 = (float)(1.0 / 10.0);
constexpr float BETA = 0.04f;
constexpr float EXPO1 = (float)(0.2 - 0.04 * 0.75);
constexpr float STIFF_THRESHOLD = 3.25f;
constexpr int STIFF_TEST = 1000;
// float(math.log(1e-4)); also the value of logf(1e-4f), the initial facold.
constexpr float LOG_FACOLD_FLOOR = (float)(-9.210340371976182);

__device__ __forceinline__ double nmax(double a, double b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ double nmin(double a, double b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmaxf(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nminf(float a, float b) {
  return (a < b || a != a) ? a : b;
}
// jnp.sign: -1, 0 or 1, NaN for NaN.
__device__ __forceinline__ double sgn(double x) {
  return x > 0.0 ? 1.0 : (x < 0.0 ? -1.0 : x);
}

// core/common.py::hinit, all in double.
template <class F>
__device__ double hinit(const F& f, double t, const double* y, double posneg,
                        const double* f0, double hmax, const double* atol,
                        const double* rtol, const double* args) {
  constexpr int N = F::N;
  double sk[N], y1[N], f1[N];
  double dnf = 0.0, dny = 0.0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    sk[j] = atol[j] + rtol[j] * fabs(y[j]);
    const double a = f0[j] / sk[j], b = y[j] / sk[j];
    dnf += a * a;
    dny += b * b;
  }
  double h = (dnf <= 1e-10 || dny <= 1e-10) ? 1.0e-6 : sqrt(dny / dnf) * 0.01;
  h = nmin(h, fabs(hmax));
  h = fabs(h) * sgn(posneg);
#pragma unroll
  for (int j = 0; j < N; ++j) y1[j] = y[j] + h * f0[j];
  f(t + h, y1, f1, args);
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const double d = (f1[j] - f0[j]) / sk[j];
    s += d * d;
  }
  const double der2 = sqrt(s) / fabs(h);
  const double der12 = nmax(fabs(der2), sqrt(dnf));
  const double h1 = der12 <= 1.0e-15 ? nmax(1.0e-6, fabs(h) * 1.0e-3)
                                     : pow(0.01 / der12, 1.0 / 5.0);
  const double hf = nmin(nmin(fabs(h), h1), fabs(hmax));
  return fabs(hf) * sgn(posneg);
}

template <class F>
__global__ void __launch_bounds__(128) dopri5_ensemble_kernel(
    int B, const double* __restrict__ y0, const double* __restrict__ t0,
    const double* __restrict__ tf, const double* __restrict__ hmax_in,
    const double* __restrict__ first_step, const double* __restrict__ rtol,
    const double* __restrict__ atol, const double* __restrict__ args,
    int max_steps, double* __restrict__ t_out, double* __restrict__ y_out,
    int* __restrict__ status_out, int* __restrict__ nfev_out,
    int* __restrict__ nstep_out, int* __restrict__ naccpt_out,
    int* __restrict__ nrejct_out) {
  constexpr int N = F::N;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const F f{};

  double a[F::NARGS > 0 ? F::NARGS : 1];
#pragma unroll
  for (int j = 0; j < F::NARGS; ++j) a[j] = args[(size_t)i * F::NARGS + j];

  double y[N], k1[N], rt[N], at[N];
  float rtf[N], atf[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const size_t o = (size_t)i * N + j;
    y[j] = y0[o];
    rt[j] = rtol[o];
    at[j] = atol[o];
    rtf[j] = (float)rt[j];
    atf[j] = (float)at[j];
  }
  double t = t0[i];
  const double tend = tf[i];
  const double hmax = fabs(hmax_in[i]);
  const double posneg = sgn(tend - t);

  // methods/erk.py::erk_init
  f(t, y, k1, a);
  double h;
  int nfev;
  if (!isnan(first_step[i])) {
    h = fabs(first_step[i]) * posneg;
    nfev = 1;
  } else {
    h = hinit(f, t, y, posneg, k1, hmax, at, rt, a);
    nfev = 2;
  }
  float facold = LOG_FACOLD_FLOOR;
  float hlamb = 0.0f;
  bool reject = false;
  int iasti = 0, nonstiff = 0;
  int nstep = 0, naccpt = 0, nrejct = 0;
  int status = fabs(tend - t) < 1e-15 ? SUCCESS : RUNNING;

  while (status == RUNNING) {
    // ---- methods/erk.py::dopri5_attempt ----
    const bool too_small = 0.1 * fabs(h) <= fabs(t) * UROUND;
    const bool last = __dmul_rn(__dadd_rn(__dadd_rn(t, __dmul_rn(1.01, h)),
                                          -tend),
                                posneg) > 0.0;
    if (last) h = tend - t;

    double k2[N], k3[N], k4[N], k5[N], k6[N], k7[N], ys[N], ysti[N], ynew[N];
#pragma unroll
    for (int j = 0; j < N; ++j) ys[j] = y[j] + h * (A21 * k1[j]);
    f(t + C2 * h, ys, k2, a);
#pragma unroll
    for (int j = 0; j < N; ++j) ys[j] = y[j] + h * (A31 * k1[j] + A32 * k2[j]);
    f(t + C3 * h, ys, k3, a);
#pragma unroll
    for (int j = 0; j < N; ++j)
      ys[j] = y[j] + h * (A41 * k1[j] + A42 * k2[j] + A43 * k3[j]);
    f(t + C4 * h, ys, k4, a);
#pragma unroll
    for (int j = 0; j < N; ++j)
      ys[j] = y[j] + h * (A51 * k1[j] + A52 * k2[j] + A53 * k3[j] +
                          A54 * k4[j]);
    f(t + C5 * h, ys, k5, a);
#pragma unroll
    for (int j = 0; j < N; ++j)
      ysti[j] = y[j] + h * (A61 * k1[j] + A62 * k2[j] + A63 * k3[j] +
                            A64 * k4[j] + A65 * k5[j]);
    f(t + h, ysti, k6, a);
#pragma unroll
    for (int j = 0; j < N; ++j)
      ynew[j] = y[j] + h * (A71 * k1[j] + A73 * k3[j] + A74 * k4[j] +
                            A75 * k5[j] + A76 * k6[j]);
    f(t + h, ynew, k7, a);

    // Error norm in float: err_vec in double, cast; sk and the mean in float.
    float ssum = 0.0f, stnum = 0.0f, stden = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double ev = h * (E1 * k1[j] + E3 * k3[j] + E4 * k4[j] +
                             E5 * k5[j] + E6 * k6[j] + E7 * k7[j]);
      const float sk = __fadd_rn(
          atf[j], __fmul_rn(rtf[j], nmaxf(fabsf((float)y[j]),
                                          fabsf((float)ynew[j]))));
      const float r = (float)ev / sk;
      ssum = __fadd_rn(ssum, __fmul_rn(r, r));
      const float dk = (float)(k7[j] - k6[j]);
      const float dy = (float)(ynew[j] - ysti[j]);
      stnum = __fadd_rn(stnum, __fmul_rn(dk, dk));
      stden = __fadd_rn(stden, __fmul_rn(dy, dy));
    }
    const float err = sqrtf(ssum / (float)N);
    const bool accepted = (err <= 1.0f) && !too_small;

    // Stiffness detection.
    const bool do_stiff =
        accepted && (((naccpt + 1) % STIFF_TEST == 0) || iasti > 0);
    if (do_stiff && stden > 0.0f)
      hlamb = __fmul_rn((float)fabs(h), sqrtf(stnum / stden));
    const bool is_stiff = hlamb > STIFF_THRESHOLD;
    if (do_stiff) {
      if (is_stiff) {
        iasti += 1;
        nonstiff = 0;
      } else {
        nonstiff += 1;
      }
    }
    if (do_stiff && !is_stiff && nonstiff == 6) iasti = 0;
    const bool stiff_fail = do_stiff && is_stiff && iasti == 15;
    const bool advance = accepted && !stiff_fail;

    // Controller (Lund-stabilised PI on log(facold)), in float.
    const float log_err = logf(nmaxf(err, 1e-35f));
    const float fac11 = expf(__fmul_rn(EXPO1, log_err));
    float fac = expf(__fsub_rn(__fmul_rn(EXPO1, log_err),
                               __fmul_rn(BETA, facold)));
    fac = nmaxf(FACC2, nminf(FACC1, fac / SAFETY));
    double hnew_acc = h / (double)fac;
    if (fabs(hnew_acc) > hmax) hnew_acc = posneg * hmax;
    if (reject) hnew_acc = posneg * nmin(fabs(hnew_acc), fabs(h));
    const double hnew_rej = h / (double)nminf(FACC1, fac11 / SAFETY);
    const double h_next = accepted ? hnew_acc : hnew_rej;

    int st = too_small ? STEP_SIZE_TOO_SMALL
                       : (stiff_fail ? PROBABLY_STIFF : RUNNING);
    if (accepted) facold = nmaxf(log_err, LOG_FACOLD_FLOOR);
    reject = !accepted;

    // ---- core/driver.py: counters, then status priority ----
    nrejct += (!accepted && naccpt > 1 && !too_small) ? 1 : 0;
    nstep += too_small ? 0 : 1;
    naccpt += accepted ? 1 : 0;
    nfev += 6;
    if (st == RUNNING && advance && last) st = SUCCESS;
    if (st == RUNNING && nstep > max_steps) st = NEED_LARGER_NMAX;

    if (advance) {
      t = last ? tend : t + h;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        y[j] = ynew[j];
        k1[j] = k7[j];
      }
    }
    h = h_next;
    status = st;
  }

  t_out[i] = t;
#pragma unroll
  for (int j = 0; j < N; ++j) y_out[(size_t)i * N + j] = y[j];
  status_out[i] = status;
  nfev_out[i] = nfev;
  nstep_out[i] = nstep;
  naccpt_out[i] = naccpt;
  nrejct_out[i] = nrejct;
}

constexpr int THREADS = 128;

template <class F>
int launch(int B, const double* y0, const double* t0, const double* tf,
           const double* hmax, const double* first_step, const double* rtol,
           const double* atol, const double* args, int max_steps,
           double* t_out, double* y_out, int* status, int* nfev, int* nstep,
           int* naccpt, int* nrejct, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + THREADS - 1) / THREADS;
  dopri5_ensemble_kernel<F><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      B, y0, t0, tf, hmax, first_step, rtol, atol, args, max_steps, t_out,
      y_out, status, nfev, nstep, naccpt, nrejct);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry per RHS functor (rhs.py::CudaRHS of the same name), plus its
// state size and parameter count so the wrapper can check its CudaRHS.
#define IVP_DOPRI5_ENTRY(NAME, FUNCTOR)                                      \
  extern "C" int ivp_dopri5_##NAME(                                          \
      int B, const double* y0, const double* t0, const double* tf,           \
      const double* hmax, const double* first_step, const double* rtol,      \
      const double* atol, const double* args, int max_steps, double* t_out,  \
      double* y_out, int* status, int* nfev, int* nstep, int* naccpt,        \
      int* nrejct, void* stream) {                                           \
    return launch<FUNCTOR>(B, y0, t0, tf, hmax, first_step, rtol, atol,      \
                           args, max_steps, t_out, y_out, status, nfev,      \
                           nstep, naccpt, nrejct, stream);                   \
  }                                                                          \
  extern "C" int ivp_rhs_n_##NAME() { return FUNCTOR::N; }                   \
  extern "C" int ivp_rhs_nargs_##NAME() { return FUNCTOR::NARGS; }

IVP_DOPRI5_ENTRY(vdp, VdP)
IVP_DOPRI5_ENTRY(decay, Decay)
IVP_DOPRI5_ENTRY(lorenz, Lorenz)

extern "C" const char* ivp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
