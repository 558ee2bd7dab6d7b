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
// What bounds it on an H100: float64 operations.  A VdP attempt does 154
// f64 flops (kernels/dopri5_ensemble.py::FLOPS_PER_ATTEMPT), so bench.py's
// headline solve (B=524288, ~1112.5 attempts a lane) needs at least 2.64 ms
// at the data sheet's 34 TFLOP/s; device memory (132 bytes a lane, read or
// written once) needs 0.02 ms.  The kernel reaches about a third of that
// bound (PERF.md).  What holds it back is instruction issue, with each f64
// instruction holding its scheduler for two cycles (16 FP64 lanes a
// scheduler): a VdP attempt issues 298 instructions on its loop's fast path
// (measure_kernel.py's loop SASS count), 107 of them f64, so 298 + 107 = 405
// cycles a warp-attempt against 411 measured at saturation.  That is a fit
// across three builds, not a hardware counter.  It is not latency: one
// warp's attempt is a dependent chain of ~1400 cycles (the stages, then the
// float32 controller's IEEE division, sqrt, log, exp and division and the
// f64 division of h), which the 6 warps a scheduler hold at 79 registers
// would hide down to ~234; register caps that give more warps spill and
// run slower.  Most of the ~190 non-f64 instructions are that controller's,
// which the reference's step counts depend on.
//
// What the design does about it: one thread per lane, the whole carry (t, y,
// h, k1, the controller memory and the counters) in registers, one launch per
// solve and no host synchronisation per step.  Each attempt issues only what
// it needs: the double constants come from the constant bank (an immediate
// double costs two UMOVs an attempt), one exp and one f64 division serve
// whichever of the accept and reject factors is used, the stiffness sums run
// only when the test is due, |(float)y| is carried across a step, and NaN-
// propagating min/max are single instructions.  Results are bit for bit
// those of the straightforward version.
//
// What does not apply here: tensor cores (wgmma, f64 DMMA), since each
// stage's sum needs the previous stage's RHS and the rows are n long, so no
// product has a tile's shape; TMA and asynchronous copies, since each lane's
// bytes cross memory once; persistent blocks and lane refill, which help
// ensembles whose lanes take very different numbers of steps, where here a
// warp's lanes take the same number to within 0.5% (warp efficiency 0.9955).
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

#include "rhs/cr3bp.cuh"
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
constexpr double UROUND = 2.3e-16;

// The loop reads its double constants from the constant bank: a DFMA or
// DMUL takes c[bank][offset] as an operand, while an immediate double costs
// two UMOVs into uniform registers, issued again on every attempt (73 of
// the ~370 instructions of a VdP attempt).  Not const, so that nvcc cannot
// fold them back into immediates.
struct Dopri5Constants {
  double a21, a31, a32, a41, a42, a43, a51, a52, a53, a54, a61, a62, a63,
      a64, a65, a71, a73, a74, a75, a76, e1, e3, e4, e5, e6, e7, uround,
      tenth, one01;
};
__constant__ Dopri5Constants K = {
    A21, A31, A32, A41, A42, A43, A51, A52, A53, A54, A61, A62, A63, A64, A65,
    A71, A73, A74, A75, A76, E1,  E3,  E4,  E5,  E6,  E7,  UROUND, 0.1, 1.01};

// ERKParams defaults for DOPRI5 (methods/erk.py), as the float32 controller
// sees them: Python floats rounded to float.
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
// PTX max.NaN/min.NaN (sm_80 and later): NaN if either input is NaN, in one
// instruction where the compare-and-select takes three.
__device__ __forceinline__ float nmaxf(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nminf(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

template <class F, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) dopri5_ensemble_kernel(
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
  // Accepted attempts until the periodic stiffness test: 0 exactly when
  // (naccpt + 1) % STIFF_TEST == 0.
  int stiff_in = STIFF_TEST - 1;
  // |(float)y|, carried across an accepted step (it is |(float)ynew| then).
  float ayf[N];
#pragma unroll
  for (int j = 0; j < N; ++j) ayf[j] = fabsf((float)y[j]);
  int status = fabs(tend - t) < 1e-15 ? SUCCESS : RUNNING;

  while (status == RUNNING) {
    // ---- methods/erk.py::dopri5_attempt ----
    const bool too_small = K.tenth * fabs(h) <= fabs(t) * K.uround;
    const bool last = __dmul_rn(__dadd_rn(__dadd_rn(t, __dmul_rn(K.one01, h)),
                                          -tend),
                                posneg) > 0.0;
    if (last) h = tend - t;
    // The stiffness test runs on this attempt if it is accepted.
    const bool stiff_due = stiff_in == 0 || iasti > 0;

    double k2[N], k3[N], k4[N], k5[N], k6[N], k7[N], ys[N], ynew[N];
#pragma unroll
    for (int j = 0; j < N; ++j) ys[j] = y[j] + h * (K.a21 * k1[j]);
    f(t + C2 * h, ys, k2, a);
#pragma unroll
    for (int j = 0; j < N; ++j)
      ys[j] = y[j] + h * (K.a31 * k1[j] + K.a32 * k2[j]);
    f(t + C3 * h, ys, k3, a);
#pragma unroll
    for (int j = 0; j < N; ++j)
      ys[j] = y[j] + h * (K.a41 * k1[j] + K.a42 * k2[j] + K.a43 * k3[j]);
    f(t + C4 * h, ys, k4, a);
#pragma unroll
    for (int j = 0; j < N; ++j)
      ys[j] = y[j] + h * (K.a51 * k1[j] + K.a52 * k2[j] + K.a53 * k3[j] +
                          K.a54 * k4[j]);
    f(t + C5 * h, ys, k5, a);
#pragma unroll
    for (int j = 0; j < N; ++j)
      ys[j] = y[j] + h * (K.a61 * k1[j] + K.a62 * k2[j] + K.a63 * k3[j] +
                          K.a64 * k4[j] + K.a65 * k5[j]);
    f(t + h, ys, k6, a);
#pragma unroll
    for (int j = 0; j < N; ++j)
      ynew[j] = y[j] + h * (K.a71 * k1[j] + K.a73 * k3[j] + K.a74 * k4[j] +
                            K.a75 * k5[j] + K.a76 * k6[j]);
    // Stiffness denominator |ynew - ysti|^2, only where the test may run.
    float stden = 0.0f;
    if (stiff_due) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float dy = (float)(ynew[j] - ys[j]);
        stden = __fadd_rn(stden, __fmul_rn(dy, dy));
      }
    }
    f(t + h, ynew, k7, a);

    // Error norm in float: err_vec in double, cast; sk and the mean in float.
    float ssum = 0.0f, aynew[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double ev = h * (K.e1 * k1[j] + K.e3 * k3[j] + K.e4 * k4[j] +
                             K.e5 * k5[j] + K.e6 * k6[j] + K.e7 * k7[j]);
      aynew[j] = fabsf((float)ynew[j]);
      const float sk =
          __fadd_rn(atf[j], __fmul_rn(rtf[j], nmaxf(ayf[j], aynew[j])));
      const float r = (float)ev / sk;
      ssum = __fadd_rn(ssum, __fmul_rn(r, r));
    }
    const float err = sqrtf(ssum / (float)N);
    const bool accepted = (err <= 1.0f) && !too_small;

    // Stiffness detection.
    bool stiff_fail = false;
    if (accepted && stiff_due) {
      float stnum = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float dk = (float)(k7[j] - k6[j]);
        stnum = __fadd_rn(stnum, __fmul_rn(dk, dk));
      }
      if (stden > 0.0f) hlamb = __fmul_rn((float)fabs(h), sqrtf(stnum / stden));
      if (hlamb > STIFF_THRESHOLD) {
        iasti += 1;
        nonstiff = 0;
        stiff_fail = iasti == 15;
      } else {
        nonstiff += 1;
        if (nonstiff == 6) iasti = 0;
      }
    }
    const bool advance = accepted && !stiff_fail;

    // Controller (Lund-stabilised PI on log(facold)), in float.  One
    // exponential and one division of h: the PI factor if accepted, the
    // plain factor if rejected.
    const float log_err = logf(nmaxf(err, 1e-35f));
    const float e1 = __fmul_rn(EXPO1, log_err);
    const float q =
        expf(accepted ? __fsub_rn(e1, __fmul_rn(BETA, facold)) : e1) / SAFETY;
    const float fac = accepted ? nmaxf(FACC2, nminf(FACC1, q)) : nminf(FACC1, q);
    double h_next = h / (double)fac;
    if (accepted) {
      if (fabs(h_next) > hmax) h_next = posneg * hmax;
      if (reject) h_next = posneg * nmin(fabs(h_next), fabs(h));
      facold = nmaxf(log_err, LOG_FACOLD_FLOOR);
      stiff_in = stiff_in == 0 ? STIFF_TEST - 1 : stiff_in - 1;
    }
    int st = too_small ? STEP_SIZE_TOO_SMALL
                       : (stiff_fail ? PROBABLY_STIFF : RUNNING);
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
        ayf[j] = aynew[j];
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

template <class F, int THREADS, int MIN_BLOCKS>
int launch(int B, const double* y0, const double* t0, const double* tf,
           const double* hmax, const double* first_step, const double* rtol,
           const double* atol, const double* args, int max_steps,
           double* t_out, double* y_out, int* status, int* nfev, int* nstep,
           int* naccpt, int* nrejct, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + THREADS - 1) / THREADS;
  dopri5_ensemble_kernel<F, THREADS, MIN_BLOCKS>
      <<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          B, y0, t0, tf, hmax, first_step, rtol, atol, args, max_steps,
          t_out, y_out, status, nfev, nstep, naccpt, nrejct);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry per RHS functor (rhs.py::CudaRHS of the same name), plus its
// state size and parameter count so the wrapper can check its CudaRHS.
// THREADS and MIN_BLOCKS (threads a block, and blocks an SM that
// __launch_bounds__ asks registers for) are chosen per functor from
// measure_kernel.py's occupancy sweep, which builds one library per setting
// by defining IVP_THREADS and IVP_MIN_BLOCKS for every functor at once.
#ifdef IVP_THREADS
#define IVP_LAUNCH_CONFIG(THREADS, MIN_BLOCKS) IVP_THREADS, IVP_MIN_BLOCKS
#else
#define IVP_LAUNCH_CONFIG(THREADS, MIN_BLOCKS) THREADS, MIN_BLOCKS
#endif

#define IVP_DOPRI5_ENTRY(NAME, FUNCTOR, THREADS, MIN_BLOCKS)                 \
  extern "C" int ivp_dopri5_##NAME(                                          \
      int B, const double* y0, const double* t0, const double* tf,           \
      const double* hmax, const double* first_step, const double* rtol,      \
      const double* atol, const double* args, int max_steps, double* t_out,  \
      double* y_out, int* status, int* nfev, int* nstep, int* naccpt,        \
      int* nrejct, void* stream) {                                           \
    return launch<FUNCTOR, IVP_LAUNCH_CONFIG(THREADS, MIN_BLOCKS)>(          \
        B, y0, t0, tf, hmax, first_step, rtol, atol, args, max_steps, t_out, \
        y_out, status, nfev, nstep, naccpt, nrejct, stream);                 \
  }                                                                          \
  extern "C" int ivp_rhs_n_##NAME() { return FUNCTOR::N; }                   \
  extern "C" int ivp_rhs_nargs_##NAME() { return FUNCTOR::NARGS; }

// The fastest median of measure_kernel.py's occupancy sweep, timed in 10
// interleaved rounds on an H100 (PERF.md).  The settings that leave VdP its
// 79 registers (and Decay its 71) compile to the same code and lie within
// 0.5% (VdP) of each other, an order 10 rounds do not settle.  Lorenz is
// fastest at 64 x 10 (96 registers, 24 bytes spilled), ahead of 64 x 8 in 9
// of 10 rounds.  Tighter register caps spill more and run slower for all
// three.
IVP_DOPRI5_ENTRY(vdp, VdP, 64, 12)
IVP_DOPRI5_ENTRY(decay, Decay, 64, 8)
IVP_DOPRI5_ENTRY(lorenz, Lorenz, 64, 10)
// CR3BP (n = 6) is not tuned: it is no ensemble main path.
IVP_DOPRI5_ENTRY(cr3bp, Cr3bp, 64, 8)

extern "C" const char* ivp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
