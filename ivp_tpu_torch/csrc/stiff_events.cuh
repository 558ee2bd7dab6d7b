// The stiff kernels' event mode (radau.cuh, bdf.cuh with an event set EV,
// EV::E > 0): core/events.py::process_events and the restart of
// core/driver.py::step_body after each accepted step, as erk_common.cuh's
// event mode does for the explicit kernels.  The event values at the
// step's end are tested against the lane's values at its last accepted
// point in the launch's direction of each event; a crossing is refined by
// erk_common.cuh's ev_brent (core/common.py::brentq) on the step's
// interpolant, which the method hands in as interp(ti, yi): Radau's
// collocation polynomial over its cont slots, BDF's Newton form over D
// before the loop's change_d (StiffInterpAt).  Crossings are resolved at
// once: a deferred rebuild is bit for bit only where the step's arithmetic
// is pinned, and the stiff attempt is not.  The step's events count in
// time order, a terminal one (the launch's count of each event) cuts the
// later ones and ends the lane at its root, and each occurrence goes to
// the lane's row of the event buffers (ErkEvents,
// kernels/erk_ensemble.py::KernelEvents), or sets its overflow flag when
// they are full.  A terminal event whose restart map the
// launch allows, within max_restarts, restarts the lane instead: here the
// map, the event values from the new state and that event's hit count back
// to 0; the kernel runs the method's init at the event point.
//
// The lane's event state (values at the last accepted point, hit counts,
// the buffers' cursors and overflow flags, restarts and Brent evaluations)
// sits in its slots past the method's (EvSlots), not in registers: the
// stiff kernels already spill at their register cap.
#pragma once

#include "stiff_common.cuh"

namespace ivp {

// A lane's event slots past BASE doubles of the method's: the event values
// at the last accepted point, the hit counts, the buffers' cursors, the
// overflow flags (E each, counts as exact doubles), the restarts made and
// Brent's evaluations.
template <int NE, int BASE>
struct EvSlots {
  static constexpr int G = BASE, HITS = BASE + NE, NEV = BASE + 2 * NE,
                       OVF = BASE + 3 * NE, NRES = BASE + 4 * NE,
                       NBRENT = NRES + 1;
  static constexpr int DOUBLES = NE > 0 ? 4 * NE + 2 : 0;
};

// The stiff interpolants as ev_brent evaluates them: interp(ti, yi) takes
// the time itself (radau_interp's s = (ti - (xold + h)) / h, bdf_interp's
// (ti - t_shift) / denom), as the plain version's do, so Brent's next time
// is the argument on both of ev_brent's paths and the fast paths are open
// from the start.
template <class Interp>
struct StiffInterpAt {
  const Interp& interp;
  __device__ __forceinline__ bool start() const { return true; }
  __device__ __forceinline__ double at(double t, FastCtl<double>&) const {
    return t;
  }
  __device__ __forceinline__ double at_lib(double t) const { return t; }
  __device__ __forceinline__ void eval(double t, double* yi) const {
    interp(t, yi);
  }
};

// The lane's event slots at a launch's start: on a solve's first launch
// (init) the event values at (t, y) and every count 0, else the state the
// last launch of a record solve stored (ev.g_prev, ev.hits and the
// buffers' counts).
template <class EV, int T, int BASE>
__device__ __forceinline__ void ev_load(const EV& evf, const ErkEvents& ev,
                                        Slots<T> s, int i, bool init,
                                        double t, const double* y,
                                        const double* a) {
  constexpr int NE = EV::E;
  using V = EvSlots<NE, BASE>;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const size_t q = (size_t)i * NE + e;
    s[V::G + e] = init ? evf.value(e, t, y, a) : ev.g_prev[q];
    s[V::HITS + e] = init ? 0.0 : (double)ev.hits[q];
    s[V::NEV + e] = init ? 0.0 : (double)ev.n_ev[q];
    s[V::OVF + e] = init ? 0.0 : (double)ev.overflow[q];
  }
  s[V::NRES] = init ? 0.0 : (double)ev.n_restarts[i];
  s[V::NBRENT] = init ? 0.0 : (double)ev.n_brent[i];
}

// The lane's event slots to the launch's outputs at its end; the values and
// hit counts only where the launch keeps them (a record solve's chunks).
template <int NE, int T, int BASE>
__device__ __forceinline__ void ev_store(const ErkEvents& ev, Slots<T> s,
                                         int i) {
  using V = EvSlots<NE, BASE>;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const size_t q = (size_t)i * NE + e;
    ev.n_ev[q] = (int)s[V::NEV + e];
    ev.overflow[q] = s[V::OVF + e] != 0.0;
    if (ev.g_prev) ev.g_prev[q] = s[V::G + e];
    if (ev.hits) ev.hits[q] = (int)s[V::HITS + e];
  }
  ev.n_restarts[i] = (int)s[V::NRES];
  ev.n_brent[i] = (int)s[V::NBRENT];
}

// What an accepted step's events decide: a terminal event ends the lane at
// t_ev, or restarts it there (the kernel then runs the method's init from
// yev, which holds the mapped state).
struct EvOutcome {
  bool terminal = false, restart = false;
  double t_ev = 0.0;
};

// The state at a root r of the step from (t_old, y_old) to (t_new, y_new):
// the step's exact end states at its ends, else its interpolant.
template <int N, class Interp>
__device__ __forceinline__ void ev_state_at(const Interp& interp,
                                            double t_old, const double* y_old,
                                            double t_new, const double* y_new,
                                            double r, double* out) {
  if (r == t_old) {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = y_old[j];
  } else if (r == t_new) {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = y_new[j];
  } else {
    interp(r, out);
  }
}

// core/events.py::process_events on lane i's accepted step from (t_old,
// y_old) to (t_new, y_new), its interpolant interp, then the restart's
// event part (core/driver.py::step_body): the occurrences to the buffers,
// the slots updated; with a terminal event its time, yev its state, or the
// restart map's state where the lane restarts.
template <int N, class EV, int T, int BASE, class Interp>
__device__ EvOutcome ev_step(const EV& evf, const ErkEvents& ev, Slots<T> s,
                             int i, const double* a, double t_old,
                             const double* y_old, double t_new,
                             const double* y_new, double posneg,
                             double tend, const Interp& interp, double* yev) {
  constexpr int NE = EV::E;
  using V = EvSlots<NE, BASE>;
  EvOutcome out;
  double gc[NE], root[NE];
  bool cr[NE];
  double cut = INFINITY;
  int i_term = 0, evals = 0;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const double gp = s[V::G + e];
    gc[e] = evf.value(e, t_new, y_new, a);
    cr[e] = ev_crossed(gp, gc[e], ev.direction[e]);
    root[e] = cr[e] ? ev_brent<N>(evf, e, StiffInterpAt<Interp>{interp}, a,
                                  t_old, t_new, gp, gc[e], evals)
                    : t_new;
    // The earliest terminal event in the direction of the solve.
    const double key = root[e] * posneg;
    if (cr[e] && ev.terminal[e] > 0 &&
        (int)s[V::HITS + e] + 1 >= ev.terminal[e] && key < cut) {
      cut = key;
      i_term = e;
      out.t_ev = root[e];
      out.terminal = true;
    }
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    // Each occurrence up to the terminal one, at the event's cursor.
    if (cr[e] && (!out.terminal || root[e] * posneg <= cut)) {
      const int nev = (int)s[V::NEV + e];
      if (nev < ev.cap) {
        const size_t q = (size_t)i * NE + e;
        double ye[N];
        ev_state_at<N>(interp, t_old, y_old, t_new, y_new, root[e], ye);
        ev.t_ev[q * ev.cap + nev] = root[e];
#pragma unroll
        for (int j = 0; j < N; ++j)
          ev.y_ev[(q * ev.cap + nev) * N + j] = ye[j];
        s[V::NEV + e] = nev + 1;
      } else {
        s[V::OVF + e] = 1.0;
      }
      s[V::HITS + e] = s[V::HITS + e] + 1.0;
    }
    s[V::G + e] = gc[e];
  }
  s[V::NBRENT] = s[V::NBRENT] + (double)evals;
  if (out.terminal) {
    ev_state_at<N>(interp, t_old, y_old, t_new, y_new, out.t_ev, yev);
    // ---- core/driver.py: the in-loop restart ----
    if (((ev.restart_mask & EV::RESTARTS) >> i_term & 1u) &&
        (out.t_ev - tend) * posneg < 0.0 &&
        (int)s[V::NRES] < ev.max_restarts) {
      double yn[N];
      evf.restart(i_term, out.t_ev, yev, a, yn);
#pragma unroll
      for (int j = 0; j < N; ++j) yev[j] = yn[j];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        s[V::G + e] = evf.value(e, out.t_ev, yev, a);
        if (e == i_term) s[V::HITS + e] = 0.0;
      }
      s[V::NRES] = s[V::NRES] + 1.0;
      out.terminal = false;
      out.restart = true;
    }
  }
  return out;
}

}  // namespace ivp
