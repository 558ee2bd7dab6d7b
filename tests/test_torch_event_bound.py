"""The event modes' bound counts what the function needs: the dense rows
(and DOP853's three dense stages) only on the steps where an event crosses
(or, sampled, that emit), whatever the kernel builds besides (rows on
every step of a set with a restart map, a deferred crossing's step again;
``kernels/erk_ensemble.py::event_bound``), beside the older count with
rows on every accepted step.  Checked against a hand count of each
method's operations (``FLOPS``' comments) on small made-up counters; no
kernel runs.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ivp_tpu_torch import rhs  # noqa: E402
from ivp_tpu_torch.events import SETS  # noqa: E402
from ivp_tpu_torch.kernels import erk_ensemble as K  # noqa: E402
from ivp_tpu_torch.kernels import erk_record as R  # noqa: E402
from ivp_tpu_torch.kernels.dopri5_ensemble import FP64_PEAK, HBM_RATE  # noqa

I32 = torch.int32


def _out(n_events, n_brent, n_restarts):
    """An EventOut of one event a lane with these counts."""
    B = len(n_events)
    ne = torch.tensor(n_events, dtype=I32).reshape(B, 1)
    return K.EventOut(torch.zeros(B, 1, 4, dtype=torch.float64),
                      torch.zeros(B, 1, 4, 2, dtype=torch.float64), ne,
                      torch.zeros(B, 1, dtype=torch.bool),
                      torch.tensor(n_restarts, dtype=I32),
                      torch.tensor(n_brent, dtype=I32))


def _ms(flops, lane_bytes, B, extra_bytes):
    return 1e3 * max(flops / FP64_PEAK, (B * lane_bytes + extra_bytes)
                     / HBM_RATE)


def test_section_dop853_deferred_by_hand():
    """DOP853 on the Lorenz section (the kernel defers its crossings and
    runs their steps again, which the bound leaves out): every attempt's
    149 flops a component, 8 a lane and 11 RHS evaluations (8 flops each),
    f(ynew) on each accepted one; on each crossing step the rows (153 a
    component, 3 RHS); the event work: 2 flops a value at every accepted
    step, Brent's evaluations (14 a component, 3, and a value) and no
    restart."""
    nstep, naccpt = torch.tensor([100, 120]), torch.tensor([90, 110])
    out = _out([5, 7], [140, 196], [0, 0])
    n, r = 3, 8
    attempt = n * 149 + 8 + r * 11
    hand_rows = (100 + 120) * attempt + (90 + 110) * r
    hand_rows += 12 * (n * 153 + r * 3)
    event = (90 + 110) * 2 + (140 + 196) * (n * 14 + 3 + 2)
    every = (100 + 120) * attempt + (90 + 110) * r
    every += (90 + 110) * (n * 153 + r * 3)
    lane = 8 * (3 * n + 4 + 3) + 8 * (1 + n) + 4 * 5
    ev_bytes = 8.0 * (1 + n) * 12 + 2 * (1 * 5 + 8)
    ms, by, ms_every = K.event_bound("DOP853", rhs.lorenz, SETS["section"],
                                     nstep, naccpt, out)
    assert by == "operations"
    assert ms == pytest.approx(_ms(hand_rows + event, lane, 2, ev_bytes))
    assert ms_every == pytest.approx(_ms(every + event, lane, 2, ev_bytes))
    assert ms < ms_every


def test_section_rk23_at_once_by_hand():
    """RK23 resolves its crossings at once: rows (two of 4 terms a
    component) on each crossing step, no step again."""
    nstep, naccpt = torch.tensor([300, 280]), torch.tensor([290, 270])
    out = _out([5, 7], [140, 196], [0, 0])
    n, r = 3, 8
    attempt = n * 19 + 9 + r * 3
    hand = (300 + 280) * attempt + 12 * (n * 14)
    event = (290 + 270) * 2 + (140 + 196) * (n * 10 + 2 + 2)
    lane = 8 * (3 * n + 4 + 3) + 8 * (1 + n) + 4 * 5
    ev_bytes = 8.0 * (1 + n) * 12 + 2 * (1 * 5 + 8)
    ms = K.event_bound("RK23", rhs.lorenz, SETS["section"], nstep, naccpt,
                       out)[0]
    assert ms == pytest.approx(_ms(hand + event, lane, 2, ev_bytes))


def test_ball_dopri5_at_once_by_hand():
    """DOPRI5 on the ball (a restart map: the kernel builds rows on every
    accepted step, the bound only on the crossing steps, 18 a component);
    each restart's map, values and init (two RHS evaluations, hinit)."""
    nstep, naccpt = torch.tensor([40, 44, 38]), torch.tensor([39, 43, 38])
    out = _out([9, 9, 8], [200, 210, 180], [8, 8, 8])
    n, r = 2, 0
    attempt = n * 58 + 8 + r * 6
    base = (40 + 44 + 38) * attempt
    rows = (9 + 9 + 8) * (n * 18)
    rows_every = (39 + 43 + 38) * (n * 18)
    restart = 1 + 0 + 2 * r + n * K.INIT_FLOPS_N + K.INIT_FLOPS
    event = (39 + 43 + 38) * 0 + (200 + 210 + 180) * (n * 8 + 3 + 0)
    event += 24 * restart
    lane = 8 * (3 * n + 4 + 1) + 8 * (1 + n) + 4 * 5
    ev_bytes = 8.0 * (1 + n) * 26 + 3 * (1 * 5 + 8)
    ms, by, ms_every = K.event_bound("DOPRI5", rhs.ball, SETS["ground"],
                                     nstep, naccpt, out)
    assert by == "operations"
    assert ms == pytest.approx(_ms(base + rows + event, lane, 3, ev_bytes))
    assert ms_every == pytest.approx(
        _ms(base + rows_every + event, lane, 3, ev_bytes))
    assert ms < ms_every


def test_sampled_rows_where_either_asks():
    """Sampled with events: rows on a lane's crossing steps or its
    emitting ones (min(naccpt, n_samples)), whichever is more; lean, on
    its crossing steps."""
    out = _out([3, 9], [30, 90], [0, 0])
    naccpt, n_samples = torch.tensor([50, 60]), torch.tensor([7, 4])
    steps = K.event_dense_steps(out, naccpt, n_samples)
    assert steps.tolist() == [7.0, 9.0]
    assert K.crossing_steps(out).tolist() == [3.0, 9.0]
    assert K.event_dense_steps(out, naccpt).tolist() == [3.0, 9.0]


def test_record_steps_take_the_crossing_rows():
    """The record-event bound: coefficient records build rows on every
    recorded step; steps records only on the crossing steps."""
    nstep, naccpt = torch.tensor([100, 120]), torch.tensor([90, 110])
    n_rec = torch.tensor([90, 110], dtype=I32)
    out = _out([5, 7], [140, 196], [0, 0])
    ev = (SETS["section"], out)
    steps = R.record_bound("DOP853", rhs.lorenz, nstep, naccpt, n_rec, False,
                           events=ev)[0]
    cont = R.record_bound("DOP853", rhs.lorenz, nstep, naccpt, n_rec, True,
                          events=ev)[0]
    n, r = 3, 8
    fl, by = K.event_work("DOP853", rhs.lorenz, SETS["section"], naccpt, out)
    base = K.solve_flops("DOP853", rhs.lorenz, nstep, naccpt)
    lane = 8 * (3 * n + 4 + 3) + 8 * (1 + n) + 4 * 5
    rows_steps = 8.0 * 200 * (3 + n)
    assert steps == pytest.approx(_ms(
        base + 12 * (n * 153 + r * 3) + fl, lane, 2, rows_steps + by))
    rows_cont = 8.0 * 200 * (3 + n + 8 * n)
    assert cont == pytest.approx(_ms(
        base + 200 * (n * 153 + r * 3) + fl, lane, 2, rows_cont + by))
