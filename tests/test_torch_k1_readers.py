"""The benchmark's readers of K1's record (``benchmarks/k1_record.py`` and
the eight ``benchmarks/metrics/k1_*`` files that use it), on the CPU: each
returns None on a tree whose port keeps no record, before any launch made
one, and in a run of the other kind; on a planted record, plan and trace,
the value worked out by hand."""

import sys
from types import SimpleNamespace

import pytest
import torch

from benchmarks import harness
from ilqr_tpu_torch.utils import counters

K1 = "cilqr_solve_kernel<float, false, false>"
# phases P0-P7 of 900 clocks; 10 launches of 2112 slots (132 SMs x 16
# resident), 0.75 of them held for the 1 ms a traced launch takes; the
# busiest lane's 180 rows in each of the 81920 + 500 projections
RECORD = dict(p0_stage=10, p1_init=20, p2_deriv=30, p3_backward=300, p4_forward=100,
              p5_project=250, p6_cost=150, p7_rest=40, clocks=900,
              solve_ns=int(0.75 * 132 * 16 * 1e6 * 10), solves=81920, launches=10, iters=200,
              chunks=260, trials=500, accepted_full=100, converged=50, backward_fail=0,
              ls_exhausted=20, accepted_small=30, scan_trips=180 * (81920 + 500))
PLAN = dict(variant="cilqr_solve_f32_rear_barrier_dot_ls", agents=3, columns=14, rows=312,
            shared_bytes=13424, resident=16, sms=132)
# four traced K1 launches of 1000 us, beside other device work
TRACE = SimpleNamespace(spans=[(K1, 1000.0 * i, 1000.0 * (i + 1)) for i in range(4)]
                        + [("elementwise_kernel", 4000.0, 4100.0)])
METRICS = {
    "k1_backward_share.mpc": ("mpc_episodes", 100.0 * 300 / 900),
    "k1_search_share.mpc": ("mpc_episodes", 100.0 * 500 / 900),
    "k1_search_share.cold": ("cold_sweep", 100.0 * 500 / 900),
    "k1_trials_per_iter.mpc": ("mpc_episodes", 2.5),
    "k1_slot_use.mpc": ("mpc_episodes", 75.0),
    "k1_slot_use.cold": ("cold_sweep", 75.0),
    "k1_scan_trips.mpc": ("mpc_episodes", 180.0),
    "k1_scan_trips.cold": ("cold_sweep", 180.0),
}


def _planted(monkeypatch):
    record = torch.tensor([RECORD[f] for f in counters.K1_FIELDS], dtype=torch.int64)
    monkeypatch.setattr(counters, "k1_records", {torch.device("cpu"): record})
    monkeypatch.setattr(counters, "plan", dict(PLAN))


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader_none_without_the_record(metric, monkeypatch):
    """No counter module, a counter module without ``k1_totals`` (the port
    before the record), no record allocated, a run of the other kind:
    None, and no exception."""
    import ilqr_tpu_torch.utils as utils

    kind, _ = METRICS[metric]
    read = harness.reader(metric)
    ctx = SimpleNamespace(kind=kind, trace=TRACE)
    _planted(monkeypatch)
    with monkeypatch.context() as m:
        m.delattr(utils, "counters")
        m.setitem(sys.modules, "ilqr_tpu_torch.utils.counters", None)
        assert read(ctx) is None
    with monkeypatch.context() as m:
        m.delattr(counters, "k1_totals")
        assert read(ctx) is None
    with monkeypatch.context() as m:
        m.setattr(counters, "k1_records", {})
        assert read(ctx) is None
    other = "cold_sweep" if kind == "mpc_episodes" else "mpc_episodes"
    assert read(SimpleNamespace(kind=other, trace=TRACE)) is None


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader_value_from_a_planted_record(metric, monkeypatch):
    """The value worked out by hand from the planted record, plan and
    trace; slot use is None without the plan's residency or SMs, or
    without a traced K1 launch."""
    kind, want = METRICS[metric]
    read = harness.reader(metric)
    _planted(monkeypatch)
    assert read(SimpleNamespace(kind=kind, trace=TRACE)) == pytest.approx(want, rel=1e-12)
    if "slot_use" in metric:
        no_k1 = SimpleNamespace(spans=TRACE.spans[-1:])
        assert read(SimpleNamespace(kind=kind, trace=no_k1)) is None
        for key in ("resident", "sms"):
            monkeypatch.setattr(counters, "plan", dict(PLAN, **{key: None}))
            assert read(SimpleNamespace(kind=kind, trace=TRACE)) is None


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader_on_a_record_without_scan_trips(metric, monkeypatch):
    """A record of the fields before ``scan_trips`` (the port before the
    field): the scan-trip readers give None, the others what they gave."""
    kind, want = METRICS[metric]
    read = harness.reader(metric)
    _planted(monkeypatch)
    fields = tuple(f for f in counters.K1_FIELDS if f != "scan_trips")
    monkeypatch.setattr(counters, "K1_FIELDS", fields)
    monkeypatch.setattr(counters, "k1_records", {torch.device("cpu"): torch.tensor(
        [RECORD[f] for f in fields], dtype=torch.int64)})
    value = read(SimpleNamespace(kind=kind, trace=TRACE))
    if "scan_trips" in metric:
        assert value is None
    else:
        assert value == pytest.approx(want, rel=1e-12)
