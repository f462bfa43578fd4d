"""The reduction of a trace: busy seconds as the union of device spans,
and a traced window that holds every span, so the busy seconds never
exceed it."""

from __future__ import annotations

import pytest

from benchmarks import tracing

HOST = [("bench.episode", 0.0, 1_000_000.0), ("bench.episode", 1_000_000.0, 2_000_000.0)]


@pytest.mark.parametrize("spans, busy, window", [
    ([("k1", 100.0, 900_000.0), ("pack", 800_000.0, 1_000_000.0)], 0.9999, 2.0),
    # a device span read past the host's last span (clocks of two sources)
    ([("k1", 10.0, 1_999_990.0), ("k1", 1_999_000.0, 2_000_500.0)], 2.00049, 2.0005),
    ([], 0.0, 2.0),
])
def test_busy_within_window(spans, busy, window):
    t = tracing.reduce(spans, HOST)
    assert t.busy_s == pytest.approx(busy) and t.window_s == pytest.approx(window)
    assert 0 <= t.busy_s <= t.window_s


def test_gaps_named_by_host_span():
    t = tracing.reduce([("k1", 0.0, 900_000.0), ("k1", 1_200_000.0, 1_900_000.0)],
                       HOST[:1] + [("bench.solve", 1_000_000.0, 1_100_000.0)] + HOST[1:])
    assert [n for n, _ in t.gaps] == ["bench.solve", "bench.episode"]
    assert [s for _, s in t.gaps] == pytest.approx([0.3, 0.1])
