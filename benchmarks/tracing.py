"""The device trace of a stretch of calls, read from ``torch.profiler``.

``profile(calls)`` runs each callable of ``calls`` under the profiler
(CPU and CUDA activity; nothing is written to disk), each inside the
benchmark's own span ``bench.<label>`` (``torch.profiler.record_function``),
and returns a ``Trace``: every device span (kernels and copies) with its
name, the seconds in which some device span ran (the union of the spans,
as ``chip_smoke.py:profile_run`` computes it; the device-side copies of the
benchmark's spans left out), the length of the traced window (from the
start of the first benchmark span, or of the first device span where that
comes earlier, to the end of the last of either, so the busy seconds never
exceed it), and the idle gaps between device spans, each named by the
innermost benchmark span the host was in at the gap's midpoint (``host``
outside them).
"""

from __future__ import annotations

import collections
from typing import NamedTuple


class Trace(NamedTuple):
    spans: list  # (name, start_us, end_us) of every device span
    busy_s: float  # seconds in which some device span ran
    window_s: float  # seconds from the traced window's start to its end
    gaps: list  # (label, seconds) of the idle gaps, longest first

    def seconds_by_name(self) -> dict:
        out = collections.Counter()
        for name, a, b in self.spans:
            out[name] += (b - a) / 1e6
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The ``breakdown`` of a result line: the device operations that
        took most time, and the longest idle gaps by what the host was
        doing."""
        ops = self.seconds_by_name().most_common(top)
        return {"device_ops": [[name[:160], s] for name, s in ops],
                "idle_gaps": [[label, s] for label, s in self.gaps[:top]]}


def _union(spans):
    merged = []
    for a, b in sorted((a, b) for _, a, b in spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def profile(calls, label: str, sync) -> Trace:
    """Run ``calls`` (callables, each ended by ``sync()``) under the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for call in calls:
            with record_function(f"bench.{label}"):
                call()
                sync()
    events = prof.events()
    # the profiler mirrors each ``bench.`` span on the device's timeline:
    # those are the host's, not device work
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and not e.name.startswith("bench.")]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU and e.name.startswith("bench.")]
    return reduce(spans, host)


def reduce(spans, host) -> Trace:
    """The ``Trace`` of device spans and the host's benchmark spans, each
    (name, start_us, end_us)."""
    merged = _union(spans)
    busy = sum(b - a for a, b in merged) / 1e6
    ends = [x for _, a, b in host for x in (a, b)] + [x for ab in merged for x in ab]
    lo, hi = (min(ends), max(ends)) if ends else (0, 0)
    gaps = []
    if host and merged:
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            inner = [(e - s, n) for n, s, e in host if s <= mid <= e]
            gaps.append((min(inner)[1] if inner else "host", (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return Trace(spans, busy, (hi - lo) / 1e6, gaps)
