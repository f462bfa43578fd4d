"""Per-layer metrics, one reader a file: ``<metric>.py`` defines
``read(ctx)``, which returns the metric's value, or None where the traced
run holds nothing to read. ``ctx`` is a runner's ``traced()``: ``kind``,
``trace`` (``benchmarks.tracing.Trace``), ``calls`` and ``ticks`` (solves of
the batch a call) and ``solves`` (each traced solve's shape and iterations,
for ``benchmarks.roofline``). The quantities they share are here."""

from __future__ import annotations

from benchmarks import roofline


def k1_seconds(ctx) -> float:
    return sum(b - a for name, a, b in ctx.trace.spans if roofline.K1_NAME in name) / 1e6


def other_ms_per_solve(ctx):
    """Device ms of every span that is not K1's, per solve of the batch."""
    if not ctx.trace.spans:
        return None
    other = sum(b - a for name, a, b in ctx.trace.spans if roofline.K1_NAME not in name)
    return other / 1e3 / (ctx.calls * ctx.ticks)


def k1_roofline(ctx):
    """K1's share of its roofline, %: the floor's seconds over K1's."""
    k1 = k1_seconds(ctx)
    return 100.0 * roofline.floor(ctx.solves)["seconds"] / k1 if k1 > 0 else None


def idle(ctx):
    """The device's idle share, %, of the traced window."""
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s) if ctx.trace.spans else None

