"""K1's share of its roofline in the traced steps, %."""

from benchmarks.metrics import k1_roofline


def read(ctx):
    return k1_roofline(ctx) if ctx.kind == "cold_sweep" else None
