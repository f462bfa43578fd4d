"""K1's share of its roofline in the traced episodes, %."""

from benchmarks.metrics import k1_roofline


def read(ctx):
    return k1_roofline(ctx) if ctx.kind == "mpc_episodes" else None
