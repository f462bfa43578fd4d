"""The device's idle share over the traced steps, %: one minus the
busy seconds over the length of the traced window."""

from benchmarks.metrics import idle


def read(ctx):
    return idle(ctx) if ctx.kind == "cold_sweep" else None
