"""The device's idle share over the traced episodes, %: one minus the
busy seconds over the length of the traced window."""

from benchmarks.metrics import idle


def read(ctx):
    return idle(ctx) if ctx.kind == "mpc_episodes" else None
