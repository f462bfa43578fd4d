"""Device ms per step of every span that is not K1's (the window gather,
the copies of the starts and the summary) in the traced steps."""

from benchmarks.metrics import other_ms_per_solve


def read(ctx):
    return other_ms_per_solve(ctx) if ctx.kind == "cold_sweep" else None
