"""Device ms per tick of every span that is not K1's (the tick's packing,
the episode's copies) in the traced episodes."""

from benchmarks.metrics import other_ms_per_solve


def read(ctx):
    return other_ms_per_solve(ctx) if ctx.kind == "mpc_episodes" else None
