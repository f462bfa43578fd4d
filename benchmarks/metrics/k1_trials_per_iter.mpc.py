"""K1's line-search trials judged per iteration in the episodes run (the
port's K1 record)."""

from benchmarks import k1_record


def read(ctx):
    return k1_record.trials_per_iter() if ctx.kind == "mpc_episodes" else None
