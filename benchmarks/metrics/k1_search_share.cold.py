"""K1's line search (the trials' rollouts, projections and costs, P4-P6)
as a share of its solves' clocks in the steps run, % (the port's K1
record)."""

from benchmarks import k1_record


def read(ctx):
    return k1_record.phase_share(k1_record.SEARCH) if ctx.kind == "cold_sweep" else None
