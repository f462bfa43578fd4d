"""K1's Riccati pass (``backward``, P3) as a share of its solves' clocks in
the episodes run, % (the port's K1 record)."""

from benchmarks import k1_record


def read(ctx):
    return k1_record.phase_share(("p3_backward",)) if ctx.kind == "mpc_episodes" else None
