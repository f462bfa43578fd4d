"""The share of K1's resident slots that hold a solve over a launch of the
episodes, % (``k1_record.slot_use``: the port's K1 record over the traced
launches)."""

from benchmarks import k1_record


def read(ctx):
    return k1_record.slot_use(ctx) if ctx.kind == "mpc_episodes" else None
