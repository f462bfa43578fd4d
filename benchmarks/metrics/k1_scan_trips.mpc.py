"""K1's window-scan trips a projection in the episodes run: the rows the
busiest lane of a warp scores in one projection, summed over the
projections (the port's K1 record's ``scan_trips``) over the projections
made (one a solve, one a trial judged). None where the record has no such
field."""

from benchmarks import k1_record


def read(ctx):
    if ctx.kind != "mpc_episodes":
        return None
    rec = k1_record.totals()
    if rec is None or "scan_trips" not in rec or rec["solves"] + rec["trials"] <= 0:
        return None
    return rec["scan_trips"] / (rec["solves"] + rec["trials"])
