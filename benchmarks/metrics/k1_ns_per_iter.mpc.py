"""K1's device ns in the traced episodes over the scenario-iterations their
solves ran (the summed ``iters`` of every row and tick): K1's time as
iterations times the cost of one. Read beside ``k1_resident.mpc``, from
the same traced episodes; None where the port keeps no plan record
(``ilqr_tpu_torch/utils/counters.py``) or nothing was traced."""

from benchmarks.metrics import k1_seconds


def read(ctx):
    if ctx.kind != "mpc_episodes":
        return None
    try:
        from ilqr_tpu_torch.utils import counters
    except ImportError:
        return None
    if counters.plan is None:
        return None
    iters = sum(s["iters"] for s in ctx.solves)
    k1 = k1_seconds(ctx)
    return 1e9 * k1 / iters if iters > 0 and k1 > 0 else None
