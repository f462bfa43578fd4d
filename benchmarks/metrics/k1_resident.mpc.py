"""K1's scenarios resident on one SM in the plan the traced episodes ran,
as the port's counter record holds it (``ilqr_tpu_torch/utils/counters.py``:
the newest plan's ``resident``, from the card's occupancy query). None
where the port keeps no such record."""


def read(ctx):
    if ctx.kind != "mpc_episodes":
        return None
    try:
        from ilqr_tpu_torch.utils import counters
    except ImportError:
        return None
    plan = counters.plan
    return None if plan is None or plan["resident"] is None else int(plan["resident"])
