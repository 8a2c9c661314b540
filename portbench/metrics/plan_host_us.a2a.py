"""Host microseconds a dispatch or combine call of the plan takes, from
the call to its return, each started on an idle card (no span and no
synchronisation inside the call), over every rank's timed calls."""


def read(ctx):
    us = ctx.work.get("plan_host_us")
    if not us:
        return None
    return sum(us) / len(us)
