"""``jobs_per_round`` (jobs): the server worker's own counters over the
window, jobs answered (``ok``) over dispatch rounds (``rounds``)."""


def read(ctx):
    rounds = ctx.win.counters.get("rounds")
    if not rounds:
        return None
    return ctx.win.counters["ok"] / rounds
