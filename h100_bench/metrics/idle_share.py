"""``idle_share.<part>``: the share of a step's (training) or a batch's
(serving) wall time in which no operation ran on the device, in percent:
one less the device busy time a unit in the profiled tail over the
untraced window's wall time a unit (a micro-step; a batch's service, from
its call to its host copy). The wall time is not the profiled tail's,
which the profiler's own host work lengthens."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or not prof.get("units") or ctx.get("unit_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["units"] / ctx["unit_s"])
