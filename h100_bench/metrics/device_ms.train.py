"""``device_ms.train``: device busy milliseconds a micro-step over the
profiled steps."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or not prof.get("units"):
        return None
    return 1e3 * prof["busy_s"] / prof["units"]
