"""``attn_fwd_roofline.<part>``: the attention calls' least time (the
yardstick's bound of each probed call, forward) summed, over their device
time summed, as a percentage. Nothing to read where no call ran or no
device time was attributed."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or "attention" not in prof:
        return None
    att = prof["attention"]["fwd"]
    if not att["calls"] or att["device_s"] <= 0:
        return None
    return 100.0 * att["bound_s"] / att["device_s"]
