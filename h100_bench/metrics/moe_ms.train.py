"""``moe_ms.train``: device milliseconds a micro-step of the kernels launched
inside the port's ``ssl_vit.moe.*`` ranges over the profiled steps (the MoE
MLPs' forward, any recompute and backward, each kernel counted once).
Nothing to read where the program has no such ranges."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or not prof.get("units") or not prof.get("moe_s"):
        return None
    return 1e3 * prof["moe_s"] / prof["units"]
