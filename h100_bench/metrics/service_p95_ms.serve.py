"""``service_p95_ms.serve``: the 95th percentile of the window's batches'
service times (from a batch's call to its host copy, without the wait for
its turn), in milliseconds."""
from h100_bench.yardstick import percentile


def read(ctx):
    if not ctx.get("service"):
        return None
    return 1e3 * percentile(ctx["service"], 95)
