"""``latency_p50_ms.serve``: the median of the window's batch latencies
(from when a batch was due to its host copy), in milliseconds."""
from h100_bench.yardstick import percentile


def read(ctx):
    if not ctx.get("latency"):
        return None
    return 1e3 * percentile(ctx["latency"], 50)
