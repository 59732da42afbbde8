"""``moe_slot_fill.train``: the share of the expert bank's computed slots that
hold a token, in percent: 100 x the program's ``moe.kept`` counter (tokens
that fit their expert's buffer) over its ``moe.slots`` counter (every
expert's buffer, E x groups x capacity), over the whole run (``run.py``
runs one cell a process). Nothing to read where the program has no such
counters."""


def read(ctx):
    try:
        from ssl_vit_video_analytics_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    if not counts.get("moe.slots") or "moe.kept" not in counts:
        return None
    return 100.0 * counts["moe.kept"] / counts["moe.slots"]
