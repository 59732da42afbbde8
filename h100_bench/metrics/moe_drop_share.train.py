"""``moe_drop_share.train``: the share of routed tokens that found their
expert's buffer full and were dropped, in percent: 100 x (the program's
``moe.tokens`` - ``moe.kept``) / ``moe.tokens``, over the whole run
(``run.py`` runs one cell a process). Nothing to read where the program
has no such counters."""


def read(ctx):
    try:
        from ssl_vit_video_analytics_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    if not counts.get("moe.tokens") or "moe.kept" not in counts:
        return None
    return 100.0 * (counts["moe.tokens"] - counts["moe.kept"]) / counts["moe.tokens"]
