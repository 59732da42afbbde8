"""``graph_share.serve``: the share of the early-exit loop's frames that a
CUDA graph's replay stepped, in percent: 100 x its ``early_exit.graph_replays``
counter over its ``early_exit.frames`` counter, over the whole run (warm-up,
window and traced tail alike; ``run.py`` runs one cell a process). Nothing to
read where the program has no such counters."""


def read(ctx):
    try:
        from ssl_vit_video_analytics_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    if not counts.get("early_exit.frames"):
        return None
    return 100.0 * counts.get("early_exit.graph_replays", 0) / counts["early_exit.frames"]
