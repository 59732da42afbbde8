"""``host_syncs.serve``: the blocking device-to-host reads the program made a
served batch: its ``host_syncs`` counter over its ``early_exit.batches``
counter, over the whole run (warm-up, window and traced tail serve alike;
``run.py`` runs one cell a process). Nothing to read where the program has
no such counters."""


def read(ctx):
    try:
        from ssl_vit_video_analytics_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    if not counts.get("early_exit.batches"):
        return None
    return counts["host_syncs"] / counts["early_exit.batches"]
