"""``host_syncs.train``: the blocking device-to-host reads the program made a
micro-step: its ``host_syncs`` counter over its ``train.steps`` counter,
over the whole run (the checked steps, the window and the traced tail step
alike; ``run.py`` runs one cell a process). The benchmark's own reads, as
the entry's every ``log_interval`` steps, are not the program's and are
not counted. Nothing to read where the program has no such counters."""


def read(ctx):
    try:
        from ssl_vit_video_analytics_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    if not counts.get("train.steps"):
        return None
    return counts["host_syncs"] / counts["train.steps"]
