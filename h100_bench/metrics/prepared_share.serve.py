"""``prepared_share.serve``: the share of the model's conv and linear calls
that ran on prepared weights (cast, and their BatchNorm folded, once per
weight version), in percent: 100 x the program's ``weights.prepared_calls``
counter over it plus its ``weights.cast_calls`` counter, over the whole run
(warm-up, window and traced tail alike; ``run.py`` runs one cell a process;
a CUDA graph's replays count the calls they replay). Nothing to read where
the program has no such counters."""


def read(ctx):
    try:
        from ssl_vit_video_analytics_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    prepared, cast = counts.get("weights.prepared_calls"), counts.get("weights.cast_calls")
    if prepared is None or cast is None or not prepared + cast:
        return None
    return 100.0 * prepared / (prepared + cast)
