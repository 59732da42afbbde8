"""``norm_kernel_share.<part>``: the share of the model's LayerNorm calls that
ran the one-pass kernel, in percent: 100 x the program's
``layer_norm.launches`` counter over it plus its ``layer_norm.plain_calls``
counter, over the whole run (warm-up, window and traced tail alike;
``run.py`` runs one cell a process, so training and serving read the same
counters; a CUDA graph's replays count the calls they replay). A counter the
program lacks counts 0; nothing to read where it has neither, or neither
counted a call."""


def read(ctx):
    try:
        from ssl_vit_video_analytics_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = tracing.counters()
    launched, plain = counts.get("layer_norm.launches"), counts.get("layer_norm.plain_calls")
    if launched is None and plain is None:
        return None
    launched, plain = launched or 0, plain or 0
    if not launched + plain:
        return None
    return 100.0 * launched / (launched + plain)
