"""``mfu.<part>``: the model FLOPs of the untraced window over the seconds
they took, as a share of the H100's dense bf16 peak. Training: pipeline B's
analytic count a clip (forward and backward, recomputation not counted)
times the clips, over the window. Serving: frames encoded times one
frame's embedding FLOPs (``torch.utils.flop_counter`` on the plain
reference, forward only), over the seconds the batches were being served
(each from its call to its host copy; the open loop's waits for arrivals
left out)."""
from h100_bench.yardstick import BF16_TENSOR_FLOP_PER_S


def read(ctx):
    if ctx.get("model_s", 0) <= 0:
        return None
    return 100.0 * ctx["model_flops"] / ctx["model_s"] / BF16_TENSOR_FLOP_PER_S
