"""The streaming early-exit loop's CUDA graphs (``models/dynamic.py``).

On the CPU the loop always runs eagerly (a CPU clip), and ``eager_reason``
names each other condition that keeps it eager on a card: grad on, a module
in train mode, functions that are not methods of one module, a recording
profiler, the port's spans. The eager loop counts its frames and no replay.
A capture's counted launches are taken back and added on each replay.

Then the graphed loop, each test twice. On the card (``[cuda]``, marked
``cuda``; it skips without one): MobileViT-S at the serving cell's widths
(``h100_bench/configs/mobilevit_s_ee.json``: embed 256, 101 classes, bf16,
batches of 8 clips x 16 frames at 112^2) under ``torch.inference_mode``: the
graphed loop against the eager one (forced by a recording profiler) bit for
bit, K1 launch for launch and call for call on prepared weights (59 a
frame, no weight cast), the tensors it returns, the new weights it reads,
the clips it shares graphs with and the captures it makes. On the CPU
(``[cpu]``), the same at 4 clips x 8 frames at 32^2 through stand-ins: the
CPU clip counts as a card's and a graph's replay runs its step's Python
again on the same buffers, so the loop's bookkeeping (buffers, keys,
counters, fresh outputs) is held here and the CUDA mechanics on the card. This file imports torch and the port
only, so on the card run it as

    python -m pytest tests/test_torch_port_frame_graph.py --noconftest -q -p no:cacheprovider
"""
import contextlib
from typing import NamedTuple

import pytest
import torch
from torch import nn

from ssl_vit_video_analytics_tpu_torch.models import dynamic
from ssl_vit_video_analytics_tpu_torch.models.dynamic import (_check_and_update,
                                                              eager_reason,
                                                              select_topk_frames,
                                                              streaming_early_exit)
from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as eng
from ssl_vit_video_analytics_tpu_torch.utils import tracing

torch.set_num_threads(2)  # six test workers share the host

S, B, T, D, K = 4, 3, 8, 6, 5
COUNTERS = ("early_exit.frames", "early_exit.graph_replays", "early_exit.graph_captures",
            "host_syncs", "flash_fwd.launches", "weights.prepared_calls",
            "weights.cast_calls")


def _counted(fn) -> tuple:
    """``fn()``, and what it added to each of :data:`COUNTERS`."""
    before = tracing.counters()
    out = fn()
    after = tracing.counters()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


class Toy(nn.Module):
    """A per-frame linear embedding and a linear head."""

    def __init__(self):
        super().__init__()
        with torch.random.fork_rng():
            torch.manual_seed(0)
            self.proj = nn.Linear(S * S * 3, D)
            self.head = nn.Linear(D, K)

    def frame_embedding(self, frames):
        return self.proj(frames.reshape(frames.shape[0], -1))

    def classify_embedding(self, emb):
        return self.head(emb.float())


def _profiling():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@contextlib.contextmanager
def _spans_on():
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()


# name: (setup of the module, functions of it, context, the reason)
EAGER_CASES = {
    "cpu_clip": (nn.Module.eval, lambda m: (m.frame_embedding, m.classify_embedding),
                 torch.no_grad, "the clip is not on a CUDA device"),
    "grad_on": (nn.Module.eval, lambda m: (m.frame_embedding, m.classify_embedding),
                contextlib.nullcontext, "grad is on"),
    "train_mode": (nn.Module.train, lambda m: (m.frame_embedding, m.classify_embedding),
                   torch.inference_mode, "the module is in train mode"),
    "plain_functions": (nn.Module.eval,
                        lambda m: (lambda f: m.frame_embedding(f), m.classify_embedding),
                        torch.inference_mode,
                        "embed_fn and classify_fn are not methods of one module"),
    "profiler": (nn.Module.eval, lambda m: (m.frame_embedding, m.classify_embedding),
                 _profiling, "a profiler is recording"),
    "spans_on": (nn.Module.eval, lambda m: (m.frame_embedding, m.classify_embedding),
                 _spans_on, "spans are on"),
}


@pytest.mark.parametrize("case", list(EAGER_CASES))
@pytest.mark.parametrize("threshold,frames", [(1.1, T), (0.0, 4)])
def test_the_loop_runs_eagerly_and_counts_its_frames(case, threshold, frames):
    setup, fns, context, reason = EAGER_CASES[case]
    model = Toy()
    setup(model)
    embed, classify = fns(model)
    clip = torch.rand(B, T, S, S, 3, generator=torch.Generator().manual_seed(1))
    with context():
        got = eager_reason(embed, classify, clip)
        (_, stats), counted = _counted(lambda: streaming_early_exit(embed, classify, clip,
                                                                    threshold, 4))
    assert got == reason
    assert (stats.used_frames == frames).all()
    assert counted == {"early_exit.frames": frames, "early_exit.graph_replays": 0,
                       "early_exit.graph_captures": 0, "host_syncs": min(frames, T - 1),
                       "flash_fwd.launches": 0, "weights.prepared_calls": 0,
                       "weights.cast_calls": 0}


def test_device_scalars_compare_as_the_numbers_do():
    """The graphed step holds ``threshold`` and ``min_frames`` as 0-d fp32
    and int32 tensors: each exit decision is the one the numbers give, at
    thresholds on the confidences themselves and on either side of them."""
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(64, K, generator=g) * 3
    emb = torch.randn(64, D, generator=g)
    conf = torch.softmax(logits, 1).amax(1)
    cnt = torch.randint(1, 8, (64,), dtype=torch.int32, generator=g)
    decided = torch.rand(64, generator=g) < 0.3
    final = torch.randn(64, K, generator=g)
    used = torch.randint(0, 8, (64,), dtype=torch.int32, generator=g)
    classify = lambda e: logits  # noqa: E731 - the head's output, fixed
    thresholds = [float(c) for c in conf[:16]] + [0.7, 0.1, 0.55, 1.0]
    thresholds += [t + d for t in thresholds[:16] for d in (-1e-9, 1e-9)]
    for thr in thresholds:
        for min_frames in (1, 4, 7):
            as_numbers = _check_and_update(classify, emb, cnt, decided, final, used, thr,
                                           min_frames)
            as_tensors = _check_and_update(
                classify, emb, cnt, decided, final, used,
                torch.tensor(thr, dtype=torch.float32),
                torch.tensor(min_frames, dtype=torch.int32))
            for a, b in zip(as_numbers, as_tensors):
                assert torch.equal(a, b), (thr, min_frames)


def test_a_capture_takes_its_launches_back_and_each_replay_adds_them():
    """A capture runs the kernel wrappers, which count, but launches nothing:
    ``uncounted_launches`` takes what it added to the launch counters back
    off and hands it to ``count_launches``, a replay's; other counters keep
    what it added."""
    kernel = tracing.counter("test_frame_graph.kernel.launches", launches=True)
    other = tracing.counter("test_frame_graph.kernel.calls")
    kernel.count, other.count = 5, 0

    def capture():
        kernel.count += 6
        other.count += 1

    launched = tracing.uncounted_launches(capture)
    assert (kernel.count, other.count) == (5, 1)
    assert launched == ((kernel, 6),)
    for _ in range(3):
        tracing.count_launches(launched)
    assert kernel.count == 5 + 18
    assert tracing.uncounted_launches(lambda: None) == ()
    assert tracing.counter("test_frame_graph.kernel.launches") is kernel and kernel.launches
    kernel.reset()
    other.reset()


# --------------------------------------------------------------------------
# The graphed loop: on the card, and on the CPU through stand-ins
# --------------------------------------------------------------------------

CLASSES, EMBED = 101, 256


class Where(NamedTuple):
    dev: torch.device
    clips: int
    frames: int
    size: int


class _Replayed:
    """A captured graph's stand-in on the CPU: a replay runs the captured
    Python again, on the same buffers."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _cpu_counts_as_a_card(embed_fn, classify_fn, clip):
    why = eager_reason(embed_fn, classify_fn, clip)
    return None if why == "the clip is not on a CUDA device" else why


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def where(request, monkeypatch):
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (CUDA graphs and the K1 kernel)")
        return Where(torch.device("cuda"), 8, 16, 112)
    monkeypatch.setattr(dynamic, "eager_reason", _cpu_counts_as_a_card)
    monkeypatch.setattr(dynamic, "_capture", lambda step, dev: (_Replayed(step), ()))
    return Where(torch.device("cpu"), 4, 8, 32)


def _mobilevit(where, seed=0, dtype=torch.bfloat16, dev=None):
    model = eng.build_model(CLASSES, EMBED, dtype=dtype, backbone="mobilevit_s")
    eng.init_model(model, torch.Generator().manual_seed(seed))
    return model.to(dev or where.dev).eval()


def _clip(where, seed, clips=None):
    g = torch.Generator(device=where.dev).manual_seed(seed)
    shape = (clips or where.clips, where.frames, where.size, where.size, 3)
    return normalize_clip(torch.randint(0, 256, shape, dtype=torch.uint8, device=where.dev,
                                        generator=g))


def _serve(model, clip, threshold, eager=False, **kw):
    """One batch through the loop, counted; eagerly under a profiler."""
    with _profiling() if eager else contextlib.nullcontext():
        return _counted(lambda: streaming_early_exit(model.frame_embedding,
                                                     model.classify_embedding, clip,
                                                     threshold, 4, **kw))


def _same(a, b) -> None:
    (la, sa), (lb, sb) = a, b
    assert torch.equal(sa.used_frames, sb.used_frames)
    assert torch.equal(la, lb)
    assert torch.equal(sa.final_conf, sb.final_conf)


@pytest.mark.parametrize("threshold", [0.0, 0.75, 1.1, "median"])
def test_graphed_loop_matches_the_eager_loop_bit_for_bit(where, threshold):
    """"median": the median confidence after 4 frames, so that some clips
    exit at 4 frames and the rest later or never (random weights)."""
    model = _mobilevit(where)
    with torch.inference_mode():
        clip = _clip(where, 1)
        if threshold == "median":
            (_, st), _ = _serve(model, clip, 1.1, eager=True, max_frames=4)
            threshold = float(st.final_conf.median())
        _, first = _serve(model, _clip(where, 0), threshold)  # eager, then the capture
        graphed, counted = _serve(model, clip, threshold)
        eager, counted_eager = _serve(model, clip, threshold, eager=True)
    _same(graphed, eager)
    assert (first["early_exit.graph_captures"], first["early_exit.graph_replays"]) == (1, 0)
    # K1 a frame: 3 MobileViT blocks x depth 2; the capture's warm-up step
    # launches, the capture itself does not
    on_card = where.dev.type == "cuda"
    assert first["flash_fwd.launches"] == (6 * (first["early_exit.frames"] + 1) if on_card else 0)
    # prepared weights a frame: 35 ConvBNActs and 24 linears, no cast
    assert first["weights.prepared_calls"] == 59 * (first["early_exit.frames"] + on_card)
    assert first["weights.cast_calls"] == 0
    frames = counted["early_exit.frames"]
    k1 = 6 * frames if on_card else 0
    assert counted == {"early_exit.frames": frames, "early_exit.graph_replays": frames,
                       "early_exit.graph_captures": 0,
                       "host_syncs": min(frames, where.frames - 1), "flash_fwd.launches": k1,
                       "weights.prepared_calls": 59 * frames, "weights.cast_calls": 0}
    assert counted_eager == {**counted, "early_exit.graph_replays": 0}
    used = graphed[1].used_frames
    if threshold == 0.0:
        assert (used == 4).all()
    elif threshold > 1:
        assert (used == where.frames).all()
    elif threshold < 0.5:  # the median's
        assert used.min() == 4 < used.max()


def test_returned_tensors_outlive_the_next_batch(where):
    model = _mobilevit(where)
    with torch.inference_mode():
        _serve(model, _clip(where, 0), 0.75)
        (lg1, st1), counted = _serve(model, _clip(where, 1), 0.75)
        kept = lg1.clone(), st1.used_frames.clone(), st1.final_conf.clone()
        (lg2, _), _ = _serve(model, _clip(where, 2), 0.75)
    assert counted["early_exit.graph_replays"] == where.frames
    assert not torch.equal(lg1, lg2)
    for a, b in zip((lg1, st1.used_frames, st1.final_conf), kept):
        assert torch.equal(a, b)


def test_new_weights_replay_without_a_capture_and_new_storage_captures(where):
    model = _mobilevit(where, seed=0)
    other = _mobilevit(where, seed=3, dev=torch.device("cpu")).state_dict()
    clip = _clip(where, 1)
    with torch.inference_mode():
        _serve(model, clip, 0.75)  # captured over seed 0's weights
        before, _ = _serve(model, clip, 0.75)
    model.load_state_dict(other)  # copies in place: the graphs read the new weights
    with torch.inference_mode():
        graphed, counted = _serve(model, clip, 0.75)
        eager, _ = _serve(model, clip, 0.75, eager=True)
    assert counted["early_exit.graph_replays"] == where.frames
    assert counted["early_exit.graph_captures"] == 0
    _same(graphed, eager)
    assert not torch.equal(graphed[0], before[0])

    for p in model.parameters():  # new storage: served eagerly and captured anew
        p.data = p.data.clone()
    with torch.inference_mode():
        _, first = _serve(model, clip, 0.75)
        graphed, counted = _serve(model, clip, 0.75)
        eager, _ = _serve(model, clip, 0.75, eager=True)
    assert (first["early_exit.graph_captures"], first["early_exit.graph_replays"]) == (1, 0)
    assert counted["early_exit.graph_replays"] == where.frames
    _same(graphed, eager)


def test_a_gated_clip_replays_the_same_graphs(where):
    """The hybrid mode's clips: k = 6 frames a clip chosen by motion, the
    same frame shape."""
    model = _mobilevit(where)
    with torch.inference_mode():
        clip = _clip(where, 1)
        _serve(model, clip, 0.75)
        sel, _ = select_topk_frames(clip, 6)
        graphed, counted = _serve(model, sel, 0.75)
        eager, _ = _serve(model, sel, 0.75, eager=True)
    assert counted["early_exit.graph_captures"] == 0
    assert counted["early_exit.graph_replays"] == 6
    _same(graphed, eager)


def test_one_capture_a_key_whatever_the_threshold(where):
    """A key is the frame shape, dtype, device and inference mode: every
    threshold of a sweep shares one graph."""
    model = _mobilevit(where)
    clip = _clip(where, 1)
    captures = 0
    with torch.inference_mode():
        for thr in (0.55, 0.75, 0.85, 0.0, 1.1):
            captures += _serve(model, clip, thr)[1]["early_exit.graph_captures"]
        assert captures == 1
        for thr in (0.75, 0.0):  # half the batch: another key
            captures += _serve(model, clip[:where.clips // 2], thr)[1][
                "early_exit.graph_captures"]
        assert captures == 2
    with torch.no_grad():  # buffers that are not inference tensors: another key
        captures += _serve(model, clip, 0.75)[1]["early_exit.graph_captures"]
        graphed, counted = _serve(model, clip, 0.75)
        eager, _ = _serve(model, clip, 0.75, eager=True)
    assert captures == 3
    assert counted["early_exit.graph_replays"] == where.frames
    _same(graphed, eager)


def test_an_fp32_model_matches_the_eager_loop(where):
    """fp32 parameters take the first conv's input as the clip's strided
    view; the graph's frame buffer is contiguous."""
    model = _mobilevit(where, dtype=torch.float32)
    with torch.inference_mode():
        clip = _clip(where, 1)
        _serve(model, clip, 1.1)
        graphed, counted = _serve(model, clip, 1.1)
        eager, _ = _serve(model, clip, 1.1, eager=True)
    assert counted["early_exit.graph_replays"] == where.frames
    _same(graphed, eager)
