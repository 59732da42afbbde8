"""The port's tracer (``utils/tracing.py``) on the CPU at toy sizes: no range
while off, the early-exit loop's reads, the train step's phases, attention
calls with the attrs the benchmark's probe records and a backward range
that holds the call's backward, the stores' gathers, each span as a
profiler range, and counters by name."""
from collections import Counter

import pytest
import torch

from h100_bench import trace as bench_trace
from ssl_vit_video_analytics_tpu_torch.data.device_store import (ChunkedDeviceClipStore,
                                                                 DeviceClipStore)
from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.data.loader import ClipDataset
from ssl_vit_video_analytics_tpu_torch.models.dynamic import (early_exit_batched,
                                                              streaming_early_exit)
from ssl_vit_video_analytics_tpu_torch.models.mae import TinyVideoMAE
from ssl_vit_video_analytics_tpu_torch.models.tiny_vit import TinyViT
from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa
from ssl_vit_video_analytics_tpu_torch.ops.attention import attention_packed
from ssl_vit_video_analytics_tpu_torch.scripts import profile_step
from ssl_vit_video_analytics_tpu_torch.train import mae_engine, state
from ssl_vit_video_analytics_tpu_torch.utils import tracing

torch.set_num_threads(2)  # six test workers share the host

B, T, S, K = 3, 16, 4, 5
SPANS = {"train.step", "train.forward", "train.backward", "train.update", "attn.fwd",
         "attn.bwd", "store.gather", "layer_norm", "layer_norm.bwd"}


@pytest.fixture
def tracer():
    """Spans off before and after."""
    tracing.disable()
    yield tracing
    tracing.disable()


def _counted(fn) -> dict:
    """What ``fn`` added to each counter."""
    before = tracing.counters()
    fn()
    return {k: v - before.get(k, 0) for k, v in tracing.counters().items()}


def _classifier():
    w = torch.randn(S * S * 3, K, generator=torch.Generator().manual_seed(0))
    return (lambda f: f.reshape(f.shape[0], -1).float()), (lambda e: e @ w)


def _clip():
    return torch.rand(B, T, S, S, 3, generator=torch.Generator().manual_seed(1))


def _profiled(fn) -> list:
    """The span ranges of ``fn``'s CPU profile, by start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    evts = [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    return sorted(evts, key=lambda e: e.time_range.start)


def _name(e) -> str:
    """A range's span name, its attrs left out."""
    return e.name[len(tracing.PREFIX):].split("(", 1)[0]


def _span_parent(e):
    """The innermost span range around ``e``, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(tracing.PREFIX):
        p = p.cpu_parent
    return p


def _under(e, pattern: str) -> bool:
    return any(pattern in c.name or _under(c, pattern) for c in e.cpu_children)


def test_spans_off_record_nothing_and_leave_no_profiler_range(tracer):
    embed, classify = _classifier()
    got = {}
    counted = _counted(lambda: got.update(
        ranges=_profiled(lambda: streaming_early_exit(embed, classify, _clip(), 1.1, 4)),
        step=_profiled(_toy_step())))
    assert got["ranges"] == [] and got["step"] == []
    # counters count with spans off
    assert counted["host_syncs"] == T - 1
    assert counted["early_exit.batches"] == 1 and counted["train.steps"] == 1


@pytest.mark.parametrize("threshold,frames", [(1.1, T), (0.0, 4)])
def test_early_exit_records_its_frames_and_reads(tracer, threshold, frames):
    """No clip reaches 1.1: every frame, a read before each after the
    first. At 0 every clip exits at ``min_frames`` 4: the read at t = 4
    ends the loop."""
    embed, classify = _classifier()
    tracer.enable()
    out = {}
    counted = _counted(lambda: out.update(
        stats=streaming_early_exit(embed, classify, _clip(), threshold, 4)[1]))
    assert (out["stats"].used_frames == frames).all()
    assert counted["host_syncs"] == min(frames, T - 1)
    assert counted["early_exit.batches"] == 1


def test_batched_early_exit_counts_a_batch_without_reads(tracer):
    embed, classify = _classifier()
    batched = _counted(lambda: early_exit_batched(embed, classify, _clip(), 1.1, 4))
    streamed = _counted(lambda: streaming_early_exit(embed, classify, _clip(), 1.1, 4))
    assert (batched["early_exit.batches"], batched["host_syncs"]) == (1, 0)
    assert (streamed["early_exit.batches"], streamed["host_syncs"]) == (1, T - 1)


def _toy_mae():
    enc = TinyViT(embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
                  drop_path_rate=0.0, use_checkpoint=False, num_stages=3)
    return TinyVideoMAE(enc, clip_len=4, img_size=32, decoder_embed_dim=16, decoder_depth=1,
                        decoder_num_heads=2)


def _toy_step(accum=2):
    torch.manual_seed(0)
    model = _toy_mae()
    tx = mae_engine.wrap_accum_and_skip(state.make_optimizer(model.parameters(), 1e-3),
                                        accum_steps=accum)
    st = state.create_train_state(model, tx)
    step = mae_engine.make_pixel_mae_step(model, mask_ratio=0.75)
    clip = torch.randint(0, 256, (2, 4, 32, 32, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    return lambda: step(st, {"clip": clip}, gen)


def test_train_step_records_forward_backward_and_update(tracer):
    step = _toy_step(accum=2)
    tracer.enable()
    got = {}

    def four():
        for _ in range(4):
            step()

    counted = _counted(lambda: got.update(ranges=_profiled(four)))
    ranges = got["ranges"]
    roots = [e for e in ranges if _span_parent(e) is None]
    assert [_name(e) for e in roots] == ["train.step"] * 4
    for root in roots:
        phases = [_name(e) for e in ranges if _span_parent(e) is root]
        assert phases == ["train.forward", "train.backward", "train.update"]
    fwd = [e for e in ranges if _name(e) == "attn.fwd"]
    bwd = [e for e in ranges if _name(e) == "attn.bwd"]
    assert len(fwd) == len(bwd) == 4 * 3  # two encoder stages and the decoder a step
    # the CPU runs the backward on the calling thread, inside train.backward
    assert all(_name(_span_parent(e)) == "train.forward" for e in fwd)
    assert all(_name(_span_parent(e)) == "train.backward" for e in bwd)
    # one finite check an update: every second call at accumulation 2
    assert counted["host_syncs"] == 2
    assert counted["train.steps"] == 4


def _attrs_name(kind: str, call: tuple) -> str:
    b, lq, lk, h, d, dtype = call
    return (f"ssl_vit.attn.{kind}(B={b},Lq={lq},Lk={lk},H={h},d={d},"
            f"dtype={str(dtype).removeprefix('torch.')})")


def test_attention_attrs_are_what_the_benchmark_probe_records(tracer):
    model = _toy_mae()
    clip = torch.rand(2, 4, 32, 32, 3)
    mask = torch.zeros(2, 4, 16, dtype=torch.bool)
    mask[:, :, ::2] = True
    probe = bench_trace.AttentionProbe()
    tracer.enable()

    def work():
        with probe:
            model(clip, mask).square().mean().backward()

    ranges = _profiled(work)
    fwd = [e.name for e in ranges if _name(e) == "attn.fwd"]
    bwd = [e.name for e in ranges if _name(e) == "attn.bwd"]
    assert len(probe.calls) == 3  # two encoder stages, the decoder
    assert fwd == [_attrs_name("fwd", c) for c in probe.calls]
    assert sorted(bwd) == sorted(_attrs_name("bwd", c) for c in probe.calls)


@pytest.mark.parametrize("grads", ["qkv", "kv", "none"])
def test_attn_bwd_range_holds_the_calls_backward(tracer, grads):
    """The backward's range is opened before the call's autograd node runs
    and closed after it, whichever of q, k, v need a gradient; without
    gradients there is no backward range. The gradients are those of
    tracing off."""
    g = torch.Generator().manual_seed(4)
    q0, k0, v0 = (torch.randn(2, 6, 16, generator=g) for _ in range(3))
    dout = torch.randn(2, 6, 16, generator=g)

    def grads_of():
        q, k, v = (t.clone().requires_grad_(grads == "qkv" or name != "q")
                   for name, t in zip("qkv", (q0, k0, v0)))
        if grads == "none":
            with torch.no_grad():
                out = attention_packed(q, k, v, 2)
            assert out.grad_fn is None
            return out, []
        out = attention_packed(q, k, v, 2)
        out.backward(dout)
        return out, [t.grad for t in (q, k, v)]

    off_out, off_grads = grads_of()
    tracer.enable()
    got = {}
    ranges = _profiled(lambda: got.update(zip(("out", "grads"), grads_of())))
    assert torch.equal(got["out"], off_out)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got["grads"], off_grads))
    bwd = [e for e in ranges if _name(e) == "attn.bwd"]
    assert [_name(e) for e in ranges if _name(e) == "attn.fwd"] == ["attn.fwd"]
    if grads == "none":
        assert bwd == []
    else:
        assert len(bwd) == 1 and _under(bwd[0], "FlashAttentionBackward")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    return make_synthetic_dataset(str(root), num_classes=2, videos_per_class=4, num_frames=8,
                                  image_size=32, seed=0)["train"]


def _stores(split):
    ds = ClipDataset(split, mode="ssl", clip_len=4, stride=2, image_size=32, seed=3,
                     verbose=False)
    return ds, (DeviceClipStore(ds, "cpu", log=lambda m: None),
                ChunkedDeviceClipStore(ds, shard_bytes=2 * 4 * 32 * 32 * 3, batch_size=2,
                                       device="cpu", log=lambda m: None))


def test_stores_record_each_gather(tracer, split):
    ds, stores = _stores(split)
    tracer.enable()

    def walk():
        for store in stores:
            for _ in store.epoch_batches(2, shuffle=True, seed=0, epoch=1):
                # a gather's range has closed before its batch is handed over
                with tracing.span("consumer"):
                    pass

    ranges = _profiled(walk)
    batches = len(ds) // 2
    assert Counter(_name(e) for e in ranges) == {"store.gather": 2 * batches,
                                                 "consumer": 2 * batches}
    assert all(_span_parent(e) is None for e in ranges)


def test_every_span_is_a_profiler_range_while_one_records(tracer, split):
    """With a profiler recording, the work of both paths shows every span
    ``utils/tracing.py`` names, and no other."""
    embed, classify = _classifier()
    step = _toy_step()
    _, (store, _) = _stores(split)
    tracer.enable()

    def work():
        streaming_early_exit(embed, classify, _clip(), 1.1, 4)
        next(store.epoch_batches(2, shuffle=False, seed=0, epoch=0))
        step()

    assert {_name(e) for e in _profiled(work)} == SPANS
    # outside a profiler a span is a range no one records
    with tracing.span("train.step"):
        step()


def test_profile_step_reads_each_span(tracer):
    step = _toy_step()
    tracer.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step()
        step()
    rows = profile_step.spans(prof.events(), steps=2)
    assert {k: r["calls_per_step"] for k, r in rows.items()} == {
        "attn.bwd": 3, "attn.fwd": 3, "train.backward": 1, "train.forward": 1,
        "train.step": 1, "train.update": 1, "layer_norm": 7, "layer_norm.bwd": 7}
    # no kernel on the CPU
    assert all(r["device_ms_per_step"] == r["K2 flash_bwd"] == 0 for r in rows.values())


def test_counters_are_registered_by_name(tracer):
    assert tracing.counter("flash_fwd.launches") is fa.launches
    assert tracing.counter("flash_bwd.launches") is fa.bwd_launches
    fa.launches.reset()
    fa.launches.count += 3
    assert tracing.counters()["flash_fwd.launches"] == 3
    fa.launches.reset()
    assert fa.launches.count == 0
    # a read: a number for a 0-d tensor, a host tensor else, each counted
    got = {}
    counted = _counted(lambda: got.update(one=tracing.host_read(torch.tensor(2.5)),
                                          row=tracing.host_read(torch.ones(1))))
    assert got["one"] == 2.5 and isinstance(got["one"], float)
    assert isinstance(got["row"], torch.Tensor) and got["row"].shape == (1,)
    assert counted["host_syncs"] == 2
