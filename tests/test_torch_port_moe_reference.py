"""The port's MoE decoder (``models/layers.MoeMlp`` in pipeline B's step)
against the benchmark's plain MoE reference
(``h100_bench/reference/tinyvit_mae_moe.py``), and the MoE layer's spans
and counters, in fp32 on the CPU at toy widths: TinyViT dims (24, 48, 96),
2 clips of 4 frames at 32x32 (128 decoder tokens), a 2-block decoder 16
wide with 4 experts in groups of 16 tokens.

Both sides load one state dict drawn by ``h100_bench/inputs.make_weights``
and see the same clips, tube masks and stochastic-depth decisions. Two
cases: capacity factor 1.0 (4 slots an expert a group; the random router
sends most masked tokens, which differ only by their position embeddings,
to one expert, so tokens are dropped) and capacity factor 4.0 (every
group fits in any expert's buffer; none is dropped).
"""
import copy
import json
import os

import pytest
import torch

from h100_bench import harness, inputs
from h100_bench.reference import tinyvit_mae as RT
from h100_bench.reference import tinyvit_mae_moe as RM
from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae
from ssl_vit_video_analytics_tpu_torch.models.layers import MoeMlp
from ssl_vit_video_analytics_tpu_torch.train import mae_engine
from ssl_vit_video_analytics_tpu_torch.train.state import create_train_state, make_optimizer
from ssl_vit_video_analytics_tpu_torch.utils import tracing

torch.set_num_threads(2)  # six test workers share the host

B, T, L = 2, 4, 16
AUX_WEIGHT = 0.01
MOE_SPANS = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.bwd"}


def _cfg(capacity_factor: float) -> dict:
    return {"model": {"embed_dims": [24, 48, 96, 576], "decoder_embed_dim": 16,
                      "decoder_depth": 2, "decoder_num_heads": 2, "decoder_moe_experts": 4,
                      "decoder_moe_capacity_factor": capacity_factor,
                      "decoder_moe_group_size": 16},
            "dataset": {"clip_len": T, "image_size": 32},
            "training": {"epochs": 10, "lr": 5e-4, "min_lr": 1e-6, "warmup_epochs": 0,
                         "weight_decay": 0.05, "accumulation_steps": 1},
            "ssl": {"mask_ratio": 0.9, "moe_aux_weight": AUX_WEIGHT}}


def _pair(cfg, seed=0):
    with torch.device("meta"):
        template = RM.TinyVideoMAE(cfg)
    sd = inputs.make_weights(template, seed, "cpu")
    ref = RM.TinyVideoMAE(cfg)
    ref.load_state_dict(sd)
    prog = train_ssl_mae.build_model(cfg, torch.float32)
    prog.load_state_dict(sd)
    return ref, prog


def _batch(ref, seed=1):
    g = torch.Generator().manual_seed(seed)
    clip = torch.randint(0, 256, (B, T, 32, 32, 3), dtype=torch.uint8, generator=g)
    mask = inputs.tube_mask(g, B, T, L, 0.9)
    keeps = inputs.keep_factors(g, ref.drop_rates(), B * T)
    return clip, mask, keeps, g


class _recording:
    """Records each MoE layer's ``assignments`` of its inputs, in call order."""

    def __init__(self, model):
        self.mods = [m for m in model.modules() if isinstance(m, MoeMlp)]
        self.routes = []

    def __enter__(self):
        self.hooks = [m.register_forward_pre_hook(
            lambda mod, args: self.routes.append(mod.assignments(args[0])))
            for m in self.mods]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        return False


def _program_step(prog, clip, mask, keeps, g):
    """One call of the port's pipeline-B step at accumulation 1: its metrics,
    the gradients it handed the optimizer, and its routes."""
    state = create_train_state(prog, make_optimizer(list(prog.parameters()), 0.0))
    step = mae_engine.make_pixel_mae_step(prog, mask_ratio=0.9, moe_aux_weight=AUX_WEIGHT)
    got = {}
    orig = mae_engine.apply_updates

    def capture(st, grads, group=None, shards=None):
        got["grads"] = [gr.clone() for gr in grads]
        return orig(st, grads, group, shards)

    mae_engine.apply_updates = capture
    try:
        with _recording(prog) as rec:
            _, metrics = step(state, {"clip": clip}, g, mask=mask, drop=keeps)
    finally:
        mae_engine.apply_updates = orig
    return metrics, got["grads"], rec.routes


def _reference_step(ref, clip, mask, keeps):
    ref.train()
    pred, x, auxes, routes = ref(clip, mask, keeps)
    aux = torch.stack(auxes).mean()
    loss = RT.masked_norm_pix_mse(pred, x, mask, 8) + AUX_WEIGHT * aux
    return loss, aux, torch.autograd.grad(loss, list(ref.parameters())), routes


@pytest.mark.parametrize("capacity_factor,drops", [(1.0, True), (4.0, False)])
def test_moe_step_matches_the_plain_reference(capacity_factor, drops):
    ref, prog = _pair(_cfg(capacity_factor))
    clip, mask, keeps, g = _batch(ref)
    loss_r, aux_r, grads_r, routes_r = _reference_step(ref, clip, mask, keeps)
    metrics, grads_p, routes_p = _program_step(prog, clip, mask, keeps, g)

    # routing is discontinuous: the same expert for every token and the
    # same dropped tokens, exactly (fp32 on both sides; no token of these
    # draws lies within round-off of a tie)
    assert len(routes_p) == len(routes_r) == 2
    for rp, rr in zip(routes_p, routes_r):
        assert torch.equal(rp, rr)
    dropped = sum(int((r == -1).sum()) for r in routes_r)
    assert (dropped > 0) == drops
    # fp32 on both sides, the same arithmetic in another order (the port's
    # one-hot einsums and batched matmuls against the reference's index
    # gathers): the loss and the auxiliary to 1e-5 relative
    loss_r, aux_r = float(loss_r.detach()), float(aux_r.detach())
    assert abs(float(metrics["loss"]) - loss_r) <= 1e-5 * loss_r
    assert abs(float(metrics["moe_aux"]) - aux_r) <= 1e-5 * aux_r
    names = [n for n, _ in ref.named_parameters()]
    assert names == [n for n, _ in prog.named_parameters()]
    scale = max(float(gr.norm()) for gr in grads_r)
    for name, gr, gp in zip(names, grads_r, grads_p):
        # each leaf to 1e-3 of its own norm, the sums' order alone differing
        # (BatchNorm's statistics over 128 frames lose most digits), plus
        # 1e-6 of the largest leaf's for leaves whose gradient is all but 0
        assert float((gr - gp).norm()) <= 1e-3 * float(gr.norm()) + 1e-6 * scale, name


def test_counters_count_each_micro_steps_routing_once_under_remat():
    """Over a step of the entry's model (remat on), the counters add what the
    reference's routing gives: every token, the kept ones, and E x G x C
    slots a block; the capture of assignments and any recompute add nothing."""
    cfg = _cfg(1.0)
    ref, prog = _pair(cfg)
    assert prog.encoder.use_checkpoint
    clip, mask, keeps, g = _batch(ref)
    with torch.no_grad():
        routes_r = ref(clip, mask, keeps)[3]
    before = tracing.counters()
    _program_step(prog, clip, mask, keeps, g)
    added = {k: v - before.get(k, 0) for k, v in tracing.counters().items()}
    groups, capacity = B * T * L // 16, 4
    assert added["moe.calls"] == 2
    assert added["moe.tokens"] == sum(r.numel() for r in routes_r)
    assert added["moe.kept"] == sum(int((r != -1).sum()) for r in routes_r)
    assert added["moe.slots"] == 2 * 4 * groups * capacity


def test_a_recomputed_moe_call_is_not_counted_again():
    layer = MoeMlp(8, 16, 4, capacity_factor=1.0, group_size=8)
    x = torch.randn(2, 8, 8, requires_grad=True, generator=torch.Generator().manual_seed(5))
    before = tracing.counters()
    y, aux = torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False)
    (y.square().sum() + aux).backward()
    added = {k: v - before.get(k, 0) for k, v in tracing.counters().items()}
    assert (added["moe.calls"], added["moe.tokens"], added["moe.slots"]) == (1, 16, 4 * 2 * 2)
    assert added["moe.kept"] == int((layer.assignments(x) != -1).sum())


def test_the_device_counter_is_read_once_and_not_as_a_host_sync():
    kept = tracing.device_counter("test_moe_reference.kept")
    kept.reset()
    before = tracing.counters()["host_syncs"]
    kept.add(torch.tensor(3))
    kept.add(torch.count_nonzero(torch.ones(4)))
    assert tracing.counters()["test_moe_reference.kept"] == 7
    assert tracing.counters()["host_syncs"] == before
    assert tracing.device_counter("test_moe_reference.kept") is kept
    with pytest.raises(TypeError):
        tracing.counter("test_moe_reference.kept")
    with pytest.raises(TypeError):
        tracing.device_counter("host_syncs")


def _profiled_names(fn) -> list:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith(tracing.PREFIX + "moe.")]


def test_spans_off_add_no_range_and_no_host_read():
    ref, prog = _pair(_cfg(1.0))
    clip, mask, keeps, _ = _batch(ref)
    tracing.disable()
    before = tracing.counters()["host_syncs"]

    def fwd_bwd():
        pred, auxes = prog(clip.float(), mask, keeps, with_aux=True)
        (pred.square().mean() + torch.stack(auxes).mean()).backward()

    assert _profiled_names(fwd_bwd) == []
    assert tracing.counters()["host_syncs"] == before


def test_spans_on_show_each_moe_range_and_keep_the_gradients():
    """Each MoE call's four forward ranges and its backward's range, which
    holds the layer's autograd nodes; the gradients are those of spans off."""
    ref, prog = _pair(_cfg(1.0))
    clip, mask, keeps, _ = _batch(ref)
    twin = copy.deepcopy(prog)

    def grads(model):
        pred, auxes = model(clip.float(), mask, keeps, with_aux=True)
        loss = pred.square().mean() + torch.stack(auxes).mean()
        return torch.autograd.grad(loss, list(model.parameters()))

    off = grads(twin)
    tracing.enable()
    try:
        got = {}
        evts = _profiled_names(lambda: got.update(on=grads(prog)))
    finally:
        tracing.disable()
    names = [e.name[len(tracing.PREFIX):] for e in evts]
    assert set(names) == MOE_SPANS
    assert all(names.count(s) == 2 for s in MOE_SPANS)  # two MoE blocks
    for e in evts:
        if e.name.endswith("moe.bwd"):
            assert _under(e, "BmmBackward0") and _under(e, "SoftmaxBackward0")
    assert all(torch.equal(a, b) for a, b in zip(got["on"], off))


def _under(e, pattern: str) -> bool:
    return any(pattern in c.name or _under(c, pattern) for c in e.cpu_children)


def test_the_moe_cell_resolves_to_its_files():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = harness.resolve(bench, "b_pretrain.moe")
    assert cell.path == os.path.join(harness.HERE, "paths", "pixel_mae_moe_train.py")
    assert os.path.exists(cell.path)
    assert cell.cfg["model"]["decoder_moe_experts"] == 8
    assert cell.cfg["model"]["decoder_moe_group_size"] == 392
    assert cell.cfg["device"]["expert_parallel"] == 1
    assert set(cell.limits) == {"grad_gap", "grad_median_gap", "change_gap", "route_differ"}
    names = {m["name"] for m in cell.per_layer}
    assert {"moe_ms.train", "moe_slot_fill.train", "moe_drop_share.train",
            "host_syncs.train", "mfu.train"} <= names
    assert {m["name"] for m in cell.end_to_end} == {"train_clips_per_s", "train_peak_gib",
                                                     "setup_s"}
    for name in ("moe_ms.train", "moe_slot_fill.train", "moe_drop_share.train"):
        assert os.path.exists(harness.reader_path(os.path.join(harness.HERE, "metrics"), name))
