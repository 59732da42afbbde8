"""The plain references against the port, at toy widths on the CPU, with
one set of weights made by the benchmark loaded into both."""
import copy

import pytest
import torch

from h100_bench import inputs, yardstick
from h100_bench.reference import mobilevit_ee as RM
from h100_bench.reference import tinyvit_mae as RT
from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae
from ssl_vit_video_analytics_tpu_torch.models.dynamic import streaming_early_exit
from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as eng
from ssl_vit_video_analytics_tpu_torch.train.mae_engine import (make_pixel_mae_step,
                                                                wrap_accum_and_skip)
from ssl_vit_video_analytics_tpu_torch.train.state import (create_train_state, make_optimizer,
                                                           warmup_cosine_schedule)

CFG = {"model": {"embed_dims": [24, 48, 96, 576], "decoder_embed_dim": 16,
                 "decoder_depth": 2, "decoder_num_heads": 2},
       "dataset": {"clip_len": 4, "image_size": 32},
       "training": {"epochs": 10, "lr": 5e-4, "min_lr": 1e-6, "warmup_epochs": 0,
                    "weight_decay": 0.05, "accumulation_steps": 2},
       "ssl": {"mask_ratio": 0.9}}


def _pair(cfg, seed=0):
    with torch.device("meta"):
        template = RT.TinyVideoMAE(cfg)
    sd = inputs.make_weights(template, seed, "cpu")
    ref = RT.TinyVideoMAE(cfg)
    ref.load_state_dict(sd)
    prog = train_ssl_mae.build_model(cfg, torch.float32)
    prog.load_state_dict(sd)
    return ref, prog, sd


def test_state_dicts_share_names_and_shapes():
    with torch.device("meta"):
        pairs = [(RT.TinyVideoMAE(CFG), train_ssl_mae.build_model(CFG, torch.float32)),
                 (RM.Classifier({"model": {"embed_dim": 32}, "dataset": {"num_classes": 7}}),
                  eng.build_model(7, 32, torch.float32))]
    for ref, prog in pairs:
        assert ({k: tuple(v.shape) for k, v in ref.state_dict().items()}
                == {k: tuple(v.shape) for k, v in prog.state_dict().items()})


@pytest.mark.parametrize("rates", ["published", "high"])
def test_pixel_mae_forward_loss_and_gradients(rates):
    ref, prog, _ = _pair(CFG)
    g = torch.Generator().manual_seed(1)
    B, T, L = 2, 4, 16
    clip = torch.randint(0, 256, (B, T, 32, 32, 3), dtype=torch.uint8, generator=g)
    mask = inputs.tube_mask(g, B, T, L, 0.9)
    r = ref.drop_rates() if rates == "published" else [[0.0, 0.5], [0.5, 0.5], [0.5] * 6]
    keeps = inputs.keep_factors(g, r, B * T)
    ref.train()
    prog.train()
    pred_r, x = ref(clip, mask, keeps)
    loss_r = RT.masked_norm_pix_mse(pred_r, x, mask, 8)
    step = make_pixel_mae_step(prog, mask_ratio=0.9)
    params = list(prog.parameters())
    state = create_train_state(prog, make_optimizer(params, 0.0))
    _, metrics = step(state, {"clip": clip}, g, mask=mask, drop=keeps)
    assert abs(float(metrics["loss"]) - float(loss_r)) <= 1e-5 * float(loss_r)
    grads_r = torch.autograd.grad(loss_r, list(ref.parameters()))
    # the port's gradient of the same loss, before its (lr 0) update
    prog2 = copy.deepcopy(prog)
    pred_p = prog2(normalize_clip(clip), mask, keeps)
    from ssl_vit_video_analytics_tpu_torch.train.losses import mae_loss_l2
    from ssl_vit_video_analytics_tpu_torch.ops.patchify import patchify
    loss_p = mae_loss_l2(pred_p, patchify(normalize_clip(clip), 8), mask.reshape(B, -1))
    grads_p = torch.autograd.grad(loss_p, list(prog2.parameters()))
    scale = max(float(g.norm()) for g in grads_r)
    for gr, gp in zip(grads_r, grads_p):
        # fp32 on both sides: the sums' order alone differs
        assert float((gr - gp).norm()) <= 1e-3 * float(gr.norm()) + 1e-6 * scale


def test_training_trajectory_matches_the_port():
    """Three updates of two micro-steps each: the reference's AdamW, running
    mean and schedule against the port's optimizer stack."""
    ref, prog, sd = _pair(CFG, seed=4)
    spe = 5
    tr = CFG["training"]
    sched = warmup_cosine_schedule(tr["lr"], 0, tr["epochs"] * spe, tr["min_lr"])
    tx = wrap_accum_and_skip(make_optimizer(prog.parameters(), sched, weight_decay=0.05), 2)
    state = create_train_state(prog, tx)
    step = make_pixel_mae_step(prog, mask_ratio=0.9)
    trainer = RT.Trainer(ref, CFG, spe)
    g = torch.Generator().manual_seed(2)
    for _ in range(6):
        clip = torch.randint(0, 256, (2, 4, 32, 32, 3), dtype=torch.uint8, generator=g)
        mask = inputs.tube_mask(g, 2, 4, 16, 0.9)
        keeps = inputs.keep_factors(g, ref.drop_rates(), 8)
        state, metrics = step(state, {"clip": clip}, g, mask=mask, drop=keeps)
        loss_r = trainer.step(clip, mask, keeps)
        assert abs(float(metrics["loss"]) - loss_r) <= 1e-4 * loss_r
    names = [n for n, _ in prog.named_parameters()]
    moving = yardstick.moving_elements(dict(zip(names, trainer.first_grad)))
    d_p = {n: (p.detach() - sd[n])[moving[n]] for n, p in prog.named_parameters() if n in moving}
    d_r = {n: (q.detach() - sd[n])[moving[n]] for n, q in ref.named_parameters() if n in moving}
    assert len(moving) > 0.7 * len(names)
    assert all(float(d.norm()) > 0 for d in d_r.values())
    assert yardstick.norm_gap(d_p, d_r)[0] <= 1e-2


@pytest.mark.parametrize("threshold", [0.05, 0.2, 1.1])
def test_streaming_early_exit_matches_the_port(threshold):
    cfg = {"model": {"embed_dim": 32}, "dataset": {"num_classes": 7}}
    with torch.device("meta"):
        template = RM.Classifier(cfg)
    sd = inputs.make_weights(template, 5, "cpu")
    ref = RM.Classifier(cfg)
    ref.load_state_dict(sd)
    prog = eng.build_model(7, 32, torch.float32)
    prog.load_state_dict(sd)
    prog.eval()
    clips = torch.randint(0, 256, (5, 8, 32, 32, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        lp, st = streaming_early_exit(prog.frame_embedding, prog.classify_embedding,
                                      normalize_clip(clips), threshold, min_frames=2,
                                      max_frames=6)
    lr, used = RM.early_exit(ref, clips, threshold, 2, 6)
    assert torch.equal(st.used_frames.long(), used.long())
    assert torch.allclose(lp, lr, atol=1e-5)
    if threshold > 1:
        assert (used == 6).all()
