"""Rank program of the port's multi-rank parity tests
(``tests/test_torch_port_dist_parity.py``), and the regimes it runs.

It imports torch and the port, never JAX: spawned ranks re-import the
module that holds their code. The test process writes each regime's spec
(weights, global batch, global draws) to ``inputs.pt`` and launches one
process per rank:

    python tests/torch_dist_ranks.py DIR RANK WORLD NAME[,NAME...]

Each rank joins a gloo group through a ``file://`` store under DIR (no
port, so parallel test workers do not collide), builds the regime's mesh
over the whole world, runs the regime on its part of the global batch and
writes its results to ``DIR/rank{RANK}_w{WORLD}.pt``. The test process runs
the same functions with ``mesh=None`` on the global batch for the world-1
reference.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

if __name__ == "__main__":  # run as a script: the repo root holds the port
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssl_vit_video_analytics_tpu_torch.federated.core import (  # noqa: E402
    make_parallel_client_update, run_fedavg_round)
from ssl_vit_video_analytics_tpu_torch.models.classifier import VideoClassifier  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.models.mae import TinyVideoMAE, TinyViTMAE  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.models.temporal import TemporalSSL  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.models.tiny_vit import (  # noqa: E402
    TinyViT, TinyViTBackbone)
from ssl_vit_video_analytics_tpu_torch.ops import attention  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_packed)
from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.parallel.collectives import (  # noqa: E402
    all_gather, all_gather_cat, all_reduce_sum)
from ssl_vit_video_analytics_tpu_torch.parallel.sp import sp_attention_packed  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as feng  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.train import mae_engine as meng  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.train import ssl_engine as seng  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.train import state as tstate  # noqa: E402

DIMS, DEPTHS, HEADS = (8, 16, 24, 32), (1, 1, 1, 1), (1, 2, 2, 2)


def _train_result(model, tx, metrics, ema=None) -> dict:
    """What a train step left: its metrics, the gradient Adam's first
    update saw (first moment over 1 - b1), the second moment, the new
    params, the BatchNorm statistics and, for pipeline A, the EMA."""
    opt = tstate.adamw_of(tx)
    b1 = opt.opt.param_groups[0]["betas"][0]
    by_param = {id(p): n for n, p in model.named_parameters()}
    grads, nu = {}, {}
    for p in opt.params:
        st = opt.opt.state[p]
        grads[by_param[id(p)]] = (st["exp_avg"] / (1 - b1)).clone()
        nu[by_param[id(p)]] = st["exp_avg_sq"].clone()
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads, "nu": nu,
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "ema": None if ema is None else {k: v.clone() for k, v in ema.items()}}


def pixel_mae(spec: dict, mesh) -> dict:
    """Pipeline B: one step of ``make_pixel_mae_step`` (dense or MoE; over
    a ``data`` or, with the decoder's ``sp`` attention, a ``seq`` mesh)."""
    T, S = spec["clip"].shape[1], spec["clip"].shape[2]
    seq = mesh is not None and mesh.axis == "seq"
    enc = TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, drop_path_rate=0.0,
                  use_checkpoint=True, num_stages=3)
    model = TinyVideoMAE(enc, clip_len=T, img_size=S, decoder_embed_dim=16, decoder_depth=1,
                         decoder_num_heads=2, attn_impl="sp" if spec.get("sp") else None,
                         **spec.get("moe", {}))
    model.load_state_dict(spec["state"])
    tx = meng.wrap_accum_and_skip(tstate.make_optimizer(model.parameters(), spec["lr"]), 1)
    state = tstate.create_train_state(model, tx)
    step = meng.make_pixel_mae_step(model, mask_ratio=0.75,
                                    moe_aux_weight=spec.get("moe_aux_weight", 0.0), mesh=mesh)
    attention.set_sp_group(mesh.group if seq else None)
    try:
        state, m = step(state, pmesh.shard_batch({"clip": spec["clip"]}, mesh),
                        torch.Generator().manual_seed(0), mask=spec["mask"])
    finally:
        attention.set_sp_group(None)
    return _train_result(model, tx, m)


def token_mae(spec: dict, mesh) -> dict:
    """Pipeline C: one step of ``make_token_mae_step`` (tube mask, flips)."""
    enc = TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, drop_path_rate=0.0,
                  use_checkpoint=False)
    model = TinyViTMAE(enc, stage4_pool=2, decoder_dim=16, decoder_depth=1,
                       decoder_num_heads=2)
    model.load_state_dict(spec["state"])
    tx = meng.wrap_accum_and_skip(tstate.make_optimizer(model.parameters(), spec["lr"]), 1)
    state = tstate.create_train_state(model, tx)
    step = meng.make_token_mae_step(model, 4, mask_mode="tube", augment_hflip=True, mesh=mesh)
    state, m = step(state, pmesh.shard_batch({"clip": spec["clip"]}, mesh),
                    torch.Generator().manual_seed(0), spec["ratio"],
                    token_mask=spec["mask"], flip=spec["flip"])
    return _train_result(model, tx, m)


def ssl_step(spec: dict, mesh) -> dict:
    """Pipeline A: one step of ``make_ssl_step`` with TOP (the EMA teacher,
    VICReg, the predictor's BatchNorm)."""
    T = spec["clip"].shape[1]
    model = TemporalSSL(16, 1, 2, clip_len=T)
    model.load_state_dict(spec["state"])
    tx = tstate.make_optimizer(model.parameters(), spec["lr"], grad_clip=1.0)
    state = tstate.create_train_state(
        model, tx, ema={n: spec["ema"][n].clone() for n, _ in model.named_parameters()})
    step = seng.make_ssl_step(model, spec["cfg"], with_top=True, mesh=mesh)
    state, m = step(state, pmesh.shard_batch({"clip": spec["clip"]}, mesh),
                    torch.Generator().manual_seed(0), mask=spec["mask"],
                    top_sel=spec["top_sel"], top_labels=spec["top_labels"])
    return _train_result(model, tx, m, state.ema)


def _classifier(state: dict, classes: int) -> VideoClassifier:
    model = VideoClassifier(TinyViTBackbone(embed_dims=DIMS), classes)
    model.backbone.encoder = TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS,
                                     drop_path_rate=0.0, use_checkpoint=False, num_stages=3)
    model.load_state_dict(state)
    return model


def finetune(spec: dict, mesh) -> dict:
    """``evaluate`` over eval batches with a padded tail (the spec's
    weights), then the finetune step (ft_random; TinyViT backbone with
    BatchNorm)."""
    model = _classifier(spec["state"], spec["classes"])
    evals = [pmesh.shard_batch(b, mesh) for b in spec["eval_batches"]]
    top = feng.evaluate(feng.make_eval_step(model), evals, mesh=mesh)
    tx = feng.build_finetune_tx(spec["cfg"], "ft_random", model, False)
    state = tstate.create_train_state(model, tx)
    step = feng.make_train_step(model, mesh=mesh)
    batch = {"clip": spec["clip"], "label": spec["label"]}
    state, m = step(state, pmesh.shard_batch(batch, mesh), torch.Generator().manual_seed(0))
    return {**_train_result(model, tx, m), "eval": top}


def sp_attention(spec: dict, mesh) -> dict:
    """``sp_attention_packed`` forward and backward (``sum(sin(out))``) on
    this rank's block of the sequence; the blocks gathered in rank order.
    World 1: the single-device attention over the whole sequence."""
    q, k, v = (spec[n].clone() for n in ("q", "k", "v"))
    H = spec["heads"]
    if mesh is not None:
        q, k, v = (x[:, mesh.block(x.shape[1])].clone() for x in (q, k, v))
    for x in (q, k, v):
        x.requires_grad_(True)
    out = (flash_attention_packed(q, k, v, H) if mesh is None
           else sp_attention_packed(q, k, v, H, mesh.group))
    grads = torch.autograd.grad(torch.sin(out).sum(), (q, k, v))
    res = {"out": out.detach(), **{f"d{n}": g for n, g in zip("qkv", grads)}}
    if mesh is not None:
        res = {n: all_gather_cat(x, mesh.group, dim=1) for n, x in res.items()}
    return res


def fedavg(spec: dict, mesh) -> dict:
    """One FedAvg round of the spec's clients (MobileViT-S classifier,
    ``client`` mesh: padded, a block of clients a rank, all-reduced
    aggregate). World 1 also returns each client's state, for the JAX
    aggregate."""
    model = feng.build_model(spec["classes"], 16)
    model.load_state_dict(spec["state"])
    update = make_parallel_client_update(model, lr=1e-3, weight_decay=0.05,
                                         normalize_fn=normalize_clip)
    global_state = {k: v.clone() for k, v in spec["state"].items()}
    out = {}
    if mesh is None:
        states, losses = update(global_state, spec["batches"]["clip"], spec["batches"]["label"],
                                spec["batches"]["valid"])
        out["client_states"] = states
    agg, losses = run_fedavg_round(update, global_state, spec["batches"], spec["sizes"], mesh)
    out.update(state=agg, losses=losses)
    return out


def collectives(spec: dict, mesh) -> dict:
    """The differentiable collectives alone: rank r's ``x`` is ``xs[r]``;
    ``sum_r (all_reduce_sum(x) * c[r]).sum()`` and ``sum_r
    (all_gather(x[None], 0) * d[r]).sum()``, each rank adding its own term,
    differentiated for ``x``. Returns the forward values and the gradients
    (the sums of what every rank's term sends back)."""
    r = mesh.index
    x = spec["xs"][r].clone().requires_grad_(True)
    y = all_reduce_sum(x, mesh.group)
    z = all_gather(x[None], 0, mesh.group)
    (gy,) = torch.autograd.grad((y * spec["c"][r]).sum(), x)
    (gz,) = torch.autograd.grad((z * spec["d"][r]).sum(), x)
    return {"y": y.detach(), "z": z.detach(), "gy": gy, "gz": gz}


KINDS = {"collectives": collectives, "pixel_mae": pixel_mae, "token_mae": token_mae, "ssl": ssl_step,
         "finetune": finetune, "sp_attention": sp_attention, "fedavg": fedavg}


def run_regime(spec: dict, mesh) -> dict:
    return KINDS[spec["kind"]](spec, mesh)


def main(argv: list[str]) -> None:
    out_dir, rank, world, names = argv[0], int(argv[1]), int(argv[2]), argv[3].split(",")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
                            rank=rank, world_size=world)
    try:
        specs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
        results = {}
        for name in names:
            spec = specs[name]
            results[name] = run_regime(spec, pmesh.make_mesh({spec["axis"]: world}))
        torch.save(results, os.path.join(out_dir, f"rank{rank}_w{world}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
