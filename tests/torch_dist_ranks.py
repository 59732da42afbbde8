"""Rank program of the port's multi-rank parity tests
(``tests/test_torch_port_dist_parity.py``,
``tests/test_torch_port_model_parallel.py``), and the regimes it runs.

It imports torch and the port, never JAX: spawned ranks re-import the
module that holds their code. The test process writes each regime's spec
(weights, global batch, global draws) to ``inputs.pt`` and launches one
process per rank:

    python tests/torch_dist_ranks.py DIR RANK WORLD NAME[,NAME...]

Each rank counts the collectives of its train steps by kind. Each rank
joins a gloo
group through a ``file://`` store under DIR (no
port, so parallel test workers do not collide), builds the regime's mesh
(``spec["mesh"]``, else ``{spec["axis"]: WORLD}``), cuts the model over its
model axis where it has one, runs the regime on its part of the global
batch and writes its results to ``DIR/rank{RANK}_w{WORLD}.pt``: a train
step's gradients, moments and state gathered whole (the checkpoint a mesh
writes), with what the rank itself held. The test process runs the same
functions with ``mesh=None`` on the global batch for the world-1
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
from ssl_vit_video_analytics_tpu_torch.parallel import collectives as pcoll  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.parallel.collectives import (  # noqa: E402
    all_gather, all_gather_cat, all_reduce_sum)
from ssl_vit_video_analytics_tpu_torch.parallel.shard import (  # noqa: E402
    full_state_dict, local_state_dict, optimizer_state_like, shard_model)
from ssl_vit_video_analytics_tpu_torch.parallel.sp import sp_attention_packed  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as feng  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.train import mae_engine as meng  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.train import ssl_engine as seng  # noqa: E402
from ssl_vit_video_analytics_tpu_torch.train import state as tstate  # noqa: E402

DIMS, DEPTHS, HEADS = (8, 16, 24, 32), (1, 1, 1, 1), (1, 2, 2, 2)


def _train_result(model, tx, metrics, ema=None, mesh=None) -> dict:
    """What a train step left: its metrics, the gradient Adam's first
    update saw (first moment over 1 - b1), the second moment, the new
    params, the BatchNorm statistics and, for pipeline A, the EMA. Under a
    model axis each is gathered whole, and ``held`` records the shapes of
    what this rank held of each param and of its moments."""
    opt = tstate.adamw_of(tx)
    b1 = opt.opt.param_groups[0]["betas"][0]
    by_param = {id(p): n for n, p in model.named_parameters()}
    grads, nu, held = {}, {}, {}
    for p in opt.params:
        st = opt.opt.state[p]
        name = by_param[id(p)]
        grads[name] = (st["exp_avg"] / (1 - b1)).clone()
        nu[name] = st["exp_avg_sq"].clone()
        held[name] = (tuple(p.shape), tuple(st["exp_avg"].shape), tuple(nu[name].shape))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if mesh is not None and mesh.model_axis is not None:
        grads, nu, state = (full_state_dict(model, mesh, t) for t in (grads, nu, state))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads, "nu": nu,
            "state": state, "held": held,
            "ema": None if ema is None else {k: v.clone() for k, v in ema.items()}}


def _cut(model, mesh):
    """``model`` cut over the mesh's model axis (whole on one device)."""
    if mesh is not None:
        shard_model(model, mesh)
    return model


def pixel_mae(spec: dict, mesh) -> dict:
    """Pipeline B: one step of ``make_pixel_mae_step`` (dense or MoE; over
    a ``data`` or, with the decoder's ``sp`` attention, a ``seq`` mesh)."""
    T, S = spec["clip"].shape[1], spec["clip"].shape[2]
    seq = mesh is not None and mesh.split_axis == "seq"
    pipe = mesh is not None and mesh.model_axis == "pipe"
    dec = {"decoder_embed_dim": 16, "decoder_depth": 1, "decoder_num_heads": 2,
           **spec.get("decoder", {})}
    enc = TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=spec.get("heads", HEADS),
                  drop_path_rate=0.0, use_checkpoint=True, num_stages=3)
    model = TinyVideoMAE(enc, clip_len=T, img_size=S, attn_impl="sp" if spec.get("sp") else None,
                         **dec, **spec.get("moe", {}))
    model.load_state_dict(spec["state"])
    _cut(model, mesh)
    tx = meng.wrap_accum_and_skip(tstate.make_optimizer(model.parameters(), spec["lr"]), 1)
    state = tstate.create_train_state(model, tx)
    step = meng.make_pixel_mae_step(model, mask_ratio=0.75,
                                    moe_aux_weight=spec.get("moe_aux_weight", 0.0),
                                    mesh=None if pipe else mesh, pp_mesh=mesh if pipe else None,
                                    pp_microbatches=spec.get("n_micro"))
    attention.set_sp_group(mesh.group() if seq else None)
    try:
        (state, m), calls = _counted(step, state, pmesh.shard_batch({"clip": spec["clip"]}, mesh),
                                     torch.Generator().manual_seed(0), mask=spec["mask"])
    finally:
        attention.set_sp_group(None)
    return {**_train_result(model, tx, m, mesh=mesh), "collectives": calls}


def token_mae(spec: dict, mesh) -> dict:
    """Pipeline C: one step of ``make_token_mae_step`` (tube mask, flips)."""
    enc = TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, drop_path_rate=0.0,
                  use_checkpoint=False)
    model = TinyViTMAE(enc, stage4_pool=2, decoder_dim=16, decoder_depth=1,
                       decoder_num_heads=2)
    model.load_state_dict(spec["state"])
    _cut(model, mesh)
    tx = meng.wrap_accum_and_skip(tstate.make_optimizer(model.parameters(), spec["lr"],
                                                        grad_clip=spec.get("clip_norm")), 1)
    state = tstate.create_train_state(model, tx)
    step = meng.make_token_mae_step(model, 4, mask_mode="tube", augment_hflip=True, mesh=mesh)
    (state, m), calls = _counted(step, state, pmesh.shard_batch({"clip": spec["clip"]}, mesh),
                                 torch.Generator().manual_seed(0), spec["ratio"],
                                 token_mask=spec["mask"], flip=spec["flip"])
    res = {**_train_result(model, tx, m, mesh=mesh), "collectives": calls}
    if spec.get("checkpoint"):
        res["checkpoint"] = _checkpoint_round_trip(model, tx, mesh)
    return res


def _checkpoint_round_trip(model, tx, mesh) -> dict:
    """Pipeline C's full checkpoint (model and optimizer state, as
    ``entry/train_mae`` writes it) gathered whole, and whether cutting it
    back gives this rank exactly what it held (the exact resume)."""
    sd, opt_sd = model.state_dict(), tx.state_dict()
    like = optimizer_state_like(model, tstate.adamw_of(tx).params, opt_sd)
    full = full_state_dict(model, mesh, sd)
    full_opt = full_state_dict(model, mesh, opt_sd, like)
    back = local_state_dict(model, full)
    back_opt = local_state_dict(model, full_opt, like)
    exact = (all(torch.equal(back[k], v) for k, v in sd.items())
             and all(torch.equal(back_opt[k], v) for k, v in opt_sd.items()))
    return {"model": full, "opt": full_opt, "resume_exact": exact}


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
           else sp_attention_packed(q, k, v, H, mesh.group()))
    grads = torch.autograd.grad(torch.sin(out).sum(), (q, k, v))
    res = {"out": out.detach(), **{f"d{n}": g for n, g in zip("qkv", grads)}}
    if mesh is not None:
        res = {n: all_gather_cat(x, mesh.group(), dim=1) for n, x in res.items()}
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
    r = mesh.index()
    x = spec["xs"][r].clone().requires_grad_(True)
    y = all_reduce_sum(x, mesh.group())
    z = all_gather(x[None], 0, mesh.group())
    (gy,) = torch.autograd.grad((y * spec["c"][r]).sum(), x)
    (gz,) = torch.autograd.grad((z * spec["d"][r]).sum(), x)
    return {"y": y.detach(), "z": z.detach(), "gy": gy, "gz": gz}


KINDS = {"collectives": collectives, "pixel_mae": pixel_mae, "token_mae": token_mae, "ssl": ssl_step,
         "finetune": finetune, "sp_attention": sp_attention, "fedavg": fedavg}


def run_regime(spec: dict, mesh) -> dict:
    return KINDS[spec["kind"]](spec, mesh)


COUNTED = ("all_reduce", "broadcast", "send", "recv")
COUNTS: dict = {}  # this process's collectives so far, by kind (a rank's)


def counting_collectives() -> None:
    """Count this process's collectives by kind in :data:`COUNTS`
    (``dist``'s, and the tensor all-gather and reduce-scatter that
    ``collectives`` bound at import)."""
    counts = COUNTS
    counts.update(dict.fromkeys(COUNTED + ("all_gather", "reduce_scatter"), 0))

    def counted(kind, fn):
        def call(*args, **kwargs):
            counts[kind] += 1
            return fn(*args, **kwargs)
        return call

    for kind in COUNTED:
        setattr(dist, kind, counted(kind, getattr(dist, kind)))
    pcoll._gather_into = counted("all_gather", pcoll._gather_into)
    pcoll._reduce_scatter = counted("reduce_scatter", pcoll._reduce_scatter)


def _counted(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` and the collectives it made (empty unless
    counting)."""
    before = dict(COUNTS)
    out = fn(*args, **kwargs)
    return out, {k: n - before[k] for k, n in COUNTS.items()}


def main(argv: list[str]) -> None:
    out_dir, rank, world, names = argv[0], int(argv[1]), int(argv[2]), argv[3].split(",")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
                            rank=rank, world_size=world)
    try:
        specs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
        results = {}
        counting_collectives()
        for name in names:
            spec = specs[name]
            results[name] = run_regime(spec, pmesh.make_mesh(spec.get("mesh")
                                                             or {spec["axis"]: world}))
        torch.save(results, os.path.join(out_dir, f"rank{rank}_w{world}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
