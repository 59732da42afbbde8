"""Import a reference (PyTorch) checkpoint into the port (counterpart of the
JAX repo's ``tools/import_torch_checkpoint.py``).

A user of the reference repo (lzc452/SSL-VIT-VIDEO-ANALYTICS) brings
finetuned ``.pth`` state_dicts of its MobileViT-S VideoClassifier (ref:
src/train_finetune.py:19-40, src/models/mobilevit.py:118-172), or TinyViT
encoder weights (ref: src/models/tiny_vit.py:135-191). This tool maps them
key-for-key onto the flax tree the JAX package's ``VideoClassifier`` (or
``TinyViT``) has -- the JAX tool's layout rules and name map, copied below
-- and then into the port's ``state_dict`` through
``utils/convert.classifier_state_dict_from_flax`` (or
``encoder_state_dict_from_flax``), and writes a port ``.pt`` checkpoint:
a classifier for ``model.finetune_ckpt`` (``run_dynamic``, ``evaluate``,
``run_privacy``), an encoder (``encoder.*``) for ``model.pretrained_ssl``.

Layout rules:
  Conv2d  weight [O, I/g, kh, kw] -> kernel [kh, kw, I/g, O]
  Linear  weight [O, I]           -> kernel [I, O]
  BatchNorm2d weight/bias          -> scale/bias (params)
              running_mean/var     -> mean/var  (batch_stats)
  nn.MultiheadAttention in_proj_weight [3D, D] -> fused qkv kernel [D, 3D]
  (torch packs q;k;v rows, the fused qkv Dense packs q|k|v output columns
  with the SAME per-head lane order, so a plain transpose is exact)

Module-name map (torch -> flax scope), 1:1 by construction:
  backbone.stem            -> backbone/stem
  backbone.s{1,2}.{0,1}    -> backbone/s{1,2}_{0,1}
  backbone.mvit{k}.0       -> backbone/mvit{k}_ir
  backbone.mvit{k}.1       -> backbone/mvit{k}
  backbone.head.0          -> backbone/head
  classifier               -> head
Inside blocks: ConvBNAct(conv, bn) -> (Conv_0, BatchNorm_0);
InvertedResidual(pw1, dw, pw2) -> ConvBNAct_{0,1,2}; MobileViTBlock(local1,
local2, transformer.i, proj, fuse) -> (ConvBNAct_0, ConvBNAct_1, tblock{i},
ConvBNAct_2, ConvBNAct_3); TransformerBlock(norm1, attn, norm2, mlp.0,
mlp.3) -> (LayerNorm_0, MultiHeadAttention_0 qkv/proj, LayerNorm_1,
Mlp_0/Dense_{0,1}).

Known numeric nuance: the reference's GELUs are exact (erf); the port's,
like flax's, use the tanh approximation -- outputs agree to ~1e-3, which
does not move argmax classifications.

Usage:
  python -m ssl_vit_video_analytics_tpu_torch.tools.import_torch_checkpoint \\
      --torch_ckpt ref_finetune.pth --out results/imported/best
  python -m ssl_vit_video_analytics_tpu_torch.tools.import_torch_checkpoint \\
      --torch_ckpt ref_mae.pth --tinyvit --prefix encoder. --out results/imported/encoder
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..utils.checkpoint import save_checkpoint
from ..utils.convert import classifier_state_dict_from_flax, encoder_state_dict_from_flax


class _TrackedDict(dict):
    """state_dict wrapper recording which keys the converters consumed, so a
    partial import (corrupt / differently-prefixed checkpoint) is visible
    instead of silently yielding a partial params tree."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.consumed: set[str] = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)

    def __contains__(self, k):
        hit = super().__contains__(k)
        if hit:
            self.consumed.add(k)
        return hit

    def unconsumed(self) -> list[str]:
        return sorted(set(self) - self.consumed - {
            k for k in self if k.endswith("num_batches_tracked")})


def _warn_unconsumed(sd) -> None:
    if isinstance(sd, _TrackedDict):
        left = sd.unconsumed()
        if left:
            print(f"[WARN] {len(left)} state_dict keys were NOT consumed by the "
                  f"conversion (partial/unknown layout?): {left[:8]}"
                  + (" ..." if len(left) > 8 else ""))


def _put(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = np.asarray(value)


def _conv(sd, params, tkey: str, fpath: tuple[str, ...]) -> None:
    _put(params, fpath + ("kernel",), sd[tkey + ".weight"].transpose(2, 3, 1, 0))
    if tkey + ".bias" in sd:
        _put(params, fpath + ("bias",), sd[tkey + ".bias"])


def _bn(sd, params, stats, tkey: str, fpath: tuple[str, ...]) -> None:
    _put(params, fpath + ("scale",), sd[tkey + ".weight"])
    _put(params, fpath + ("bias",), sd[tkey + ".bias"])
    _put(stats, fpath + ("mean",), sd[tkey + ".running_mean"])
    _put(stats, fpath + ("var",), sd[tkey + ".running_var"])


def _convbnact(sd, params, stats, tpre: str, fpre: tuple[str, ...]) -> None:
    _conv(sd, params, tpre + ".conv", fpre + ("Conv_0",))
    _bn(sd, params, stats, tpre + ".bn", fpre + ("BatchNorm_0",))


def _ir(sd, params, stats, tpre: str, fpre: tuple[str, ...]) -> None:
    for t, f in (("pw1", "ConvBNAct_0"), ("dw", "ConvBNAct_1"),
                 ("pw2", "ConvBNAct_2")):
        _convbnact(sd, params, stats, f"{tpre}.{t}", fpre + (f,))


def _ln(sd, params, tpre: str, fpre: tuple[str, ...]) -> None:
    _put(params, fpre + ("scale",), sd[tpre + ".weight"])
    _put(params, fpre + ("bias",), sd[tpre + ".bias"])


def _linear(sd, params, tpre: str, fpre: tuple[str, ...]) -> None:
    _put(params, fpre + ("kernel",), sd[tpre + ".weight"].T)
    if tpre + ".bias" in sd:
        _put(params, fpre + ("bias",), sd[tpre + ".bias"])


def _tblock(sd, params, tpre: str, fpre: tuple[str, ...]) -> None:
    _ln(sd, params, tpre + ".norm1", fpre + ("LayerNorm_0",))
    att = fpre + ("MultiHeadAttention_0",)
    _put(params, att + ("qkv", "kernel"), sd[tpre + ".attn.in_proj_weight"].T)
    _put(params, att + ("qkv", "bias"), sd[tpre + ".attn.in_proj_bias"])
    _linear(sd, params, tpre + ".attn.out_proj", att + ("proj",))
    _ln(sd, params, tpre + ".norm2", fpre + ("LayerNorm_1",))
    _linear(sd, params, tpre + ".mlp.0", fpre + ("Mlp_0", "Dense_0"))
    _linear(sd, params, tpre + ".mlp.3", fpre + ("Mlp_0", "Dense_1"))


def _mvit_block(sd, params, stats, tpre: str, fpre: tuple[str, ...],
                depth: int = 2) -> None:
    _convbnact(sd, params, stats, tpre + ".local1", fpre + ("ConvBNAct_0",))
    _convbnact(sd, params, stats, tpre + ".local2", fpre + ("ConvBNAct_1",))
    for i in range(depth):
        _tblock(sd, params, f"{tpre}.transformer.{i}", fpre + (f"tblock{i}",))
    _convbnact(sd, params, stats, tpre + ".proj", fpre + ("ConvBNAct_2",))
    _convbnact(sd, params, stats, tpre + ".fuse", fpre + ("ConvBNAct_3",))


def convert_classifier_state_dict(sd: dict) -> dict:
    """Reference VideoClassifier state_dict (numpy-valued) ->
    {"params": ..., "batch_stats": ...}: the JAX package's VideoClassifier
    tree."""
    sd = _TrackedDict({k: np.asarray(v) for k, v in sd.items()})
    params: dict = {}
    stats: dict = {}
    bb = ("backbone",)
    _convbnact(sd, params, stats, "backbone.stem", bb + ("stem",))
    for s in (1, 2):
        for j in (0, 1):
            _ir(sd, params, stats, f"backbone.s{s}.{j}", bb + (f"s{s}_{j}",))
    for k in (1, 2, 3):
        _ir(sd, params, stats, f"backbone.mvit{k}.0", bb + (f"mvit{k}_ir",))
        _mvit_block(sd, params, stats, f"backbone.mvit{k}.1", bb + (f"mvit{k}",))
    _convbnact(sd, params, stats, "backbone.head.0", bb + ("head",))
    _linear(sd, params, "classifier", ("head",))
    _warn_unconsumed(sd)
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------- TinyViT

def _conv2dbn(sd, params, stats, tpre: str, fpre: tuple[str, ...]) -> None:
    """Reference Conv2d_BN (ref: src/models/tiny_vit.py:12-18): .c + .bn."""
    _conv(sd, params, tpre + ".c", fpre + ("Conv_0",))
    _bn(sd, params, stats, tpre + ".bn", fpre + ("BatchNorm_0",))


def _tv_mbconv(sd, params, stats, tpre: str, fpre: tuple[str, ...]) -> None:
    """Reference MBConv.conv Sequential indices (ref tiny_vit.py:36-52):
    0 expand Conv2d_BN, 2 depthwise Conv2d_BN, 4 SELayer(fc.0, fc.2),
    5 project Conv2d_BN -> ConvBNAct_{0,1,2} + SELayer_0/Dense_{0,1}."""
    _conv2dbn(sd, params, stats, tpre + ".conv.0", fpre + ("ConvBNAct_0",))
    _conv2dbn(sd, params, stats, tpre + ".conv.2", fpre + ("ConvBNAct_1",))
    _linear(sd, params, tpre + ".conv.4.fc.0", fpre + ("SELayer_0", "Dense_0"))
    _linear(sd, params, tpre + ".conv.4.fc.2", fpre + ("SELayer_0", "Dense_1"))
    _conv2dbn(sd, params, stats, tpre + ".conv.5", fpre + ("ConvBNAct_2",))


def _tv_tblock(sd, params, tpre: str, fpre: tuple[str, ...]) -> None:
    """Reference TinyViTBlock (ref tiny_vit.py:108-131): norm1/attn(qkv,
    proj)/norm2/mlp(fc1, fc2). The separate-qkv Linear packs rows
    (c, head, kd) exactly like the fused qkv Dense packs columns, so
    a transpose is exact."""
    _ln(sd, params, tpre + ".norm1", fpre + ("LayerNorm_0",))
    att = fpre + ("MultiHeadAttention_0",)
    _linear(sd, params, tpre + ".attn.qkv", att + ("qkv",))
    _linear(sd, params, tpre + ".attn.proj", att + ("proj",))
    _ln(sd, params, tpre + ".norm2", fpre + ("LayerNorm_1",))
    _linear(sd, params, tpre + ".mlp.fc1", fpre + ("Mlp_0", "Dense_0"))
    _linear(sd, params, tpre + ".mlp.fc2", fpre + ("Mlp_0", "Dense_1"))


def convert_tinyvit_state_dict(sd: dict, prefix: str = "",
                               depths=(2, 2, 6, 2)) -> dict:
    """Reference TinyViT state_dict (ref: src/models/tiny_vit.py:135-191) ->
    the JAX package's TinyViT variables. ``prefix`` strips a wrapper scope (e.g.
    "encoder." for MAE checkpoints)."""
    sd = _TrackedDict({k[len(prefix):]: np.asarray(v) for k, v in sd.items()
                       if k.startswith(prefix)})
    params: dict = {}
    stats: dict = {}
    _conv2dbn(sd, params, stats, "patch_embed.patch_embed.0",
              ("patch_embed", "ConvBNAct_0"))
    _conv2dbn(sd, params, stats, "patch_embed.patch_embed.2",
              ("patch_embed", "ConvBNAct_1"))
    for i, depth in enumerate(depths):
        stage = (f"stage{i}",)
        off = 0
        if i > 0:
            if f"stages.{i}.0.conv.0.c.weight" not in sd:
                # Legitimate for encoder checkpoints saved from
                # forward_stage3-only training (stage 3 never materialized),
                # but loud so a corrupt/differently-prefixed checkpoint
                # doesn't silently yield a partial params tree.
                print(f"[WARN] missing key 'stages.{i}.0.conv.0.c.weight' — "
                      f"stopping conversion at stage {i} "
                      "(expected only for forward_stage3-only checkpoints)")
                break
            _tv_mbconv(sd, params, stats, f"stages.{i}.0", stage + ("down",))
            off = 1
        for j in range(depth):
            tpre = f"stages.{i}.{off + j}"
            if i == 0:
                _tv_mbconv(sd, params, stats, tpre, stage + (f"mbconv{j}",))
            else:
                _tv_tblock(sd, params, tpre, stage + (f"tblock{j}",))
    _warn_unconsumed(sd)
    return {"params": params, "batch_stats": stats}


def classifier_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """Reference VideoClassifier state_dict (numpy-valued) -> the port's
    ``VideoClassifier`` state_dict."""
    return classifier_state_dict_from_flax(convert_classifier_state_dict(sd))


def tinyvit_encoder_state_dict(sd: dict, prefix: str = "",
                               depths=(2, 2, 6, 2)) -> dict[str, torch.Tensor]:
    """Reference TinyViT state_dict (blocks per stage ``depths``) ->
    ``encoder.*`` tensors, the keys of the port's own encoder checkpoint
    (``model.pretrained_ssl``)."""
    v = convert_tinyvit_state_dict(sd, prefix=prefix, depths=depths)
    return encoder_state_dict_from_flax({"params": {"encoder": v["params"]},
                                         "batch_stats": {"encoder": v["batch_stats"]}})


def load_state_dict(path: str, unsafe: bool = False) -> dict:
    """The numpy-valued state_dict in a ``.pth`` (under ``model`` or
    ``state_dict`` if it is wrapped). Plain tensor state_dicts (the
    reference's save format) load under ``weights_only=True``; full
    unpickling executes arbitrary pickled code, so it is gated behind
    ``unsafe``."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not unsafe:
            raise SystemExit(
                f"[ERROR] weights-only load failed ({e}); if you trust this "
                "checkpoint, re-run with --unsafe to allow full unpickling")
        print("[WARN] weights-only load failed; falling back to full "
              "unpickling (--unsafe)")
        blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("model", blob.get("state_dict", blob))
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def main():
    p = argparse.ArgumentParser(
        description="Convert a reference torch VideoClassifier (or TinyViT) .pth to a "
                    "port checkpoint consumable by model.finetune_ckpt "
                    "(or model.pretrained_ssl)")
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--out", required=True, help="output checkpoint path (.pt is added)")
    p.add_argument("--tinyvit", action="store_true",
                   help="a TinyViT encoder state_dict, written as encoder.* tensors")
    p.add_argument("--prefix", default="",
                   help="with --tinyvit: the wrapper scope to strip, e.g. 'encoder.'")
    p.add_argument("--unsafe", action="store_true",
                   help="allow full (arbitrary-code) unpickling if the "
                        "weights-only load fails; only for checkpoints you "
                        "trust")
    args = p.parse_args()

    sd = load_state_dict(args.torch_ckpt, args.unsafe)
    tensors = (tinyvit_encoder_state_dict(sd, args.prefix) if args.tinyvit
               else classifier_state_dict(sd))
    out_dir, name = os.path.split(args.out.rstrip("/"))
    path = save_checkpoint(out_dir or ".", name, tensors)
    n = sum(t.numel() for k, t in tensors.items() if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")))
    print(f"[INFO] wrote {path} ({n} params)")


if __name__ == "__main__":
    main()
