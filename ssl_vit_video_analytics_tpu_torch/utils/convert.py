"""Weights carried from the JAX package into the port.

:func:`classifier_state_dict_from_flax` takes a JAX ``VideoClassifier``'s
``{"params", "batch_stats"}`` (nested dicts of numpy arrays) and returns the
port's ``state_dict``; :func:`state_dict_from_flax` does the same for any
ported module, given the port module's own ``state_dict`` as a template. The layout rules are the inverse of
``tools/import_torch_checkpoint.py``:

- conv kernel ``[kh, kw, I/g, O]`` -> weight ``[O, I/g, kh, kw]``
- Dense kernel ``[I, O]`` -> Linear weight ``[O, I]``
- BatchNorm ``scale/bias`` -> ``weight/bias``, ``mean/var`` ->
  ``running_mean/running_var``; LayerNorm ``scale/bias`` -> ``weight/bias``
- raw parameters (``temporal_pos_embed``, ``spatial_pos_embed``,
  ``mask_token``, ``pos``) and a ``MoeMlp_0``'s expert bank (``w1 [E, D,
  H]``, ``b1``, ``w2 [E, H, D]``, ``b2``) keep their name and shape; its
  ``router`` is a Dense

:func:`attacker_state_dict_from_flax` does it for the privacy layer's
``FeatureAttacker``, :func:`mae_state_dict_from_flax` for a pipeline-B
``TinyVideoMAE``,
:func:`token_mae_state_dict_from_flax` for a pipeline-C ``TinyViTMAE``,
:func:`temporal_state_dict_from_flax` for pipeline A's ``TemporalSSL``,
and :func:`encoder_state_dict_from_flax` for an encoder-only pretraining
checkpoint (``{"params": {"encoder": ...}, "batch_stats": {"encoder":
...}}``), whose tensors come out as ``encoder.*``, the keys of the port's own
pretraining checkpoint.

Every flax leaf must land on a port tensor of the same shape and every port
tensor must be filled, or the converter raises. An ``.npz`` of flax leaves
keyed by their path (``params/backbone/stem/Conv_0/kernel``) round-trips
through :func:`flatten_variables` / :func:`unflatten_variables`.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# flax auto-names -> the port's module names
_FIXED_NAMES = {
    "Conv_0": "conv", "BatchNorm_0": "bn",
    "LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
    "MultiHeadAttention_0": "attn", "Mlp_0": "mlp", "MoeMlp_0": "mlp",
    "Dense_0": "fc1", "Dense_1": "fc2", "SELayer_0": "se",
}
# numbered flax names -> the port's ModuleLists
_NUMBERED = (("tblock", "tblocks"), ("mbconv", "mbconvs"), ("block", "blocks"),
             ("stage", "stages"))
# the ConvBNAct_i of a module, by how many it has
_INVERTED_RESIDUAL = ("expand", "dw", "project")  # also TinyViT's MBConv
_MOBILEVIT_BLOCK = ("local_conv", "local_proj", "fuse_proj", "fuse_conv")
_PATCH_EMBED = ("conv1", "conv2")
_RAW_PARAMS = ("temporal_pos_embed", "spatial_pos_embed", "mask_token", "pos")
# a MoeMlp's expert bank: the flax layout is the port's
_MOE_BANK = ("w1", "b1", "w2", "b2")


def _module_name(name: str, siblings: Mapping) -> str:
    if name in _FIXED_NAMES:
        return _FIXED_NAMES[name]
    for flax_prefix, port_list in _NUMBERED:
        m = re.fullmatch(flax_prefix + r"(\d+)", name)
        if m:
            return f"{port_list}.{m.group(1)}"
    m = re.fullmatch(r"ConvBNAct_(\d+)", name)
    if m:
        # a MobileViT block has four ConvBNActs, an inverted residual and an
        # MBConv three, TinyViT's patch embedding two
        names = (_MOBILEVIT_BLOCK if "ConvBNAct_3" in siblings
                 else _INVERTED_RESIDUAL if "ConvBNAct_2" in siblings else _PATCH_EMBED)
        return names[int(m.group(1))]
    return name


def _convert_leaf(collection: str, name: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if collection == "batch_stats":
        return {"mean": "running_mean", "var": "running_var"}[name], arr
    if name in _RAW_PARAMS or name in _MOE_BANK:
        return name, arr
    if name == "kernel" and arr.ndim == 4:
        return "weight", arr.transpose(3, 2, 0, 1)
    if name == "kernel" and arr.ndim == 2:
        return "weight", arr.T
    if name == "scale":
        return "weight", arr
    if name == "bias":
        return "bias", arr
    raise KeyError(name)


def state_dict_from_flax(variables: Mapping, template: Mapping[str, torch.Tensor]
                         ) -> dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` of a module -> the ``state_dict`` of
    its port counterpart, whose own ``state_dict`` is ``template``."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, flax_path: tuple, torch_path: tuple, collection: str):
        for name, sub in tree.items():
            if isinstance(sub, Mapping):
                walk(sub, flax_path + (name,), torch_path + (_module_name(name, tree),),
                     collection)
                continue
            where = "/".join((collection,) + flax_path + (name,))
            try:
                leaf, value = _convert_leaf(collection, name, np.asarray(sub))
            except KeyError:
                raise KeyError(f"flax leaf {where} has no rule in the converter") from None
            key = ".".join(torch_path + (leaf,))
            if key not in template:
                raise KeyError(f"flax leaf {where} -> {key}: no such port tensor")
            if key in out:
                raise KeyError(f"flax leaf {where} -> {key}: filled twice")
            if tuple(template[key].shape) != value.shape:
                raise ValueError(f"flax leaf {where} {value.shape} -> {key} "
                                 f"{tuple(template[key].shape)}: shape mismatch")
            out[key] = torch.from_numpy(np.array(value)).to(template[key].dtype)

    walk(variables["params"], (), (), "params")
    walk(variables.get("batch_stats") or {}, (), (), "batch_stats")
    for key, t in template.items():
        if key.endswith("num_batches_tracked"):  # torch-only bookkeeping
            out[key] = torch.zeros_like(t)
    missing = sorted(set(template) - set(out))
    if missing:
        raise KeyError(f"port tensors not filled by the flax variables: {missing}")
    return out


def _tinyvit_template(enc: Mapping) -> torch.nn.Module:
    """A TinyViT with the widths, depths, stage count and attention widths
    (heads x head width) of the flax encoder tree ``enc``."""
    from ..models.tiny_vit import TinyViT

    n = sum(1 for name in enc if re.fullmatch(r"stage\d+", name))
    dims = [np.shape(enc["patch_embed"]["ConvBNAct_1"]["BatchNorm_0"]["scale"])[0]]
    depths, heads = [], [1]
    for i in range(n):
        stage = enc[f"stage{i}"]
        if i > 0:
            dims.append(np.shape(stage["down"]["ConvBNAct_2"]["BatchNorm_0"]["scale"])[0])
            # a head count that gives the attention width H * (dim // H) of
            # the tree (the true count or another: the shapes are the same)
            hd = np.shape(stage["tblock0"]["MultiHeadAttention_0"]["proj"]["kernel"])[0]
            heads.append(next(h for h in range(1, dims[i] + 1) if h * (dims[i] // h) == hd))
        depths.append(sum(1 for name in stage if re.fullmatch(r"(mbconv|tblock)\d+", name)))
    return TinyViT(embed_dims=dims, depths=depths, num_heads=heads,
                   use_checkpoint=False, num_stages=n)


def _backbone_template(backbone: Mapping) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of the port backbone a flax backbone tree fills:
    a TinyViT nested as ``encoder`` (``TinyViTBackbone``) or a MobileViT."""
    from ..models.mobilevit import MobileViTBackbone

    if set(backbone) == {"encoder"}:
        enc = _tinyvit_template(backbone["encoder"])
        return {f"encoder.{k}": v for k, v in enc.state_dict().items()}
    embed_dim = np.shape(backbone["head"]["BatchNorm_0"]["scale"])[0]
    return MobileViTBackbone(int(embed_dim)).state_dict()


def classifier_state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``VideoClassifier`` variables, over a MobileViT or a TinyViT
    backbone (known by ``params/backbone/encoder``), -> the port's
    ``state_dict``. Widths and depths are read off the flax tree."""
    embed_dim, num_classes = np.shape(variables["params"]["head"]["kernel"])
    template = {f"backbone.{k}": v for k, v in
                _backbone_template(variables["params"]["backbone"]).items()}
    template["head.weight"] = torch.empty(int(num_classes), int(embed_dim))
    template["head.bias"] = torch.empty(int(num_classes))
    return state_dict_from_flax(variables, template)


def attacker_state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``FeatureAttacker`` variables (``params/Dense_0``, ``Dense_1``)
    -> the port's ``state_dict``; width and class count read off the tree."""
    from ..privacy.attacker import FeatureAttacker

    dim, num_classes = np.shape(variables["params"]["Dense_1"]["kernel"])
    return state_dict_from_flax(variables,
                                FeatureAttacker(int(dim), int(num_classes)).state_dict())


def encoder_state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """An encoder-only JAX pretraining blob (``params/encoder`` and
    ``batch_stats/encoder``: a TinyViT from pipeline B, or a MobileViT from
    pipeline A) -> ``encoder.*`` tensors, the keys of the port's own encoder
    checkpoint."""
    params = variables["params"]["encoder"]
    stats = (variables.get("batch_stats") or {}).get("encoder") or {}
    if "patch_embed" in params:
        template = _tinyvit_template(params).state_dict()
    else:
        template = _backbone_template(params)
    sd = state_dict_from_flax({"params": params, "batch_stats": stats}, template)
    return {f"encoder.{k}": v for k, v in sd.items()}


def mae_state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``TinyVideoMAE`` variables -> the port's ``state_dict``.

    The widths, depths, clip length, image size and the MoE decoder's
    expert count are read off the flax tree; head counts, capacity and
    group size do not change any tensor's shape."""
    from ..models.mae import TinyVideoMAE

    params = variables["params"]
    moe = params["decoder"].get("block0", {}).get("MoeMlp_0")
    D = np.shape(params["enc_to_dec"]["kernel"])[1]
    clip_len = np.shape(params["temporal_pos_embed"])[1]
    num_patches = np.shape(params["spatial_pos_embed"])[2]
    patch = int(round((np.shape(params["decoder_pred"]["kernel"])[1] / 3) ** 0.5))
    model = TinyVideoMAE(_tinyvit_template(params["encoder"]), clip_len=int(clip_len),
                         img_size=int(round(num_patches ** 0.5)) * patch,
                         patch_size=patch, decoder_embed_dim=int(D),
                         decoder_depth=sum(1 for n in params["decoder"]
                                           if re.fullmatch(r"block\d+", n)),
                         decoder_num_heads=1,
                         decoder_moe_experts=int(np.shape(moe["w1"])[0]) if moe else 0)
    return state_dict_from_flax(variables, model.state_dict())


def _encoder_shape(blocks: Mapping) -> dict:
    """Depth, heads and MLP ratio of a flax ``TransformerEncoder`` tree: a
    head count giving the tree's attention width (the true count or
    another: the shapes are the same)."""
    names = [n for n in blocks if re.fullmatch(r"block\d+", n)]
    blk = blocks[names[0]]
    dim, hidden = np.shape(blk["Mlp_0"]["Dense_0"]["kernel"])
    hd = np.shape(blk["MultiHeadAttention_0"]["proj"]["kernel"])[0]
    heads = next(h for h in range(1, dim + 1) if h * (dim // h) == hd)
    return {"depth": len(names), "heads": heads, "mlp_ratio": hidden / dim}


def temporal_state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``TemporalSSL`` variables (pipeline A) -> the port's
    ``state_dict``. Embedding width, clip length and temporal depth are read
    off the flax tree."""
    from ..models.temporal import TemporalSSL

    params = variables["params"]
    _, clip_len, embed_dim = np.shape(params["pos"])
    shape = _encoder_shape(params["temporal"])
    model = TemporalSSL(embed_dim=int(embed_dim), layers=shape["depth"], heads=shape["heads"],
                        clip_len=int(clip_len))
    return state_dict_from_flax(variables, model.state_dict())


def token_mae_state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``TinyViTMAE`` variables (pipeline C) -> the port's
    ``state_dict``. The encoder's widths, depths and attention widths and
    the decoder's width, depth and MLP ratio are read off the flax tree."""
    from ..models.mae import TinyViTMAE

    params = variables["params"]
    dec = params["decoder"]
    shape = _encoder_shape(dec["blocks"])
    model = TinyViTMAE(_tinyvit_template(params["encoder"]),
                       decoder_dim=int(np.shape(dec["proj"]["kernel"])[1]),
                       decoder_depth=shape["depth"], decoder_num_heads=shape["heads"],
                       mlp_ratio=shape["mlp_ratio"])
    return state_dict_from_flax(variables, model.state_dict())


def flatten_variables(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts of arrays -> ``{"params/a/b/kernel": array}``."""
    flat = {}
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if isinstance(sub, Mapping):
            flat.update(flatten_variables(sub, key + "/"))
        elif sub is not None:
            flat[key] = np.asarray(sub)
    return flat


def unflatten_variables(flat: Mapping[str, np.ndarray]) -> dict:
    """Inverse of :func:`flatten_variables`."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)
    return tree
