"""Pipeline B's opt-in regimes in the port, on the CPU: the one-device
resolution of the multi-device knobs against the JAX package's
``setup_parallelism`` (``jax.device_count`` patched to 1), the entry on
``configs/ssl_mae_moe.yaml`` and ``configs/ssl_mae_longclip.yaml`` shrunk
to toy widths (2 steps each; the MoE run with a profiler trace), the
analytic FLOP count and MFU, and the finetune entry with
``training.augment``.
"""
import json
import os

import jax
import pytest
import torch

from ssl_vit_video_analytics_tpu.entry import common as jcommon
from ssl_vit_video_analytics_tpu.utils import metrics as jmetrics
from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.entry import common, train_finetune, train_ssl_mae
from ssl_vit_video_analytics_tpu_torch.utils import metrics as tmetrics
from ssl_vit_video_analytics_tpu_torch.utils import tracing
from ssl_vit_video_analytics_tpu_torch.utils.config import load_config

torch.set_num_threads(2)  # six test workers share the host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(REPO, "configs", "base.yaml")


def _yaml(name: str) -> dict:
    return load_config(os.path.join(REPO, "configs", f"{name}.yaml"), base=BASE)


ONE_DEVICE_LINE = ("one process runs on one device; launch one process a card with "
                   "torchrun --nproc_per_node N for several")
# (config, allow_pp): both opt-in yamls as they stand, then each knob alone
# and where two of them meet
KNOB_CASES = {
    "ssl_mae_moe": (lambda: _yaml("ssl_mae_moe"), True),
    "ssl_mae_longclip": (lambda: _yaml("ssl_mae_longclip"), True),
    "ep_moe": (lambda: {"device": {"expert_parallel": 2},
                        "model": {"decoder_moe_experts": 4}}, True),
    "ep_dense": (lambda: {"device": {"expert_parallel": 2}}, True),
    "ep_pipeline_c": (lambda: {"device": {"expert_parallel": 2},
                               "model": {"decoder_moe_experts": 4}}, False),
    "ep_with_sp": (lambda: {"device": {"expert_parallel": 2},
                            "model": {"decoder_moe_experts": 4, "sequence_parallel": True}},
                   True),
    "pp": (lambda: {"device": {"pipeline_parallel": 2}}, True),
    "pp_pipeline_c": (lambda: {"device": {"pipeline_parallel": 2}}, False),
    "pp_with_tp": (lambda: {"device": {"pipeline_parallel": 2, "model_parallel": 2}}, True),
    "sp_device": (lambda: {"device": {"sequence_parallel": True}}, False),
    "tp": (lambda: {"device": {"model_parallel": 4}}, True),
    "dp_n": (lambda: {"device": {"data_parallel": 2}}, True),
    "dp_auto": (lambda: {"device": {"data_parallel": "auto"}}, True),
    "dp_off": (lambda: {"device": {"data_parallel": False}}, False),
    "none": (lambda: {}, True),
}


@pytest.mark.parametrize("case", list(KNOB_CASES))
def test_one_device_knob_resolution_matches_jax(case, monkeypatch):
    """JAX's setup_parallelism on one device sets up nothing (no mesh, no
    batch sharding, no pipeline) and warns where it ignores a knob; the
    port logs the same warnings, plus one line naming the knobs on which
    JAX is silent (model_parallel, an explicit data_parallel: N)."""
    make, allow_pp = KNOB_CASES[case]
    cfg = make()
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    jax_lines, port_lines = [], []
    par = jcommon.setup_parallelism(cfg, 8, jax_lines.append, allow_pp=allow_pp)
    assert (par.mesh, par.batch_sharding, par.pp_mesh, par.pp_microbatches) == (
        None, None, None, None)
    common.setup_parallelism(cfg, 8, port_lines.append, allow_pp=allow_pp)
    extra = [ln for ln in port_lines if ONE_DEVICE_LINE in ln]
    assert [ln for ln in port_lines if ONE_DEVICE_LINE not in ln] == jax_lines
    dev = cfg.get("device", {})
    silent = [k for k, on in (("device.model_parallel", int(dev.get("model_parallel", 1)) > 1),
                              ("device.data_parallel", case == "dp_n")) if on]
    assert len(extra) == (1 if silent else 0)
    assert all(k in extra[0] for k in silent)
    if case == "ssl_mae_moe":
        assert jax_lines == ["[WARN] expert_parallel requested on 1 device; ignoring"]
    if case == "ssl_mae_longclip":
        assert jax_lines == ["[WARN] sequence_parallel requested on 1 device; attention "
                             "falls back to the single-device kernel"]
    # the data-parallel half alone (pipeline A, finetune): JAX is silent
    dp_lines = []
    jcommon.setup_data_parallel(cfg, 8, dp_lines.append)
    common.setup_data_parallel(cfg, 8, dp_lines.append)
    assert dp_lines == ([f"[WARN] device.data_parallel=2 requested; {ONE_DEVICE_LINE}; "
                         "ignoring"] if case == "dp_n" else [])


@pytest.mark.parametrize("name", ["ssl_mae", "ssl_mae_moe", "ssl_mae_longclip"])
def test_flops_and_mfu_match_jax_on_the_pipeline_b_yamls(name):
    cfg = _yaml(name)
    kw = tmetrics.pipeline_b_model_kwargs(cfg)
    assert kw == jmetrics.pipeline_b_model_kwargs(cfg)
    d = cfg["dataset"]
    assert tmetrics.pipeline_b_flops_per_clip(d["clip_len"], d["image_size"], **kw) == \
        jmetrics.pipeline_b_flops_per_clip(d["clip_len"], d["image_size"], **kw)
    # the same count over the H100 SXM's 989 TFLOP/s bf16 where JAX divides by a v5e's
    port = tmetrics.pipeline_b_mfu(50.0, d["clip_len"], d["image_size"], **kw)
    ref = jmetrics.pipeline_b_mfu(50.0, d["clip_len"], d["image_size"], **kw)
    assert tmetrics.H100_SXM_PEAK_BF16_FLOPS == 989e12
    assert port == pytest.approx(ref * jmetrics.V5E_PEAK_BF16_FLOPS / 989e12, rel=1e-12)


# --- the entry on the two opt-in yamls, shrunk to toy widths ---

TOY = {"model": {"embed_dims": [24, 48, 96, 576], "decoder_embed_dim": 16,
                 "decoder_num_heads": 2},
       "dataset": {"image_size": 32},
       "training": {"batch_size": 1, "epochs": 1, "warmup_epochs": 0, "log_interval": 1},
       "device": {"name": "cpu"}}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """64-frame videos at 32x32: a 64-frame clip at stride 1, or 16 at 4."""
    root = tmp_path_factory.mktemp("regimes")
    return make_synthetic_dataset(str(root), num_classes=2, videos_per_class=2,
                                  num_frames=64, image_size=32, seed=0)["train"]


def _shrunk(name: str, split: str, out: str, **extra) -> dict:
    cfg = _yaml(name)
    for section, values in TOY.items():
        cfg.setdefault(section, {}).update(values)
    cfg["dataset"]["train_split"] = split
    cfg["training"]["save_dir"] = out
    cfg["paths"]["split_root"] = ""
    for section, values in extra.items():
        cfg.setdefault(section, {}).update(values)
    return cfg


def test_entry_runs_the_long_clip_yaml(split, tmp_path):
    cfg = _shrunk("ssl_mae_longclip", split, str(tmp_path / "out"))
    assert (cfg["dataset"]["clip_len"], cfg["dataset"]["stride"]) == (64, 1)
    lines, seen = [], []
    out = train_ssl_mae.run(cfg, log=lines.append, max_steps=2,
                            on_step=lambda i, st, m: seen.append(sorted(m)))
    assert out["steps"] == 2 and out["last_loss"] == out["last_loss"]
    assert ("[WARN] sequence_parallel requested on 1 device; attention falls back to the "
            "single-device kernel") in lines
    assert any(" mfu=0.000 " in ln for ln in lines)  # 0 off a card, as JAX off a TPU
    assert all("moe_aux" not in m for m in seen)


def test_entry_runs_the_moe_yaml_with_a_profiler_trace(split, tmp_path):
    # the yaml's group of 392 tokens divides 16 frames x 196 patches at
    # 112x112; at 32x32 a clip has 16 x 16 tokens
    cfg = _shrunk("ssl_mae_moe", split, str(tmp_path / "out"),
                  model={"decoder_moe_group_size": 64},
                  logging={"profile_dir": str(tmp_path / "prof")})
    assert (cfg["model"]["decoder_moe_experts"], cfg["ssl"]["moe_aux_weight"]) == (8, 0.01)
    lines, aux = [], []
    out = train_ssl_mae.run(cfg, log=lines.append, max_steps=2,
                            on_step=lambda i, st, m: aux.append(float(m["moe_aux"])))
    assert out["steps"] == 2 and len(aux) == 2
    assert all(1 / 8 <= a <= 8 for a in aux)
    assert "[WARN] expert_parallel requested on 1 device; ignoring" in lines
    step_lines = [ln for ln in lines if ln.startswith("[INFO] ep=1 step=")]
    assert len(step_lines) == 2 and all(" moe_aux=" in ln for ln in step_lines)
    assert f"[INFO] profiling first steps to {tmp_path / 'prof'}" in lines
    assert lines.count("[INFO] profiler trace written") == 1
    with open(tmp_path / "prof" / "train_ssl_mae_trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::bmm" for e in events)  # the expert bank
    # the port's spans, on while it profiled and off after
    names = {str(e.get("name")).split("(", 1)[0] for e in events}
    assert {"ssl_vit.train.step", "ssl_vit.train.update", "ssl_vit.attn.fwd",
            "ssl_vit.attn.bwd"} <= names
    assert not tracing.enabled()


def test_finetune_entry_logs_and_runs_its_augmentation(tmp_path):
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=3,
                                    num_frames=8, image_size=32, seed=1)
    cfg = {"seed": 42, "device": {"compute_dtype": "float32", "name": "cpu"},
           "dataset": {"train_split": splits["train"], "val_split": splits["val"],
                       "num_classes": 2, "clip_len": 4, "stride": 2, "image_size": 32,
                       "backend": "packed"},
           "model": {"backbone": "tinyvit", "embed_dim": 256,
                     "backbone_kwargs": {"embed_dims": [8, 16, 24, 32]}},
           "training": {"epochs": 1, "batch_size": 2, "learning_rate": 1e-3, "augment": True},
           "paths": {"save_dir": str(tmp_path / "ft"), "split_root": "",
                     "log_dir": str(tmp_path / "logs")}}
    lines = []
    out = train_finetune.run(cfg, mode="ft_random", log=lines.append)
    assert "[INFO] on-device augmentation enabled (training.augment)" in lines
    assert out["best_top1"] >= 0
