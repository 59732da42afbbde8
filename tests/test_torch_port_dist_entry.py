"""The pipeline-B entry under ``torchrun --standalone --nproc_per_node 2``
(and 4, for the MoE yaml's expert mesh) on the CPU (gloo), at toy widths,
against the same entry run in one process.

The two ranks split each batch of 2 clips; rank 0 alone writes the log and
the checkpoint. The checkpoint must equal the one-process run's: its
BatchNorm statistics (the global batch's, which a rank's own statistics
would miss by far more) and its params at 1e-4, and the logged losses to
the 4 decimals of the log. The learning rate is 1e-5: AdamW's first steps
move every element by about the learning rate whatever the size of its
gradient, so an element whose gradient is zero in exact arithmetic (a
BatchNorm bias ahead of another BatchNorm) moves by the sign of rounding
noise; at 1e-5 that stays inside the tolerance.
"""
import os
import re
import subprocess
import sys

import numpy as np
import torch
import yaml

from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae
from ssl_vit_video_analytics_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET_TOL = dict(atol=1e-4, rtol=1e-4)


def _cfg(split: str, out: str) -> dict:
    return {"seed": 0, "device": {"name": "cpu", "compute_dtype": "float32"},
            "dataset": {"train_split": split, "clip_len": 4, "stride": 2, "image_size": 32,
                        "backend": "packed"},
            "model": {"embed_dims": [24, 48, 96, 576], "decoder_embed_dim": 16,
                      "decoder_depth": 1, "decoder_num_heads": 2},
            "ssl": {"mask_ratio": 0.9, "norm_pix_loss": True},
            "training": {"epochs": 1, "batch_size": 2, "lr": 1e-5, "warmup_epochs": 0,
                         "save_dir": os.path.join(out, "ckpt"), "log_interval": 1},
            "paths": {"log_dir": os.path.join(out, "logs"), "split_root": ""}}


def _losses(lines):
    return [re.search(r" loss=(\S+) ", ln).group(1) for ln in lines
            if ln.startswith("[INFO] ep=")]


def test_torchrun_two_ranks_checkpoint_equals_one_process(tmp_path):
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=4,
                                    num_frames=12, image_size=32, seed=0)
    cfg2 = _cfg(splits["train"], str(tmp_path / "w2"))
    with open(tmp_path / "w2.yaml", "w") as f:
        yaml.safe_dump(cfg2, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae",
         "--config", str(tmp_path / "w2.yaml"), "--base", "", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]

    lines = []
    out = train_ssl_mae.run(_cfg(splits["train"], str(tmp_path / "w1")), log=lines.append)
    assert out["steps"] >= 2

    # rank 0 alone wrote the log; it names the mesh
    assert os.listdir(tmp_path / "w2" / "logs") == ["train_ssl_mae.log"]
    with open(tmp_path / "w2" / "logs" / "train_ssl_mae.log") as f:
        logged = [ln.split("] ", 1)[1].rstrip("\n") for ln in f]
    assert "[INFO] data-parallel over 2 devices: Mesh('data': 2)" in logged
    assert _losses(logged) == _losses(lines) and len(_losses(lines)) == out["steps"]

    want = torch.load(tmp_path / "w1" / "ckpt" / "ckpt_epoch_1.pt", weights_only=True)
    got = torch.load(tmp_path / "w2" / "ckpt" / "ckpt_epoch_1.pt", weights_only=True)
    assert set(got) == set(want) and all(k.startswith("encoder.") for k in got)
    for key, t in want.items():
        np.testing.assert_allclose(got[key].numpy(), t.numpy(), err_msg=key, **NET_TOL)
    # BatchNorm statistics over one rank's clip would differ: the global
    # batch's are held, not reproduced by chance
    assert any(k.endswith("running_var") for k in want)


def test_entry_builds_the_expert_mesh_of_ssl_mae_moe(tmp_path):
    """configs/ssl_mae_moe.yaml with its device section as shipped
    (expert_parallel: 4, data_parallel: auto) under ``torchrun
    --nproc_per_node 4`` on gloo: JAX's {data: 1, expert: 4} mesh and its
    log lines, each rank holding 2 of the 8 experts, and a full checkpoint
    (``training.save_full``: the experts gathered whole) equal to one
    process's. Widths, clip and batch are cut to toy sizes through --set;
    the MoE group is one clip's 64 tokens."""
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=4,
                                    num_frames=12, image_size=32, seed=0)

    def overrides(out):
        return [f"dataset.train_split={splits['train']}", "dataset.clip_len=4",
                "dataset.stride=2", "dataset.image_size=32", "training.batch_size=2",
                "training.epochs=1", "training.accumulation_steps=1", "training.lr=0.00001",
                "training.warmup_epochs=0", "training.log_interval=1", "training.save_full=true",
                f"training.save_dir={out}/ckpt", f"paths.log_dir={out}/logs",
                "paths.split_root=", "device.compute_dtype=float32", "seed=0",
                "model.embed_dims=[24,48,96,576]", "model.decoder_embed_dim=16",
                "model.decoder_depth=1", "model.decoder_num_heads=2",
                "model.decoder_moe_group_size=64"]

    moe_yaml = os.path.join(REPO, "configs", "ssl_mae_moe.yaml")
    args = ["--config", moe_yaml, "--device", "cpu"]
    for o in overrides(tmp_path / "w4"):
        args += ["--set", o]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4",
         "-m", "ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]

    cfg = load_config(moe_yaml, base=os.path.join(REPO, "configs", "base.yaml"),
                      overrides=overrides(tmp_path / "w1"))
    assert cfg["device"]["expert_parallel"] == 4
    lines = []
    out = train_ssl_mae.run(cfg, log=lines.append, device="cpu")
    assert out["steps"] >= 2
    assert "[WARN] expert_parallel requested on 1 device; ignoring" in lines

    with open(tmp_path / "w4" / "logs" / "train_ssl_mae.log") as f:
        logged = [ln.split("] ", 1)[1].rstrip("\n") for ln in f]
    assert ("[INFO] expert-parallel MoE decoder: 8 experts over 4 devices: "
            "Mesh('data': 1, 'expert': 4)") in logged
    ep_lines = [ln for ln in logged if ln.startswith("[INFO] EP: ")]
    assert len(ep_lines) == 1 and ep_lines[0].startswith("[INFO] EP: 4/")
    assert _losses(logged) == _losses(lines) and len(_losses(lines)) == out["steps"]

    for name in ("ckpt_epoch_1.pt", "ckpt_full_epoch_1.pt"):
        want = torch.load(tmp_path / "w1" / "ckpt" / name, weights_only=True)
        got = torch.load(tmp_path / "w4" / "ckpt" / name, weights_only=True)
        assert set(got) == set(want), name
        for key, t in want.items():
            assert got[key].shape == t.shape, key
            np.testing.assert_allclose(got[key].numpy(), t.numpy(), err_msg=key, **NET_TOL)
    assert got["decoder.blocks.0.mlp.w1"].shape[0] == 8
