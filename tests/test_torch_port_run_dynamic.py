"""The slice end to end: ``run_dynamic.run`` of the JAX package and of the
port (on the CPU) over the same synthetic val split, with the same weights
(the JAX init, handed to the port as an ``.npz`` of flax leaves). The CSV
rows must agree exactly in every non-latency column, as formatted strings.
Frame gating scores by motion: the ``random`` scores come from two different
RNGs.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.entry import run_dynamic as jax_run_dynamic
from ssl_vit_video_analytics_tpu.train import finetune_engine as jeng
from ssl_vit_video_analytics_tpu.utils.io import read_csv_dicts
from ssl_vit_video_analytics_tpu_torch.entry import run_dynamic
from ssl_vit_video_analytics_tpu_torch.utils.checkpoint import read_checkpoint
from ssl_vit_video_analytics_tpu_torch.utils.convert import flatten_variables

torch.set_num_threads(2)  # six test workers share the host

LATENCY = {"avg_latency_ms", "throughput_fps", "throughput_clips_per_s"}


def _cfg(synth_data, tmp_path):
    # tests/test_privacy_entry.py's config, plus the dynamic section
    return {
        "seed": 42,
        "device": {"compute_dtype": "float32"},
        "dataset": {"backend": "packed", "split": synth_data["val"],
                    "num_classes": 4, "clip_len": 4, "stride": 2, "image_size": 32},
        "model": {"embed_dim": 32, "finetune_ckpt": None},
        "runtime": {"batch_size": 4, "num_warmup": 0, "num_measure": 1},
        "paths": {"log_dir": str(tmp_path / "logs"), "split_root": ""},
        "output": {"save_dir": str(tmp_path / "out"), "save_csv": True},
        "dynamic": {"mode": "early_exit",
                    "confidence_thresholds": [0.26, 0.3, 0.34, 0.5],
                    "min_frames": 2, "max_frames": 4, "frame_step": 1,
                    "gating_topk_list": [3], "gating_score": "motion"},
    }


@pytest.fixture(scope="module")
def jax_weights_npz(tmp_path_factory):
    """The weights the JAX entry draws (init_model with key 0 at its clip
    shape), as the port's .npz checkpoint."""
    model = jeng.build_model(4, 32)
    v = jeng.init_model(model, jax.random.key(0), (4, 4, 32, 32, 3))
    path = tmp_path_factory.mktemp("ckpt") / "classifier.npz"
    np.savez(path, **flatten_variables(jax.tree.map(np.asarray, v)))
    return str(path)


def _port_cfg(cfg, npz, tmp_path, **dynamic):
    out = copy.deepcopy(cfg)
    out["model"]["finetune_ckpt"] = npz
    out["output"]["save_dir"] = str(tmp_path / "port_out")
    out["dynamic"].update(dynamic)
    return out


def _strip_latency(rows):
    return [{k: v for k, v in r.items() if k not in LATENCY} for r in rows]


@pytest.mark.parametrize("mode", ["early_exit", "frame_gating", "hybrid"])
def test_port_rows_match_jax(synth_data, tmp_path, jax_weights_npz, mode):
    cfg = _cfg(synth_data, tmp_path)
    ref = jax_run_dynamic.run(cfg, mode=mode, log=lambda *_: None)
    logs = []
    impls = ("streaming", "batched") if mode != "frame_gating" else ("auto",)
    for impl in impls:
        out = run_dynamic.run(_port_cfg(cfg, jax_weights_npz, tmp_path,
                                        early_exit_impl=impl),
                              mode=mode, log=logs.append, device="cpu")
        rows = read_csv_dicts(out["csv"])
        assert rows == out["rows"]
        assert list(rows[0]) == list(read_csv_dicts(ref["csv"])[0])
        assert _strip_latency(rows) == _strip_latency(ref["rows"]), impl
        assert all(float(r["avg_latency_ms"]) > 0 for r in rows)
    assert any("loaded finetune ckpt" in m for m in logs)
    if mode == "early_exit":
        frames = {r["avg_frames"] for r in ref["rows"]}
        assert len(frames) > 1, "thresholds should make early exit matter"


def test_checkpoint_formats(synth_data, tmp_path, jax_weights_npz):
    """A .pt state_dict loads like the .npz; a missing path warns and keeps
    random weights; any other existing path raises."""
    cfg = _port_cfg(_cfg(synth_data, tmp_path), jax_weights_npz, tmp_path)
    sd = read_checkpoint(jax_weights_npz)
    pt = tmp_path / "classifier.pt"
    torch.save(sd, pt)
    from_npz = run_dynamic.run(cfg, log=lambda *_: None, device="cpu")["rows"]
    cfg["model"]["finetune_ckpt"] = str(pt)
    from_pt = run_dynamic.run(cfg, log=lambda *_: None, device="cpu")["rows"]
    assert _strip_latency(from_pt) == _strip_latency(from_npz)

    logs = []
    cfg["model"]["finetune_ckpt"] = str(tmp_path / "missing.pt")
    run_dynamic.run(cfg, log=logs.append, device="cpu")
    assert any("[WARN] finetune ckpt not found" in m for m in logs)

    cfg["model"]["finetune_ckpt"] = str(tmp_path)  # a directory, e.g. orbax
    with pytest.raises(ValueError, match="orbax"):
        run_dynamic.run(cfg, log=lambda *_: None, device="cpu")
