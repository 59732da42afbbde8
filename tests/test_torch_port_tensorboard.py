"""``logging.tensorboard`` of the pipeline-B entry against the JAX entry's,
on the CPU at toy widths: a recording ``tensorboardX.SummaryWriter`` stands
in for the package in both, and both runs (3 steps, every step logged)
write the same tags at the same steps into ``training.save_dir`` and close
the writer. The values are finite, MFU 0 off a card in both. Where
``tensorboardX`` is missing, the port prints JAX's warning and trains on.
"""
import pathlib
import sys
import types

import numpy as np
import pytest

from ssl_vit_video_analytics_tpu.entry import train_ssl_mae as jentry
from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae as tentry

REPO = pathlib.Path(__file__).resolve().parents[1]
WARNING = "[WARN] tensorboardX unavailable; skipping TB logging"


class RecordingWriter:
    made: list = []

    def __init__(self, logdir):
        self.logdir, self.scalars, self.closed = logdir, [], False
        RecordingWriter.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def close(self):
        self.closed = True


@pytest.fixture
def writers(monkeypatch):
    RecordingWriter.made = []
    monkeypatch.setitem(sys.modules, "tensorboardX",
                        types.SimpleNamespace(SummaryWriter=RecordingWriter))
    return RecordingWriter.made


def _cfg(split, save_dir, name):
    return {"seed": 0, "device": {"name": "cpu", "compute_dtype": "float32",
                                  "data_parallel": False},
            "dataset": {"backend": "packed", "train_split": split, "clip_len": 4, "stride": 2,
                        "image_size": 32},
            "model": {"type": "tiny_vit_21m_variant", "embed_dims": [8, 16, 24, 32],
                      "decoder_embed_dim": 16, "decoder_depth": 1, "decoder_num_heads": 2,
                      "use_checkpoint": False},
            "ssl": {"mask_ratio": 0.9, "mask_strategy": "tube", "norm_pix_loss": True},
            "training": {"epochs": 1, "batch_size": 2, "accumulation_steps": 1, "lr": 1e-3,
                         "min_lr": 0.0, "warmup_epochs": 0, "weight_decay": 0.05,
                         "save_dir": str(save_dir / name), "save_every": 10,
                         "log_interval": 1},
            "logging": {"tensorboard": True}, "paths": {"split_root": ""}}


def test_tensorboard_tags_and_steps_match_jax(writers, tmp_path):
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=3, videos_per_class=3,
                                    num_frames=8, image_size=32, seed=0)
    jentry.run(_cfg(splits["train"], tmp_path, "jax"), log=lambda *_: None, max_steps=3)
    tentry.run(_cfg(splits["train"], tmp_path, "port"), log=lambda *_: None, max_steps=3)
    ref, got = writers
    assert (ref.logdir, got.logdir) == (str(tmp_path / "jax"), str(tmp_path / "port"))
    assert ref.closed and got.closed
    tags = [(tag, step) for tag, _, step in got.scalars]
    assert tags == [(tag, step) for tag, _, step in ref.scalars]
    assert tags == [(t, s) for s in (1, 2, 3) for t in ("Train/Loss", "Train/Throughput",
                                                        "Train/MFU")]
    for w in (ref, got):
        assert all(np.isfinite(v) for _, v, _ in w.scalars)
        assert [v for t, v, _ in w.scalars if t == "Train/MFU"] == [0.0] * 3


def test_missing_tensorboardx_warns_as_jax_and_trains_on(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # import raises ImportError
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=2,
                                    num_frames=8, image_size=32, seed=0)
    lines = []
    out = tentry.run(_cfg(splits["train"], tmp_path, "port"), log=lines.append, max_steps=1)
    assert out["steps"] == 1 and WARNING in lines
    assert f'log("{WARNING}")' in (REPO / "ssl_vit_video_analytics_tpu" / "entry" /
                                   "train_ssl_mae.py").read_text()
    lines = []
    tentry.run(dict(_cfg(splits["train"], tmp_path, "off"), logging={}), log=lines.append,
               max_steps=1)
    assert WARNING not in lines  # the default path: no writer, no warning
