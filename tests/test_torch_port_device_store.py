"""The port's device-resident split (``data/device_store.py``) on the CPU
device: its batches are bit-equal to the port's host path and to the JAX
package's stores on the same split (the expectations of
``tests/test_device_store.py``), shuffled or not, with and without the
padded tail, and across several shards of the chunked store; and the gating
of ``entry.common.maybe_device_resident``."""
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.data import device_store as jax_store
from ssl_vit_video_analytics_tpu.data.loader import ClipDataset as JaxClipDataset
from ssl_vit_video_analytics_tpu_torch.data.device_store import (ChunkedDeviceClipStore,
                                                                 DeviceClipStore)
from ssl_vit_video_analytics_tpu_torch.data.loader import ClipDataset, iterate_batches
from ssl_vit_video_analytics_tpu_torch.entry import common
from ssl_vit_video_analytics_tpu_torch.utils.io import read_csv_dicts

CPU = torch.device("cpu")
CLIP_BYTES = 4 * 32 * 32 * 3
# (shuffle, drop_last, epoch): shuffled full batches, the padded tail, both
EPOCHS = ((True, True, 1), (False, False, 2), (True, False, 3))


def _dataset(split, mode, cls=ClipDataset, seed=3):
    return cls(split, mode=mode, clip_len=4, stride=2, image_size=32, seed=seed,
               verbose=False)


def _host(ds, B, **kw):
    return list(iterate_batches(ds, B, **kw))


def _assert_equal(ref, got):
    assert len(ref) == len(got) > 0
    for rb, gb in zip(ref, got):
        assert set(rb) == set(gb)
        for k in rb:
            assert gb[k].device == CPU
            a, b = np.asarray(rb[k]), gb[k].numpy()
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("mode", ["ssl", "supervised"])
def test_device_store_matches_host_and_jax(synth_data, mode):
    ds = _dataset(synth_data["train"], mode)
    store = DeviceClipStore(ds, CPU, log=lambda *_: None)
    jstore = jax_store.DeviceClipStore(_dataset(synth_data["train"], mode, JaxClipDataset),
                                       log=lambda *_: None)
    assert len(store) == len(ds) and store.clip_len == 4 and store.image_size == 32
    for shuffle, drop_last, epoch in EPOCHS:
        kw = dict(shuffle=shuffle, seed=3, epoch=epoch, drop_last=drop_last)
        got = list(store.epoch_batches(3, **kw))
        _assert_equal(_host(ds, 3, **kw), got)
        _assert_equal([{k: np.asarray(v) for k, v in b.items()}
                       for b in jstore.epoch_batches(3, **kw)], got)


@pytest.mark.parametrize("mode", ["ssl", "supervised"])
def test_chunked_store_matches_host_and_jax_across_shards(synth_data, mode):
    ds = _dataset(synth_data["train"], mode)
    # room for two batches of 3 a shard: several shards
    store = ChunkedDeviceClipStore(ds, 6 * CLIP_BYTES, 3, CPU, log=lambda *_: None)
    jstore = jax_store.ChunkedDeviceClipStore(
        _dataset(synth_data["train"], mode, JaxClipDataset), shard_bytes=6 * CLIP_BYTES,
        batch_size=3, log=lambda *_: None)
    assert store.num_shards == jstore.num_shards >= 2
    assert store.clips_per_shard == jstore.clips_per_shard == 6
    for shuffle, drop_last, epoch in EPOCHS:
        kw = dict(shuffle=shuffle, seed=3, epoch=epoch, drop_last=drop_last)
        got = list(store.epoch_batches(3, **kw))
        _assert_equal(_host(ds, 3, **kw), got)
        _assert_equal([{k: np.asarray(v) for k, v in b.items()}
                       for b in jstore.epoch_batches(3, **kw)], got)
    with pytest.raises(ValueError, match="sized for batch_size=3"):
        next(store.epoch_batches(4, shuffle=False, seed=0, epoch=0))


def test_chunked_store_can_be_abandoned_mid_epoch(synth_data):
    """Closing the generator after its first batch stops the assembling
    thread (the first batch of an epoch, as the entries' warm-up takes it)."""
    ds = _dataset(synth_data["train"], "supervised")
    store = ChunkedDeviceClipStore(ds, 3 * CLIP_BYTES, 3, CPU, log=lambda *_: None)
    first = common.first_batch(store, 3, CPU)
    _assert_equal(_host(ds, 3, shuffle=False, seed=0, epoch=0, drop_last=False)[:1], [first])


def test_maybe_device_resident_gating(synth_data):
    ds = _dataset(synth_data["train"], "supervised", seed=0)
    quiet = dict(log=lambda *_: None)
    # auto on a CPU device: the host path
    assert common.maybe_device_resident({"dataset": {}}, ds, CPU, **quiet) is ds
    assert common.maybe_device_resident({"dataset": {"device_resident": False}}, ds, CPU,
                                        **quiet) is ds
    assert common.maybe_device_resident({"dataset": {"device_resident": "off"}}, ds, CPU,
                                        **quiet) is ds
    # true: resident on any device, and epoch_batches dispatches to the store
    store = common.maybe_device_resident({"dataset": {"device_resident": True}}, ds, CPU,
                                         **quiet)
    assert isinstance(store, DeviceClipStore)
    _assert_equal(_host(ds, 3, shuffle=False, seed=0, epoch=0, drop_last=True),
                  list(common.epoch_batches(store, 3, shuffle=False, seed=0, epoch=0,
                                            device=CPU)))
    # chunked: shard rotation sized by the training batch
    cfg = {"dataset": {"device_resident": "chunked", "resident_shard_bytes": 8 * CLIP_BYTES},
           "training": {"batch_size": 4}}
    chunked = common.maybe_device_resident(cfg, ds, CPU, **quiet)
    assert isinstance(chunked, ChunkedDeviceClipStore) and chunked.batch_size == 4
    _assert_equal(_host(ds, 4, shuffle=True, seed=0, epoch=1, drop_last=True),
                  list(common.epoch_batches(chunked, 4, shuffle=True, seed=0, epoch=1,
                                            device=CPU)))
    # below 12 GB, true keeps the whole split resident whatever max_bytes says
    small = common.maybe_device_resident({"dataset": {"device_resident": True}}, ds, CPU,
                                         max_bytes=0, **quiet)
    assert isinstance(small, DeviceClipStore)


class _Huge:
    """A split of 100 000 clips of 16 frames at 112x112 (60 GB): only its
    size is read before the chunked store is built (ssl: no labels)."""
    mode, clip_len, image_size = "ssl", 16, 112

    def __len__(self):
        return 100_000


def test_maybe_device_resident_large_splits_rotate_shards():
    logs = []
    cfg = {"dataset": {"device_resident": True}, "training": {"batch_size": 16}}
    store = common.maybe_device_resident(cfg, _Huge(), CPU, log=logs.append)
    assert isinstance(store, ChunkedDeviceClipStore) and store.batch_size == 16
    assert any("switching to chunked shard rotation" in m for m in logs)
    # auto goes resident on a CUDA device only, chunked above 4 GB (the
    # constructor allocates nothing on the device for an ssl split)
    cuda = torch.device("cuda")
    store = common.maybe_device_resident({"dataset": {}, "training": {"batch_size": 16}},
                                         _Huge(), cuda, log=logs.append)
    assert isinstance(store, ChunkedDeviceClipStore) and store.device == cuda
    assert store.clips_per_shard == 2_000_000_000 // (16 * 112 * 112 * 3) // 16 * 16


def test_run_dynamic_device_resident_matches_host(synth_data, tmp_path):
    """run_dynamic with dataset.device_resident=true: the accuracy and
    frame-usage columns of the host path (only timings may differ)."""
    from ssl_vit_video_analytics_tpu_torch.entry import run_dynamic

    def cfg(dev_res, out):
        return {"seed": 42, "device": {"compute_dtype": "float32"},
                "dataset": {"backend": "packed", "split": synth_data["val"],
                            "num_classes": 4, "clip_len": 4, "stride": 2,
                            "image_size": 32, "device_resident": dev_res},
                "model": {"embed_dim": 32, "finetune_ckpt": None},
                "runtime": {"batch_size": 4, "num_warmup": 0, "num_measure": 1},
                "paths": {"log_dir": str(tmp_path / "logs"), "split_root": ""},
                "output": {"save_dir": str(tmp_path / out), "save_csv": True},
                "dynamic": {"mode": "early_exit", "confidence_thresholds": [0.3],
                            "min_frames": 2, "max_frames": 4, "frame_step": 1}}

    logs = []
    host = read_csv_dicts(run_dynamic.run(cfg(False, "host"), mode="early_exit",
                                          log=lambda *_: None, device="cpu")["csv"])
    dev = read_csv_dicts(run_dynamic.run(cfg(True, "dev"), mode="early_exit",
                                         log=logs.append, device="cpu")["csv"])
    assert any("device-resident store" in m for m in logs)
    for col in ("top1", "top5", "avg_frames", "avg_conf"):
        assert host[0][col] == dev[0][col], col
