"""The port's reconstruction pictures against the JAX package, in fp32 on
the CPU, at toy widths: pipeline B's triptych (TinyViT dims (8, 16, 24),
depths 1, heads (1, 2, 2); decoder 16 wide, 1 block, 2 heads; T=4 frames at
32x32) and pipeline C's mask grid and error heatmap (the four-stage TinyViT
at dims (8, 16, 24, 32), 3x3 pooled tokens, decoder 16 wide).

Weights are the JAX package's, converted (``mae_state_dict_from_flax``,
``token_mae_state_dict_from_flax``) after every param is moved off its init
and the BatchNorm statistics made non-trivial. Masks cannot match across
frameworks' random streams, so both sides get the same mask: pipeline B's
as an argument, pipeline C's through ``make_token_mask`` patched in each
module. matplotlib is replaced by a recorder of what each ``imshow`` draws,
and the drawn arrays are compared, not PNG bytes: orig and masked frames and
the mask grid exactly; recon pixels at most 1 grey level apart on at most 1%
of them (uint8 truncation of fp32 values that differ by ~1e-5); the error
heatmap to 1e-4 relative.

Then the entries on the port side: ``visualize_mae`` grafting an
encoder-only checkpoint (JAX's warning), reading a JAX ``.npz``, and
``train_mae``'s ``mae.vis_every`` hook, which logs a failed picture and
trains on, as JAX's does.
"""
import os
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.data.masking import get_tube_mask as jax_tube_mask
from ssl_vit_video_analytics_tpu.models.mae import TinyVideoMAE as JaxMAE
from ssl_vit_video_analytics_tpu.models.mae import TinyViTMAE as JaxTinyViTMAE
from ssl_vit_video_analytics_tpu.models.tiny_vit import TinyViT as JaxTinyViT
from ssl_vit_video_analytics_tpu.reporting import visualize as jvis
from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.entry import train_mae, visualize_mae
from ssl_vit_video_analytics_tpu_torch.models.mae import TinyVideoMAE, TinyViTMAE
from ssl_vit_video_analytics_tpu_torch.models.tiny_vit import TinyViT
from ssl_vit_video_analytics_tpu_torch.reporting import visualize as tvis
from ssl_vit_video_analytics_tpu_torch.utils.checkpoint import save_checkpoint
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    flatten_variables, mae_state_dict_from_flax, token_mae_state_dict_from_flax,
    unflatten_variables)

torch.set_num_threads(2)  # six test workers share the host

REPO = pathlib.Path(__file__).resolve().parents[1]
T, S = 4, 32
L = (S // 8) ** 2
DIMS, DEPTHS, HEADS = (8, 16, 24, 32), (1, 1, 1, 1), (1, 2, 2, 2)
POOL = 3
P = POOL ** 2


class _Axes:
    def __init__(self, images: list):
        self.images = images

    def imshow(self, img, **_):
        self.images.append(np.array(img))

    def __getattr__(self, name):
        return lambda *a, **k: None


class _Figure:
    def __getattr__(self, name):
        return lambda *a, **k: None


class RecordingPlt:
    """Stands in for matplotlib.pyplot: keeps each imshow's array."""

    def __init__(self):
        self.images = []

    def subplots(self, nrows=1, ncols=1, **_):
        axes = np.empty((nrows, ncols), dtype=object)
        for i in np.ndindex(axes.shape):
            axes[i] = _Axes(self.images)
        return _Figure(), (axes.reshape(-1) if 1 in (nrows, ncols) else axes)

    def close(self, *_):
        pass


def _perturb(v, seed):
    """Every param moved off its init, BN statistics made non-trivial."""
    rng = np.random.default_rng(seed)
    flat = flatten_variables(jax.tree.map(np.asarray, v))
    for key, a in flat.items():
        if key.endswith("/mean"):
            a = 0.3 * rng.standard_normal(a.shape)
        elif key.endswith("/var"):
            a = rng.uniform(0.5, 2.0, a.shape)
        else:
            a = a + 0.1 * rng.standard_normal(a.shape)
        flat[key] = a.astype(np.float32)
    return unflatten_variables(flat)


def _jax_encoder():
    return JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, use_checkpoint=False,
                      drop_path_rate=0.0)


def _port_encoder(stages):
    return TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS, drop_path_rate=0.0,
                   use_checkpoint=False, num_stages=stages)


@pytest.fixture(scope="module")
def pixel_mae():
    """Pipeline B: the JAX model, its variables and the port model."""
    model = JaxMAE(encoder=_jax_encoder(), clip_len=T, img_size=S, patch_size=8,
                   decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)
    v = _perturb(jax.jit(lambda k: model.init(k, jnp.zeros((1, T, S, S, 3)),
                                              jnp.zeros((1, T, L), bool)))(jax.random.key(0)), 1)
    port = TinyVideoMAE(_port_encoder(3), clip_len=T, img_size=S, decoder_embed_dim=16,
                        decoder_depth=1, decoder_num_heads=2)
    port.load_state_dict(mae_state_dict_from_flax(v))
    return model, v, port


def _clip(seed):
    return np.random.default_rng(seed).integers(0, 256, (T, S, S, 3), dtype=np.uint8)


def _assert_recon_close(got, ref):
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("norm_pix", [True, False], ids=["norm_pix", "raw_pix"])
def test_triptych_matches_jax_on_the_same_mask(pixel_mae, monkeypatch, tmp_path, norm_pix):
    model, v, port = pixel_mae
    clip = _clip(2)
    mask = np.array(jax_tube_mask(jax.random.key(3), 1, T, L, 0.75))
    jplt, tplt = RecordingPlt(), RecordingPlt()
    monkeypatch.setattr(jvis, "plt", jplt)
    monkeypatch.setattr(tvis, "plt", tplt)
    jvis.save_reconstruction_triptych(model, v, clip, mask, 8, str(tmp_path / "j.png"),
                                      jnp.float32, max_frames=T, norm_pix=norm_pix)
    port.train()  # the picture runs in eval mode and puts the mode back
    out = tvis.save_reconstruction_triptych(port, clip, torch.from_numpy(mask), 8,
                                            str(tmp_path / "t.png"), torch.float32,
                                            max_frames=T, norm_pix=norm_pix)
    assert out == str(tmp_path / "t.png") and port.training
    assert len(tplt.images) == len(jplt.images) == 3 * T
    # drawn frame by frame, rows orig, masked, recon
    for i, (got, ref) in enumerate(zip(tplt.images, jplt.images)):
        if i % 3 == 2:
            _assert_recon_close(got, ref)
        else:
            np.testing.assert_array_equal(got, ref)
    arrays = tvis.triptych_arrays(port, clip, torch.from_numpy(mask), 8, torch.float32,
                                  norm_pix=norm_pix)
    for row, arr in enumerate(arrays):
        np.testing.assert_array_equal(arr, np.stack(tplt.images[row::3]))
    # visible patches come from the input, masked ones are black in "masked"
    visible = ~np.kron(mask[0].reshape(T, S // 8, S // 8), np.ones((8, 8), bool))
    np.testing.assert_array_equal(arrays[2][visible], clip[visible])
    assert not arrays[1][~visible].any()


@pytest.fixture(scope="module")
def token_mae():
    """Pipeline C: the JAX model, its variables and the port model."""
    model = JaxTinyViTMAE(encoder=_jax_encoder(), stage4_pool=POOL, decoder_dim=16,
                          decoder_depth=1, decoder_num_heads=2)
    v = _perturb(jax.jit(lambda k: model.init(k, jnp.zeros((1, T, S, S, 3)),
                                              jnp.zeros((1, T * P), bool)))(jax.random.key(4)), 5)
    port = TinyViTMAE(_port_encoder(4), stage4_pool=POOL, decoder_dim=16, decoder_depth=1,
                      decoder_num_heads=2)
    port.load_state_dict(token_mae_state_dict_from_flax(v))
    return model, v, port


def test_mae_vis_matches_jax_on_the_same_mask(token_mae, monkeypatch, tmp_path):
    model, v, port = token_mae
    clip = _clip(6)
    mask = np.random.default_rng(7).random((1, T * P)) < 0.6
    seeds = []

    def port_mask(gen, B, T_, P_, ratio, mode, device):
        seeds.append((gen.initial_seed(), B, T_, P_, ratio, mode))
        return torch.from_numpy(mask.copy())

    monkeypatch.setattr(jvis, "make_token_mask", lambda *a: jnp.asarray(mask))
    monkeypatch.setattr(tvis, "make_token_mask", port_mask)
    jplt, tplt = RecordingPlt(), RecordingPlt()
    monkeypatch.setattr(jvis, "plt", jplt)
    monkeypatch.setattr(tvis, "plt", tplt)
    ds = types.SimpleNamespace(get_clip=lambda i: clip)
    state = types.SimpleNamespace(params=v["params"], batch_stats=v["batch_stats"])
    ref_path = jvis.save_mae_vis(model, state, ds, str(tmp_path / "j"), 3, P, 0.6, "random",
                                 jnp.float32)
    path = tvis.save_mae_vis(port, ds, str(tmp_path / "t"), 3, P, 0.6, "random", torch.float32)
    assert os.path.relpath(path, tmp_path / "t") == os.path.relpath(ref_path, tmp_path / "j") \
        == os.path.join("vis", "mae_vis_epoch_3.png")
    assert seeds == [(3, 1, T, P, 0.6, "random")]  # a generator seeded with the epoch
    (got_mask, got_err), (ref_mask, ref_err) = tplt.images, jplt.images
    np.testing.assert_array_equal(got_mask, ref_mask)
    assert got_mask.shape == (T, P) and got_mask.sum() == mask.sum()
    scale = np.abs(ref_err).max()
    assert scale > 0
    np.testing.assert_allclose(got_err / scale, ref_err / scale, atol=1e-4, rtol=1e-4)


def _pixel_cfg(split):
    return {"seed": 0, "device": {"name": "cpu", "compute_dtype": "float32"},
            "dataset": {"train_split": split, "clip_len": T, "stride": 2, "image_size": S,
                        "backend": "packed"},
            "model": {"embed_dims": [24, 48, 96, 576], "decoder_embed_dim": 16,
                      "decoder_depth": 1, "decoder_num_heads": 2, "use_checkpoint": False},
            "ssl": {"mask_ratio": 0.75, "norm_pix_loss": True}, "paths": {"split_root": ""}}


def test_visualize_mae_grafts_an_encoder_only_checkpoint(tmp_path):
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=2,
                                    num_frames=8, image_size=S, seed=0)
    cfg = _pixel_cfg(splits["train"])
    trained = visualize_mae.build_model(cfg, torch.float32)
    with torch.no_grad():
        for p in trained.parameters():
            p.add_(0.05)
    save_checkpoint(str(tmp_path / "ck"), "enc", {k: t for k, t in trained.state_dict().items()
                                                  if k.startswith("encoder.")})
    lines = []
    outs = visualize_mae.run(cfg, str(tmp_path / "ck" / "enc"), 3, str(tmp_path / "vis"),
                             "cpu", log=lines.append)
    assert visualize_mae.NO_DECODER in lines
    # 3 asked, the split's 2 clips drawn
    assert outs == [str(tmp_path / "vis" / f"recon_{i:03d}.png") for i in range(2)]
    assert all(os.path.getsize(p) > 0 for p in outs)
    model = visualize_mae.load_model(cfg, str(tmp_path / "ck" / "enc"), torch.device("cpu"),
                                     torch.float32, log=lambda m: None)
    for k, t in model.encoder.state_dict().items():
        assert torch.equal(t, trained.encoder.state_dict()[k]), k
    fresh = visualize_mae.load_model(cfg, None, torch.device("cpu"), torch.float32,
                                     log=lambda m: None)
    for k, t in model.decoder.state_dict().items():  # the seeded random decoder
        assert torch.equal(t, fresh.decoder.state_dict()[k]), k


def test_visualize_mae_reads_a_full_jax_npz(pixel_mae, tmp_path):
    _, v, port = pixel_mae
    path = tmp_path / "full.npz"
    np.savez(path, **flatten_variables(v))
    sd = visualize_mae.checkpoint_state_dict(str(path))
    assert set(sd) == set(port.state_dict())
    for k, t in port.state_dict().items():
        assert torch.equal(sd[k], t), k


def test_train_mae_draws_every_vis_every_epochs_and_survives_a_failed_picture(
        tmp_path, monkeypatch):
    monkeypatch.setattr(train_mae, "DEFAULT_EMBED_DIMS", DIMS)
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=2,
                                    num_frames=8, image_size=S, seed=0)
    cfg = {"seed": 0, "device": {"name": "cpu"},
           "dataset": {"backend": "packed", "train_split": splits["train"], "clip_len": T,
                       "stride": 2, "image_size": S},
           "model": {"use_checkpoint": False},
           "training": {"epochs": 3, "batch_size": 2, "lr": 1e-3, "warmup_epochs": 0,
                        "save_every": 5, "log_interval": 100},
           "output": {"dir": str(tmp_path / "c")},
           "mae": {"stage4_pool": 2, "mask_mode": "tube", "mask_ratio": 0.75, "vis_every": 2,
                   "loss": {"type": "l2", "normalize_target": True},
                   "decoder": {"dim": 16, "depth": 1, "num_heads": 2, "mlp_ratio": 2.0}}}
    lines = []
    assert train_mae.run(cfg, log=lines.append, resume=False)["completed"]
    assert os.listdir(tmp_path / "c" / "vis") == ["mae_vis_epoch_2.png"]
    assert not any("vis" in m and m.startswith("[WARN]") for m in lines)

    def boom(*_):
        raise RuntimeError("no picture")

    monkeypatch.setattr(tvis, "save_mae_vis", boom)
    lines = []
    out = train_mae.run(dict(cfg, output={"dir": str(tmp_path / "d")}), log=lines.append,
                        resume=False)
    assert out["completed"] and out["steps"] == 3
    assert "[WARN] vis failed: RuntimeError: no picture" in lines
    jax_entry = (REPO / "ssl_vit_video_analytics_tpu" / "entry" / "train_mae.py").read_text()
    assert 'log(f"[WARN] vis failed: {type(e).__name__}: {e}")' in jax_entry
