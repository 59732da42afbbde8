"""The port's privacy layers against the JAX package, in fp32 on the CPU, at
toy sizes: the device blur, the visual anonymizer (stub detector, and YuNet
where cv2 has ``FaceDetectorYN``), the privacy metrics, the feature
perturbation, the re-identification attacker, and ``entry/run_privacy.py``
on the synthetic fixture with the MobileViT-S classifier at embed 32.

Tolerances: the blur 1e-5 abs on [0, 1) images (sums of up to 31 fp32 terms
in another order); the anonymizer's uint8 output within 1 grey level (a
float a hair either side of an integer truncates to neighbours); metrics
1e-6; the perturbation's noise std and keep share within 3 standard errors
of sigma and 1 - r over 65 536 draws; the attacker's final weights 1e-5
relative L2 after 10 full-batch Adam steps from the JAX attacker's initial
weights, its top-1 equal; the feature layer's clean top-1 equal, its entropy
1e-5 and its per-dim std 1e-5 relative, from the same weights; the visual
CSV equal but for its ``seconds`` column.
"""
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.entry import run_privacy as jax_run_privacy
from ssl_vit_video_analytics_tpu.ops.preprocess import gaussian_blur_nhwc as jax_blur
from ssl_vit_video_analytics_tpu.privacy import attacker as jax_attacker
from ssl_vit_video_analytics_tpu.privacy import metrics as jax_pmetrics
from ssl_vit_video_analytics_tpu.privacy import visual as jax_visual
from ssl_vit_video_analytics_tpu.train import finetune_engine as jeng
from ssl_vit_video_analytics_tpu.utils import metrics as jax_metrics
from ssl_vit_video_analytics_tpu_torch.data import transforms
from ssl_vit_video_analytics_tpu_torch.entry import run_privacy
from ssl_vit_video_analytics_tpu_torch.ops.preprocess import gaussian_blur_nhwc
from ssl_vit_video_analytics_tpu_torch.privacy import (
    StubFaceDetector, VisualAnonymizer, boxes_to_mask, make_detector, perturb_features,
    train_attacker)
from ssl_vit_video_analytics_tpu_torch.privacy import metrics as pmetrics
from ssl_vit_video_analytics_tpu_torch.utils import metrics as tmetrics
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    attacker_state_dict_from_flax, flatten_variables)
from ssl_vit_video_analytics_tpu_torch.utils.io import read_csv_dicts

try:
    import cv2
except ImportError:
    cv2 = None

torch.set_num_threads(2)  # six test workers share the host

REPO = pathlib.Path(__file__).resolve().parents[1]
YUNET = REPO / "assets" / "yunet.onnx"


@pytest.mark.parametrize("k", [7, 31])
def test_gaussian_blur_matches_jax(k):
    """k = 31 is wider than the 17x23 image: the zero padding decides."""
    x = np.random.default_rng(k).random((2, 17, 23, 3), dtype=np.float32)
    ref = np.asarray(jax_blur(jnp.asarray(x), k))
    got = gaussian_blur_nhwc(torch.from_numpy(x), k).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # an even kernel size is made odd, as k | 1; an unbatched image blurs alike
    np.testing.assert_array_equal(gaussian_blur_nhwc(torch.from_numpy(x), k - 1).numpy(), got)
    np.testing.assert_allclose(gaussian_blur_nhwc(torch.from_numpy(x[1]), k).numpy(), got[1],
                               rtol=0, atol=1e-6)


def _frames(n=3, h=40, w=48, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("kernel", [9, 31])
@pytest.mark.parametrize("batched", [False, True])
def test_visual_anonymizer_matches_jax(batched, kernel):
    imgs = _frames()
    ours = VisualAnonymizer(StubFaceDetector(), blur_kernel=kernel, device="cpu")
    theirs = jax_visual.VisualAnonymizer(jax_visual.StubFaceDetector(), blur_kernel=kernel)
    if batched:
        (got, n_got), (ref, n_ref) = ours.apply_batch(imgs), theirs.apply_batch(imgs)
    else:
        (got, n_got), (ref, n_ref) = ours.apply(imgs[0]), theirs.apply(imgs[0])
    assert n_got == n_ref and got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    # the blur stays inside the stub's central box
    mask = boxes_to_mask(StubFaceDetector().detect(imgs[0]), 40, 48)[..., 0] > 0
    first = got[0] if batched else got
    np.testing.assert_array_equal(first[~mask], imgs[0][~mask])
    assert np.abs(first[mask].astype(int) - imgs[0][mask].astype(int)).mean() > 10


def test_anonymizer_without_faces_returns_a_copy():
    class NoFaces:
        def detect(self, img):
            return np.zeros((0, 4), dtype=int)

    img = _frames(1)[0]
    out, n = VisualAnonymizer(NoFaces(), device="cpu").apply(img)
    assert n == 0 and out is not img
    np.testing.assert_array_equal(out, img)
    assert VisualAnonymizer(NoFaces(), blur_kernel=30, device="cpu").blur_kernel == 31


def test_yunet_detects_and_the_port_blur_suppresses_it():
    """As tests/test_privacy_entry.py's YuNet test, with the port's blur: the
    synthetic face is detected before anonymization and suppressed after."""
    if cv2 is None or not hasattr(cv2, "FaceDetectorYN") or not YUNET.exists():
        pytest.skip("needs cv2.FaceDetectorYN and assets/yunet.onnx")
    from ssl_vit_video_analytics_tpu_torch.data.fixtures import _synth_face
    from ssl_vit_video_analytics_tpu_torch.privacy.visual import YuNetFaceDetector

    det = make_detector(str(YUNET))
    assert isinstance(det, YuNetFaceDetector)
    rng = np.random.default_rng(0)
    hits = suppressed = 0
    n = 4
    for _ in range(n):
        img = _synth_face(rng, 224)
        before = det.detect(img)
        if len(before) == 0:
            continue
        hits += 1
        anon, n_faces = VisualAnonymizer(det, blur_kernel=41, device="cpu").apply(img)
        assert n_faces == len(before)
        if len(det.detect(anon)) == 0:
            suppressed += 1
    assert hits >= n // 2, f"YuNet detected only {hits}/{n} synthetic faces"
    assert suppressed >= hits // 2, "blur failed to suppress re-detection"


def test_make_detector_falls_back_to_the_stub_without_weights(tmp_path):
    assert isinstance(make_detector(None), StubFaceDetector)
    assert isinstance(make_detector(str(tmp_path / "missing.onnx")), StubFaceDetector)


def _logits_labels(seed=0, n=64, c=7):
    rng = np.random.default_rng(seed)
    return (3.0 * rng.standard_normal((n, c)).astype(np.float32),
            rng.integers(0, c, n).astype(np.int32))


@pytest.mark.parametrize("metric", ["privacy_entropy", "utils_entropy", "top1", "per"])
def test_privacy_metrics_match_jax(metric):
    logits, labels = _logits_labels()
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    lj, yj = jnp.asarray(logits), jnp.asarray(labels)
    if metric == "privacy_entropy":
        got, ref = pmetrics.prediction_entropy(lt), jax_pmetrics.prediction_entropy(lj)
    elif metric == "utils_entropy":
        got, ref = float(tmetrics.prediction_entropy(lt)), float(
            jax_metrics.prediction_entropy(lj))
    elif metric == "top1":
        got, ref = pmetrics.top1_accuracy(lt, yt), jax_pmetrics.top1_accuracy(lj, yj)
        assert 0 < got < 1
    else:
        for before, after in ((0.5, 0.25), (0.0, 0.3), (1e-7, 0.2)):
            assert pmetrics.privacy_exposure_rate(before, after) == pytest.approx(
                jax_pmetrics.privacy_exposure_rate(before, after), rel=1e-6)
        return
    assert got == pytest.approx(ref, abs=1e-6)


def test_perturb_features_identity_noise_and_mask():
    z = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    assert perturb_features(g, z, 0.0, 0.0) is z
    assert perturb_features(g, z, -1.0, -0.5) is z
    n = 256 * 256
    sigma, r = 0.7, 0.3
    noise = perturb_features(torch.Generator().manual_seed(2), torch.zeros(256, 256), sigma, 0.0)
    assert abs(float(noise.std()) - sigma) <= 3 * sigma / (2 * n) ** 0.5
    assert abs(float(noise.mean())) <= 3 * sigma / n ** 0.5
    kept = perturb_features(torch.Generator().manual_seed(3), torch.ones(256, 256), 0.0, r)
    assert set(kept.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(kept.mean()) - (1 - r)) <= 3 * (r * (1 - r) / n) ** 0.5
    # the same seed gives the same draws; noise first, then the mask
    a = perturb_features(torch.Generator().manual_seed(4), z, sigma, r)
    b = perturb_features(torch.Generator().manual_seed(4), z, sigma, r)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert ((a == 0) | ((a - z).abs() > 0)).all() and (a == 0).any()


def test_train_attacker_matches_jax_from_its_initial_weights():
    rng = np.random.default_rng(5)
    N, D, C = 48, 16, 5
    emb = rng.standard_normal((N, D)).astype(np.float32)
    labels = rng.integers(0, C, N).astype(np.int32)
    key = jax.random.key(3)
    jparams, jtop1 = jax_attacker.train_attacker(key, jnp.asarray(emb), jnp.asarray(labels), C,
                                                 epochs=10, lr=1e-3, batch_size=None)
    k_init, _ = jax.random.split(key)  # as train_attacker draws its init
    init = jax_attacker.FeatureAttacker(num_classes=C).init(k_init, jnp.asarray(emb[:1]))
    model, top1 = train_attacker(torch.Generator().manual_seed(0), torch.from_numpy(emb),
                                 torch.from_numpy(labels), C, epochs=10, lr=1e-3,
                                 init_state=attacker_state_dict_from_flax(init))
    ref = attacker_state_dict_from_flax({"params": jparams})
    got = model.state_dict()
    assert set(got) == set(ref) == {"fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
    for k, v in got.items():
        rel = float((v - ref[k]).norm() / ref[k].norm())
        assert rel <= 1e-5, (k, rel)
    assert top1 == jtop1
    # it trained: the weights left their start
    start = attacker_state_dict_from_flax(init)
    assert not torch.allclose(got["fc2.weight"], start["fc2.weight"], atol=1e-4)


def test_train_attacker_minibatch_and_own_init_draw_from_the_generator():
    rng = np.random.default_rng(6)
    emb = torch.from_numpy(rng.standard_normal((30, 8)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, 30))
    runs = [train_attacker(torch.Generator().manual_seed(s), emb, labels, 3, epochs=3,
                           batch_size=8) for s in (1, 1, 2)]
    for k, v in runs[0][0].state_dict().items():
        torch.testing.assert_close(v, runs[1][0].state_dict()[k], atol=0, rtol=0)
    assert not torch.equal(runs[0][0].fc1.weight, runs[2][0].fc1.weight)
    assert float(runs[0][0].fc1.bias.detach().abs().max()) > 0  # trained from zero biases


def test_transforms_copy():
    img = np.random.default_rng(0).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    out = transforms.build_transforms(16)(img)
    assert out.shape == (16, 16, 3) and out.dtype == np.float32
    np.testing.assert_allclose(transforms.normalize(transforms.to_float(img))[0, 0],
                               (img[0, 0] / 255.0 - transforms.IMAGENET_MEAN)
                               / transforms.IMAGENET_STD, rtol=1e-6)


# --- the entry ---

B, T, S, C, EMBED = 4, 4, 32, 4, 32


def _cfg(synth_data, tmp_path, out: str, ckpt=None):
    return {
        "seed": 42,
        "device": {"compute_dtype": "float32"},
        "dataset": {"backend": "packed", "split": synth_data["train"],
                    "num_classes": C, "clip_len": T, "stride": 2, "image_size": S},
        "model": {"embed_dim": EMBED, "finetune_ckpt": ckpt},
        "runtime": {"batch_size": B},
        "paths": {"log_dir": str(tmp_path / "logs"), "split_root": ""},
        "output": {"save_dir": str(tmp_path / out)},
    }


def _face_frames(tmp_path):
    d = tmp_path / "faces" / "vid0"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(d / f"f_{i:03d}.jpg"), rng.integers(0, 255, (48, 48, 3), dtype=np.uint8))
    return str(tmp_path / "faces")


def test_visual_layer_csv_matches_jax(synth_data, tmp_path):
    if cv2 is None:
        pytest.skip("cv2 required")
    vp = {"enabled": True, "frame_root": _face_frames(tmp_path), "max_images": 4,
          "save_examples": 2, "yunet_model": None, "blur_kernel": 7}
    off = {"enabled": False}
    got = run_privacy.run({**_cfg(synth_data, tmp_path, "port"), "visual_privacy": vp,
                           "feature_privacy": off}, log=lambda *_: None, device="cpu")
    ref = jax_run_privacy.run({**_cfg(synth_data, tmp_path, "jax"), "visual_privacy": vp,
                               "feature_privacy": off}, log=lambda *_: None)
    assert run_privacy.VISUAL_FIELDS == jax_run_privacy.VISUAL_FIELDS
    rows, ref_rows = read_csv_dicts(got["visual_csv"]), read_csv_dicts(ref["visual_csv"])
    assert list(rows[0]) == list(run_privacy.VISUAL_FIELDS)
    assert [{k: v for k, v in r.items() if k != "seconds"} for r in rows] == [
        {k: v for k, v in r.items() if k != "seconds"} for r in ref_rows]
    assert rows[0]["total_frames"] == "4" and rows[0]["frames_with_face_before"] == "4"
    assert os.path.exists(os.path.join(os.path.dirname(got["visual_csv"]),
                                       "visual_privacy_examples.jpg"))


def test_feature_layer_matches_jax_from_the_same_weights(synth_data, tmp_path, monkeypatch):
    """JAX's entry on its random init (key 0); the port's on those weights
    as an ``.npz`` checkpoint. Clean top-1, entropy and per-dim std agree;
    the sigma = 0, r = 0 row's top-1 is the clean top-1."""
    fp = {"enabled": True, "noise_sigmas": [0.0, 0.5], "mask_ratios": [0.0, 0.25],
          "attacker_epochs": 2, "attacker_lr": 1e-3}
    off = {"enabled": False}
    seen = {"top1": [], "entropy": [], "z": []}

    def spy(name, fn):
        def wrapped(*args):
            out = fn(*args)
            seen[name].append(out)
            return out
        return wrapped

    monkeypatch.setattr(jax_run_privacy, "top1_accuracy",
                        spy("top1", jax_run_privacy.top1_accuracy))
    monkeypatch.setattr(jax_run_privacy, "prediction_entropy",
                        spy("entropy", jax_run_privacy.prediction_entropy))
    perturb = jax_run_privacy.perturb_features
    monkeypatch.setattr(jax_run_privacy, "perturb_features",
                        lambda key, z, s, r: seen["z"].append(np.asarray(z)) or perturb(key, z, s, r))
    jax_cfg = {**_cfg(synth_data, tmp_path, "jax"), "visual_privacy": off,
               "feature_privacy": {**fp, "noise_sigmas": [0.0], "mask_ratios": [0.0]}}
    jax_run_privacy.run(jax_cfg, log=lambda *_: None)
    ref_top1, ref_ent = seen["top1"][0], seen["entropy"][0]
    ref_std = float(np.mean(np.std(seen["z"][0], axis=0)))

    model = jeng.build_model(C, EMBED, backbone="mobilevit_s")
    variables = jeng.init_model(model, jax.random.key(0), (B, T, S, S, 3))
    ckpt = tmp_path / "finetune.npz"
    np.savez(ckpt, **flatten_variables(jax.tree.map(np.asarray, variables)))
    zs, lines = [], []
    real = run_privacy.perturb_features
    monkeypatch.setattr(run_privacy, "perturb_features",
                        lambda g, z, s, r: zs.append(z.clone()) or real(g, z, s, r))
    out = run_privacy.run({**_cfg(synth_data, tmp_path, "port", str(ckpt)),
                           "visual_privacy": off, "feature_privacy": fp},
                          log=lines.append, device="cpu")
    assert f"[INFO] loaded finetune ckpt: {ckpt}" in lines
    # the clean embeddings (what the grid perturbs) and their per-dim std
    z, ref_z = zs[0].numpy(), seen["z"][0]
    assert z.shape == ref_z.shape == (8, EMBED)
    np.testing.assert_allclose(z, ref_z, rtol=0, atol=1e-5 * np.abs(ref_z).max())
    assert float(zs[0].std(dim=0, correction=0).mean()) == pytest.approx(ref_std, rel=1e-5)
    # the CSV's rows hold 6 decimals; the sigma = 0, r = 0 row is the clean one
    rows = read_csv_dicts(out["feature_csv"])
    assert list(rows[0]) == list(run_privacy.FEATURE_FIELDS) == list(
        jax_run_privacy.FEATURE_FIELDS)
    assert [(float(r["sigma"]), float(r["mask_ratio"])) for r in rows] == [
        (0.0, 0.0), (0.0, 0.25), (0.5, 0.0), (0.5, 0.25)]
    assert float(rows[0]["top1"]) == pytest.approx(ref_top1, abs=1e-6)
    assert float(rows[0]["entropy"]) == pytest.approx(ref_ent, abs=1e-5)
    clean = next(m for m in lines if m.startswith("[INFO] Clean embeddings"))
    assert clean == (f"[INFO] Clean embeddings -> Top-1={ref_top1:.4f}, "
                     f"Entropy={float(rows[0]['entropy']):.4f}")
    assert float(rows[0]["per_vs_clean"]) == pytest.approx(
        float(rows[0]["attacker_top1"]) / max(ref_top1, 1e-6), abs=1e-5)


def test_feature_layer_per_dim_std_is_the_population_std(synth_data, tmp_path, monkeypatch):
    """The per-dim std of the port's clean embeddings, read where the grid
    starts, equals numpy's population std of those embeddings to 1e-5
    relative; attacker_repeats writes the side CSV with a row per repeat."""
    zs = []
    real = run_privacy.perturb_features
    monkeypatch.setattr(run_privacy, "perturb_features",
                        lambda g, z, s, r: zs.append(z.clone()) or real(g, z, s, r))
    lines = []
    cfg = {**_cfg(synth_data, tmp_path, "port_std"), "visual_privacy": {"enabled": False},
           "feature_privacy": {"enabled": True, "noise_sigmas": [0.1], "mask_ratios": [0.5],
                               "attacker_epochs": 1, "attacker_repeats": 2}}
    out = run_privacy.run(cfg, log=lines.append, device="cpu")
    assert any(m.startswith("[WARN] finetune ckpt not found") for m in lines)
    z = zs[0].numpy()
    assert z.shape == (8, EMBED)
    logged = float(next(m for m in lines if "per-dim std" in m).split("= ")[1].split(";")[0])
    assert logged == pytest.approx(float(np.mean(np.std(z, axis=0))), rel=1e-5, abs=5e-5)
    reps = read_csv_dicts(os.path.join(os.path.dirname(out["feature_csv"]),
                                       "feature_privacy_repeats.csv"))
    assert [r["repeat"] for r in reps] == ["0", "1"]
    assert float(read_csv_dicts(out["feature_csv"])[0]["attacker_top1"]) == pytest.approx(
        np.mean([float(r["attacker_top1"]) for r in reps]), abs=1e-6)
