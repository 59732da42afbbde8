"""The port's dataset front end (``ssl_vit_video_analytics_tpu_torch.preprocess``,
``tools/verify_dataset.py``, ``tools/env_checker.py`` and
``experiments/torch/run_full_pipeline_dataset.sh``) against the repo's JAX
scripts, as tests/test_preprocess_tools.py drives those: each CLI as a user
runs it, on one cv2-written ``.avi`` tree. The packed arrays must be equal
byte for byte, the split files equal line for line (with each run's own
frame root), and the ``verify_dataset`` reports and ``download_dataset``'s
offline exit codes the same.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "ssl_vit_video_analytics_tpu_torch"


def _write_videos(root, per_class, classes=("walk", "jump-rope")):
    """``per_class`` MJPG videos of 24 frames of 64x48 for each class."""
    rng = np.random.default_rng(0)
    for cls in classes:
        d = root / cls
        d.mkdir(parents=True)
        for v in range(per_class):
            path = str(d / f"v{v}.avi")
            w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (64, 48))
            assert w.isOpened()
            for t in range(24):
                frame = np.full((48, 64, 3), (10 * t) % 255, np.uint8)
                frame[:, : 8 * (v + 1)] = rng.integers(0, 255, 3, dtype=np.uint8)
                w.write(frame)
            w.release()
    return root


@pytest.fixture(scope="module")
def video_tree(tmp_path_factory):
    return _write_videos(tmp_path_factory.mktemp("videos"), 4)


def _jax(script, argv, cwd=REPO):
    return subprocess.run([sys.executable, os.path.join(REPO, script)] + argv,
                          capture_output=True, text=True, cwd=cwd)


def _port(module, argv, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", f"{PORT}.{module}"] + argv,
                          capture_output=True, text=True, cwd=cwd, env=env)


def _both(tmp_path, jax_script, module, argv_of):
    """Run the JAX script and the port's module, each on its own copy of the
    outputs (``argv_of(side_dir)``); both must exit alike."""
    out = {}
    for side, run in (("jax", lambda a: _jax(jax_script, a)),
                      ("port", lambda a: _port(module, a))):
        side_dir = tmp_path / side
        side_dir.mkdir(exist_ok=True)
        out[side] = (run(argv_of(side_dir)), side_dir)
    assert out["jax"][0].returncode == out["port"][0].returncode, (
        out["jax"][0].stdout + out["jax"][0].stderr, out["port"][0].stdout
        + out["port"][0].stderr)
    return out


def _lines(path, root):
    """A split file's lines with the run's own directory as ``<root>``."""
    return [line.replace(str(root), "<root>") for line in open(path).read().splitlines()]


def test_standardize_structure_matches_jax(tmp_path):
    """Class dirs renamed alike (a space and a dash, as UCF101's own names
    need normalizing; a split line cannot hold a space), the same
    class_index.txt and log."""
    videos = _write_videos(tmp_path / "videos", 1, ("walk", "Jump-Rope now"))
    runs = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        shutil.copytree(videos, root)
        argv = ["--root", str(root), "--transcode"]
        r = (_jax("preprocess/standardize_structure.py", argv) if side == "jax"
             else _port("preprocess.standardize_structure", argv))
        assert r.returncode == 0, r.stderr
        runs[side] = (r.stdout.replace(str(root), "<root>"), sorted(os.listdir(root)),
                      (root / "class_index.txt").read_text())
    assert runs["jax"] == runs["port"]
    assert "Jump_Rope_now" in runs["port"][1]
    if shutil.which("ffmpeg") is None:  # the transcode stays gated on ffmpeg
        assert "[WARN] ffmpeg not found; skipping transcode" in runs["port"][0]


def test_extract_pack_splits_verify_match_jax(video_tree, tmp_path):
    # 1. videos -> resized JPEG folders + packed arrays, equal byte for byte
    out = _both(tmp_path, "preprocess/extract_frames.py", "preprocess.extract_frames",
                lambda d: ["--video_root", str(video_tree), "--out_root", str(d / "frames"),
                           "--size", "32", "--pack", "--workers", "2"])
    assert out["port"][0].returncode == 0, out["port"][0].stderr
    jax_root, port_root = out["jax"][1] / "frames", out["port"][1] / "frames"
    assert (out["jax"][0].stdout.replace(str(jax_root), "<root>")
            == out["port"][0].stdout.replace(str(port_root), "<root>"))
    packed = sorted(p.relative_to(port_root) for p in port_root.rglob("packed_32.npy"))
    assert len(packed) == 8
    assert packed == sorted(p.relative_to(jax_root) for p in jax_root.rglob("packed_32.npy"))
    for rel in packed:
        assert (port_root / rel).read_bytes() == (jax_root / rel).read_bytes(), rel
    arr = np.load(port_root / packed[0], mmap_mode="r")
    assert arr.shape == (24, 32, 32, 3) and arr.dtype == np.uint8
    jpgs = sorted(p.relative_to(port_root) for p in port_root.rglob("*.jpg"))
    assert len(jpgs) == 8 * 24
    assert jpgs == sorted(p.relative_to(jax_root) for p in jax_root.rglob("*.jpg"))

    # 2. pack_frames on its own (the packed arrays removed first)
    for root in (jax_root, port_root):
        for p in root.rglob("packed_32.npy"):
            p.unlink()
    for script, module, root in (("preprocess/pack_frames.py", "preprocess.pack_frames",
                                  jax_root), (None, "preprocess.pack_frames", port_root)):
        argv = ["--frame_root", str(root), "--size", "32"]
        r = _jax(script, argv) if script else _port(module, argv)
        assert r.returncode == 0 and "packed 8, skipped 0" in r.stdout, r.stdout + r.stderr
    for rel in packed:
        assert (port_root / rel).read_bytes() == (jax_root / rel).read_bytes(), rel

    # 3. frame tree -> train/val/test split files and the class list
    splits = {}
    for side, root in (("jax", jax_root), ("port", port_root)):
        argv = ["--frame_root", str(root), "--out_dir", str(root.parent / "splits"),
                "--prefix", "SYN", "--ratios", "0.5", "0.25", "0.25"]
        r = (_jax("preprocess/generate_splits_lazy.py", argv) if side == "jax"
             else _port("preprocess.generate_splits_lazy", argv))
        assert r.returncode == 0, r.stderr
        names = ("train", "val", "test", "classes")
        splits[side] = {n: _lines(root.parent / "splits" / f"SYN_{n}.txt", root)
                        for n in names}
        splits[side]["log"] = r.stdout.replace(str(root.parent), "<dir>")
    assert splits["jax"] == splits["port"]
    assert sum(len(splits["port"][n]) for n in ("train", "val", "test")) == 8

    # 4. the mixed SSL list over both frame roots' classes
    mixed = {}
    for side, root in (("jax", jax_root), ("port", port_root)):
        argv = ["--roots", str(root / "walk"), str(root / "jump-rope"),
                "--out", str(root.parent / "mixed.txt"), "--seed", "3"]
        r = (_jax("preprocess/generate_mixed_list.py", argv) if side == "jax"
             else _port("preprocess.generate_mixed_list", argv))
        assert r.returncode == 0, r.stderr
        mixed[side] = _lines(root.parent / "mixed.txt", root)
    assert mixed["jax"] == mixed["port"] and len(mixed["port"]) == 8

    # 5. verify_dataset: the same report and exit code where every entry
    # passes, and where every entry falls short (--min_frames 30 > 24): rc 1
    # with --dry_run, and --clean, which leaves empty splits, fails alike
    for argv_tail in (["--min_frames", "8"], ["--min_frames", "30", "--dry_run"],
                      ["--min_frames", "30", "--clean"]):
        reports = {}
        for side, root in (("jax", jax_root), ("port", port_root)):
            files = [str(root.parent / "splits" / f"SYN_{n}.txt")
                     for n in ("train", "val", "test")]
            argv = ["--splits", *files, "--image_size", "32", *argv_tail]
            r = (_jax("verify_dataset.py", argv) if side == "jax"
                 else _port("tools.verify_dataset", argv))
            reports[side] = (r.returncode, r.stdout.replace(str(root.parent), "<dir>"))
        assert reports["jax"] == reports["port"], argv_tail
        assert reports["port"][0] == (0 if argv_tail[1] == "8" else 1), argv_tail


def test_download_dataset_offline_paths_match_jax(tmp_path):
    """--list, the manual-path message with rc 1, --synthetic-fallback and an
    extracted tree that short-circuits: the JAX script's exit codes and
    lines, and equal synthetic trees."""
    runs = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side / "data")
        run = ((lambda a: _jax("preprocess/download_dataset.py", a)) if side == "jax"
               else (lambda a: _port("preprocess.download_dataset", a)))
        steps = [["--list"], ["--dataset", "UCF101_frames", "--root", root],
                 ["--dataset", "UCF101_frames", "--root", root, "--synthetic-fallback"],
                 ["--dataset", "UCF101_frames", "--root", root],
                 ["--dataset", "nope", "--root", root]]
        runs[side] = [(r.returncode, r.stdout.replace(root, "<root>"))
                      for r in map(run, steps)]
    assert [rc for rc, _ in runs["port"]] == [0, 1, 0, 0, 2]
    assert runs["jax"] == runs["port"]
    assert "Manual path" in runs["port"][1][1] and "drive.google.com" in runs["port"][1][1]
    assert "already extracted" in runs["port"][3][1]
    jax_tree = tmp_path / "jax" / "data" / "UCF101_frames"
    port_tree = tmp_path / "port" / "data" / "UCF101_frames"
    files = sorted(p.relative_to(port_tree) for p in port_tree.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(jax_tree) for p in jax_tree.rglob("*")
                                     if p.is_file())
    for rel in files:
        if rel.suffix == ".txt":
            assert (_lines(port_tree / rel, port_tree) == _lines(jax_tree / rel, jax_tree)), rel
        else:
            assert (port_tree / rel).read_bytes() == (jax_tree / rel).read_bytes(), rel


def test_runner_prepares_a_dataset_without_jax(tmp_path):
    """experiments/torch/run_full_pipeline_dataset.sh with jax made
    unimportable: standardize, extract + pack, splits (7 videos a class, so
    that the 15% val split holds one), verify; the packed store then feeds
    the port's loader."""
    videos = _write_videos(tmp_path / "videos", 7, ("walk", "Jump-Rope now"))
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "jax.py").write_text("raise ImportError('jax is not installed here')\n")
    env = dict(os.environ, PYTHONPATH=f"{blocker}{os.pathsep}{REPO}")
    r = subprocess.run(["bash", os.path.join(REPO, "experiments/torch/run_full_pipeline_dataset.sh"),
                        str(videos), str(tmp_path / "frames"), "SYN", "32"],
                       capture_output=True, text=True, cwd=tmp_path, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[INFO] Dataset pipeline finished" in r.stdout
    assert "all splits verified clean" in r.stdout
    assert len(list((tmp_path / "frames").rglob("packed_32.npy"))) == 14

    from ssl_vit_video_analytics_tpu_torch.data.loader import ClipDataset

    ds = ClipDataset(str(tmp_path / "data" / "splits" / "SYN_train.txt"), mode="supervised",
                     clip_len=4, stride=2, image_size=32, verbose=False)
    clip = ds.get_clip(0)
    assert clip.shape == (4, 32, 32, 3) and clip.dtype == np.uint8 and clip.max() > 0


def test_env_checker_reports_the_card_side(tmp_path):
    """torch, CUDA, nvcc, cv2 and the kernel build directory in place of
    jax and the TPU; the report lands in logs/env_report.txt."""
    r = _port("tools.env_checker", [], cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    report = (tmp_path / "logs" / "env_report.txt").read_text()
    for key in ("torch cuda:", "device_count:", "nvcc:", "kernel build dir:", "cv2:",
                "torch:", "ffmpeg:"):
        assert key in report, key
    assert "jax" not in report


def test_chip_smoke_front_end_videos_are_ucf101_shaped(tmp_path, monkeypatch):
    """Phase 33's videos: UCF101's 320x240 at 25 fps in MJPG .avi that cv2
    reads back, file names without spaces, enough videos a class for the
    runner's 15% val split to hold one; written here at 3 frames a video."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO,
                                                                            "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    fe = cs.FRONT_END
    assert (fe["width"], fe["height"], fe["fps"]) == (320, 240, 25.0)
    assert int(fe["videos_per_class"] * 0.15) >= 1 and fe["frames"] >= 16
    assert any(" " in c for c in fe["classes"])
    monkeypatch.setattr(cs, "FRONT_END", dict(fe, frames=3))
    root = tmp_path / "videos"
    assert cs.write_videos(str(root)) == len(fe["classes"]) * fe["videos_per_class"]
    files = sorted(root.rglob("*.avi"))
    assert len(files) == len(fe["classes"]) * fe["videos_per_class"]
    assert not any(" " in f.name for f in files)
    cap = cv2.VideoCapture(str(files[0]))
    shapes = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        shapes.append(frame.shape)
    cap.release()
    assert shapes == [(240, 320, 3)] * 3
