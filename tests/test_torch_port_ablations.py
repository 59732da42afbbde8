"""The port's ablation runner against the JAX package's, on the CPU: the
``--dry_run`` command lists of the four grids and ``ablation_index.json``
are the JAX ones once the entry package is mapped; ``--device`` goes on to
every cell only when given; ``--max_per_group 0`` runs no cell; one real
cell of the dynamic grid runs the port's ``run_dynamic`` in a subprocess on
the CPU. Then the port's experiment runners (``experiments/torch/``): one
for each JAX runner the port takes, valid bash, naming only port entries
and scripts (a JAX ``python scripts/<name>.py`` is the port's ``python -m
ssl_vit_video_analytics_tpu_torch.scripts.<name>``).
"""
import json
import pathlib
import re
import subprocess
import sys

import pytest
import yaml

from ssl_vit_video_analytics_tpu.entry import ablations as jabl
from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.entry import ablations as tabl
from ssl_vit_video_analytics_tpu_torch.utils.io import read_csv_dicts

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_ENTRY, PORT_ENTRY = "ssl_vit_video_analytics_tpu.entry", "ssl_vit_video_analytics_tpu_torch.entry"
PORT_SCRIPTS = "ssl_vit_video_analytics_tpu_torch.scripts"
PORT_PREPROCESS = "ssl_vit_video_analytics_tpu_torch.preprocess"
PORT_TOOLS = "ssl_vit_video_analytics_tpu_torch.tools"
# the JAX runner the port leaves out: TPU-environment code
NOT_PORTED = {"run_segmented.sh"}


def _drive(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["ablations", *argv])
    module.main()
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[ABLATION]")]


@pytest.mark.parametrize("argv", [[], ["--groups", "privacy", "dynamic", "--max_per_group", "2"],
                                  ["--max_per_group", "1", "--base", "b.yaml"]],
                         ids=["all", "two_groups", "first_cells"])
def test_dry_run_commands_and_index_match_jax(argv, tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "abl")
    ref = _drive(jabl, ["--dry_run", "--out_dir", out, *argv], monkeypatch, capsys)
    ref_index = json.loads((tmp_path / "abl" / "ablation_index.json").read_text())
    got = _drive(tabl, ["--dry_run", "--out_dir", out, *argv], monkeypatch, capsys)
    got_index = json.loads((tmp_path / "abl" / "ablation_index.json").read_text())
    assert got == [ln.replace(f" {JAX_ENTRY}.", f" {PORT_ENTRY}.") for ln in ref]
    assert got_index == ref_index and got
    assert all(f" -m {PORT_ENTRY}." in ln and "--device" not in ln for ln in got)


def test_device_goes_on_to_every_cell_and_zero_cells_run_none(tmp_path, monkeypatch, capsys):
    got = _drive(tabl, ["--dry_run", "--out_dir", str(tmp_path), "--device", "cpu"],
                 monkeypatch, capsys)
    assert len(got) == 14 and all(" --device cpu --set " in ln for ln in got)
    assert _drive(tabl, ["--dry_run", "--out_dir", str(tmp_path), "--max_per_group", "0"],
                  monkeypatch, capsys) == []
    assert json.loads((tmp_path / "ablation_index.json").read_text()) == []


def test_a_real_dynamic_cell_runs_the_port_entry_on_the_cpu(tmp_path, monkeypatch):
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=4, videos_per_class=2,
                                    num_frames=8, image_size=32, seed=0)
    dyn_cfg = {
        "seed": 42, "device": {"compute_dtype": "float32"},
        "dataset": {"backend": "packed", "split": splits["val"], "num_classes": 4,
                    "clip_len": 4, "stride": 2, "image_size": 32},
        "model": {"embed_dim": 32, "finetune_ckpt": None},
        "runtime": {"batch_size": 4, "num_warmup": 0, "num_measure": 1},
        "paths": {"log_dir": str(tmp_path / "logs"), "split_root": ""},
        "output": {"save_dir": str(tmp_path / "unused"), "save_csv": True},
        "dynamic": {"mode": "early_exit", "confidence_thresholds": [0.3],
                    "min_frames": 2, "max_frames": 4, "frame_step": 1}}
    cfg_path = tmp_path / "dynamic_tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(dyn_cfg))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(sys, "argv", [
        "ablations", "--groups", "dynamic", "--max_per_group", "1", "--device", "cpu",
        "--dynamic_config", str(cfg_path), "--base", "", "--out_dir", str(tmp_path / "abl")])
    tabl.main()
    index = json.loads((tmp_path / "abl" / "ablation_index.json").read_text())
    assert len(index) == 1 and index[0]["exit"] == 0
    assert index[0]["group"] == "dynamic" and index[0]["tag"] == "DYN_min_frames2"
    rows = read_csv_dicts(str(tmp_path / "abl" / "DYN_min_frames2" / "dynamic" /
                              "early_exit_results.csv"))
    assert rows and all(2.0 <= float(r["avg_frames"]) <= 4.0 for r in rows)


def test_experiment_runners_mirror_the_jax_ones_with_port_entries():
    jax_runners = {p.name for p in (REPO / "experiments").glob("*.sh")}
    port_runners = sorted((REPO / "experiments" / "torch").glob("*.sh"))
    assert {p.name for p in port_runners} == jax_runners - NOT_PORTED
    for path in port_runners:
        assert subprocess.run(["bash", "-n", str(path)], capture_output=True).returncode == 0
        text = path.read_text()
        modules = re.findall(r"python -m (\S+)", text)
        # entries, scripts/*.py, and the dataset front end's preprocess/*.py
        # and root verify_dataset.py
        jax_calls = re.findall(
            r"python (?:-m (\S+)|scripts/(\w+)\.py|preprocess/(\w+)\.py|(verify_dataset)\.py)",
            (REPO / "experiments" / path.name).read_text())
        assert modules and modules == [
            m.replace(JAX_ENTRY, PORT_ENTRY) if m else f"{PORT_SCRIPTS}.{script}" if script
            else f"{PORT_PREPROCESS}.{pre}" if pre else f"{PORT_TOOLS}.{tool}"
            for m, script, pre, tool in jax_calls]
        assert "ssl_vit_video_analytics_tpu." not in text
        assert path.stat().st_mode & 0o111  # executable, as the JAX runners
