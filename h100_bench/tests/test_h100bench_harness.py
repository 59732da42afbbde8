"""The harness: finding a cell's files by name, the import check, the
result line, and the refusal to run without a card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from h100_bench import harness


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["torch", "numpy.linalg", "ssl_vit_video_analytics_tpu_torch.models.layers",
             "h100_bench.harness", "jaxtyping", "flaxen"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["jax._src.api"]) == ["jax"]
    assert harness.forbidden_modules(names + ["ssl_vit_video_analytics_tpu.ops"]) == [
        "ssl_vit_video_analytics_tpu"]
    assert harness.forbidden_modules(["jaxlib", "flax.linen"]) == ["flax", "jaxlib"]


def test_every_cell_resolves_to_its_files():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = harness.resolve(bench, w["name"])
        assert os.path.exists(cell.path)
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        for m in cell.per_layer:
            assert os.path.exists(harness.reader_path(os.path.join(harness.HERE, "metrics"),
                                                      m["name"]))
            assert m["moves"] in [e["name"] for e in cell.end_to_end]
        assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A traffic file, a configuration file, a metric reader and a limits
    file, with entries in a copy of BENCHMARK.json, make a cell that the
    harness resolves and whose reader it finds, with no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: p.read_bytes() for p in (root / "h100_bench").rglob("*") if p.is_file()}
    new = root / "h100_bench"
    (new / "traffic" / "clip32.json").write_text(json.dumps(
        {"split_clips": 3000, "set": {"dataset.clip_len": 32, "training.batch_size": 20}}))
    conf = json.loads((new / "configs" / "tinyvit_videomae_b.json").read_text())
    conf["cfg"]["model"]["decoder_num_heads"] = 3
    (new / "configs" / "tinyvit_videomae_b_h3.json").write_text(json.dumps(conf))
    (new / "metrics" / "clips_seen.train.py").write_text(
        "def read(ctx):\n    return ctx.get('window_clips')\n")
    (new / "limits" / "b_pretrain.h3_clip32.json").write_text(json.dumps(
        {"loss_gap": {"limit": 0.1, "lower": 0.02, "upper": 0.5}}))
    bench["configs"].append({"name": "tinyvit_videomae_b_h3", "source": "x",
                             "file": "h100_bench/configs/tinyvit_videomae_b_h3.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "b_pretrain.h3_clip32", "config": "tinyvit_videomae_b_h3",
                               "traffic": "clip32", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "clips_seen.train", "unit": "clips", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "train_clips_per_s",
                               "workloads": ["b_pretrain.h3_clip32"]})
    for m in bench["end_to_end"]:
        if "b_pretrain.clip16" in m.get("workloads", []):
            m["workloads"].append("b_pretrain.h3_clip32")
    cell = harness.resolve(bench, "b_pretrain.h3_clip32", root=str(root))
    assert cell.cfg["dataset"]["clip_len"] == 32 and cell.cfg["training"]["batch_size"] == 20
    assert cell.cfg["model"]["decoder_num_heads"] == 3
    assert cell.path == str(new / "paths" / "pixel_mae_train.py")
    assert cell.limits == {"loss_gap": 0.1}
    assert "clips_seen.train" in [m["name"] for m in cell.per_layer]
    assert "train_clips_per_s" in [m["name"] for m in cell.end_to_end]
    cell.trace = True
    values = harness.per_layer_values(cell, {"window_clips": 12})
    assert values["clips_seen.train"] == {"value": 12, "unit": "clips"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_result_line_puts_the_checks_last_and_judges_them():
    cell = harness.Cell(workload="w", config_name="c", cfg={}, traffic={},
                        limits={"a": 1.0, "b": 0.0}, path="", chips=1,
                        end_to_end=[{"name": "setup_s", "unit": "s"}], per_layer=[])
    res = {"checks": {"a": 0.5, "b": 0.0}, "attempted": 3, "failed": 0,
           "metrics": {"setup_s": 1.5}, "device": {"platform": "gpu"}}
    line = harness.result_line(cell, res)
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert line["checks"]["a"] == {"value": 0.5, "limit": 1.0}
    res["checks"]["b"] = 1.0
    assert harness.result_line(cell, res)["correct"] is False
    res["checks"] = {"a": float("nan"), "b": 0.0}
    assert harness.result_line(cell, res)["correct"] is False
    res["checks"] = {"a": 0.5, "b": 0.0, "unlimited": 0.0}
    assert harness.result_line(cell, res)["correct"] is False


def test_run_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                        "serve_ee.b8", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_run_fails_where_only_the_benchmark_is(tmp_path):
    """A directory holding BENCHMARK.json and the benchmark's folder alone:
    the run fails before printing a result (no card here, or no program
    there)."""
    shutil.copytree(harness.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "serve_ee.b8",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    p = subprocess.run([sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
                        "serve_ee.b8", "--seed", "5", "--seconds", "3", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"serve_batch_p95_ms", "setup_s"}


@pytest.mark.parametrize("workload", ["b_pretrain.clip16", "serve_ee.b8"])
def test_a_traced_run_reads_its_per_layer_metrics(workload):
    """A traced toy run on the CPU: every reader that needs no device time
    finds its number (the rooflines, which do, find none there)."""
    import toy

    cell = toy.cell(workload, trace=True)
    line = harness.result_line(cell, harness.run_cell(cell))
    names = {m["name"] for m in cell.per_layer}
    device_timed = {n for n in names if "roofline" in n}
    assert set(line["metrics"]) == names - device_timed, line["metrics"]
    assert 0 < line["metrics"][[n for n in names if n.startswith("mfu.")][0]]["value"] < 100
    assert line["metrics"][[n for n in names if n.startswith("idle_share.")][0]]["value"] == 100
    assert "device_ops" in line["breakdown"] and line["correct"] is True
