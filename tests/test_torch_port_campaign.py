"""The port's research campaign scripts (``ssl_vit_video_analytics_tpu_torch/
scripts/``) against the JAX package's ``scripts/``, on the CPU at toy sizes.

- Orchestration, exact: with each package's ``train_ssl.run``,
  ``train_finetune.run`` and ``run_privacy.run`` replaced by a recorder, the
  same argv gives the same sequence of ``(entry, cfg, mode)`` calls (the
  port's ``device`` argument aside), the same label-subset split file byte
  for byte, the same ``campaign_summary.json`` and the same ``[campaign]``
  lines; ``r5_privacy_grid`` gives the same config.
- The hard fixture, bit-equal: split files and ``packed_*.npy`` bytes.
- ``mae_evidence``'s CSVs and the aggregators' CSVs (``make_campaign_
  artifacts``, ``make_sweep_artifacts``, ``make_seed_artifacts``, on inputs
  built from the committed ``docs/examples/csv/``), byte-identical, with the
  same printed lines.
- The port's own ``--smoke --device cpu`` runs of the campaign and of
  ``mae_evidence`` write every file their docstrings list, with finite
  losses.

The entries' numbers against JAX are held by ``test_torch_port_{train_ssl,
finetune,privacy,pipeline_b_regimes}.py``. Random streams differ across
frameworks (torch and JAX draw other numbers from the same laws), so the
campaigns' end-to-end accuracies are not compared here.
"""
import csv
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from ssl_vit_video_analytics_tpu.data import fixtures as jax_fixtures
from ssl_vit_video_analytics_tpu.entry import run_privacy as jax_privacy
from ssl_vit_video_analytics_tpu.entry import train_finetune as jax_finetune
from ssl_vit_video_analytics_tpu.entry import train_ssl as jax_ssl
from ssl_vit_video_analytics_tpu_torch.data import fixtures as port_fixtures
from ssl_vit_video_analytics_tpu_torch.entry import run_privacy as port_privacy
from ssl_vit_video_analytics_tpu_torch.entry import train_finetune as port_finetune
from ssl_vit_video_analytics_tpu_torch.entry import train_ssl as port_ssl
from ssl_vit_video_analytics_tpu_torch.scripts import (make_campaign_artifacts,
                                                       make_seed_artifacts,
                                                       make_sweep_artifacts, mae_evidence,
                                                       r5_privacy_grid, ssl_transfer_campaign)

REPO = pathlib.Path(__file__).resolve().parents[1]
DOCS_CSV = REPO / "docs" / "examples" / "csv"
MODES = ("ft_ssl", "ft_random", "linear_probe", "two_stage")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(module, argv, monkeypatch):
    """The JAX script's main on ``argv``; its stdout lines."""
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        module.main()
    return out.getvalue().splitlines()


def _run_port(module, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        module.main(argv)
    return out.getvalue().splitlines()


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(pathlib.Path(root).rglob("*")) if p.is_file()}


def _record(monkeypatch, ssl_mod, ft_mod, priv_mod, calls):
    def ssl_run(cfg, log=print, **kw):
        calls.append(("train_ssl", json.loads(json.dumps(cfg)), None, kw.get("device")))
        return {}

    def ft_run(cfg, mode=None, log=print, **kw):
        calls.append(("train_finetune", json.loads(json.dumps(cfg)), mode, kw.get("device")))
        return {"best_top1": 0.125 * (1 + MODES.index(mode)), "best_ckpt": None}

    def priv_run(cfg, log=print, **kw):
        calls.append(("run_privacy", json.loads(json.dumps(cfg)), None, kw.get("device")))
        return {}

    monkeypatch.setattr(ssl_mod, "run", ssl_run)
    monkeypatch.setattr(ft_mod, "run", ft_run)
    monkeypatch.setattr(priv_mod, "run", priv_run)


# the dataset line's seconds and the summary's minutes are wall clock
CLOCK = (re.compile(r" \(\d+s\)$"), re.compile(r'"minutes": [\d.]+'))


def _campaign_lines(lines):
    out = [ln for ln in lines if ln.startswith("[campaign]")]
    for pattern in CLOCK:
        out = [pattern.sub("", ln) for ln in out]
    return out


@pytest.mark.parametrize("argv", [
    ["--smoke"],
    ["--smoke", "--ft_label_fraction", "0.5", "--seed", "43"],
    ["--smoke", "--skip_ssl", "--skip_privacy", "--backbone", "tinyvit",
     "--ssl_ckpt", "mae_b/ckpt/ckpt_epoch_2", "--ft_label_fraction", "0.5",
     "--modes", "ft_random,ft_ssl,linear_probe,two_stage"],
    ["--smoke", "--modes", "", "--skip_privacy", "--appearance", "0.6"],
    ["--classes", "2", "--clips", "3", "--ssl_epochs", "1", "--ft_epochs", "4",
     "--ft_label_fraction", "0.34", "--device_resident", "true", "--ft_augment",
     "--modes", "ft_ssl,two_stage", "--nuisance", "0.5", "--motion", "0.8"],
], ids=["default", "label_fraction", "b_family_sweep_cell", "pretrain_only", "full_width"])
def test_campaign_hands_the_entries_the_jax_configs(argv, tmp_path, monkeypatch):
    """Exact: the calls, their configs and modes, the label subset's bytes,
    the summary and the printed lines; the port passes ``--device`` on to
    every call."""
    out, data = str(tmp_path / "out"), str(tmp_path / "data")
    argv = [*argv, "--out", out, "--data", data]
    jax_calls, port_calls = [], []
    _record(monkeypatch, jax_ssl, jax_finetune, jax_privacy, jax_calls)
    jax_lines = _run_jax(_jax_script("ssl_transfer_campaign"), argv, monkeypatch)
    jax_out = _files(out)
    shutil.rmtree(out)
    _record(monkeypatch, port_ssl, port_finetune, port_privacy, port_calls)
    port_lines = _run_port(ssl_transfer_campaign, [*argv, "--device", "cpu"])
    port_out = _files(out)

    assert [c[:3] for c in port_calls] == [c[:3] for c in jax_calls] and port_calls
    assert {c[3] for c in port_calls} == {"cpu"} and {c[3] for c in jax_calls} == {None}
    assert set(port_out) == set(jax_out)
    if "--ft_label_fraction" in argv:
        assert port_out["ft_train_subset.txt"] == jax_out["ft_train_subset.txt"]
    summary = {k: json.loads(v) for k, v in (("jax", jax_out["campaign_summary.json"]),
                                            ("port", port_out["campaign_summary.json"]))}
    for s in summary.values():
        s.pop("minutes")
    assert summary["port"] == summary["jax"]
    assert _campaign_lines(port_lines) == _campaign_lines(jax_lines)


def test_campaign_default_device_is_the_entries_own(tmp_path, monkeypatch):
    """Without ``--device`` every entry gets None and so runs on its own
    default, cuda."""
    calls = []
    _record(monkeypatch, port_ssl, port_finetune, port_privacy, calls)
    _run_port(ssl_transfer_campaign, ["--smoke", "--out", str(tmp_path / "out"),
                                      "--data", str(tmp_path / "data")])
    assert [c[0] for c in calls] == ["train_ssl"] + ["train_finetune"] * 3 + ["run_privacy"]
    assert {c[3] for c in calls} == {None}


@pytest.mark.parametrize("knobs", [
    {"seed": 0},
    {"seed": 3, "appearance_signal": 0.6, "motion_signal": 0.5, "nuisance": 0.3},
    {"seed": 7, "appearance_signal": 1.0, "motion_signal": 0.0, "nuisance": 0.0,
     "val_fraction": 0.5},
])
def test_hard_fixture_is_bit_equal_to_jax(knobs, tmp_path):
    kw = dict(num_classes=3, videos_per_class=4, num_frames=6, image_size=16, **knobs)
    jax_splits = jax_fixtures.make_hard_synthetic_dataset(str(tmp_path / "jax"), **kw)
    port_splits = port_fixtures.make_hard_synthetic_dataset(str(tmp_path / "port"), **kw)
    jax_files = _files(tmp_path / "jax")
    port_files = {k: v.replace(str(tmp_path / "port").encode(), str(tmp_path / "jax").encode())
                  for k, v in _files(tmp_path / "port").items()}
    assert any(k.endswith(".npy") for k in jax_files) and "splits/train.txt" in jax_files
    assert port_files == jax_files
    assert {k: v.replace("port", "jax") for k, v in port_splits.items()} == jax_splits
    # reuse: the same paths back and nothing written again
    stamps = {p: p.stat().st_mtime_ns for p in (tmp_path / "port").rglob("*")}
    again = port_fixtures.make_hard_synthetic_dataset(str(tmp_path / "port"), **kw)
    assert again == port_splits
    assert {p: p.stat().st_mtime_ns for p in (tmp_path / "port").rglob("*")} == stamps


@pytest.mark.parametrize("missing", [False, True], ids=["ckpt", "no_ckpt"])
def test_privacy_grid_config_matches_jax(missing, tmp_path, monkeypatch):
    """The JAX script takes an Orbax directory, the port ``<name>.pt``;
    the configs agree but for that path. A missing checkpoint raises in
    both."""
    jax_ckpt, port_ckpt = tmp_path / "jax" / "best", tmp_path / "port" / "best"
    if not missing:
        jax_ckpt.mkdir(parents=True)
        port_ckpt.parent.mkdir(parents=True)
        (tmp_path / "port" / "best.pt").write_bytes(b"")
    argv = ["--split", "val.txt", "--out", str(tmp_path / "p"), "--repeats", "2",
            "--classes", "5"]
    calls = []
    monkeypatch.setattr(jax_privacy, "run", lambda cfg, log=print: calls.append(cfg))
    monkeypatch.setattr(port_privacy, "run",
                        lambda cfg, log=print, device=None: calls.append((cfg, device)))
    if missing:
        with pytest.raises(FileNotFoundError):
            _run_jax(_jax_script("r5_privacy_grid"), [*argv, "--ckpt", str(jax_ckpt)],
                     monkeypatch)
        with pytest.raises(FileNotFoundError):
            r5_privacy_grid.main([*argv, "--ckpt", str(port_ckpt)])
        assert calls == []
        return
    _run_jax(_jax_script("r5_privacy_grid"), [*argv, "--ckpt", str(jax_ckpt)], monkeypatch)
    r5_privacy_grid.main([*argv, "--ckpt", str(port_ckpt), "--device", "cpu"])
    (jax_cfg, (port_cfg, device)) = calls
    assert (jax_cfg["model"].pop("finetune_ckpt"), port_cfg["model"].pop("finetune_ckpt")) == (
        str(jax_ckpt), str(port_ckpt))
    assert port_cfg == jax_cfg and device == "cpu"
    assert port_cfg["feature_privacy"]["attacker_repeats"] == 2


def test_privacy_grid_runs_on_the_cpu_from_a_port_checkpoint(tmp_path):
    """The grid end to end at its own widths (S=112, T=16, embed 256) on a
    small hard fixture: ``--ckpt .../best`` loads the port's ``best.pt``,
    every cell is filled and each repeat has its row."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.train import finetune_engine
    from ssl_vit_video_analytics_tpu_torch.utils.checkpoint import save_checkpoint

    splits = port_fixtures.make_hard_synthetic_dataset(
        str(tmp_path / "data"), num_classes=2, videos_per_class=3)
    model = finetune_engine.build_model(2, 256)
    finetune_engine.init_model(model, torch.Generator().manual_seed(1))
    save_checkpoint(str(tmp_path / "ft"), "best", model.state_dict())
    out = tmp_path / "p"
    lines = _run_port(r5_privacy_grid, [
        "--ckpt", str(tmp_path / "ft" / "best"), "--split", splits["val"], "--out", str(out),
        "--repeats", "2", "--classes", "2", "--device", "cpu"])
    assert f"[INFO] loaded finetune ckpt: {tmp_path / 'ft' / 'best'}" in lines
    with open(out / "feature_privacy.csv") as f:
        rows = list(csv.DictReader(f))
    with open(out / "feature_privacy_repeats.csv") as f:
        reps = list(csv.DictReader(f))
    assert len(rows) == 24 and len(reps) == 48
    assert [r["repeat"] for r in reps[:2]] == ["0", "1"]
    assert all(math.isfinite(float(r[k])) for r in rows + reps
               for k in ("top1", "entropy", "attacker_top1", "per_vs_clean"))


@pytest.fixture(scope="module")
def mae_smoke(tmp_path_factory):
    """The port's ``mae_evidence --smoke --device cpu``: its out dir and
    stdout lines."""
    root = tmp_path_factory.mktemp("mae")
    argv = ["--smoke", "--device", "cpu", "--out", str(root / "out"),
            "--data", str(root / "data")]
    return root / "out", _run_port(mae_evidence, argv), argv


def test_mae_evidence_smoke_writes_every_listed_file(mae_smoke):
    out, lines, argv = mae_smoke
    names = set(os.listdir(out))
    assert {"mae_pretrain_metrics.csv", "mae_pretrain_steps.csv", "train.log", "ckpt"} <= names
    assert set(os.listdir(out / "ckpt")) == {"ckpt_epoch_2.pt", "ckpt_full_epoch_2.pt"}
    # the CSVs, the figure and 3 triptychs; a figure or triptych without
    # matplotlib prints None, as the JAX script's
    wrote = [ln[len("[mae-evidence] wrote "):] for ln in lines
             if ln.startswith("[mae-evidence] wrote ")]
    assert len(wrote) == 5 and "(2 epochs)" in wrote[0], lines
    if importlib.util.find_spec("matplotlib") is not None:
        assert wrote[1:] == [str(out / n) for n in ("fig_mae_pretrain.png", "recon_val_0.png",
                                                   "recon_val_1.png", "recon_val_2.png")]
        assert all(os.path.isfile(w) for w in wrote[1:])
    else:
        assert wrote[1:] == ["None"] * 4
    with open(out / "mae_pretrain_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["1", "2"]
    assert all(math.isfinite(float(r[k])) for r in rows for k in ("loss", "loss_last",
                                                                 "pred_std"))
    with open(out / "mae_pretrain_steps.csv") as f:
        steps = list(csv.DictReader(f))
    assert len(steps) == 10 and all(math.isfinite(float(r["loss"])) for r in steps)

    # --replot regenerates the CSVs from train.log, byte for byte
    before = {n: (out / n).read_bytes() for n in ("mae_pretrain_metrics.csv",
                                                  "mae_pretrain_steps.csv")}
    _run_port(mae_evidence, [*argv, "--replot"])
    assert {n: (out / n).read_bytes() for n in before} == before
    # --triptychs_only draws from the saved full checkpoint
    again = _run_port(mae_evidence, [*argv, "--triptychs_only"])
    assert [ln for ln in again if ln.startswith("[mae-evidence] wrote ")] == [
        f"[mae-evidence] wrote {w}" for w in wrote[2:]]


def test_mae_evidence_csvs_match_jax_on_the_port_log(mae_smoke, tmp_path):
    """Both packages' write_metric_csvs on the log lines of the port's
    train_ssl_mae give the same bytes and the same line (paths aside)."""
    out, _, _ = mae_smoke
    log_lines = (out / "train.log").read_text().splitlines()
    assert any(mae_evidence.STEP_RE.search(ln) for ln in log_lines)
    jax_mae = _jax_script("mae_evidence")
    got = {}
    for name, module in (("jax", jax_mae), ("port", mae_evidence)):
        (tmp_path / name).mkdir()
        buf = io.StringIO()
        with redirect_stdout(buf):
            module.write_metric_csvs(log_lines, str(tmp_path / name))
        got[name] = (_files(tmp_path / name), buf.getvalue().replace(str(tmp_path / name), "D"))
    assert got["port"] == got["jax"]
    assert "(2 epochs)" in got["port"][1] and "(10 step samples)" in got["port"][1]


def test_campaign_smoke_on_the_cpu_writes_every_listed_file(tmp_path):
    out = tmp_path / "out"
    lines = _run_port(ssl_transfer_campaign, ["--smoke", "--device", "cpu", "--out", str(out),
                                              "--data", str(tmp_path / "data")])
    assert (out / "ssl" / "ssl_epoch_2.pt").is_file()
    with open(out / "ssl" / "ssl_metrics.csv") as f:
        ssl_rows = list(csv.DictReader(f))
    assert len(ssl_rows) == 2 and all(math.isfinite(float(r["total"])) for r in ssl_rows)
    for mode in ("ft_ssl", "ft_random", "linear_probe"):
        with open(out / "finetune" / mode / "metrics.csv") as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 2 and all(math.isfinite(float(r["train_loss"])) for r in rows)
    assert any("loaded finetune ckpt" in ln and ln.endswith("ft_random/best") for ln in lines)
    with open(out / "privacy" / "feature_privacy.csv") as f:
        assert len(list(csv.DictReader(f))) == 24
    summary = json.loads((out / "campaign_summary.json").read_text())
    assert set(summary["best_top1"]) == {"ft_ssl", "ft_random", "linear_probe"}
    assert (summary["n_train"], summary["n_val"]) == (20, 4)


class _MaeConfig(Exception):
    """Raised by the recorder that takes JAX ``train_ssl_mae.run``'s place."""


def _jax_smoke_mae_checkpoint(root, data, monkeypatch):
    """A JAX pipeline-B encoder checkpoint at ``mae_evidence --smoke``'s
    widths: the config is the one the JAX script hands ``train_ssl_mae.run``;
    the model is that entry's, initialised and saved as its epoch save does
    (random weights: only the widths matter here)."""
    import jax
    import jax.numpy as jnp

    from ssl_vit_video_analytics_tpu.entry import train_ssl_mae as jax_mae
    from ssl_vit_video_analytics_tpu.utils.checkpoint import save_checkpoint

    def record(cfg, log=print, **kw):
        raise _MaeConfig(cfg)

    monkeypatch.setattr(jax_mae, "run", record)
    with pytest.raises(_MaeConfig) as got:
        _run_jax(_jax_script("mae_evidence"), ["--smoke", "--out", str(root),
                                               "--data", str(data)], monkeypatch)
    cfg = got.value.args[0]
    T, S = int(cfg["dataset"]["clip_len"]), int(cfg["dataset"]["image_size"])
    model = jax_mae.build_model(cfg, jnp.float32)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, T, S, S, 3)),
                                             jnp.zeros((1, T, (S // 8) ** 2), bool)))(
        jax.random.key(0))
    tree = {col: {"encoder": variables[col]["encoder"]}
            for col in ("params", "batch_stats") if col in variables}
    return save_checkpoint(cfg["training"]["save_dir"], f"ckpt_epoch_{cfg['training']['epochs']}",
                           tree)


def test_b_family_chain_at_smoke_widths_fails_as_in_jax(mae_smoke, tmp_path, monkeypatch):
    """``mae_evidence --smoke``'s encoder (embed_dims 8..32) does not fit
    the finetune's TinyViT, built at its defaults (the campaign sets no
    backbone_kwargs). The same campaign argv, each package on its own
    package's smoke checkpoint, raises at the checkpoint in both
    (JAX: ``train/finetune_engine.py:78-86``)."""
    out, _, _ = mae_smoke
    data = out.parent / "data"
    argv = ["--smoke", "--data", str(data), "--skip_ssl", "--skip_privacy",
            "--backbone", "tinyvit", "--modes", "ft_ssl"]
    with pytest.raises(ValueError, match="leaf shapes do not match") as port_err:
        _run_port(ssl_transfer_campaign, [
            *argv, "--device", "cpu", "--out", str(tmp_path / "port"),
            "--ssl_ckpt", str(out / "ckpt" / "ckpt_epoch_2")])
    jax_ckpt = _jax_smoke_mae_checkpoint(tmp_path / "jax_mae", data, monkeypatch)
    assert os.path.basename(jax_ckpt) == "ckpt_epoch_2"
    with pytest.raises(ValueError, match="leaf shapes do not match") as jax_err:
        _run_jax(_jax_script("ssl_transfer_campaign"), [
            *argv, "--out", str(tmp_path / "jax"), "--ssl_ckpt", jax_ckpt], monkeypatch)
    for err in (port_err, jax_err):
        assert str(err.value).startswith("[ERROR] SSL encoder")


def _campaign_dir(root, modes):
    (root / "ssl").mkdir(parents=True)
    shutil.copyfile(DOCS_CSV / "ssl_metrics.csv", root / "ssl" / "ssl_metrics.csv")
    for mode in modes:
        (root / "finetune" / mode).mkdir(parents=True)
        shutil.copyfile(DOCS_CSV / f"finetune_{mode}_metrics.csv",
                        root / "finetune" / mode / "metrics.csv")
    (root / "privacy").mkdir()
    shutil.copyfile(DOCS_CSV / "feature_privacy.csv", root / "privacy" / "feature_privacy.csv")


@pytest.mark.parametrize("modes", [MODES, MODES[:3]], ids=["four_modes", "no_two_stage"])
def test_campaign_artifacts_match_jax(modes, tmp_path, monkeypatch):
    camp, docs = tmp_path / "camp", tmp_path / "docs"
    _campaign_dir(camp, modes)
    argv = ["--campaign", str(camp), "--docs", str(docs)]
    got = {}
    for name in ("jax", "port"):
        if name == "jax":
            lines = _run_jax(_jax_script("make_campaign_artifacts"), argv, monkeypatch)
        else:
            lines = _run_port(make_campaign_artifacts, argv)
        got[name] = (lines, {k: v for k, v in _files(docs).items() if k.endswith(".csv")},
                     sorted(_files(camp / "figures")))
        shutil.rmtree(docs)
        shutil.rmtree(camp / "figures")
    assert got["port"] == got["jax"]
    lines, csvs, _ = got["port"]
    assert len(csvs) == 2 + len(modes) and len([ln for ln in lines if ln.startswith("figure:")]) == 4
    assert ("MISSING:" in "\n".join(lines)) == (len(modes) < 4)
    assert csvs["csv/feature_privacy.csv"] == (DOCS_CSV / "feature_privacy.csv").read_bytes()


def _sweep_root(root, families, seeds=False):
    """``<root>/<family>_lab<NN>[_s<seed>]/campaign_summary.json`` from the
    committed sweep CSVs."""
    name = "ssl_transfer_sweep_app_seeds.csv" if seeds else "ssl_transfer_sweep.csv"
    with open(DOCS_CSV / name) as f:
        rows = list(csv.DictReader(f))
    cells = {}
    for r in rows:
        family = "A" if r["backbone"].startswith("mobilevit") else "B"
        frac = float(r["label_fraction"])
        if family not in families or frac == 1.0 or (seeds and r["seed"] == "42"):
            continue
        tag = f"{family}_lab{round(frac * 100):02d}" + (f"_s{r['seed']}" if seeds else "")
        cells.setdefault(tag, {})[r["mode"]] = float(r["best_top1"])
    for tag, best in cells.items():
        (root / tag).mkdir(parents=True)
        (root / tag / "campaign_summary.json").write_text(json.dumps({"best_top1": best}))
    return cells


@pytest.mark.parametrize("case", ["both_families", "extra_and_seed_csv", "empty"])
def test_sweep_artifacts_match_jax(case, tmp_path, monkeypatch):
    root, docs = tmp_path / "sweep", tmp_path / "docs"
    (docs / "csv").mkdir(parents=True)
    (docs / "figures").mkdir()
    argv = ["--root", str(root), "--docs", str(docs), "--name", "sweep_t"]
    if case == "empty":
        root.mkdir()
    else:
        _sweep_root(root, "AB" if case == "both_families" else "A")
    if case == "extra_and_seed_csv":
        # the committed full-label pipeline-A rows as an earlier campaign
        with open(DOCS_CSV / "ssl_transfer_sweep.csv") as f:
            full = {r["mode"]: float(r["best_top1"]) for r in csv.DictReader(f)
                    if r["backbone"] == "mobilevit_s+sslA" and r["label_fraction"] == "1.0"}
        extra = tmp_path / "full" / "campaign_summary.json"
        extra.parent.mkdir()
        extra.write_text(json.dumps({"best_top1": full}))
        argv += ["--extra", f"A:1.0:{extra}", "--seed_csv",
                 str(DOCS_CSV / "ssl_transfer_sweep.csv"), "--chance", "0.05"]
    jax_mod = _jax_script("make_sweep_artifacts")
    got = {}
    for name in ("jax", "port"):
        monkeypatch.setattr(sys, "argv", ["make_sweep_artifacts", *argv])
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = jax_mod.main() if name == "jax" else make_sweep_artifacts.main(argv)
        files = {k: v for k, v in _files(tmp_path).items() if k.endswith(".csv")
                 and not k.startswith("full")}
        got[name] = (rc, buf.getvalue(), files)
        for k in files:
            os.remove(tmp_path / k)
    assert got["port"] == got["jax"]
    rc, printed, files = got["port"]
    if case == "empty":
        assert rc == 1 and files == {}
        return
    assert rc == 0 and files["sweep/sweep_summary.csv"] == files["docs/csv/sweep_t.csv"]
    if case == "extra_and_seed_csv":
        assert "seeded " in printed
        # A re-run, B seeded from the committed CSV: its rows come back
        assert files["sweep/sweep_summary.csv"] == (DOCS_CSV / "ssl_transfer_sweep.csv"
                                                    ).read_bytes()


def test_seed_artifacts_match_jax_and_the_committed_csvs(tmp_path, monkeypatch):
    """Seeds 43 and 44 laid out as ``<fam>_lab<NN>_s<seed>`` cells from the
    committed ``*_seeds.csv``, merged with the committed seed-42 CSV: both
    scripts write the committed ``*_seeds.csv`` and ``*_stats.csv`` again
    and print the same z lines."""
    root, docs = tmp_path / "sweep", tmp_path / "docs"
    _sweep_root(root, "AB", seeds=True)
    argv = ["--root", str(root), "--docs", str(docs),
            "--base_csv", str(DOCS_CSV / "ssl_transfer_sweep_app.csv")]
    got = {}
    for name in ("jax", "port"):
        if name == "jax":
            lines = _run_jax(_jax_script("make_seed_artifacts"), argv, monkeypatch)
        else:
            lines = _run_port(make_seed_artifacts, argv)
        got[name] = (lines, _files(docs))
        shutil.rmtree(docs)
    assert got["port"] == got["jax"]
    lines, files = got["port"]
    for name in ("ssl_transfer_sweep_app_seeds.csv", "ssl_transfer_sweep_app_stats.csv"):
        assert files[name] == (DOCS_CSV / name).read_bytes(), name
    assert any("z=" in ln for ln in lines)


@pytest.mark.parametrize("have", [True, False], ids=["resume", "fresh"])
def test_app_sweep_runner_resumes_from_the_port_checkpoints(have, tmp_path):
    """``experiments/torch/run_transfer_sweep_app.sh`` skips a pretraining
    whose ``.pt`` exists (the JAX runner tests for Orbax directories)."""
    out = tmp_path / "out"
    if have:
        for ckpt in (out / "ssl_a" / "ssl" / "ssl_epoch_3.pt",
                     out / "mae_b" / "ckpt" / "ckpt_epoch_3.pt"):
            ckpt.parent.mkdir(parents=True, exist_ok=True)
            ckpt.write_bytes(b"")
    shim = tmp_path / "bin" / "python"
    shim.parent.mkdir()
    shim.write_text(f'#!/bin/bash\necho "$@" >> {tmp_path / "calls.txt"}\n')
    shim.chmod(0o755)
    env = {**os.environ, "PATH": f"{shim.parent}:{os.environ['PATH']}", "OUT": str(out),
           "SSL_EPOCHS": "3", "FRACS": " "}
    proc = subprocess.run(["bash", str(REPO / "experiments" / "torch" /
                                       "run_transfer_sweep_app.sh")],
                          env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    calls_file = tmp_path / "calls.txt"
    calls = calls_file.read_text().splitlines() if calls_file.exists() else []
    if have:
        assert calls == []
    else:
        assert [c.split()[1] for c in calls] == [
            "ssl_vit_video_analytics_tpu_torch.scripts.ssl_transfer_campaign",
            "ssl_vit_video_analytics_tpu_torch.scripts.mae_evidence"]
