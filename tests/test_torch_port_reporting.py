"""The port's reporting layer against the JAX package, on the CPU:
``utils/metrics.minmax_norm`` (exact), ``ops/preprocess.denormalize_clip``
(1e-6 relative), and ``reporting/plotting.generate_all`` and
``entry/plotting`` on the committed CSVs of ``docs/examples/csv/``, laid
out as ``configs/plotting.yaml`` and ``generate_all``'s defaults expect:
the same figure names, and ``summary.csv`` equal as text (to JAX's and to
the committed one). Without matplotlib both return ``[]``."""
import os
import pathlib
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.ops import preprocess as jpre
from ssl_vit_video_analytics_tpu.reporting import plotting as jplot
from ssl_vit_video_analytics_tpu.utils import metrics as jmetrics
from ssl_vit_video_analytics_tpu_torch.entry import plotting as plotting_entry
from ssl_vit_video_analytics_tpu_torch.ops import preprocess as tpre
from ssl_vit_video_analytics_tpu_torch.reporting import plotting as tplot
from ssl_vit_video_analytics_tpu_torch.utils import metrics as tmetrics
from ssl_vit_video_analytics_tpu_torch.utils.config import load_yaml

REPO = pathlib.Path(__file__).resolve().parents[1]
CSV = REPO / "docs" / "examples" / "csv"
# the committed CSVs where configs/plotting.yaml and generate_all's defaults
# look for them
LAYOUT = {
    "results/dynamic/early_exit_results.csv": "early_exit_results.csv",
    "results/dynamic/frame_gating_results.csv": "frame_gating_results.csv",
    "results/privacy/feature_privacy.csv": "feature_privacy.csv",
    "results/privacy/federated/fed_summary.csv": "fed_summary.csv",
    "results/ema_ssl_vicreg/ssl_metrics.csv": "ssl_metrics.csv",
    **{f"results/finetune/{mode}/metrics.csv": f"finetune_{mode}_metrics.csv"
       for mode in ("ft_random", "linear_probe", "ft_ssl", "two_stage")}}


@pytest.mark.parametrize("values", [[3.0, 1.0, 2.0], [5, 5, 5], [0.1, -2.0, 7.5, 7.5], [4.0],
                                    [1e-13, 0.0], [247.012, 143.282, 146.012]])
def test_minmax_norm_matches_jax_exactly(values):
    assert tmetrics.minmax_norm(values) == jmetrics.minmax_norm(values)


def test_denormalize_clip_matches_jax_and_inverts_normalize_clip():
    x = np.random.default_rng(0).standard_normal((2, 3, 8, 8, 3), dtype=np.float32) * 2
    got = tpre.denormalize_clip(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jpre.denormalize_clip(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6 * 255)
    u8 = np.random.default_rng(1).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    back = tpre.denormalize_clip(tpre.normalize_clip(torch.from_numpy(u8)))
    np.testing.assert_allclose(back.numpy(), u8.astype(np.float32), atol=1e-3)
    bf16 = tpre.denormalize_clip(tpre.normalize_clip(torch.from_numpy(u8), torch.bfloat16))
    assert bf16.dtype == torch.float32


@pytest.fixture
def laid_out(tmp_path, monkeypatch):
    """docs/examples/csv/ under tmp_path as configs/plotting.yaml expects,
    and tmp_path the working directory."""
    for dst, src in LAYOUT.items():
        (tmp_path / dst).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(CSV / src, tmp_path / dst)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _cfg(name: str) -> dict:
    cfg = load_yaml(str(REPO / "configs" / "plotting.yaml"))
    cfg["outputs"] = {"figures_dir": f"{name}/figures", "summary_csv": f"{name}/summary.csv"}
    return cfg


def test_generate_all_on_the_committed_csvs_matches_jax(laid_out):
    ref = jplot.generate_all(_cfg("jax"), log=lambda *_: None)
    got = tplot.generate_all(_cfg("port"), log=lambda *_: None)
    names = [os.path.basename(p) for p in got]
    assert names == [os.path.basename(p) for p in ref] and len(names) == 7
    assert all(os.path.getsize(p) > 0 for p in got)
    summary = (laid_out / "port" / "summary.csv").read_text()
    assert summary == (laid_out / "jax" / "summary.csv").read_text()
    assert summary == (CSV / "summary.csv").read_text()


def test_generate_all_without_matplotlib_returns_nothing_as_jax(laid_out, monkeypatch):
    monkeypatch.setattr(jplot, "plt", None)
    monkeypatch.setattr(tplot, "plt", None)
    assert jplot.generate_all(_cfg("jax"), log=lambda *_: None) == []
    assert tplot.generate_all(_cfg("port"), log=lambda *_: None) == []
    assert not (laid_out / "port").exists() or not any((laid_out / "port").rglob("*.*"))


def test_plotting_entry_takes_the_yaml_and_overrides(laid_out, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "plotting", "--config", str(REPO / "configs" / "plotting.yaml"),
        "--set", "figures.fig_statistical_analysis=false",
        "--set", "outputs.figures_dir=figs"])
    plotting_entry.main()
    out = capsys.readouterr().out.splitlines()
    assert sorted(os.listdir(laid_out / "figs")) == sorted(
        os.path.basename(p) for p in jplot.generate_all(
            dict(_cfg("jax"), figures={"fig_statistical_analysis": False}),
            log=lambda *_: None))
    assert len(out) == 6 and all(m.startswith("[INFO] wrote figs/") for m in out)
    assert (laid_out / "results" / "summary.csv").read_text() == (CSV / "summary.csv").read_text()
