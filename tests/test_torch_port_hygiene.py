"""The port stands alone: it imports no JAX-family package and not the JAX
package, its kernel wrappers stay off the build directory for CPU tensors,
and chip_smoke.py holds to the configs and reads every kernel's build
report."""
import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from ssl_vit_video_analytics_tpu_torch.ops import depthwise, kernel_build, unary_chain
from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa
from ssl_vit_video_analytics_tpu_torch.utils.config import load_config, load_yaml, merge_configs

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "ssl_vit_video_analytics_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ssl_vit_video_analytics_tpu"}


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_family():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_importing_the_entry_loads_no_jax():
    """In a fresh interpreter with JAX-family imports blocked, every module
    of the port imports, and none of those packages is in sys.modules."""
    code = f"""
import importlib, json, pkgutil, sys
BLOCK = {sorted(FORBIDDEN)!r}
for m in list(sys.modules):
    if m.split(".")[0] in BLOCK:
        del sys.modules[m]
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Blocker())
import ssl_vit_video_analytics_tpu_torch as pkg
importlib.import_module("ssl_vit_video_analytics_tpu_torch.entry.run_dynamic")
importlib.import_module("ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae")
importlib.import_module("ssl_vit_video_analytics_tpu_torch.entry.train_finetune")
importlib.import_module("ssl_vit_video_analytics_tpu_torch.entry.evaluate")
importlib.import_module("ssl_vit_video_analytics_tpu_torch.entry.train_ssl")
importlib.import_module("ssl_vit_video_analytics_tpu_torch.entry.train_mae")
importlib.import_module("ssl_vit_video_analytics_tpu_torch.entry.sanity_check_mae")
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    walked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"entry/train_ssl_mae.py", "models/tiny_vit.py", "models/mae.py",
            "train/mae_engine.py", "train/state.py", "train/losses.py", "ops/patchify.py",
            "data/masking.py", "utils/checkpoint.py", "utils/metrics.py",
            "ops/kernel_build.py", "ops/depthwise.py", "ops/unary_chain.py",
            "scripts/__init__.py", "scripts/probe_dw.py", "scripts/probe_exp.py",
            "scripts/profile_step.py", "entry/train_finetune.py", "entry/evaluate.py",
            "entry/common.py", "data/device_store.py", "train/finetune_engine.py",
            "models/classifier.py", "utils/convert.py", "entry/train_ssl.py",
            "entry/train_mae.py", "entry/sanity_check_mae.py", "models/temporal.py",
            "models/heads.py", "train/ssl_engine.py", "ops/augment.py",
            "parallel/__init__.py", "parallel/mesh.py", "parallel/collectives.py",
            "parallel/sp.py", "federated/core.py", "entry/run_federated.py",
            "parallel/ep.py", "parallel/tp.py", "parallel/pp.py", "parallel/shard.py",
            "reporting/plotting.py", "reporting/visualize.py", "entry/plotting.py",
            "entry/visualize_mae.py", "entry/ablations.py", "tools/export_serving.py",
            "tools/import_torch_checkpoint.py", "scripts/ssl_transfer_campaign.py",
            "scripts/mae_evidence.py", "scripts/make_campaign_artifacts.py",
            "scripts/make_sweep_artifacts.py", "scripts/make_seed_artifacts.py",
            "scripts/r5_privacy_grid.py"} <= walked


def test_wrapper_on_cpu_runs_plain_version_without_building(tmp_path, monkeypatch):
    def no_build(*_):
        raise AssertionError("the CPU path must not build the kernel")

    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build" / "kernels")
    monkeypatch.setattr(kernel_build, "_build", no_build)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 10, 64, generator=g) for _ in range(3))
    before = fa.launches.count
    out, lse = fa.flash_attention_fwd(q, k, v, 2)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, 2)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=0, rtol=0)
    assert fa.launches.count == before
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("wrapper", ["dw3x3", "unary_chain"])
def test_probe_wrappers_on_cpu_run_plain_versions_without_building(wrapper, tmp_path,
                                                                   monkeypatch):
    def no_build(*_):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build" / "kernels")
    monkeypatch.setattr(kernel_build, "_build", no_build)
    g = torch.Generator().manual_seed(0)
    if wrapper == "dw3x3":
        module = depthwise
        x, w = torch.randn(2, 6 * 4, 8, generator=g), torch.randn(9, 8, generator=g)
        before = module.launches.count
        got, ref = depthwise.dw3x3(x, w, 6, 4), depthwise.dw3x3_plain(x, w, 6, 4)
    else:
        module = unary_chain
        x = torch.randn(3, 50, generator=g)
        before = module.launches.count
        got = unary_chain.unary_chain(x, 7, torch.bfloat16, "gelu")
        ref = unary_chain.unary_chain_plain(x, 7, torch.bfloat16, "gelu")
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert module.launches.count == before
    assert not (tmp_path / "build").exists()


def test_kernel_build_registers_every_kernel_source():
    """kernel_build compiles the five kernel sources of the port in one
    batch, each listed with the C functions its wrapper calls."""
    sources = kernel_build.sources()
    assert set(sources) == {"flash_fwd", "flash_bwd", "dw3x3", "unary_chain",
                            "layer_norm"}
    for name, path in sources.items():
        assert path.is_file() and path.parent == PORT / "ops" / "csrc", name
    assert set(kernel_build.LIBRARIES) == set(sources)
    assert kernel_build.BUILD_DIR == REPO / "build" / "kernels"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _flat(cfg, prefix=""):
    out = {}
    for key, value in cfg.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


ABSENT = object()  # a departure's key that the yaml does not have
ON_CARD = {"device.name": "cuda", "paths.split_root": ""}
# each phase config of chip_smoke.py: its yaml, how the phase builds it, its
# named departures (flat key: (the yaml's value, the phase's)), its own keys
# and spot checks of what it runs
PHASE_CONFIGS = {
    "slice_7": ("dynamic", lambda cs: cs.slice_cfg("v.txt", "out", "streaming"),
                {"model.finetune_ckpt": ("results/finetune/two_stage/best", None)},
                {"dataset.split": "v.txt", "output.save_dir": "out",
                 "dynamic.early_exit_impl": "streaming"},
                {"runtime.batch_size": 8, "dataset.clip_len": 32, "dataset.stride": 2,
                 "dynamic.max_frames": 16, "dataset.num_classes": 101, "model.embed_dim": 256}),
    "pipeline_b_6": ("ssl_mae", lambda cs: cs.ssl_mae_cfg("train.txt", "out"),
                     {"training.save_every": (10, 1)},
                     {"dataset.train_split": "train.txt", "training.save_dir": "out"},
                     {"training.batch_size": 40, "training.accumulation_steps": 2,
                      "dataset.clip_len": 16, "model.decoder_num_heads": 6}),
    # as phase_launch layers it
    "launch_26": ("ssl_mae", lambda cs: merge_configs(
                      cs.ssl_mae_cfg("train.txt", "ckpt"), cs.LAUNCH_OVERRIDES,
                      {"paths": {"log_dir": "logs_26"}}),
                  {"training.save_every": (10, 1), "training.epochs": (200, 1),
                   "training.batch_size": (40, 20), "training.log_interval": (20, 1)},
                  {"dataset.train_split": "train.txt", "training.save_dir": "ckpt",
                   "paths.log_dir": "logs_26"},
                  {"dataset.clip_len": 16, "training.accumulation_steps": 2}),
    "moe_20_21": ("ssl_mae_moe", lambda cs: cs.opt_in_cfg("moe", "train.txt", "out", "prof"),
                  {"training.save_every": (10, 1), "logging.profile_dir": (ABSENT, "prof")},
                  {"dataset.train_split": "train.txt", "training.save_dir": "out"},
                  {"training.batch_size": 40, "model.decoder_moe_group_size": 392,
                   "model.decoder_moe_experts": 8}),
    "longclip_22_23": ("ssl_mae_longclip",
                       lambda cs: cs.opt_in_cfg("longclip", "train.txt", "out", "prof"),
                       {},
                       {"dataset.train_split": "train.txt", "training.save_dir": "out"},
                       {"training.batch_size": 8, "dataset.clip_len": 64, "dataset.stride": 1}),
    "pipeline_a_12_13": ("ssl_train", lambda cs: cs.ssl_train_cfg("train.txt", "out"),
                         {"ssl_objectives.top_start_epoch": (6, 1),
                          "training.save_every": (10, 1)},
                         {"dataset.train_split": "train.txt", "training.save_dir": "out"},
                         {"training.batch_size": 48, "dataset.clip_len": 32,
                          "model.temporal_heads": 4}),
    "pipeline_c_14_16": ("mae_train", lambda cs: cs.mae_train_cfg("train.txt", "out"),
                         {"training.batch_size": (256, 16), "training.save_every": (5, 1)},
                         {"dataset.train_split": "train.txt", "output.dir": "out"},
                         {"dataset.clip_len": 32, "mae.decoder.num_heads": 8,
                          "mae.stage4_pool": 3}),
    "transfer_11": ("finetune", lambda cs: cs.finetune_cfg("t.txt", "v.txt", "ckpt", "out"),
                    {"model.backbone": ("mobilevit_s", "tinyvit"), "dataset.clip_len": (32, 16),
                     "dataset.stride": (2, 1), "dataset.device_resident": (ABSENT, True),
                     "training.batch_size": (64, 16), "training.epochs": (30, 2),
                     "training.stage1_epochs": (10, 1)},
                    {"dataset.train_split": "t.txt", "dataset.val_split": "v.txt",
                     "dataset.num_classes": 8, "model.pretrained_ssl": "ckpt",
                     "paths.save_dir": os.path.join("out", "finetune"),
                     "paths.result_dir": os.path.join("out", "results"),
                     "paths.log_dir": os.path.join("out", "logs")},
                    {"dataset.image_size": 112, "device.compute_dtype": "bfloat16"}),
    "privacy_18": ("privacy", lambda cs: cs.privacy_cfg("s.txt", "faces", "out"),
                   {"feature_privacy.noise_sigmas": ([0.0, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 4.0],
                                                     [0.0, 0.5]),
                    "feature_privacy.mask_ratios": ([0.0, 0.2, 0.4], [0.0, 0.2])},
                   {"dataset.split": "s.txt", "visual_privacy.frame_root": "faces",
                    "output.save_dir": "out"},
                   {"runtime.batch_size": 8, "dataset.clip_len": 32, "model.embed_dim": 256,
                    "feature_privacy.attacker_epochs": 10}),
    "federated_17_19": ("federated",
                        lambda cs: cs.federated_cfg("t.txt", "v.txt", "splits", "out"),
                        {"federated.rounds": (10, 2),
                         "federated.non_iid.min_samples_per_client": (200, 32),
                         "centralized.epochs": (None, 1)},
                        {"dataset.train_split": "t.txt", "dataset.val_split": "v.txt",
                         "output.save_dir": "out", "paths.split_root": "splits"},
                        {"federated.batch_size": 16, "federated.num_clients": 5,
                         "federated.lr": 3e-4, "federated.weight_decay": 0.01,
                         "dataset.clip_len": 32}),
}


@pytest.mark.parametrize("case", list(PHASE_CONFIGS))
def test_chip_smoke_phase_config_is_its_yaml_with_named_departures(case):
    """Each phase of chip_smoke.py runs configs/<yaml>.yaml over
    configs/base.yaml, as an entry's --config loads it, with exactly its
    named departures and its own keys (splits, output directories, the
    card) on top; nothing else departs."""
    chip_smoke = _chip_smoke()
    name, build, departures, own, spot = PHASE_CONFIGS[case]
    yml = _flat(load_config(str(REPO / "configs" / f"{name}.yaml"),
                            base=str(REPO / "configs" / "base.yaml")))
    cfg = _flat(build(chip_smoke))
    assert {k: yml.get(k, ABSENT) for k in departures} == {
        k: was for k, (was, _) in departures.items()}
    want = {**yml, **{k: now for k, (_, now) in departures.items()}, **ON_CARD, **own}
    assert cfg == want
    assert {k: cfg[k] for k in spot} == spot
    if case == "transfer_11":
        assert chip_smoke.CAMPAIGN_B == {
            "model": {"backbone": "tinyvit"},
            "dataset": {"clip_len": 16, "stride": 1, "image_size": 112,
                        "device_resident": True},
            "training": {"batch_size": 16, "epochs": 2, "stage1_epochs": 1},
            "device": {"compute_dtype": "bfloat16"}}
        assert chip_smoke.FINETUNE_MODE == "two_stage" and chip_smoke.FT_CLASSES == 8


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__14de2811_12_flash_fwd_cu_83a852c716flash_fwd_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PS2_Pfiiillllllf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 252 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__80ed528a_8_dw3x3_cu_04ec13aa12dw3x3_kernelIfLi4EEEvPKT_PKfPS1_iiil' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__cb8c47d3_14_unary_chain_cu_a68193f618unary_chain_kernelILi2ELb1EEEvPKfPfli' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_chip_smoke_reads_every_kernels_ptxas_report():
    """The build phase names each kernel instantiation of the four sources
    (nvcc hashes the anonymous namespace into the mangled name)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.ptxas_summary(PTXAS_LOG) == [
        "flash_fwd_kernel<bf16,64>: spill 0/0, 252 regs",
        "dw3x3_kernel<f32,4>: spill 8/4, 30 regs",
        "unary_chain_kernel<2,1>: spill 0/0, 32 regs"]


@pytest.mark.parametrize("entry", ["run_privacy", "run_federated"])
def test_privacy_and_federated_entries_load_no_jax(entry):
    """In a fresh interpreter with JAX-family imports blocked, the port's
    privacy or federated entry (and the privacy bridge to it) imports, and
    none of those packages is in sys.modules."""
    code = f"""
import importlib, json, sys
BLOCK = {sorted(FORBIDDEN)!r}
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Blocker())
importlib.import_module("ssl_vit_video_analytics_tpu_torch.entry.{entry}")
importlib.import_module("ssl_vit_video_analytics_tpu_torch.privacy.system_federated")
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in BLOCK)))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    walked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"entry/run_privacy.py", "entry/run_federated.py", "privacy/__init__.py",
            "privacy/feature.py", "privacy/attacker.py", "privacy/visual.py",
            "privacy/metrics.py", "privacy/system_federated.py", "federated/__init__.py",
            "federated/core.py", "federated/comm_cost.py", "data/transforms.py"} <= walked


def test_chip_smoke_campaigns_run_the_scripts_at_full_width_with_counts_cut(tmp_path,
                                                                             monkeypatch):
    """Phase 31 runs the campaign scripts at their full width (16 x 112x112
    clips, batch 16, embed 256, bf16; mae_evidence at configs/ssl_mae.yaml's
    widths), cut only in counts: a 4-class x 10-clip fixture, 1 SSL epoch, 2
    finetune epochs with the default modes and privacy grid, 1 MAE epoch at
    batch 16, then the pipeline-B cell at half the labels from that
    encoder. The configs the scripts hand the entries are recorded here
    with the entries replaced."""
    from ssl_vit_video_analytics_tpu_torch.entry import (run_privacy, train_finetune,
                                                         train_ssl, train_ssl_mae)
    from ssl_vit_video_analytics_tpu_torch.scripts import mae_evidence, ssl_transfer_campaign

    chip_smoke = _chip_smoke()
    assert chip_smoke.CAMPAIGN_DATA == ["--classes", "4", "--clips", "10"]
    assert chip_smoke.CAMPAIGN_A_ARGS == ["--ssl_epochs", "1", "--ft_epochs", "2"]
    assert chip_smoke.MAE_EVIDENCE_ARGS == ["--epochs", "1", "--batch", "16",
                                            "--log_interval", "1"]
    assert chip_smoke.CAMPAIGN_B_ARGS == [
        "--ft_epochs", "2", "--skip_ssl", "--skip_privacy", "--backbone", "tinyvit",
        "--ft_label_fraction", "0.5", "--modes", "ft_ssl,two_stage"]
    assert (chip_smoke.CAMPAIGN_A_MODES, chip_smoke.CAMPAIGN_B_MODES) == (
        ("ft_ssl", "ft_random", "linear_probe"), ("ft_ssl", "two_stage"))
    assert (chip_smoke.MAE_EVIDENCE_EPOCHS, chip_smoke.PRIVACY_GRID_ROWS) == (1, 24)
    assert {f"campaign_{m}" for m in chip_smoke.CAMPAIGN_A_MODES} | {
        f"campaign_b_{m}" for m in chip_smoke.CAMPAIGN_B_MODES} | {
        "campaign_train_ssl", "campaign_run_privacy", "mae_evidence"} <= set(chip_smoke.PATHS)

    tmp = str(tmp_path)
    argvs = chip_smoke.campaign_argvs(tmp)
    assert list(argvs) == ["campaign_a", "mae_evidence", "campaign_b", "campaign_artifacts",
                           "sweep_artifacts"]
    for key in ("campaign_a", "mae_evidence", "campaign_b"):
        assert argvs[key][-2:] == ["--device", "cuda"] and "--smoke" not in argvs[key]
    calls = []
    monkeypatch.chdir(REPO)  # mae_evidence reads configs/ from the working directory
    for module, entry in ((train_ssl, "train_ssl"), (train_finetune, "train_finetune"),
                          (run_privacy, "run_privacy"), (train_ssl_mae, "train_ssl_mae")):
        monkeypatch.setattr(module, "run", lambda cfg, *a, _e=entry, **kw: calls.append(
            (_e, cfg, kw.get("mode"), kw.get("device"))) or {"best_top1": 0.0})
    monkeypatch.setattr(mae_evidence, "fig_mae_pretrain", lambda *a, **kw: None)
    monkeypatch.setattr(mae_evidence, "make_triptychs", lambda *a, **kw: None)
    ssl_transfer_campaign.main(argvs["campaign_a"])
    mae_evidence.main(argvs["mae_evidence"])
    ssl_transfer_campaign.main(argvs["campaign_b"])
    n_train = len((tmp_path / "data" / "splits" / "train.txt").read_text().splitlines())
    subset = os.path.join(tmp, "B_lab50", "ft_train_subset.txt")
    n_subset = len(pathlib.Path(subset).read_text().splitlines())
    mae_ckpt = os.path.join(tmp, "mae_b", "ckpt", "ckpt_epoch_1")
    assert [(c[0], c[2]) for c in calls] == [
        ("train_ssl", None), ("train_finetune", "ft_ssl"), ("train_finetune", "ft_random"),
        ("train_finetune", "linear_probe"), ("run_privacy", None), ("train_ssl_mae", None),
        ("train_finetune", "ft_ssl"), ("train_finetune", "two_stage")]
    assert {c[3] for c in calls} == {"cuda"} and (n_train, n_subset) == (32, 16)
    for entry, cfg, mode, _ in calls:
        d = cfg["dataset"]
        assert (d["clip_len"], d["image_size"], cfg["device"]["compute_dtype"]) == (
            16, 112, "bfloat16"), entry
        if entry == "train_ssl_mae":
            yml = load_yaml(os.path.join(REPO, "configs", "ssl_mae.yaml"))["model"]
            m, tr = cfg["model"], cfg["training"]
            assert {k: m[k] for k in ("embed_dims", "decoder_embed_dim", "decoder_depth",
                                      "decoder_num_heads")} == {
                k: yml[k] for k in ("embed_dims", "decoder_embed_dim", "decoder_depth",
                                    "decoder_num_heads")}
            assert (tr["batch_size"], tr["epochs"], tr["accumulation_steps"], tr["save_full"],
                    m["use_checkpoint"], tr["log_interval"]) == (16, 1, 1, True, False, 1)
            continue
        batch = cfg["runtime" if entry == "run_privacy" else "training"]["batch_size"]
        assert (batch, cfg["model"]["embed_dim"]) == (16, 256), entry
        if entry == "train_ssl":
            assert (cfg["model"]["temporal_layers"], cfg["training"]["epochs"]) == (4, 1)
        if entry == "train_finetune":
            assert cfg["training"]["epochs"] == 2
        if entry == "run_privacy":
            fp = cfg["feature_privacy"]
            assert len(fp["noise_sigmas"]) * len(fp["mask_ratios"]) == 24
    b_cells = [c[1] for c in calls[-2:]]
    assert all(c["model"]["backbone"] == "tinyvit" and c["model"]["pretrained_ssl"] == mae_ckpt
               and c["dataset"]["train_split"] == subset for c in b_cells)
