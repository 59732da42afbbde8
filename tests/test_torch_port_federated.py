"""The port's FedAvg against the JAX package, in fp32 on the CPU, at toy
sizes: aggregation, client selection, the comm-cost formulas, the round
sampler, one FedAvg round of a toy MobileViT-S classifier (embed 16, T=2)
against the JAX round without a mesh, the step chunking, and
``entry/run_federated.py`` with ``privacy/system_federated.py``.

Tolerances: aggregation 1e-6 (integer tensors exact); comm MB 1e-9; the
round sampler bit-equal; the FedAvg round ROUND_TOL (see there); the port's
chunked round against its unchunked one rtol 3e-6 as
``tests/test_federated.py`` holds the JAX package's.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.entry import run_federated as jax_run_federated
from ssl_vit_video_analytics_tpu.entry import common as jax_common
from ssl_vit_video_analytics_tpu.federated import core as jcore
from ssl_vit_video_analytics_tpu.federated import comm_cost as jcomm
from ssl_vit_video_analytics_tpu.ops.preprocess import normalize_clip as jax_normalize_clip
from ssl_vit_video_analytics_tpu.train import finetune_engine as jeng
from ssl_vit_video_analytics_tpu_torch.entry import common, run_federated
from ssl_vit_video_analytics_tpu_torch.federated import comm_cost, core
from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
from ssl_vit_video_analytics_tpu_torch.privacy import system_federated
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as teng
from ssl_vit_video_analytics_tpu_torch.train.state import make_optimizer
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    classifier_state_dict_from_flax, flatten_variables, unflatten_variables)
from ssl_vit_video_analytics_tpu_torch.utils.io import read_csv_dicts

torch.set_num_threads(2)  # six test workers share the host

C = 4


def _trees(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((2, 3)).astype(np.float32),
             "b": rng.standard_normal((5,)).astype(np.float32),
             "count": rng.integers(0, 100, (4,)).astype(np.int64),
             "flag": rng.integers(0, 2, (2,)).astype(bool)} for _ in range(n)]


@pytest.mark.parametrize("stacked", [False, True])
def test_fedavg_aggregate_matches_jax(stacked):
    trees = _trees()
    weights = np.array([3.0, 1.0, 6.0], np.float32)
    ref = jcore.fedavg_aggregate(
        {k: jnp.stack([t[k] for t in trees]) for k in trees[0]}, jnp.asarray(weights))
    if stacked:
        states = {k: torch.from_numpy(np.stack([t[k] for t in trees])) for k in trees[0]}
    else:
        states = [{k: torch.from_numpy(v) for k, v in t.items()} for t in trees]
    got = core.fedavg_aggregate(states, weights)
    assert set(got) == set(ref)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6)
    for k in ("count", "flag"):  # integer tensors: the max, never an average
        assert got[k].dtype == torch.from_numpy(trees[0][k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_array_equal(got["count"].numpy(), np.max([t["count"] for t in trees], 0))
    # the weights are normalized: scaling them changes nothing
    again = core.fedavg_aggregate(states, weights * 7.0)
    np.testing.assert_allclose(again["w"].numpy(), got["w"].numpy(), rtol=1e-6)


def test_broadcast_tree_matches_jax():
    tree = {k: v for k, v in _trees(1, 1)[0].items()}
    ref = jcore.broadcast_tree({k: jnp.asarray(v) for k, v in tree.items()}, 3)
    got = core.broadcast_tree({k: torch.from_numpy(v) for k, v in tree.items()}, 3)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("num_clients,fraction", [(5, 1.0), (8, 0.5), (7, 0.3), (3, 0.01)])
def test_select_clients_keeps_the_reference_stream(num_clients, fraction):
    ours, theirs = random.Random(42), random.Random(42)
    for _ in range(10):
        assert core.select_clients(ours, num_clients, fraction) == jcore.select_clients(
            theirs, num_clients, fraction)


@pytest.mark.parametrize("embed_dim,num_classes", [(16, C), (256, 101)])
def test_comm_cost_of_the_same_mobilevit_matches_jax(embed_dim, num_classes):
    """model_mb over the port's state_dict (num_batches_tracked left out)
    equals the JAX formula over params + batch_stats; at 256/101 the
    MobileViT-S of configs/federated.yaml."""
    model = jeng.build_model(num_classes, embed_dim)
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 1, 32, 32, 3))),
                            jax.random.key(0))
    ref_total, ref_model = jcomm.estimate_comm_mb_per_round(
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]}, 5)
    state = teng.build_model(num_classes, embed_dim).state_dict()
    assert any(k.endswith("num_batches_tracked") for k in state)
    total, model_mb = comm_cost.estimate_comm_mb_per_round(state, 5)
    assert model_mb == pytest.approx(ref_model, abs=1e-9)
    assert total == pytest.approx(ref_total, abs=1e-9)
    assert comm_cost.model_size_bytes({"w": torch.zeros(1000)}) == 4000
    assert comm_cost.estimate_raw_upload_mb(10, clip_len=4, image_size=8) == pytest.approx(
        jcomm.estimate_raw_upload_mb(10, clip_len=4, image_size=8), abs=1e-12)


def _client_datasets(synth_data, cfg, module):
    return [module.dataset_from_cfg(cfg, synth_data[s], "supervised", seed=42 + i)
            for i, s in enumerate(("train", "val"))]


def test_round_sampler_is_bit_equal_to_jax(synth_data):
    cfg = {"seed": 42, "dataset": {"backend": "packed", "clip_len": 4, "stride": 2,
                                   "image_size": 32}}
    ours = run_federated._build_round_sampler(
        _client_datasets(synth_data, cfg, common), 3, 2, (4, 32), 42)
    theirs = jax_run_federated._build_round_sampler(
        _client_datasets(synth_data, cfg, jax_common), 3, 2, (4, 32), 42)
    for selected, rnd in (([0, 1], 1), ([1, 0], 2), ([1], 3)):
        (b, sizes), (rb, rsizes) = ours(selected, rnd), theirs(selected, rnd)
        np.testing.assert_array_equal(sizes, rsizes)
        assert set(b) == set(rb) == {"clip", "label", "valid"}
        for k in b:
            assert b[k].dtype == rb[k].dtype
            np.testing.assert_array_equal(b[k], rb[k])
    assert not b["valid"].all()  # ragged: the padded tail is masked


@pytest.mark.parametrize("axis_size", [1, 2, 4, 8])
def test_pad_clients_to_axis_matches_jax(axis_size):
    batches = {"clip": np.ones((3, 2, 5), np.uint8), "valid": np.ones((3, 2), bool)}
    sizes = np.array([1.0, 2.0, 3.0], np.float32)
    got, got_sizes, n = core.pad_clients_to_axis(batches, sizes, axis_size)
    ref, ref_sizes, ref_n = jcore.pad_clients_to_axis(batches, sizes, axis_size)
    assert n == ref_n == 3
    np.testing.assert_array_equal(got_sizes, ref_sizes)
    for k in batches:
        np.testing.assert_array_equal(got[k], ref[k])


# --- one FedAvg round against the JAX package's (mesh=None) ---

# 64x64 frames: the last stage's maps are 2x2, so its train-mode BatchNorm
# normalizes 16 values a channel. At 32x32 (1x1 maps, 4 values a channel)
# the JAX and port trajectories part within three steps (a client's loss
# 1.5% apart), an ill-conditioned problem, not a fault of either.
N, S, B, T, IMG = 2, 3, 2, 2, 64
LR, WD = 1e-4, 0.01
# JAX (flax's one-pass BatchNorm/LayerNorm variance, XLA's convs) and the
# port agree on a client step's loss to ~1e-6 and on its gradients to ~1e-4
# relative. AdamW's update is about lr * sign(g) per element, so where |g|
# is that small its sign is rounding noise in both, and elements whose
# gradient is zero in exact arithmetic (a per-channel shift straight into a
# train-mode BatchNorm, the key bias of attention) move by rounding noise
# alone. Measured at lr 1e-4: the clients' losses 1.7e-5 apart, BatchNorm
# statistics 1.9e-4, params (but those elements) 4e-6, each param's update
# 1.2e-3 (median) to 3.7e-2 (worst) of its norm. The noise elements are held
# to AdamW's step bound instead. (At lr 1e-3 the updates part further: 2e-2
# median, the later steps' losses 3e-4.)
ROUND_TOL = {"loss": 1e-4, "bn_stats": 1e-3, "params": 1e-4, "update_median": 1e-2,
             "update_worst": 1e-1}


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


def _round_inputs():
    """Client 0: a full step, a step with one padded row, a fully padded
    last step; client 1: three full steps. Sizes weigh them 3:6."""
    rng = np.random.default_rng(1)
    valid = np.ones((N, S, B), bool)
    valid[0, 1, 1] = False
    valid[0, 2] = False
    clips = rng.integers(0, 256, (N, S, B, T, IMG, IMG, 3), dtype=np.uint8)
    clips[~valid] = 0  # padded rows are zero clips, as the round sampler makes them
    return ({"clip": clips, "label": rng.integers(0, C, (N, S, B)).astype(np.int32),
             "valid": valid}, np.array([3.0, 6.0], np.float32))


def _port_round(variables, step_chunk=None):
    model = teng.build_model(C, 16)
    model.load_state_dict(classifier_state_dict_from_flax(variables))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    update = core.make_parallel_client_update(model, LR, WD, normalize_clip,
                                              step_chunk=step_chunk)
    batches, sizes = _round_inputs()
    return core.run_fedavg_round(update, start, batches, sizes)


def _jax_round(variables):
    model = jeng.build_model(C, 16)
    update = jcore.make_parallel_client_update(model, lr=LR, weight_decay=WD,
                                               normalize_fn=jax_normalize_clip, mesh=None)
    batches, sizes = _round_inputs()
    params, stats, losses = jcore.run_fedavg_round(update, variables["params"],
                                                   variables["batch_stats"], batches, sizes,
                                                   mesh=None)
    return (classifier_state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": params, "batch_stats": stats})), np.asarray(losses))


def _noise_elements(variables) -> dict:
    """Per param, the elements whose first-step gradient is below 1e-5 of
    the largest on both clients: zero in exact arithmetic."""
    model = teng.build_model(C, 16)
    model.load_state_dict(classifier_state_dict_from_flax(variables))
    batches, _ = _round_inputs()
    names, params = zip(*model.named_parameters())
    small = None
    for i in range(N):
        _, grads = core.client_loss_and_grads(
            model, params, normalize_clip(torch.from_numpy(batches["clip"][i, 0])),
            torch.from_numpy(batches["label"][i, 0]), torch.from_numpy(batches["valid"][i, 0]))
        top = max(float(g.abs().max()) for g in grads)
        mask = [g.abs() < 1e-5 * top for g in grads]
        small = mask if small is None else [a & b for a, b in zip(small, mask)]
    return dict(zip(names, small))


def test_fedavg_round_matches_jax():
    """Client 0 has a partly padded and a fully padded step, client 1 none;
    the aggregate weighs them 3:6. Losses, BatchNorm statistics and each
    param's update held to ROUND_TOL; integer tensors exact (the max)."""
    model = jeng.build_model(C, 16)
    variables = _perturb(jeng.init_model(model, jax.random.key(0), (B, T, IMG, IMG, 3)), 2)
    ref, ref_losses = _jax_round(variables)
    got, losses = _port_round(variables)
    start = classifier_state_dict_from_flax(variables)
    noise = _noise_elements(variables)
    assert set(got) == set(ref)
    np.testing.assert_allclose(losses.numpy(), ref_losses, rtol=ROUND_TOL["loss"])
    updates = {}
    for k, v in got.items():
        if not v.is_floating_point():  # num_batches_tracked: the max
            torch.testing.assert_close(v, ref[k], atol=0, rtol=0, msg=k)
        elif k.endswith(("running_mean", "running_var")):
            rel = float((v - ref[k]).norm() / ref[k].norm())
            assert rel <= ROUND_TOL["bn_stats"], (k, rel)
            assert not torch.equal(v, start[k]), k  # the round moved them
        else:
            real = ~noise[k]
            if real.any():
                rel = float((v - ref[k])[real].norm() / ref[k][real].norm())
                assert rel <= ROUND_TOL["params"], (k, rel)
                d_got, d_ref = (v - start[k])[real], (ref[k] - start[k])[real]
                updates[k] = float((d_got - d_ref).norm() / d_ref.norm())
            # the noise elements: at most about lr a step, 3 steps
            for side in (v, ref[k]):
                moved = (side - start[k])[~real].abs()
                assert not moved.numel() or float(moved.max()) <= 3.3 * LR, k
    ordered = sorted(updates.values())
    assert ordered[len(ordered) // 2] <= ROUND_TOL["update_median"], ordered
    assert ordered[-1] <= ROUND_TOL["update_worst"], max(updates.items(), key=lambda kv: kv[1])
    # the zero-gradient elements exist, and are few
    n_noise = sum(int(m.sum()) for m in noise.values())
    assert 0 < n_noise < 1e-2 * sum(m.numel() for m in noise.values())


def test_chunked_round_matches_unchunked():
    """step_chunk 2 does not divide S = 3; the fully padded tail step lands
    alone in the second chunk."""
    model = jeng.build_model(C, 16)
    variables = _perturb(jeng.init_model(model, jax.random.key(0), (B, T, IMG, IMG, 3)), 2)
    (whole, losses), (chunked, chunked_losses) = _port_round(variables), _port_round(variables, 2)
    assert set(whole) == set(chunked)
    for k, v in whole.items():
        if v.is_floating_point():
            np.testing.assert_allclose(chunked[k].numpy(), v.numpy(), rtol=3e-6, atol=1e-7,
                                       err_msg=k)
        else:
            torch.testing.assert_close(chunked[k], v, atol=0, rtol=0)
    np.testing.assert_allclose(chunked_losses.numpy(), losses.numpy(), rtol=3e-6)


def test_fully_padded_steps_change_nothing():
    """A client update over only fully padded steps runs no forward (its
    BatchNorm statistics stay), no optimizer step (the AdamW count stays 0)
    and adds no loss."""
    model = teng.build_model(C, 16)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    tx = make_optimizer(model.parameters(), LR, weight_decay=WD)
    clips = np.full((2, B, T, IMG, IMG, 3), 7, np.uint8)
    loss_sum, count = core.client_update(model, tx, normalize_clip, clips,
                                         np.zeros((2, B), np.int32), np.zeros((2, B), bool), 1)
    assert float(loss_sum) == 0.0 and float(count) == 0.0 and tx.count == 0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, start[k], atol=0, rtol=0, msg=k)


# --- the entry, through privacy/system_federated ---

def _entry_cfg(synth_data, tmp_path) -> dict:
    """configs/federated.yaml's schema at toy size: 2 clients of the
    fixture's 8 training clips (2 classes each), batch 3, so each client's
    second step is partly padded."""
    return {
        "seed": 42, "device": {"compute_dtype": "float32"},
        "dataset": {"backend": "packed", "train_split": synth_data["train"],
                    "val_split": synth_data["val"], "num_classes": C, "clip_len": 2,
                    "stride": 2, "image_size": 32},
        "model": {"embed_dim": 16, "init_ckpt": None},
        "federated": {"num_clients": 2, "rounds": 2, "client_fraction": 1.0,
                      "local_epochs": 1, "batch_size": 3, "step_chunk": None, "lr": 3e-4,
                      "weight_decay": 0.01,
                      "non_iid": {"shards_per_client": 2, "min_samples_per_client": 4}},
        "centralized": {"enabled": True, "epochs": 1, "batch_size": 3},
        "paths": {"split_root": str(tmp_path / "splits"), "log_dir": str(tmp_path / "logs")},
        "output": {"save_dir": str(tmp_path / "fed"), "split_prefix": "fed"},
        "system_privacy": {"estimate_raw_upload": True, "raw_dtype_bytes": 1},
    }


def test_federated_entry_writes_the_jax_csvs(synth_data, tmp_path):
    lines = []
    out = system_federated.run_federated_from_privacy(_entry_cfg(synth_data, tmp_path),
                                                      log=lines.append, device="cpu")
    assert (run_federated.FED_SUMMARY_FIELDS, run_federated.CENTRALIZED_FIELDS,
            run_federated.SYSTEM_PRIVACY_FIELDS) == (
        jax_run_federated.FED_SUMMARY_FIELDS, jax_run_federated.CENTRALIZED_FIELDS,
        jax_run_federated.SYSTEM_PRIVACY_FIELDS)
    d = tmp_path / "fed"
    headers = {name: list(read_csv_dicts(str(d / name))[0]) for name in (
        "fed_summary.csv", "centralized_summary.csv", "system_privacy_summary.csv",
        "fed_client_stats.csv")}
    assert headers["fed_summary.csv"] == list(jax_run_federated.FED_SUMMARY_FIELDS)
    assert headers["centralized_summary.csv"] == list(jax_run_federated.CENTRALIZED_FIELDS)
    assert headers["system_privacy_summary.csv"] == list(
        jax_run_federated.SYSTEM_PRIVACY_FIELDS)
    assert headers["fed_client_stats.csv"] == ["client", "num_samples", "num_classes", "classes"]
    rows = read_csv_dicts(out["fed_csv"])
    assert [int(r["round"]) for r in rows] == [1, 2] and rows == [
        {k: str(v) for k, v in r.items()} for r in out["records"]]
    # model_mb and comm_mb_round: the JAX formula over the same model
    model = jeng.build_model(C, 16)
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 1, 32, 32, 3))),
                            jax.random.key(0))
    total, model_mb = jcomm.estimate_comm_mb_per_round(
        {"params": shapes["params"], "batch_stats": shapes["batch_stats"]}, 2)
    for i, r in enumerate(rows, 1):
        assert float(r["model_mb"]) == round(model_mb, 6)
        assert float(r["comm_mb_round"]) == round(total, 6)
        assert float(r["comm_mb_total"]) == pytest.approx(i * total, abs=2e-6)
        assert np.isfinite(float(r["avg_local_loss"])) and 0 <= float(r["val_top1"]) <= 1
    sys_row = read_csv_dicts(str(d / "system_privacy_summary.csv"))[0]
    raw = jcomm.estimate_raw_upload_mb(8, 2, 32)
    assert float(sys_row["raw_upload_mb_est"]) == round(raw, 6)
    assert float(sys_row["reduction_ratio"]) == pytest.approx(2 * total / raw, abs=1e-6)
    # 4 clips a client at batch 3: 2 steps each, the second partly padded
    assert [m for m in lines if "local updates" in m][0].startswith(
        "[INFO] Round 1 local updates: 4 client steps in ")
    assert "[INFO] mesh: None (clients=2, devices=1)" in lines
    assert any(m.startswith("[INFO][Centralized] ep=1/1") for m in lines)


def test_federated_subprocess_runs_the_port_entry(synth_data, tmp_path):
    yaml = pytest.importorskip("yaml")
    cfg = _entry_cfg(synth_data, tmp_path)
    cfg["federated"]["rounds"] = 1
    cfg["centralized"]["enabled"] = False
    path = tmp_path / "fed.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert system_federated.run_federated_subprocess(str(path), base="", device="cpu") == 0
    rows = read_csv_dicts(str(tmp_path / "fed" / "fed_summary.csv"))
    assert [r["round"] for r in rows] == ["1"]
    assert not (tmp_path / "fed" / "centralized_summary.csv").exists()
