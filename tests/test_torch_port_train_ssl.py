"""The port's pipeline A (EMA teacher, VICReg, temporal order) against the
JAX package, in fp32 on the CPU, at toy widths: TemporalSSL over MobileViT-S
with a 16-wide embedding and one temporal block of 2 heads, B=4 clips of T=4
frames at 32x32.

Weights are the JAX package's, carried over by
``temporal_state_dict_from_flax`` after every param is moved off its init
and the BatchNorm statistics made non-trivial; the EMA teacher is another
such copy, so the teacher and the student differ. Random streams differ
across frameworks, so the step takes the JAX step's own draws (the key split
as the JAX step splits it: frame mask, TOP subsample, TOP labels).

Tolerances: eval-mode forwards 1e-5 of the largest entry; train-mode
forwards 1e-4 of it, as ``test_torch_port_train_step``'s train-mode
encoder: batch statistics over 16 frames in MobileViT's 30-odd BatchNorms
(down to 1x1 maps) amplify the rounding of sums taken in other orders
(about 1.5e-5 here); losses and metrics 1e-4 relative;
Adam's moments 1e-4 (gradients also 1e-4 of the largest in absolute terms);
Adam's first update is about lr * sign(g), so new params and EMA params are
compared where |g| exceeds 1e-4 of the largest, to 1e-4; BN statistics
1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl_vit_video_analytics_tpu.data.masking import frame_mask as jax_frame_mask
from ssl_vit_video_analytics_tpu.models.heads import ClassificationHead as JaxClsHead
from ssl_vit_video_analytics_tpu.models.heads import SSLMultiTaskHead as JaxMultiTaskHead
from ssl_vit_video_analytics_tpu.models.temporal import TemporalSSL as JaxTemporalSSL
from ssl_vit_video_analytics_tpu.train import losses as jlosses
from ssl_vit_video_analytics_tpu.train import ssl_engine as jeng
from ssl_vit_video_analytics_tpu.train import state as jstate
from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.data.masking import frame_mask
from ssl_vit_video_analytics_tpu_torch.entry import train_ssl
from ssl_vit_video_analytics_tpu_torch.models.heads import ClassificationHead, SSLMultiTaskHead
from ssl_vit_video_analytics_tpu_torch.models.temporal import TemporalSSL
from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as feng
from ssl_vit_video_analytics_tpu_torch.train import losses as tlosses
from ssl_vit_video_analytics_tpu_torch.train import ssl_engine as teng
from ssl_vit_video_analytics_tpu_torch.train import state as tstate
from ssl_vit_video_analytics_tpu_torch.utils.checkpoint import read_checkpoint, restore_checkpoint
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    flatten_variables, temporal_state_dict_from_flax, unflatten_variables)
from ssl_vit_video_analytics_tpu_torch.utils.io import read_csv_dicts

torch.set_num_threads(2)  # six test workers share the host

B, T, S = 4, 4, 32
D, LAYERS, HEADS = 16, 1, 2
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
NET_TOL = dict(atol=1e-4, rtol=1e-4)
SSL_CFG = {"mask_ratio": 0.5, "mfm_weight": 1.0, "var_weight": 25.0, "var_target_std": 1.0,
           "var_eps": 1e-4, "top_weight": 1.0, "top_subsample": 0.5,
           "top_detach_backbone": False, "ema_momentum": 0.9}
LR, CLIP = 1e-3, 1.0


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


def _jax_model():
    return JaxTemporalSSL(embed_dim=D, layers=LAYERS, heads=HEADS, clip_len=T)


@pytest.fixture(scope="module")
def variables():
    """(student variables, EMA params), both perturbed, as numpy trees."""
    model = _jax_model()
    v = jax.jit(lambda k: model.init(k, jnp.zeros((B, T, S, S, 3)), method="init_all"))(
        jax.random.key(0))
    student = _perturb(v, 1)
    ema = _perturb({"params": v["params"]}, 2)["params"]
    return student, ema


def _port(v) -> TemporalSSL:
    model = TemporalSSL(D, LAYERS, HEADS, clip_len=T)
    model.load_state_dict(temporal_state_dict_from_flax(v))
    return model


def _clip(seed):
    return np.random.default_rng(seed).standard_normal((B, T, S, S, 3), dtype=np.float32)


def _mask(seed):
    return np.asarray(jax_frame_mask(jax.random.key(seed), B, T, SSL_CFG["mask_ratio"]))


@pytest.fixture(scope="module")
def jax_forwards(variables):
    """forward_tokens, predictor and top_logits of the JAX model in eval and
    train mode, with and without a mask (one compile), and the BatchNorm
    statistics after the train-mode forward and predictor."""
    model, (v, _) = _jax_model(), variables
    clip, mask = _clip(3), _mask(4)

    def run(v, clip, mask):
        out = {}
        for train in (False, True):
            for masked in (False, True):
                m = mask if masked else None
                if train:
                    ctx, mut = model.apply(v, clip, m, train=True, method="forward_tokens",
                                           mutable=["batch_stats"])
                    pred, mut = model.apply({"params": v["params"], **mut},
                                            ctx.reshape(B * T, D), train=True,
                                            method="predictor", mutable=["batch_stats"])
                    stats = mut["batch_stats"]
                else:
                    ctx = model.apply(v, clip, m, train=False, method="forward_tokens")
                    pred = model.apply(v, ctx.reshape(B * T, D), train=False, method="predictor")
                    stats = v["batch_stats"]
                out[f"{train}-{masked}"] = (ctx, pred, model.apply(v, ctx, method="top_logits"),
                                            stats)
        return out

    out = jax.jit(run)(v, jnp.asarray(clip), jnp.asarray(mask))
    return clip, mask, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_temporal_ssl_forward_predictor_and_top_match_jax(variables, jax_forwards, train, masked):
    v, _ = variables
    clip, mask, ref = jax_forwards
    ctx_ref, pred_ref, top_ref, stats_ref = ref[f"{train}-{masked}"]
    model = _port(v).train(train)
    with torch.no_grad():
        ctx = model(torch.from_numpy(clip), torch.from_numpy(mask) if masked else None)
        pred = model.predictor(ctx.reshape(B * T, D))
        top = model.top_logits(ctx)
    for got, want in ((ctx, ctx_ref), (pred, pred_ref), (top, top_ref)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   **(NET_TOL if train else FWD_TOL))
    want = temporal_state_dict_from_flax({"params": v["params"], "batch_stats": stats_ref})
    for key, t in model.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[key].numpy(), **NET_TOL, err_msg=key)


def test_temporal_converter_fills_every_tensor_and_refuses_strays(variables):
    student, _ = variables
    sd = temporal_state_dict_from_flax(student)
    assert set(sd) == set(TemporalSSL(D, LAYERS, HEADS, clip_len=T).state_dict())
    assert {"pos", "mask_token", "temporal.blocks.0.attn.qkv.weight", "predictor_bn1.running_var",
            "top_head.weight", "encoder.mvit3.tblocks.1.mlp.fc2.bias"} <= set(sd)
    stray = {"params": dict(student["params"], extra=np.zeros(3)),
             "batch_stats": student["batch_stats"]}
    with pytest.raises(KeyError, match="extra"):
        temporal_state_dict_from_flax(stray)
    missing = {"params": {k: v for k, v in student["params"].items() if k != "top_head"},
               "batch_stats": student["batch_stats"]}
    with pytest.raises(KeyError, match="top_head"):
        temporal_state_dict_from_flax(missing)


def test_ssl_losses_match_jax():
    rng = np.random.default_rng(5)
    p, z = (rng.standard_normal((B, T, D), dtype=np.float32) for _ in range(2))
    rows = rng.standard_normal((3 * B, D), dtype=np.float32) * 0.5
    mask = _mask(6)
    pt, zt = torch.from_numpy(p), torch.from_numpy(z)
    assert float(tlosses.cosine_loss(pt, zt)) == pytest.approx(
        float(jlosses.cosine_loss(p, z)), rel=1e-5)
    for target_std, eps in ((1.0, 1e-4), (0.3, 1e-2)):
        assert float(tlosses.variance_loss(torch.from_numpy(rows), target_std, eps)) == \
            pytest.approx(float(jlosses.variance_loss(rows, target_std, eps)), rel=1e-5)
    pn, zn = p / np.linalg.norm(p, axis=-1, keepdims=True), z / np.linalg.norm(z, axis=-1,
                                                                              keepdims=True)
    assert float(teng.masked_cosine_loss(torch.from_numpy(pn), torch.from_numpy(zn),
                                         torch.from_numpy(mask))) == pytest.approx(
        float(jeng.masked_cosine_loss(pn, zn, mask)), rel=1e-5)
    assert float(teng.masked_variance_loss(torch.from_numpy(pn), torch.from_numpy(mask))) == \
        pytest.approx(float(jeng.masked_variance_loss(pn, mask)), rel=1e-5)


def test_perm_table_and_4way_permutation_match_jax():
    for n in (1, 2, 3, 4, 7, 32):
        np.testing.assert_array_equal(teng.perm_table_4way(n), jeng.perm_table_4way(n))
    clip = _clip(7)
    key = jax.random.key(8)
    ref, labels = jeng.permute_frames_4way(key, jnp.asarray(clip))
    got, got_labels = teng.permute_frames_4way(None, torch.from_numpy(clip),
                                               torch.from_numpy(np.asarray(labels)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(labels))
    drawn, drawn_labels = teng.permute_frames_4way(torch.Generator().manual_seed(0),
                                                   torch.from_numpy(clip))
    table = teng.perm_table_4way(T)
    for b, lab in enumerate(drawn_labels.tolist()):
        np.testing.assert_array_equal(drawn[b].numpy(), clip[b][table[lab]])


@pytest.mark.parametrize("t,ratio", [(4, 0.5), (4, 0.625), (4, 0.875), (4, 0.1), (32, 0.75),
                                     (6, 0.25), (10, 0.25)])
def test_frame_mask_counts_match_jax(t, ratio):
    """max(1, round(T*ratio)) masked frames per clip, Python's round (half
    to even: 2.5 -> 2, 1.5 -> 2) as the JAX function."""
    got = frame_mask(torch.Generator().manual_seed(9), 5, t, ratio)
    ref = np.asarray(jax_frame_mask(jax.random.key(9), 5, t, ratio))
    assert got.shape == (5, t) and got.dtype == torch.bool
    assert got.sum(1).tolist() == ref.sum(1).tolist() == [max(1, round(t * ratio))] * 5
    assert got.equal(frame_mask(torch.Generator().manual_seed(9), 5, t, ratio))


def test_heads_match_jax():
    rng = np.random.default_rng(10)
    fmap = rng.standard_normal((3, 2, 2, D), dtype=np.float32)
    jhead = JaxClsHead(num_classes=5)
    hv = jax.tree.map(np.asarray, jhead.init(jax.random.key(11), jnp.asarray(fmap)))
    head = ClassificationHead(D, 5)
    head.fc.weight.data = torch.from_numpy(hv["params"]["Dense_0"]["kernel"].T.copy())
    head.fc.bias.data = torch.from_numpy(hv["params"]["Dense_0"]["bias"])
    for x in (fmap, fmap.mean(axis=(1, 2))):
        np.testing.assert_allclose(head(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(jhead.apply(hv, jnp.asarray(x))), **FWD_TOL)

    tokens, targets = (rng.standard_normal((B, T, D), dtype=np.float32) for _ in range(2))
    mask, pairs = _mask(12), rng.integers(0, T, (B, 2)).astype(np.int32)
    labels = rng.integers(0, 2, B).astype(np.int32)
    jmt = JaxMultiTaskHead(embed_dim=D, mfm_weight=0.5, order_weight=2.0)
    args = tuple(jnp.asarray(a) for a in (tokens, targets, mask, pairs, labels))
    mv = jax.tree.map(np.asarray, jmt.init(jax.random.key(13), *args))
    ref = jax.tree.map(float, jmt.apply(mv, *args))
    mt = SSLMultiTaskHead(D, mfm_weight=0.5, order_weight=2.0)
    for flax_name, layer in (("Dense_0", mt.fc1), ("Dense_1", mt.fc2), ("Dense_2", mt.order)):
        layer.weight.data = torch.from_numpy(mv["params"][flax_name]["kernel"].T.copy())
        layer.bias.data = torch.from_numpy(mv["params"][flax_name]["bias"])
    got = mt(*(torch.from_numpy(a) for a in (tokens, targets, mask, pairs, labels)))
    for key in ("loss", "mfm", "order"):
        assert float(got[key]) == pytest.approx(ref[key], rel=1e-5), key


def _adam_state(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


@pytest.mark.parametrize("with_top", [False, True], ids=["plain", "top"])
def test_one_step_matches_make_ssl_step(variables, with_top):
    """One fp32 step of each variant with the JAX step's draws: loss and
    metrics, Adam's moments (the clipped gradient), new params, new EMA
    params and the BatchNorm statistics moved by the student, the predictor
    and (with TOP) the TOP branch in that order."""
    student, ema = variables
    clip = np.random.default_rng(14).integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    key = jax.random.key(15)
    k_mask, k_sel, k_perm, _, _ = jax.random.split(key, 5)  # as make_ssl_step splits
    mask = np.asarray(jax_frame_mask(k_mask, B, T, SSL_CFG["mask_ratio"]))
    k = max(2, int(B * SSL_CFG["top_subsample"]))
    sel = np.asarray(jax.random.permutation(k_sel, B)[:k])
    labels = np.asarray(jax.random.randint(k_perm, (k,), 0, 4))

    jtx = jstate.make_optimizer(LR, grad_clip=CLIP)
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, student["params"]), jtx,
                                    batch_stats=jax.tree.map(jnp.asarray,
                                                             student["batch_stats"]),
                                    ema_params=jax.tree.map(jnp.asarray, ema))
    new, jm = jeng.make_ssl_step(_jax_model(), jtx, SSL_CFG, with_top=with_top)(
        jst, {"clip": jnp.asarray(clip)}, key)
    bs = jax.tree.map(np.asarray, new.batch_stats)

    def as_port(params):
        return temporal_state_dict_from_flax({"params": jax.tree.map(np.asarray, params),
                                              "batch_stats": bs})

    adam = _adam_state(new.opt_state)
    ref_grads = {n: v / 0.1 for n, v in as_port(adam.mu).items()}
    ref_nu, ref_new, ref_ema = as_port(adam.nu), as_port(new.params), as_port(new.ema_params)

    model = _port(student)
    tx = tstate.make_optimizer(model.parameters(), LR, grad_clip=CLIP)
    ema_sd = temporal_state_dict_from_flax({"params": ema, "batch_stats": student["batch_stats"]})
    state = tstate.create_train_state(
        model, tx, ema={n: ema_sd[n].clone() for n, _ in model.named_parameters()})
    step = teng.make_ssl_step(model, SSL_CFG, with_top=with_top)
    state, m = step(state, {"clip": torch.from_numpy(clip)}, torch.Generator().manual_seed(0),
                    mask=torch.from_numpy(mask), top_sel=torch.from_numpy(sel).long(),
                    top_labels=torch.from_numpy(labels).long())
    assert state.step == 1
    assert set(m) == set(jm) == ({"loss", "mfm", "var", "top"} if with_top
                                 else {"loss", "mfm", "var"})
    for name in jm:
        assert float(m[name]) == pytest.approx(float(jm[name]), rel=1e-4), name

    opt = tstate.adamw_of(tx).opt
    gmax = max(float(np.abs(g.numpy()).max()) for g in ref_grads.values())
    for name, p in model.named_parameters():
        st = opt.state[p]
        np.testing.assert_allclose((st["exp_avg"] / 0.1).numpy(), ref_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * gmax, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), ref_nu[name].numpy(),
                                   rtol=1e-3, atol=1e-8 * gmax ** 2, err_msg=name)
        sure = np.abs(ref_grads[name].numpy()) > 1e-4 * gmax
        for got, want in ((p.detach(), ref_new[name]), (state.ema[name], ref_ema[name])):
            np.testing.assert_allclose(got.numpy()[sure], want.numpy()[sure], **NET_TOL,
                                       err_msg=name)
    for key_, t in model.state_dict().items():
        if key_.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), ref_new[key_].numpy(), **NET_TOL, err_msg=key_)


def test_entry_trains_and_its_checkpoint_loads_into_the_mobilevit_classifier(tmp_path):
    """Two epochs on a synthetic split, TOP on from epoch 1 every second
    step: ssl_metrics.csv with the JAX header, and an ``ssl_epoch_{e}``
    checkpoint (student, EMA, optimizer, step and epoch) whose ``encoder.*``
    tensors fill the port's MobileViT classifier with no key missing or
    extra."""
    splits = make_synthetic_dataset(str(tmp_path / "data"), num_classes=2, videos_per_class=3,
                                    num_frames=10, image_size=S, seed=0)
    save_dir = tmp_path / "out"
    cfg = {"seed": 0, "device": {"name": "cpu", "compute_dtype": "bfloat16"},
           "dataset": {"train_split": splits["train"], "clip_len": T, "stride": 2,
                       "image_size": S, "backend": "packed"},
           "model": {"embed_dim": D, "temporal_layers": LAYERS, "temporal_heads": HEADS},
           "ssl_objectives": dict(SSL_CFG, top_start_epoch=1, top_every=2),
           "training": {"epochs": 2, "batch_size": 2, "learning_rate": 1e-3,
                        "weight_decay": 0.05, "clip_grad_norm": 1.0, "save_every": 1,
                        "save_dir": str(save_dir), "log_interval": 1,
                        "scheduler": {"enable": True, "warmup_epochs": 1,
                                      "eta_min_ratio": 0.05}}}
    lines, seen = [], []
    out = train_ssl.run(cfg, log=lines.append,
                        on_step=lambda i, st, m: seen.append((i, st.step, "top" in m)))
    assert out["steps"] == 4 and seen == [(1, 1, False), (2, 2, True), (3, 3, False),
                                          (4, 4, True)]
    assert any(ln.startswith("[INFO] ep=1 step=2/2 ") and " top=" in ln
               and ln.endswith("(top_on=Y every=2)") for ln in lines)
    with open(save_dir / "ssl_metrics.csv") as f:
        assert f.readline().strip() == "epoch,total,mfm,var,top"
    rows = read_csv_dicts(str(save_dir / "ssl_metrics.csv"))
    assert [r["epoch"] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r[k])) and float(r["top"]) > 0 for r in rows
               for k in ("total", "mfm", "var", "top"))

    ckpt = str(save_dir / "ssl_epoch_2")
    blob = restore_checkpoint(ckpt)
    assert blob["step"] == 4 and blob["epoch"] == 2 and blob["has_opt_state"]
    assert {"ema.pos", "ema.encoder.stem.conv.weight", "opt.count",
            "predictor_bn1.running_var"} <= set(blob)
    assert not torch.equal(blob["ema.pos"], blob["pos"])
    clf = feng.build_model(num_classes=3, embed_dim=D, backbone="mobilevit_s")
    feng.load_pretrained_ssl(clf, read_checkpoint(ckpt))
    enc = {k[len("encoder."):]: v for k, v in blob.items() if k.startswith("encoder.")}
    assert set(enc) == set(clf.backbone.state_dict())
    for k, v in clf.backbone.state_dict().items():
        assert torch.equal(v, enc[k]), k
