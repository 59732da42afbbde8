"""K1/K2 at every head dim the JAX kernels take, on the CPU: the port's
plain forward and backward against the JAX package's Pallas kernels
(interpret mode) and ``_sdpa_xla`` at head dims past the models' defaults,
up to 512 (above 256 the card runs the wide kernels), the wrapper's checks
(every d passes; only a grid overflow raises) and staging rules, the width
table against the CUDA sources, one pipeline-B step with the decoder
repacked to 3 heads of 128 and to 1 of 384 against JAX's
``make_pixel_mae_step``, and the ported repack probe at toy widths.

Tolerances: as tests/test_torch_port_attention.py (forward, 2e-5) and
tests/test_torch_port_attention_bwd.py (gradients, 5e-5), fp32 sums in other
orders; the step as tests/test_torch_port_train_step.py (1e-4).
"""
import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssl_vit_video_analytics_tpu.data.masking import get_tube_mask as jax_tube_mask
from ssl_vit_video_analytics_tpu.models.mae import TinyVideoMAE as JaxMAE
from ssl_vit_video_analytics_tpu.models.tiny_vit import TinyViT as JaxTinyViT
from ssl_vit_video_analytics_tpu.ops.attention import _sdpa_xla
from ssl_vit_video_analytics_tpu.ops.flash_attention import (
    flash_attention_packed as jax_flash_packed)
from ssl_vit_video_analytics_tpu.train import mae_engine as jeng
from ssl_vit_video_analytics_tpu.train import state as jstate
from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_hard_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae
from ssl_vit_video_analytics_tpu_torch.models.mae import TinyVideoMAE
from ssl_vit_video_analytics_tpu_torch.models.tiny_vit import TinyViT
from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa
from ssl_vit_video_analytics_tpu_torch.scripts import probe_decoder_repack as probe
from ssl_vit_video_analytics_tpu_torch.train import mae_engine as teng
from ssl_vit_video_analytics_tpu_torch.train import state as tstate
from ssl_vit_video_analytics_tpu_torch.utils.config import merge_configs
from ssl_vit_video_analytics_tpu_torch.utils.convert import (
    flatten_variables, mae_state_dict_from_flax, unflatten_variables)

torch.set_num_threads(2)  # six test workers share the host

CSRC = Path(fa.__file__).resolve().parent / "csrc"
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
BWD_TOL = dict(atol=5e-5, rtol=5e-5)
# below, between and at the widths the kernels are built for: the narrow
# heads, a d staged element by element (20), pipeline A's temporal head at
# embed 384 (96), the decoder repack (128) and the widest (256); then the
# wide kernels' head dims: just past 256, one staged element by element
# (300), and the one-head decoders of pipelines B (384) and C (512)
HEAD_DIMS = (16, 20, 24, 80, 96, 128, 256, 257, 300, 384, 512)


def _inputs(seed, B, Lq, Lk, H, d):
    rng = np.random.default_rng(seed)
    shapes = ((B, Lq, H * d), (B, Lk, H * d), (B, Lk, H * d), (B, Lq, H * d))
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_forward_matches_jax_flash_and_xla(d):
    B, Lq, Lk, H = 2, 37, 70, 2
    q, k, v, _ = _inputs(d, B, Lq, Lk, H, d)
    ref_pallas = np.asarray(jax.jit(jax_flash_packed, static_argnums=3)(q, k, v, H))
    split = lambda x: x.reshape(x.shape[0], x.shape[1], H, d)  # noqa: E731
    ref_xla = np.asarray(_sdpa_xla(split(q), split(k), split(v))).reshape(B, Lq, H * d)
    out, lse = fa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), H)
    np.testing.assert_allclose(out.numpy(), ref_pallas, **FWD_TOL)
    np.testing.assert_allclose(out.numpy(), ref_xla, **FWD_TOL)
    # lse of the logits scaled by 1/sqrt(d) of the real d, as JAX's d_real
    s = np.einsum("blhd,bmhd->bhlm", split(q).astype(np.float64),
                  split(k).astype(np.float64)) / math.sqrt(d)
    ref_lse = np.log(np.exp(s).sum(-1)).transpose(0, 2, 1)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **FWD_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_backward_matches_jax_vjp_and_xla(d):
    B, Lq, Lk, H = 1, 45, 30, 2
    q, k, v, dout = _inputs(100 + d, B, Lq, Lk, H, d)
    _, vjp = jax.vjp(jax.jit(lambda a, b, c: jax_flash_packed(a, b, c, H)), q, k, v)
    ref_pallas = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    def xla(a, b, c):
        split = lambda x: x.reshape(x.shape[0], x.shape[1], H, d)  # noqa: E731
        return _sdpa_xla(split(a), split(b), split(c)).reshape(B, Lq, H * d)

    _, vjp_x = jax.vjp(jax.jit(xla), q, k, v)
    ref_xla = [np.asarray(g) for g in vjp_x(jnp.asarray(dout))]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(tq, tk, tv, H)
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, H)
    for g, rp, rx, name in zip(grads, ref_pallas, ref_xla, "qkv"):
        np.testing.assert_allclose(g.numpy(), rp, **BWD_TOL, err_msg=f"d{name} vs Pallas")
        np.testing.assert_allclose(g.numpy(), rx, **BWD_TOL, err_msg=f"d{name} vs XLA")


def test_wrapper_takes_every_head_dim_up_to_256():
    """Every d in 1..1024 passes the kernels' checks, up to 256 and past it
    (the wide kernels), in both dtypes; at each d only a grid of 2^31 CTAs
    or more raises: B = 2^19 with L = 2^16 overflows at d = 1024 (2 column
    groups of 32-row tiles), and B = 2^14 does not."""
    for d in range(1, 1025):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.zeros(1, 3, 2 * d, dtype=dtype)
            assert fa._check_kernel_args(x, x, x, 2)[-1] == d
    assert fa.grid_ctas(2**14, 2**16, 1, 1024) < 2**31 <= fa.grid_ctas(2**19, 2**16, 1, 1024)
    fits = torch.zeros(1, 1, 1024).expand(2**14, 2**16, 1024)
    assert fa._check_kernel_args(fits, fits, fits, 1)[-1] == 1024
    big = torch.zeros(1, 1, 1024).expand(2**19, 2**16, 1024)
    with pytest.raises(ValueError, match="at head dim 1024 exceeds the kernel grid"):
        fa._check_kernel_args(big, big, big, 1)


def test_batches_past_65535_pass_the_grid_check():
    """(tile, head, batch row) fold into grid.x: B = 65536 passes; a launch
    past 2^31 - 1 CTAs raises."""
    x = torch.zeros(65536, 5, 64)
    assert fa._check_kernel_args(x, x, x, 2)[0] == 65536
    big = torch.zeros(1, 1, 8).expand(2**20, 2**14, 8)
    with pytest.raises(ValueError, match="exceeds the kernel grid"):
        fa._check_kernel_args(big, big, big, 1)


@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 64, 96, 128, 256])
def test_fused_qkv_thirds_stage_in_16_byte_copies(d):
    """Where d is a multiple of 8 the bf16 thirds of a fused qkv pass the
    16-byte alignment and stage by cp.async; the wrapper copies nothing."""
    H = 3
    qkv = torch.zeros(2, 17, 3 * H * d, dtype=torch.bfloat16)
    hd = H * d
    thirds = dict(q=qkv[..., :hd], k=qkv[..., hd:2 * hd], v=qkv[..., 2 * hd:])
    assert fa._check_staging(d, torch.bfloat16, **thirds)
    assert not fa._check_staging(d, torch.float32, **thirds)
    offset = torch.zeros(2, 17, hd + 1, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_staging(d, torch.bfloat16, q=offset, k=offset, v=offset)


@pytest.mark.parametrize("d", [1, 7, 12, 20, 100, 130, 250])
def test_other_head_dims_stage_element_by_element(d):
    """A d that is not a multiple of 8 puts the thirds at offsets of h*d*2
    bytes: the kernels stage them element by element, and nothing raises or
    is copied."""
    H = 3
    qkv = torch.zeros(2, 17, 3 * H * d, dtype=torch.bfloat16)
    hd = H * d
    thirds = dict(q=qkv[..., :hd], k=qkv[..., hd:2 * hd], v=qkv[..., 2 * hd:])
    assert not fa._check_staging(d, torch.bfloat16, **thirds)
    load_tile = re.search(r"void load_tile\(.*?\n\}", (CSRC / "flash_mma.cuh").read_text(),
                          re.S).group(0)
    assert "if ((d & 7) == 0) {" in load_tile  # cp.async chunks only where d % 8 == 0


def test_kernel_widths_match_the_cuda_sources():
    """The wrapper's width table is the CUDA sources': flash_mma.cuh's
    kernel_width() (each d to the least width that holds it) and the
    instantiations that both entry points dispatch to; every wider d goes
    to the wide kernels, whose chunk is the wrapper's WIDE_COLS."""
    header = (CSRC / "flash_mma.cuh").read_text()
    body = re.search(r"constexpr int kernel_width\(int d\) \{(.*?)\}", header, re.S).group(1)
    limit = int(re.search(r"constexpr int kMaxHeadDim = (\d+);", header).group(1))
    steps = [int(n) for n in re.findall(r"d <= (\d+) \? \1", body)]
    assert "d <= kMaxHeadDim ? kMaxHeadDim" in body
    assert tuple(steps + [limit]) == fa.KERNEL_WIDTHS
    assert int(re.search(r"constexpr int kWideCols = (\d+);", header).group(1)) == fa.WIDE_COLS
    for source in ("flash_fwd.cu", "flash_bwd.cu"):
        text = (CSRC / source).read_text()
        cases = re.findall(r"case (\d+): return launch<\1>", text)
        assert tuple(int(c) for c in cases) == fa.KERNEL_WIDTHS, source
        assert re.search(r"default:\s+return head_dim > flash_mma::kMaxHeadDim \? "
                         r"launch_wide\(dtype, a\)", text), source


@pytest.mark.parametrize("d", [300, 384, 512, 1024])
def test_grid_ctas_holds_the_wide_launchers_geometry(d):
    """Above d = 256 grid_ctas is the most CTAs that any wide launch puts in
    grid.x, read from the CUDA sources: every grid_x(L, rows, groups) of both
    launch_wide()s, rows per tile their constants, one CTA per column group
    of kGroupChunks chunks of kWideCols columns (wide_groups)."""
    header = (CSRC / "flash_mma.cuh").read_text()
    cols = int(re.search(r"constexpr int kWideCols = (\d+);", header).group(1))
    group = int(re.search(r"constexpr int kGroupChunks = (\d+);", header).group(1))
    assert cols * group == fa.WIDE_GROUP
    assert re.search(r"wide_chunks\(int d\) \{ return \(d \+ kWideCols - 1\) / kWideCols; \}",
                     header)
    assert re.search(r"wide_groups\(int d\) \{\s*return \(wide_chunks\(d\) \+ kGroupChunks - 1\) "
                     r"/ kGroupChunks;", header)
    rows = []
    for source in ("flash_fwd.cu", "flash_bwd.cu"):
        text = (CSRC / source).read_text()
        consts = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
        body = re.search(r"int launch_wide\(int dtype, const Args& a\) \{(.*?)\n\}", text,
                         re.S).group(1)
        assert "const int groups = wide_groups(a.d);" in body, source
        calls = re.findall(r"grid_x\(a\.L[qk], (\w+), (?:a, groups|groups, a)\)", body)
        assert len(calls) == body.count("grid_x("), source  # every launch by its group count
        rows += [consts[name] for name in calls]
    assert sorted(set(rows)) == [32, 64] and min(rows) == fa.WIDE_TILE_ROWS
    groups = -(-(-(-d // cols)) // group)
    assert groups == (2 if d == 1024 else 1)
    for B, L, H in ((1, 1, 1), (4, 3136, 1), (16, 288, 2), (3, 65, 5), (2**19, 2**16, 1)):
        assert fa.grid_ctas(B, L, H, d) == max(-(-L // r) * groups * H * B for r in rows)


# --- one pipeline-B step with the decoder as 3 heads of 128 or 1 of 384 -----

B, T, S = 2, 4, 32
L = (S // 8) ** 2
DIMS, DEPTHS, HEADS = (8, 16, 24, 32), (1, 1, 1, 1), (1, 2, 2, 2)


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


@pytest.mark.parametrize("heads", [3, 1])
def test_pipeline_b_step_with_the_d128_decoder_matches_jax(heads):
    """The decoder 384 wide with 3 heads (d = 128) or 1 (d = 384: the wide
    kernels on the card) and one block, fp32, the JAX tube mask injected:
    loss, gradient norm, prediction std and every gradient (Adam's first
    moment over 1 - b1) as JAX's step gives them."""
    jax_model = JaxMAE(encoder=JaxTinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS,
                                          use_checkpoint=False, drop_path_rate=0.0),
                       clip_len=T, img_size=S, patch_size=8, decoder_embed_dim=384,
                       decoder_depth=1, decoder_num_heads=heads)
    variables = _perturb(jax.jit(lambda k: jax_model.init(
        k, jnp.zeros((B, T, S, S, 3)), jnp.zeros((B, T, L), bool)))(jax.random.key(0)), 1)
    clip = np.random.default_rng(13).integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
    key = jax.random.key(14)
    jtx = jeng.wrap_accum_and_skip(jstate.make_optimizer(1e-3), accum_steps=1)
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, variables["params"]), jtx,
                                    batch_stats=jax.tree.map(jnp.asarray,
                                                             variables["batch_stats"]))
    new_jst, jm = jeng.make_pixel_mae_step(jax_model, jtx, mask_ratio=0.75)(
        jst, {"clip": jnp.asarray(clip)}, key)
    adam = [s for s in jax.tree_util.tree_leaves(
        new_jst.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    ref_grads = {k: v.numpy() / 0.1 for k, v in mae_state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, adam.mu),
         "batch_stats": new_jst.batch_stats}).items()}

    port = TinyVideoMAE(TinyViT(embed_dims=DIMS, depths=DEPTHS, num_heads=HEADS,
                                drop_path_rate=0.0, use_checkpoint=True, num_stages=3),
                        clip_len=T, img_size=S, decoder_embed_dim=384, decoder_depth=1,
                        decoder_num_heads=heads)
    assert port.decoder.blocks[0].attn.num_heads == heads
    port.load_state_dict(mae_state_dict_from_flax(variables))
    tx = teng.wrap_accum_and_skip(tstate.make_optimizer(port.parameters(), 1e-3), 1)
    state = tstate.create_train_state(port, tx)
    k_mask, _ = jax.random.split(key)  # as make_pixel_mae_step splits its key
    mask = torch.from_numpy(np.array(jax_tube_mask(k_mask, B, T, L, 0.75)))
    state, m = teng.make_pixel_mae_step(port, mask_ratio=0.75)(
        state, {"clip": torch.from_numpy(clip)}, torch.Generator().manual_seed(0), mask=mask)
    for name in ("loss", "grad_norm", "pred_std"):
        assert float(m[name]) == pytest.approx(float(jm[name]), rel=1e-4), name
    opt = tstate.adamw_of(tx).opt
    gmax = max(float(np.abs(g).max()) for g in ref_grads.values())
    for name, p in port.named_parameters():
        np.testing.assert_allclose((opt.state[p]["exp_avg"] / 0.1).numpy(), ref_grads[name],
                                   rtol=1e-4, atol=1e-4 * gmax, err_msg=name)


# --- the ported repack probe -------------------------------------------------

def test_repack_probe_runs_both_arms_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The probe's compare() at toy widths (one encoder block a stage,
    dims 24/48/96, the decoder 384 wide and 1 deep), 32x32 clips, 2 steps:
    both arms print their lines with finite losses, then the summary; the
    6x64 and 3x128 arms start from the same weights, so their first losses
    are near each other."""
    make_hard_synthetic_dataset(str(tmp_path), num_classes=2, videos_per_class=2,
                                num_frames=4, image_size=32)
    clips = probe.load_clips(str(tmp_path), image_size=32)
    assert clips.shape == (4, 4, 32, 32, 3) and clips.dtype == np.uint8
    monkeypatch.setattr(train_ssl_mae, "tiny_vit_21m_variant",
                        functools.partial(train_ssl_mae.tiny_vit_21m_variant,
                                          depths=(1, 1, 1, 1)))
    out = probe.compare(clips, batch=2, steps=2, device=torch.device("cpu"),
                        embed_dims=(24, 48, 96, 576), decoder_depth=1)
    text = capsys.readouterr().out
    for heads, d in ((6, 64), (3, 128)):
        line = re.search(rf"\[heads={heads} d={d}\] ([\d.]+) ms/step \(([\d.]+) clips/s\) "
                         r"loss (\S+) -> (\S+)", text)
        assert line, text
        assert all(math.isfinite(float(x)) for x in line.groups()), line.group(0)
    assert "step time: 6x64" in text and "trajectory deviation" in text
    assert np.isfinite(out["losses_6x64"]).all() and np.isfinite(out["losses_3x128"]).all()
    assert out["losses_6x64"].shape == out["losses_3x128"].shape == (2,)
    assert out["max_rel_dev"] < 0.5
    if not torch.cuda.is_available():  # the refusal off the card stays, as in JAX
        with pytest.raises(SystemExit, match="chip-only probe"):
            probe.main(["--data", str(tmp_path)])


# --- chip_smoke.py's phases 3-4 and 32 -----------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _flat(cfg, prefix=""):
    out = {}
    for key, value in cfg.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def test_chip_smoke_holds_every_width_and_runs_the_repack_as_a_user_would():
    """Phases 3-4 hold K1/K2 at a shape of every head dim the acceptance
    names, the one-head decoders of pipelines B and C among them, and
    build a bf16 kernel of each width and the wide ones; each of phase 32's
    runs is phase 6's with --set model.decoder_num_heads=3 or =1 and
    nothing else, and its calls by head dim add up to the pipeline-B
    step's; phase 14's one-head pipeline-C decoder is d = 512."""
    cs = _chip_smoke()
    dims = {shape[5] for shape in cs.KERNEL_SHAPES}
    assert {16, 20, 24, 32, 40, 48, 64, 80, 96, 128, 256, 300, 384, 512, 1024} <= dims
    for shape in (("mae_decoder_h3", 4, 3136, 3136, 3, 128), ("temporal_d96", 48, 32, 32, 4, 96),
                  ("mae_decoder_h1", 4, 3136, 3136, 1, 384),
                  ("token_mae_decoder_h1", 16, 288, 288, 1, 512)):
        assert shape in cs.KERNEL_SHAPES, shape
    assert cs.WIDE_SHAPE in {shape[0] for shape in cs.KERNEL_SHAPES if shape[5] > 256}
    assert cs.BF16_FLASH_KERNELS == 3 * (len(fa.KERNEL_WIDTHS) + 1)
    base = _flat(cs.ssl_mae_cfg("train.txt", "out"))
    assert base["model.decoder_num_heads"] == 6
    for path, heads in (("train_ssl_mae_repack", 3), ("train_ssl_mae_repack_h1", 1)):
        overrides, by_d = cs.REPACK_ARMS[path]
        repack = _flat(merge_configs(cs.ssl_mae_cfg("train.txt", "out"), overrides))
        assert {k for k in base.keys() | repack.keys() if base.get(k) != repack.get(k)} == {
            "model.decoder_num_heads"}
        assert repack["model.decoder_num_heads"] == heads
        d = base["model.decoder_embed_dim"] // heads
        assert (by_d[f"K1_d{d}"] + by_d["K1_d32"], by_d[f"K2_d{d}"] + by_d["K2_d32"]) == (
            cs.K1_CALLS_PER_STEP, cs.K2_CALLS_PER_STEP)
        assert path in cs.PATHS
    assert "probe_decoder_repack" in cs.PATHS
    mae = merge_configs(cs.mae_train_cfg("", ""), cs.MAE_H1_OVERRIDES)["mae"]["decoder"]
    assert mae["dim"] // mae["num_heads"] == 512 and cs.MAE_H1_WIDE_CALLS == (2, 2)
