"""The port's 3x3 depthwise conv (ops/depthwise.py, the plain version of P1)
and its probe entry point against the JAX probe, on the CPU.

The same numpy x and taps go through ``dw_roll`` of the JAX package's
``scripts/probe_dw.py`` (its Pallas kernel in interpret mode, imported by
path), through ``dw_xla`` at HIGHEST precision, and through the port. The
image is not square (H=7, W=5), so rows and columns cannot be swapped
unseen. Tolerances: fp32, 1e-5 abs (nine terms in another order); bf16
inputs, one bf16 ulp of the output (both accumulate in fp32 and round
once to bf16).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu_torch.ops import depthwise
from ssl_vit_video_analytics_tpu_torch.scripts import probe_dw

torch.set_num_threads(2)  # six test workers share the host

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_probe_dw", REPO / "scripts" / "probe_dw.py")
jax_probe_dw = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_probe_dw)

N, H, W, C = 4, 7, 5, 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, H * W, C), dtype=np.float32),
            rng.standard_normal((9, C), dtype=np.float32))


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("G", [1, 2])
def test_plain_matches_dw_roll_and_xla_fp32(G):
    x, w = _inputs(0)
    roll = np.asarray(jax_probe_dw.dw_roll(jnp.asarray(x), jnp.asarray(w), H, W, G))
    xla = np.asarray(jax_probe_dw.dw_xla(jnp.asarray(x).reshape(N, H, W, C),
                                         jnp.asarray(w).reshape(3, 3, 1, C),
                                         precision=jax.lax.Precision.HIGHEST))
    got = depthwise.dw3x3_plain(torch.from_numpy(x), torch.from_numpy(w), H, W)
    assert got.shape == (N, H * W, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), roll, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy().reshape(N, H, W, C), xla, atol=1e-5, rtol=0)


def test_plain_matches_dw_roll_bf16():
    x, w = _inputs(1)
    xb = jnp.asarray(x, jnp.bfloat16)
    roll = np.asarray(jax_probe_dw.dw_roll(xb, jnp.asarray(w), H, W).astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(tx.float().numpy(), np.asarray(xb.astype(jnp.float32)))
    got = depthwise.dw3x3_plain(tx, torch.from_numpy(w), H, W)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - roll) <= bf16_ulp(roll)).all()


# the shapes at which the card tests cross every edge of the kernel's tiles
# (8 rows x up to the whole width x 64 bytes of channels): H not a
# multiple of 8, W + 2 > 256 (column tiles), C not a multiple of the chunk
@pytest.mark.parametrize("n,h,w,c", [(1, 57, 56, 384), (1, 9, 300, 40), (2, 9, 56, 24),
                                     (2, 5, 7, 72)])
def test_plain_matches_xla_at_the_kernel_tile_edges(n, h, w, c):
    """The plain version, which the card tests hold the kernel to at these
    shapes, against the JAX probe's XLA conv at HIGHEST precision."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, h * w, c), dtype=np.float32)
    taps = rng.standard_normal((9, c), dtype=np.float32)
    xla = np.asarray(jax_probe_dw.dw_xla(jnp.asarray(x).reshape(n, h, w, c),
                                         jnp.asarray(taps).reshape(3, 3, 1, c),
                                         precision=jax.lax.Precision.HIGHEST))
    got = depthwise.dw3x3(torch.from_numpy(x), torch.from_numpy(taps), h, w)
    np.testing.assert_allclose(got.numpy().reshape(n, h, w, c), xla, atol=1e-5, rtol=0)


def test_edges_are_zero_padded():
    """A one-hot tap reads the neighbour it names, and zero past the edge."""
    x = torch.arange(N * H * W * C, dtype=torch.float32).reshape(N, H * W, C)
    for dh, dw in ((-1, 0), (0, 1), (1, -1)):
        w = torch.zeros(9, C)
        w[(dh + 1) * 3 + dw + 1] = 1.0
        got = depthwise.dw3x3(x, w, H, W).reshape(N, H, W, C)
        x4 = x.reshape(N, H, W, C)
        for h in range(H):
            for c in range(W):
                inside = 0 <= h + dh < H and 0 <= c + dw < W
                ref = x4[:, h + dh, c + dw] if inside else torch.zeros(N, C)
                torch.testing.assert_close(got[:, h, c], ref, atol=0, rtol=0)


def test_wrapper_refuses_a_device_without_a_kernel():
    x, w = (torch.from_numpy(a).to("meta") for a in _inputs(2))
    with pytest.raises(ValueError, match="no depthwise kernel"):
        depthwise.dw3x3(x, w, H, W)


def test_probe_entry_on_cpu():
    before = depthwise.launches.count
    rows = probe_dw.main(["1", "all", "--device", "cpu"])
    assert depthwise.launches.count == before
    assert [r["name"] for r in rows] == [
        "check fp32", "dw3x3 fwd", "dw3x3 bwd(dx)", "plain shifted-sum fwd",
        "cudnn grouped conv fwd", "cudnn grouped conv bwd(dx)", "copy of x (the bytes alone)"]
    assert rows[0]["err_plain"] == 0.0 and rows[0]["err_cudnn"] <= probe_dw.TOL_CHECK
    for row in rows[1:]:
        assert row["ms"] > 0 and row["bound_by"] == "bytes"
    # the probe's shape on an H100: 2 x 616.6 MB of bf16 at 3.35 TB/s
    ms, by = probe_dw.bound(256, torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(2 * 256 * 56 * 56 * 384 * 2 / 3.35e9, rel=1e-4)
    with pytest.raises(ValueError, match="mode"):
        probe_dw.run(1, "fast", "cpu")


def test_cudnn_yardsticks_compute_the_same_function():
    """The library rows time the same conv at the probe's shape: forward
    equals the kernel's plain version, and the input gradient is the conv
    with the taps flipped."""
    x, w = probe_dw.inputs(1, torch.float32, torch.device("cpu"), seed=3)
    w4 = probe_dw._conv_weight(w, torch.float32)
    hw, c = probe_dw.H, probe_dw.W
    as_rows = lambda t: t.permute(0, 2, 3, 1).reshape(1, hw * c, probe_dw.C)  # noqa: E731
    torch.testing.assert_close(as_rows(probe_dw.cudnn_fwd(x, w4)),
                               depthwise.dw3x3_plain(x, w, hw, c), atol=1e-5, rtol=0)
    torch.testing.assert_close(as_rows(probe_dw.cudnn_bwd_dx(x, w4)),
                               depthwise.dw3x3_plain(x, w.flip(0), hw, c), atol=1e-5, rtol=0)


def test_profile_step_finds_the_depthwise_convs():
    """profile_step's depthwise table: the 3x3 depthwise convs of a
    profiled forward and backward, by op and input shape; other convs are
    left out (on the CPU no kernel runs, so no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from ssl_vit_video_analytics_tpu_torch.scripts import profile_step

    x = torch.randn(2, 8, 6, 6, requires_grad=True)
    dw = torch.randn(8, 1, 3, 3, requires_grad=True)
    pw = torch.randn(4, 8, 1, 1, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for _ in range(2):
            y = torch.nn.functional.conv2d(x, dw, padding=1, groups=8)
            torch.nn.functional.conv2d(y, pw).sum().backward()
    rows = profile_step.depthwise_3x3(prof.events(), steps=2)
    assert {(r["op"], tuple(r["input"])) for r in rows} == {
        ("aten::convolution", (2, 8, 6, 6)), ("aten::convolution_backward", (2, 8, 6, 6))}
    for r in rows:
        assert r["calls_per_step"] == 1 and r["ms_per_step"] == 0
