"""The port's attention backward (ops/flash_attention.py: the plain version
of K2 and the autograd Function) against the JAX package, in fp32 on the CPU.

The same numpy q/k/v and output cotangent go through the JAX package's
custom VJP (its Pallas kernels in interpret mode), through ``jax.grad`` of
``_sdpa_xla``, and through the port. Tolerance: atol = rtol = 5e-5, as
tests/test_flash_attention.py holds the JAX kernel's gradients to XLA's
(fp32, different summation orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.ops.attention import _sdpa_xla
from ssl_vit_video_analytics_tpu.ops.flash_attention import (
    flash_attention_packed as jax_flash_packed)
from ssl_vit_video_analytics_tpu_torch.models.layers import MultiHeadAttention
from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa
from ssl_vit_video_analytics_tpu_torch.ops import kernel_build
from ssl_vit_video_analytics_tpu_torch.ops.attention import attention_packed

torch.set_num_threads(2)  # six test workers share the host

TOL = dict(atol=5e-5, rtol=5e-5)


def _inputs(seed, B, Lq, Lk, H, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, H * d), dtype=np.float32)
    k = rng.standard_normal((B, Lk, H * d), dtype=np.float32)
    v = rng.standard_normal((B, Lk, H * d), dtype=np.float32)
    dout = rng.standard_normal((B, Lq, H * d), dtype=np.float32)
    return q, k, v, dout


def _jax_grads(fn, q, k, v, dout):
    _, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


# L = 16 / 196 / 300 (one Pallas q-block, a ragged one, a 128-padded K),
# Lq != Lk both ways, and every head dim the kernel takes
@pytest.mark.parametrize("B,Lq,Lk,H,d", [
    (2, 16, 16, 2, 32), (1, 196, 196, 3, 40), (1, 300, 300, 2, 64),
    (2, 100, 300, 2, 48), (1, 196, 16, 2, 32),
])
def test_plain_backward_matches_jax_vjp_and_xla(B, Lq, Lk, H, d):
    q, k, v, dout = _inputs(B * 7 + Lq + Lk, B, Lq, Lk, H, d)
    ref_pallas = _jax_grads(jax.jit(lambda a, b, c: jax_flash_packed(a, b, c, H)),
                            q, k, v, dout)

    def xla(a, b, c):
        split = lambda x: x.reshape(x.shape[0], x.shape[1], H, d)  # noqa: E731
        return _sdpa_xla(split(a), split(b), split(c)).reshape(B, Lq, H * d)

    ref_xla = _jax_grads(jax.jit(xla), q, k, v, dout)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(tq, tk, tv, H)
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, H)
    for g, rp, rx, name in zip(grads, ref_pallas, ref_xla, "qkv"):
        assert g.shape == rp.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), rp, **TOL, err_msg=f"d{name} vs Pallas")
        np.testing.assert_allclose(g.numpy(), rx, **TOL, err_msg=f"d{name} vs XLA")


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_function_carries_gradients_on_cpu(impl, tmp_path, monkeypatch):
    """Both impls go through the autograd Function; on a CPU tensor the
    kernel impl takes the plain forward and backward and builds nothing.
    The gradient of strided qkv thirds lands in the one qkv tensor and
    equals autograd through a plain einsum softmax."""
    def no_build(*_):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(kernel_build, "_build", no_build)
    B, L, H, d = 2, 37, 4, 40
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.standard_normal((B, L, 3 * H * d), dtype=np.float32))
    dout = torch.from_numpy(rng.standard_normal((B, L, H * d), dtype=np.float32))

    x = qkv.clone().requires_grad_(True)
    hd = H * d
    before = (fa.launches.count, fa.bwd_launches.count)
    out = attention_packed(x[..., :hd], x[..., hd:2 * hd], x[..., 2 * hd:], H, impl)
    assert out.requires_grad and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(dout)
    assert (fa.launches.count, fa.bwd_launches.count) == before

    y = qkv.clone().requires_grad_(True)
    qh, kh, vh = (t.reshape(B, L, H, d) for t in (y[..., :hd], y[..., hd:2 * hd],
                                                    y[..., 2 * hd:]))
    p = torch.softmax(torch.einsum("blhd,bmhd->bhlm", qh, kh) / d ** 0.5, dim=-1)
    ref = torch.einsum("bhlm,bmhd->blhd", p, vh).reshape(B, L, hd)
    ref.backward(dout)
    torch.testing.assert_close(out, ref, **TOL)
    torch.testing.assert_close(x.grad, y.grad, **TOL)


def test_wrappers_on_cpu_are_the_plain_versions():
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(5, 2, 24, 40, 2, 32))
    out, lse = fa.flash_attention_fwd(q, k, v, 2)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, 2)
    ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, 2)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    delta = fa.softmax_grad_rowsum(dout, out, 2)
    assert delta.shape == (2, 24, 2) and delta.dtype == torch.float32
    torch.testing.assert_close(
        delta, (dout * out).reshape(2, 24, 2, 32).sum(-1), atol=1e-5, rtol=1e-5)


def test_attention_module_gradient_reaches_its_weights():
    """MultiHeadAttention trains on the CPU: every weight gets a nonzero
    gradient through the Function (on the card, the same through K1/K2 is
    tests/test_torch_port_kernel_cuda.py)."""
    torch.manual_seed(0)
    mha = MultiHeadAttention(64, 2)
    x = torch.randn(2, 20, 64)
    mha(x).square().sum().backward()
    for name, p in mha.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
