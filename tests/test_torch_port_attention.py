"""The port's attention (ops/flash_attention.py, ops/attention.py) against the
JAX package: the plain version vs the Pallas flash kernel (interpret mode on
the CPU) and vs ``_sdpa_xla``, on the same numpy inputs, in fp32.

Tolerance: atol = rtol = 2e-5, as tests/test_flash_attention.py uses for the
JAX kernel against ``_sdpa_xla`` (fp32, different summation orders).
"""
import jax
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.ops.attention import _sdpa_xla
from ssl_vit_video_analytics_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention, flash_attention_packed as jax_flash_packed)
from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa
from ssl_vit_video_analytics_tpu_torch.ops.attention import attention_packed, sdpa

torch.set_num_threads(2)  # six test workers share the host

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, B, Lq, Lk, H, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, H, d), dtype=np.float32)
    k = rng.standard_normal((B, Lk, H, d), dtype=np.float32)
    v = rng.standard_normal((B, Lk, H, d), dtype=np.float32)
    return q, k, v


def _lse_np(q, k):
    """fp64 logsumexp of the scaled logits, [B, Lq, H]."""
    d = q.shape[-1]
    s = np.einsum("blhd,bmhd->blhm", q.astype(np.float64), k.astype(np.float64))
    s /= np.sqrt(d)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


def _packed(x):
    B, L, H, d = x.shape
    return torch.from_numpy(x).reshape(B, L, H * d)


# the slice's three MobileViT shapes (mvit1/2/3 at B=2..8) and d=64
@pytest.mark.parametrize("B,L,H,d", [(2, 196, 4, 32), (3, 64, 4, 40),
                                     (8, 16, 4, 48), (1, 300, 2, 64)])
def test_plain_matches_jax_flash_and_xla(B, L, H, d):
    q, k, v = _qkv(B * 1000 + L, B, L, L, H, d)
    ref_pallas = np.asarray(jax.jit(jax_flash_attention)(q, k, v))
    ref_xla = np.asarray(_sdpa_xla(q, k, v))
    out, lse = fa.flash_attention_plain(_packed(q), _packed(k), _packed(v), H)
    out = out.reshape(B, L, H, d).numpy()
    np.testing.assert_allclose(out, ref_pallas, **TOL)
    np.testing.assert_allclose(out, ref_xla, **TOL)
    assert lse.shape == (B, L, H) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _lse_np(q, k), **TOL)


def test_plain_matches_jax_flash_when_lq_differs_from_lk():
    B, Lq, Lk, H, d = 2, 100, 300, 4, 32
    q, k, v = _qkv(7, B, Lq, Lk, H, d)
    pq, pk, pv = (x.reshape(x.shape[0], x.shape[1], H * d) for x in (q, k, v))
    ref_pallas = np.asarray(jax.jit(jax_flash_packed, static_argnums=3)(pq, pk, pv, H))
    ref_xla = np.asarray(_sdpa_xla(q, k, v)).reshape(B, Lq, H * d)
    out, lse = fa.flash_attention_plain(*(torch.from_numpy(x) for x in (pq, pk, pv)), H)
    np.testing.assert_allclose(out.numpy(), ref_pallas, **TOL)
    np.testing.assert_allclose(out.numpy(), ref_xla, **TOL)
    np.testing.assert_allclose(lse.numpy(), _lse_np(q, k), **TOL)


def test_packed_entry_takes_strided_qkv_thirds():
    """MultiHeadAttention's thirds of the fused qkv are strided views
    (row stride 3*H*d); the packed entry, ``sdpa`` and both impls agree."""
    B, L, H, d = 2, 37, 4, 40
    qkv = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, L, 3 * H * d), dtype=np.float32))
    q, k, v = qkv[..., :H * d], qkv[..., H * d:2 * H * d], qkv[..., 2 * H * d:]
    assert q.stride(1) == 3 * H * d
    out_kernel = attention_packed(q, k, v, H)             # CPU -> plain version
    out_plain = attention_packed(q, k, v, H, impl="plain")
    out_sdpa = sdpa(*(x.reshape(B, L, H, d) for x in (q, k, v))).reshape(B, L, H * d)
    ref = np.asarray(_sdpa_xla(*(x.reshape(B, L, H, d).numpy() for x in (q, k, v))))
    torch.testing.assert_close(out_kernel, out_plain, atol=0, rtol=0)
    torch.testing.assert_close(out_sdpa, out_plain, atol=0, rtol=0)
    np.testing.assert_allclose(out_plain.numpy(), ref.reshape(B, L, H * d), **TOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention_packed(q, k, v, H, impl="xla")


def test_kernel_arg_checks_refuse_what_the_kernel_does_not_take():
    B, L, H, d = 1, 8, 2, 32
    x = torch.zeros(B, L, H * d)
    assert fa._check_kernel_args(x, x, x, H) == (B, L, L, H * d, d)
    wide = torch.zeros(B, L, 2 * 257)  # above 256: the wide kernels take it
    assert fa._check_kernel_args(wide, wide, wide, 2) == (B, L, L, 514, 257)
    big = torch.zeros(1, 1, 2 * 257).expand(2**19, 2**16, 514)  # 2^31 CTAs of 32-row tiles
    with pytest.raises(ValueError, match="exceeds the kernel grid"):
        fa._check_kernel_args(big, big, big, 2)
    with pytest.raises(ValueError, match="contiguous last dim"):
        t = torch.zeros(B, H * d, L).transpose(1, 2)
        fa._check_kernel_args(t, x, x, H)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check_kernel_args(x.half(), x.half(), x.half(), H)
    with pytest.raises(ValueError, match="shape mismatch"):
        fa._check_kernel_args(x, torch.zeros(B, L, H * d), torch.zeros(B, L + 1, H * d), H)
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        fa.flash_attention_fwd(x.to("meta"), x.to("meta"), x.to("meta"), H)

