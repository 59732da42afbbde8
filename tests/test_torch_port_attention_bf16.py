"""The port's attention in bf16 (ops/flash_attention.py: the plain K1 and K2)
against the JAX package's flash attention in bf16, on the CPU, and the
16-byte alignment that the bf16 kernels require of their inputs.

The same numpy q/k/v and output cotangent are rounded to bf16 and go
through the JAX package's ``flash_attention_packed`` and its custom VJP
(the Pallas kernels in interpret mode) and through the port's plain
forward and backward. Both round the probabilities P and dS to bf16 before
their products, as the card's bf16 kernels do. Tolerance: the max abs
error of each output over its max magnitude, 2e-2, the card's bf16
tolerance (one bf16 rounding of P, dS and the output, 2^-8 relative each,
and sums of up to a few hundred such terms in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_vit_video_analytics_tpu.ops.flash_attention import (
    flash_attention_packed as jax_flash_packed)
from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)  # six test workers share the host

TOL_BF16 = 2e-2


def _rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# every head dim the kernels take, a ragged L (196: not a multiple of the
# 64-row tiles, 300: nor of the 128 that JAX pads K to), Lq != Lk both ways
@pytest.mark.parametrize("B,Lq,Lk,H,d", [
    (2, 196, 196, 2, 32), (1, 64, 64, 3, 40), (2, 100, 300, 2, 48), (1, 300, 300, 2, 64),
    (1, 196, 16, 2, 32),
])
def test_plain_bf16_matches_jax_flash_in_bf16(B, Lq, Lk, H, d):
    rng = np.random.default_rng(B * 13 + Lq + Lk + d)
    shapes = {"q": (B, Lq, H * d), "k": (B, Lk, H * d), "v": (B, Lk, H * d),
              "dout": (B, Lq, H * d)}
    x32 = {n: rng.standard_normal(s, dtype=np.float32) for n, s in shapes.items()}
    xj = {n: jnp.asarray(a, dtype=jnp.bfloat16) for n, a in x32.items()}
    xt = {n: torch.from_numpy(a).bfloat16() for n, a in x32.items()}

    core = jax.jit(lambda a, b, c: jax_flash_packed(a, b, c, H))
    ref_out, vjp = jax.vjp(core, xj["q"], xj["k"], xj["v"])
    refs = [ref_out, *vjp(xj["dout"])]

    out, lse = fa.flash_attention_plain(xt["q"], xt["k"], xt["v"], H)
    grads = fa.flash_attention_bwd_plain(xt["q"], xt["k"], xt["v"], out, lse, xt["dout"], H)
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, *grads), refs):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16, name
        assert tuple(got.shape) == ref.shape, name
        err = _rel_err(got.float().numpy(), np.asarray(ref, dtype=np.float32))
        assert err <= TOL_BF16, (name, err)


# the models' four head dims (tests/test_torch_port_head_dims.py takes the
# other widths through the wrapper's staging rule)
@pytest.mark.parametrize("d", (32, 40, 48, 64))
def test_fused_qkv_thirds_meet_the_bf16_alignment(d):
    """MultiHeadAttention's thirds of a fused bf16 qkv: offsets h*d*2 bytes,
    row stride 3*H*d*2 bytes, multiples of 16 where d is a multiple of 8
    (the kernels stage those rows in 16-byte copies)."""
    H = 3
    qkv = torch.zeros(2, 17, 3 * H * d, dtype=torch.bfloat16)
    hd = H * d
    fa.check_alignment(q=qkv[..., :hd], k=qkv[..., hd:2 * hd], v=qkv[..., 2 * hd:])


@pytest.mark.parametrize("case", ["pointer", "row_stride", "batch_stride"])
def test_misaligned_views_raise(case):
    """A view the kernels' 16-byte copies cannot read raises; nothing
    falls back to another kernel or to the plain version."""
    B, L, H, d = 2, 9, 2, 32
    hd = H * d
    if case == "pointer":     # starts one bf16 past a 16-byte boundary
        q = torch.zeros(B, L, hd + 1, dtype=torch.bfloat16)[..., 1:]
    elif case == "row_stride":  # rows 2*(hd + 1) bytes apart
        q = torch.zeros(B, L, hd + 1, dtype=torch.bfloat16)[..., :hd]
    else:                     # batch rows (L*hd + 1)*2 bytes apart
        q = torch.zeros(B, L * hd + 1, dtype=torch.bfloat16)[:, :L * hd].unflatten(1, (L, hd))
    k = v = torch.zeros(B, L, hd, dtype=torch.bfloat16)
    fa.check_alignment(q=k, k=k, v=v)
    with pytest.raises(ValueError, match="q must be 16-byte aligned"):
        fa.check_alignment(q=q, k=k, v=v)
    with pytest.raises(ValueError, match="v must be 16-byte aligned"):
        fa.check_alignment(q=k, k=k, v=q)
