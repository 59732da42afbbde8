"""The kernels on the card against their plain PyTorch versions on the same
CUDA tensors: flash attention forward (K1) and backward (K2) and the
autograd Function that joins them, the 3x3 depthwise conv (P1) and the
unary chain (P2).

This file imports torch and the port only, so it runs on a machine without
JAX; the repo's conftest imports JAX, so on the card run it as

    python -m pytest tests/test_torch_port_kernel_cuda.py --noconftest -q -p no:cacheprovider

Without a CUDA card every test skips (the kernels have no CPU mode). bf16
runs on the tensor-core kernels, fp32 on the CUDA-core ones; both are held
at every edge of the bf16 kernels' tiles.
Tolerances: K1, 1e-4 on out and lse in fp32 (TF32 off); 2e-2 on out in bf16
(1e-4 on lse) against the plain fp32 attention of the same bf16-rounded
inputs. K2, the max abs
error of each gradient over that gradient's max magnitude (but not less
than 1e-2 of the largest of the three: over a single key dQ and dK are
zero in exact arithmetic and rounding noise in both versions): 1e-4 in
fp32 (sums of up to a few hundred fp32 terms in another order); 2e-2 in
bf16 (one bf16 rounding of the output, 2^-8 relative, plus bf16 out in D).
P1, at every edge of its TMA tiles, 1e-5 abs in fp32 (nine terms, FMA
against multiply-add); in bf16 the
same 1e-5 plus one bf16 ulp of the output (each rounds its fp32 sum once,
and a sum that cancels to near zero has ulps far below 1e-5). P2, 1e-5 of the
output's largest magnitude in fp32; two bf16 ulps of each element in bf16
(both round at every elementary operation, as the JAX probe does).
"""
import pytest
import torch

from ssl_vit_video_analytics_tpu_torch.models.layers import MultiHeadAttention
from ssl_vit_video_analytics_tpu_torch.ops import depthwise, kernel_build
from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa
from ssl_vit_video_analytics_tpu_torch.ops import unary_chain as uc

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _strided_qkv(dev, B, Lq, Lk, H, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(B, Lq, 3 * H * d, device=dev, generator=g).to(dtype)
    kv = torch.randn(B, Lk, 2 * H * d, device=dev, generator=g).to(dtype)
    return qkv[..., :H * d], kv[..., :H * d], kv[..., H * d:]


# ragged Lq (not a multiple of the 64-row tile) and Lk (not of the 32-key
# tile), Lq != Lk, one-row and one-key edges, every supported head dim;
# then pipeline A's temporal transformer, pipeline C's TinyViT stage 3 and
# its decoder (fewer clips); then the MobileViT-S blocks at the FedAvg
# client step's 512 frames (16 clips x 32) and the privacy embedding's 256
MOBILEVIT_FRAMES = [(n, L, L, 4, d) for n in (512, 256)
                    for L, d in ((196, 32), (64, 40), (16, 48))]
# head dims past the four of the models' defaults: every kernel width
# (csrc/flash_mma.cuh, kernel_width) and a d below each (16 and 20 run at
# width 32, 80 at 96), odd ones (staged element by element), the decoder
# repack (3 x 128) and pipeline A's temporal head at embed 384 (4 x 96)
WIDE_AND_ODD = [(2, 196, 196, 2, 16), (3, 50, 50, 3, 20), (2, 17, 40, 2, 24),
                (1, 33, 33, 1, 7), (2, 77, 77, 2, 80), (2, 32, 32, 4, 96),
                (2, 100, 300, 3, 128), (1, 130, 5, 2, 100), (2, 65, 33, 2, 130),
                (1, 70, 70, 2, 200), (2, 65, 129, 2, 256), (1, 1, 1, 1, 1)]
# the head dims held at every tile edge
EDGE_HEAD_DIMS = (1, 7, 16, 20, 24, 32, 40, 48, 64, 72, 80, 96, 100, 128, 130, 200, 256)


@pytest.mark.parametrize("B,Lq,Lk,H,d", [
    (4, 196, 196, 4, 32), (4, 64, 64, 4, 40), (8, 16, 16, 4, 48),
    (2, 100, 300, 2, 64), (3, 65, 33, 3, 32), (1, 1, 1, 1, 40), (2, 7, 129, 2, 48),
    (3, 32, 32, 4, 64), (2, 49, 49, 18, 32), (2, 288, 288, 8, 64),
    *MOBILEVIT_FRAMES, *WIDE_AND_ODD,
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(dev, B, Lq, Lk, H, d, dtype):
    q, k, v = _strided_qkv(dev, B, Lq, Lk, H, d, dtype)
    before = fa.launches.count
    out, lse = fa.flash_attention_fwd(q, k, v, H)
    torch.cuda.synchronize()
    assert fa.launches.count == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert out.shape == (B, Lq, H * d) and lse.shape == (B, Lq, H)
    ref_out, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), H)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out, atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def _overflowing(dev, d=1024):
    """One row expanded to B = 2^19, L = 2^16 at head dim d: 2^31 CTAs or
    more in a wide kernel's grid (2 column groups of 32-row tiles at d =
    1024), without the memory."""
    return torch.zeros(1, 1, d, device=dev).expand(2**19, 2**16, d)


def test_kernel_refuses_instead_of_falling_back(dev):
    q, k, v = _strided_qkv(dev, 1, 8, 8, 2, 32, torch.float32)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), v.half(), 2)
    big = _overflowing(dev)
    before = (fa.launches.count, fa.wide_launches.count)
    with pytest.raises(ValueError, match="exceeds the kernel grid"):
        fa.flash_attention_fwd(big, big, big, 1)
    assert (fa.launches.count, fa.wide_launches.count) == before
    with pytest.raises(ValueError, match="contiguous last dim"):
        t = torch.zeros(1, 64, 8, device=dev).transpose(1, 2)
        fa.flash_attention_fwd(t, k, v, 2)


def test_attention_module_goes_through_the_kernel(dev):
    torch.manual_seed(0)
    mha = MultiHeadAttention(160, 4, dtype=torch.bfloat16).to(dev).eval()
    x = torch.randn(16, 64, 160, device=dev)
    before = fa.launches.count
    with torch.inference_mode():
        out = mha(x)
        mha.attn_impl = "plain"
        ref = mha(x)
    assert fa.launches.count == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=5e-2, rtol=0)


def _rel_err(got: torch.Tensor, ref: torch.Tensor, scale: float = 0.0) -> float:
    """Max abs error over the reference's max magnitude, or over ``scale``
    where that is larger (a gradient that is zero in exact arithmetic, as
    dQ and dK over a single key, is rounding noise in both versions)."""
    return float((got.float() - ref).abs().max() / max(float(ref.abs().max()), scale, 1e-30))


# ragged Lq and Lk (not multiples of the 64-row tiles or the 32-key tile),
# Lq != Lk both ways, one-row and one-key edges, every supported head dim;
# then the shapes of pipelines A and C, as above, and the client step's
# MobileViT-S blocks at 512 frames
@pytest.mark.parametrize("B,Lq,Lk,H,d", [
    (2, 196, 196, 3, 32), (2, 64, 64, 4, 40), (3, 100, 300, 2, 48), (2, 65, 33, 2, 64),
    (1, 1, 1, 1, 32), (2, 7, 129, 2, 64), (1, 130, 5, 3, 40),
    (3, 32, 32, 4, 64), (2, 49, 49, 18, 32), (2, 288, 288, 8, 64),
    *MOBILEVIT_FRAMES[:3], *WIDE_AND_ODD,
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain(dev, B, Lq, Lk, H, d, dtype):
    q, k, v = _strided_qkv(dev, B, Lq, Lk, H, d, dtype, seed=1)
    g = torch.Generator(device=dev).manual_seed(2)
    dout = torch.randn(B, Lq, H * d, device=dev, generator=g).to(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, H)
    before = fa.bwd_launches.count
    grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, H)
    torch.cuda.synchronize()
    assert fa.bwd_launches.count == before + 1
    refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                        dout.float(), H)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = 1e-2 * max(float(r.abs().max()) for r in refs)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == dtype and got.shape == ref.shape and got.is_contiguous(), name
        assert torch.isfinite(got).all(), name
        assert _rel_err(got, ref, scale) <= tol, (name, _rel_err(got, ref, scale))


def test_backward_kernel_refuses_instead_of_falling_back(dev):
    q, k, v = _strided_qkv(dev, 1, 8, 8, 2, 32, torch.float32)
    out, lse = fa.flash_attention_fwd(q, k, v, 2)
    dout = torch.ones_like(out)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q.half(), k.half(), v.half(), out.half(), lse, dout.half(), 2)
    big = _overflowing(dev)
    big_lse = torch.zeros(1, 1, 1, device=dev).expand(2**19, 2**16, 1)
    before = (fa.bwd_launches.count, fa.wide_bwd_launches.count)
    with pytest.raises(ValueError, match="exceeds the kernel grid"):
        fa.flash_attention_bwd(big, big, big, big, big_lse, big, 1)
    assert (fa.bwd_launches.count, fa.wide_bwd_launches.count) == before
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, out, lse.double(), dout, 2)
    with pytest.raises(ValueError, match="must match q"):
        fa.flash_attention_bwd(q, k, v, out, lse, dout[:, :4], 2)


# head dims above the widest kernel width, 256, that the wide kernels run
# in chunks of 64 columns: just past it, a chunk edge past it in TMA copies
# (264), one staged element by element (300), the one-head decoders of
# pipelines B (384) and C (512), just past one column group of 512 (513,
# element by element; 520, by the TMA: two groups, d streamed in steps of 4
# chunks), 1024 (the widest whose own rows stay resident in shared memory)
# and past it 1088 (TMA) and 1089 (element by element), whose own rows are
# streamed with each step's chunks
WIDE_HEAD_DIMS = (257, 264, 300, 384, 512, 513, 520, 1024, 1088, 1089)
# one row, the edges of the 64-row (and 32-row) tiles and of the ring's
# 64-key (and 32-row) steps, and more than 3 tiles
WIDE_LENGTHS = (1, 63, 65, 200)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_wide_heads_match_plain_at_tile_edges(dev, d, dtype):
    """K1 and K2 above d = 256 against their plain versions at every Lq x
    Lk of the edges, 2 heads of strided thirds, at the tolerances above:
    out at every column and, apart, at the columns where two 64-column
    chunks meet; lse (one CTA of a row tile writes it) at every row; the
    gradients. Each call counts one wide launch."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    meet = [h * d + c for h in range(2) for edge in range(64, d, 64) for c in (edge - 1, edge)]
    for Lq in WIDE_LENGTHS:
        for Lk in WIDE_LENGTHS:
            q, k, v = _strided_qkv(dev, 2, Lq, Lk, 2, d, dtype, seed=Lq * 1000 + Lk)
            g = torch.Generator(device=dev).manual_seed(Lk)
            dout = torch.randn(2, Lq, 2 * d, device=dev, generator=g).to(dtype)
            before = (fa.wide_launches.count, fa.wide_bwd_launches.count)
            out, lse = fa.flash_attention_fwd(q, k, v, 2)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, 2)
            torch.cuda.synchronize()
            assert (fa.wide_launches.count, fa.wide_bwd_launches.count) == (
                before[0] + 1, before[1] + 1)
            ref_out, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), 2)
            err = (out.float() - ref_out).abs()
            assert out.dtype == dtype and torch.isfinite(out).all(), (Lq, Lk)
            assert float(err.max()) <= tol, (Lq, Lk, float(err.max()))
            assert float(err[..., meet].max()) <= tol, (Lq, Lk, "where blocks meet")
            torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0,
                                       msg=f"lse at Lq={Lq} Lk={Lk}")
            refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(),
                                                lse, dout.float(), 2)
            scale = 1e-2 * max(float(r.abs().max()) for r in refs)
            for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
                assert got.dtype == dtype and torch.isfinite(got).all(), (Lq, Lk, name)
                assert _rel_err(got, ref, scale) <= tol, (Lq, Lk, name,
                                                          _rel_err(got, ref, scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [384, 1024, 1088, 1089])
def test_wide_gradients_are_deterministic(dev, d, dtype):
    """Two K2 calls on the same inputs give bit-equal dQ, dK and dV: every
    gradient has one writer and sums in a fixed order (the partial S and dP
    of a tile are added in column-warp order), no atomics."""
    q, k, v = _strided_qkv(dev, 2, 200, 130, 2, d, dtype, seed=5)
    g = torch.Generator(device=dev).manual_seed(6)
    dout = torch.randn(2, 200, 2 * d, device=dev, generator=g).to(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, 2)
    first = fa.flash_attention_bwd(q, k, v, out, lse, dout, 2)
    second = fa.flash_attention_bwd(q, k, v, out, lse, dout, 2)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_heads_take_fused_qkv_thirds(dev, dtype):
    """The thirds of one fused qkv projection at d = 384 (row stride
    3*H*d, offsets h*d elements: 16-byte copies in bf16) go through K1 and
    K2 in place by the autograd Function, and the fused tensor's gradient
    is the plain Function's."""
    B, L, H, d = 2, 130, 2, 384
    hd = H * d
    g = torch.Generator(device=dev).manual_seed(7)
    base = torch.randn(B, L, 3 * hd, device=dev, generator=g).to(dtype)
    dout = torch.randn(B, L, hd, device=dev, generator=g).to(dtype)
    grads = {}
    for impl, x in (("kernel", base.clone()), ("plain", base.float())):
        qkv = x.requires_grad_(True)
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        assert q.stride(1) == 3 * hd and q.data_ptr() == qkv.data_ptr()
        before = (fa.wide_launches.count, fa.wide_bwd_launches.count)
        fa.flash_attention_packed(q, k, v, H, impl=impl).backward(dout.to(qkv.dtype))
        torch.cuda.synchronize()
        launched = (fa.wide_launches.count - before[0], fa.wide_bwd_launches.count - before[1])
        assert launched == ((1, 1) if impl == "kernel" else (0, 0)), (impl, launched)
        grads[impl] = qkv.grad
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = 1e-2 * float(grads["plain"].abs().max())
    assert _rel_err(grads["kernel"], grads["plain"], scale) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batches_past_65535(dev, dtype):
    """(tile, head, batch row) are folded into grid.x: B = 65536 runs, and
    its first and last rows agree with the plain versions of those rows."""
    B, L, H, d = 65536, 5, 2, 32
    q, k, v = _strided_qkv(dev, B, L, L, H, d, dtype, seed=5)
    dout = torch.randn(B, L, H * d, device=dev).to(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, H)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, H)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for rows in (slice(0, 1), slice(B - 1, B)):
        one = [t[rows].float() for t in (q, k, v)]
        ref_out, ref_lse = fa.flash_attention_plain(*one, H)
        torch.testing.assert_close(out[rows].float(), ref_out, atol=tol, rtol=0)
        torch.testing.assert_close(lse[rows], ref_lse, atol=1e-4, rtol=0)
        refs = fa.flash_attention_bwd_plain(*one, out[rows].float(), lse[rows],
                                            dout[rows].float(), H)
        scale = 1e-2 * max(float(r.abs().max()) for r in refs)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            assert _rel_err(got[rows], ref, scale) <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_gradients_flow_through_the_kernels(dev, dtype):
    """The attention op on CUDA tensors is differentiable: its output has a
    graph back to q/k/v, and a MultiHeadAttention's input and weights get
    the gradients of the plain path, through K1 forward and K2 backward."""
    B, L, H, d = 4, 100, 6, 32
    qkv = torch.randn(B, L, 3 * H * d, device=dev).to(dtype).requires_grad_(True)
    hd = H * d
    out = fa.flash_attention_packed(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:], H)
    assert out.requires_grad
    out.float().square().sum().backward()
    assert qkv.grad is not None and qkv.grad.float().abs().max() > 0

    torch.manual_seed(0)
    mha = MultiHeadAttention(hd, H, dtype=dtype).to(dev)
    x = torch.randn(B, L, hd, device=dev)
    grads = {}
    for impl in ("kernel", "plain"):
        mha.attn_impl = impl
        mha.zero_grad()
        xi = x.clone().requires_grad_(True)
        before = (fa.launches.count, fa.bwd_launches.count)
        mha(xi).float().square().mean().backward()
        counts = (fa.launches.count - before[0], fa.bwd_launches.count - before[1])
        assert counts == ((1, 1) if impl == "kernel" else (0, 0)), (impl, counts)
        grads[impl] = [xi.grad] + [p.grad for p in mha.parameters()]
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for got, ref in zip(grads["kernel"], grads["plain"]):
        assert got.abs().max() > 0
        assert _rel_err(got, ref.float()) <= tol


# the edges of the bf16 kernels' 64-row tiles and of their 16-row mma
# blocks, one row, and the serving length 196 (3 tiles and 4 rows)
EDGE_LENGTHS = (1, 15, 16, 17, 63, 64, 65, 196)


@pytest.mark.parametrize("Lq", EDGE_LENGTHS)
@pytest.mark.parametrize("d", EDGE_HEAD_DIMS)
def test_bf16_forward_at_tile_edges(dev, d, Lq):
    """K1 in bf16 (the tensor-core kernel) against the plain fp32 attention
    of the same bf16 inputs, strided qkv thirds, every Lk of the edges."""
    for Lk in EDGE_LENGTHS:
        q, k, v = _strided_qkv(dev, 2, Lq, Lk, 3, d, torch.bfloat16, seed=Lq * 1000 + Lk)
        out, lse = fa.flash_attention_fwd(q, k, v, 3)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), 3)
        assert out.dtype == torch.bfloat16 and torch.isfinite(out).all(), Lk
        err = float((out.float() - ref_out).abs().max())
        assert err <= 2e-2, (Lk, err)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0, msg=f"lse at Lk={Lk}")


@pytest.mark.parametrize("Lq", EDGE_LENGTHS)
@pytest.mark.parametrize("d", EDGE_HEAD_DIMS)
def test_bf16_backward_at_tile_edges(dev, d, Lq):
    """K2 in bf16 (the tensor-core kernels) against the plain fp32 backward
    of the same bf16 inputs, strided qkv thirds, every Lk of the edges."""
    for Lk in EDGE_LENGTHS:
        q, k, v = _strided_qkv(dev, 2, Lq, Lk, 3, d, torch.bfloat16, seed=Lq * 1000 + Lk)
        g = torch.Generator(device=dev).manual_seed(Lk)
        dout = torch.randn(2, Lq, 3 * d, device=dev, generator=g).bfloat16()
        out, lse = fa.flash_attention_fwd(q, k, v, 3)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, 3)
        torch.cuda.synchronize()
        refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                            dout.float(), 3)
        scale = 1e-2 * max(float(r.abs().max()) for r in refs)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            assert got.dtype == torch.bfloat16 and torch.isfinite(got).all(), (Lk, name)
            assert _rel_err(got, ref, scale) <= 2e-2, (Lk, name, _rel_err(got, ref, scale))


def test_bf16_flash_kernels_run_on_the_tensor_cores(dev):
    """Every bf16 flash kernel's SASS holds bf16 tensor-core products:
    mma.sync (HMMA.16816.F32.BF16) at the seven widths and in K2's wide
    kernels, wgmma (HGMMA) in K1's; the fp32 kernels hold neither."""
    libs = kernel_build.build()
    widths = len(fa.KERNEL_WIDTHS) + 1  # and the wide kernels
    for lib, kernels in (("flash_fwd", widths), ("flash_bwd", 2 * widths)):
        listing = kernel_build.sass(libs[lib].path)
        hmma = kernel_build.count_by_function(listing, "HMMA.16816.F32.BF16")
        hgmma = kernel_build.count_by_function(listing, "HGMMA")
        bf16 = {f: (n, hgmma[f]) for f, n in hmma.items() if "bf16_kernel" in f}
        fp32 = {f: (n, hgmma[f]) for f, n in hmma.items() if "fp32_kernel" in f}
        assert len(bf16) == len(fp32) == kernels, (lib, hmma)
        for f, (n, g) in bf16.items():
            assert (g if "fwd_wide" in f else n) > 0, (lib, f, n, g)
        assert not any(n or g for n, g in fp32.values()), (lib, fp32)


def test_misaligned_bf16_view_raises_on_the_card(dev):
    q, k, v = _strided_qkv(dev, 2, 9, 9, 2, 32, torch.bfloat16)
    bad = torch.zeros(2, 9, 65, device=dev, dtype=torch.bfloat16)[..., 1:]
    out, lse = fa.flash_attention_fwd(q, k, v, 2)
    dout = torch.randn(2, 9, 64, device=dev).bfloat16()
    before = (fa.launches.count, fa.bwd_launches.count)
    with pytest.raises(ValueError, match="q must be 16-byte aligned"):
        fa.flash_attention_fwd(bad, k, v, 2)
    with pytest.raises(ValueError, match="v must be 16-byte aligned"):
        fa.flash_attention_bwd(q, k, bad, out, lse, dout, 2)
    assert (fa.launches.count, fa.bwd_launches.count) == before
    # an offset output gradient is copied, not refused: autograd hands it
    shifted = torch.zeros(2, 9, 65, device=dev, dtype=torch.bfloat16)[..., 1:]
    shifted.copy_(dout)
    for got, ref in zip(fa.flash_attention_bwd(q, k, v, out, lse, shifted, 2),
                        fa.flash_attention_bwd(q, k, v, out, lse, dout, 2)):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |t| (8 significant bits)."""
    mag = t.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# the probe's image, a non-square one, one pixel, a ragged channel count;
# then the edges of the kernel's tiles (8 rows x up to the whole width x 32
# bf16 or 16 fp32 channels): H not a multiple of 8, W + 2 > 256 (column
# tiles), C not a multiple of the chunk
@pytest.mark.parametrize("N,H,W,C", [(2, 56, 56, 384), (3, 7, 5, 16), (1, 1, 1, 8),
                                     (2, 3, 9, 24), (1, 57, 56, 384), (1, 9, 300, 40),
                                     (2, 9, 56, 24), (2, 5, 7, 72)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_kernel_matches_plain(dev, N, H, W, C, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(N, H * W, C, device=dev, generator=g).to(dtype)
    w = torch.randn(9, C, device=dev, generator=g)
    before = depthwise.launches.count
    out = depthwise.dw3x3(x, w, H, W)
    torch.cuda.synchronize()
    assert depthwise.launches.count == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    ref = depthwise.dw3x3_plain(x, w, H, W)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        # the fp32 sums differ by at most the fp32 tolerance before each
        # rounds to the nearest bf16; one ulp of the larger of the two
        ulp = _bf16_ulp(torch.maximum(out.float().abs(), ref.float().abs()))
        assert ((out.float() - ref.float()).abs() <= 1e-5 + ulp).all()


def test_depthwise_kernel_refuses_instead_of_falling_back(dev):
    x = torch.randn(2, 12, 16, device=dev)
    w = torch.randn(9, 16, device=dev)
    with pytest.raises(TypeError):
        depthwise.dw3x3(x.half(), w, 3, 4)
    with pytest.raises(ValueError, match="w must be fp32"):
        depthwise.dw3x3(x, w.bfloat16(), 3, 4)
    with pytest.raises(ValueError, match="H\\*W"):
        depthwise.dw3x3(x, w, 4, 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        depthwise.dw3x3(x[..., :12].bfloat16().contiguous(), w[:, :12], 3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        depthwise.dw3x3(x.transpose(0, 1).contiguous().transpose(0, 1), w, 3, 4)


def test_depthwise_kernels_copy_with_the_tma(dev):
    """Both P1 kernels (fp32, bf16) hold the TMA's tensor loads (UTMALDG)
    in their SASS."""
    counts = kernel_build.count_by_function(
        kernel_build.sass(kernel_build.build()["dw3x3"].path), "UTMALDG")
    assert len(counts) == 2, counts
    assert all(n > 0 for n in counts.values()), counts


# a ragged element count (not a multiple of a thread's 8), n = 0, chain
# lengths that run only the remainder loop (1), only the main loop of 4
# applications a trip (64, and the probe's 516 = 129 * 4), and both (7, 13)
@pytest.mark.parametrize("n", [0, 1, 7, 13, 64, 516])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", uc.OPS)
def test_unary_chain_kernel_matches_plain(dev, op, dtype, n):
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(37, 129, device=dev, generator=g)
    before = uc.launches.count
    out = uc.unary_chain(x, n, dtype, op)
    torch.cuda.synchronize()
    assert uc.launches.count == before + 1
    assert out.dtype == torch.float32 and out.shape == x.shape
    ref = uc.unary_chain_plain(x, n, dtype, op)
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    else:
        assert ((out - ref).abs() <= 2 * _bf16_ulp(ref)).all()


def test_unary_chain_bf16_main_loops_round_without_f2f(dev):
    """In bf16 the packed kernels convert only around exp and tanh, one
    F2FP pack per pair: no F2F.BF16.F32 in any main loop, and at most half
    a conversion per element and application."""
    from ssl_vit_video_analytics_tpu_torch.scripts import probe_exp

    counts = probe_exp.sass_loop_counts(kernel_build.build()["unary_chain"].path)
    assert set(counts) == {f"{op}/{dt}" for op in uc.OPS for dt in ("float32", "bfloat16")}
    conversions = probe_exp.conversions(counts)
    for name, c in conversions.items():
        assert c["F2F.BF16.F32"] == 0 and c["F2FP."] <= 0.5, (name, c)
    assert conversions["fma/bfloat16"]["F2FP."] == 0


def test_unary_chain_kernel_refuses_instead_of_falling_back(dev):
    x = torch.randn(8, 16, device=dev)
    with pytest.raises(TypeError):
        uc.unary_chain(x.half(), 2, torch.float32, "exp")
    with pytest.raises(TypeError):
        uc.unary_chain(x, 2, torch.float16, "exp")
    with pytest.raises(ValueError, match="unknown op"):
        uc.unary_chain(x, 2, torch.float32, "sin")
    with pytest.raises(ValueError, match="out of range"):
        uc.unary_chain(x, -1, torch.float32, "exp")
    with pytest.raises(ValueError, match="aligned"):
        uc.unary_chain(x.view(-1)[1:], 2, torch.float32, "exp")
    with pytest.raises(ValueError, match="contiguous"):
        uc.unary_chain(x.t(), 2, torch.float32, "exp")


# --- the finetune slice on the card: the TinyViT classifier's step, and the
# device-resident split ---

def _rel_l2(a, b, floor):
    return float((a.float() - b.float()).norm()) / max(float(b.float().norm()), floor)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("frozen", [False, True])
def test_finetune_step_through_the_kernels_matches_plain(dev, dtype, frozen):
    """The TinyViT classifier (dims 96/192/384, heads of 32) at 2 clips x 4
    frames x 64x64, the same weights and drop-path decisions through K1/K2
    and through the plain versions: loss 1e-4 (fp32) / 1e-3 (bf16)
    relative, every gradient 1e-3 / 5e-2 relative L2 (at least 1e-4 of the
    largest norm); a frozen backbone runs K1 and never K2. bf16 holds the
    gradients that are not zero in the fp32 plain run: a gradient that is
    zero in exact arithmetic (a per-channel shift ahead of a train-mode
    BatchNorm) is bf16 rounding noise in both runs; and one beyond 5e-2 of
    the plain bf16 run must lie within 5e-2 of the fp32 plain run beyond
    the plain bf16 run's own distance from it."""
    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
    from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as eng

    g = torch.Generator(device=dev).manual_seed(1)
    clip_u8 = torch.randint(0, 256, (2, 4, 64, 64, 3), dtype=torch.uint8, device=dev,
                            generator=g)
    labels = torch.randint(0, 5, (2,), device=dev, generator=g)
    drop = None
    runs = {}
    for run_dtype, impl in ((torch.float32, "plain"), (dtype, "kernel"), (dtype, "plain")):
        model = eng.build_model(5, 256, dtype=run_dtype, backbone="tinyvit")
        eng.init_model(model, torch.Generator().manual_seed(0))
        model.to(dev)
        if drop is None:
            drop = model.draw_drop_path(2, 4, g)
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                m.attn_impl = impl
        tx = eng.build_finetune_tx({"learning_rate": 1e-3}, "two_stage", model, frozen)
        fa.launches.reset()
        fa.bwd_launches.reset()
        loss, _, grads = eng.loss_and_grads(model, tx.params, normalize_clip(clip_u8, run_dtype),
                                            labels, drop)
        torch.cuda.synchronize()
        runs[(run_dtype, impl)] = (float(loss), grads, fa.launches.count, fa.bwd_launches.count)
    ref32 = [float(b.norm()) for b in runs[(torch.float32, "plain")][1]]
    (lk, gk, k1, k2), (lp, gp, p1, p2) = runs[(dtype, "kernel")], runs[(dtype, "plain")]
    assert (k1, k2, p1, p2) == (8, 0 if frozen else 8, 0, 0)
    tol_loss, tol_grad = (1e-4, 1e-3) if dtype == torch.float32 else (1e-3, 5e-2)
    assert abs(lk - lp) <= tol_loss * abs(lp)
    floor = 1e-4 * max(float(b.float().norm()) for b in gp)
    assert len(gk) == (2 if frozen else len(list(model.parameters())))
    g32 = runs[(torch.float32, "plain")][1]
    floor32 = 1e-4 * max(ref32)
    for a, b, c, n32 in zip(gk, gp, g32, ref32):
        if dtype == torch.float32:
            assert _rel_l2(a, b, floor) <= tol_grad
        elif n32 >= floor32 and _rel_l2(a, b, floor) > tol_grad:
            # beyond tol of the plain bf16 run: only as far from the fp32
            # run as bf16 rounding alone puts the plain run, plus tol
            assert _rel_l2(a, c, floor32) <= _rel_l2(b, c, floor32) + tol_grad


@pytest.mark.parametrize("chunked", [False, True])
def test_device_stores_on_the_card_match_the_host_path(dev, tmp_path, chunked):
    """Every batch of a shuffled epoch with its padded tail, gathered on the
    card (the chunked store in 4 shards, uploaded on a side stream), is
    bit-equal to the host path's."""
    from ssl_vit_video_analytics_tpu_torch.data.device_store import (ChunkedDeviceClipStore,
                                                                     DeviceClipStore)
    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
    from ssl_vit_video_analytics_tpu_torch.data.loader import ClipDataset, iterate_batches

    # 5 classes x 3 train videos: 15 clips, a tail of 3 in batches of 4
    splits = make_synthetic_dataset(str(tmp_path), num_classes=5, videos_per_class=4,
                                    num_frames=12, image_size=32, seed=0)
    ds = ClipDataset(splits["train"], mode="supervised", clip_len=4, stride=2,
                     image_size=32, seed=3, verbose=False)
    store = (ChunkedDeviceClipStore(ds, 4 * 4 * 32 * 32 * 3, 4, dev, log=lambda *_: None)
             if chunked else DeviceClipStore(ds, dev, log=lambda *_: None))
    if chunked:
        assert store.num_shards == 4
    for epoch, drop_last in ((1, True), (2, False)):
        kw = dict(shuffle=True, seed=3, epoch=epoch, drop_last=drop_last)
        host = list(iterate_batches(ds, 4, **kw))
        got = list(store.epoch_batches(4, **kw))
        assert len(host) == len(got) > 0
        for hb, gb in zip(host, got):
            assert set(hb) == set(gb)
            for k in hb:
                assert gb[k].device.type == "cuda"
                assert torch.equal(gb[k].cpu(), torch.from_numpy(hb[k])), k
