"""The port's LayerNorm (ops/layer_norm.py) on the CPU: its plain version is
the expression the models computed before the kernel, bit for bit, forward
and backward; the transformer blocks and the pixel head's final norm go
through it; its counters count one call a call; and the dispatch: the
plain version on a CPU tensor and under a compile or export trace, the
kernels (or a refusal) anywhere else. The kernels themselves are held on the
card by tests/test_torch_port_layer_norm_cuda.py."""
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from ssl_vit_video_analytics_tpu_torch.models import mae, tiny_vit
from ssl_vit_video_analytics_tpu_torch.models.layers import TransformerBlock
from ssl_vit_video_analytics_tpu_torch.ops import layer_norm as ln
from ssl_vit_video_analytics_tpu_torch.utils import tracing

torch.set_num_threads(2)  # test workers share the host

WIDTHS = (144, 192, 384)
DTYPES = (torch.bfloat16, torch.float32)


def _before_the_kernel(x, norm, dtype):
    """What TransformerBlock._norm and TinyVideoMAE.predict_pixels computed
    before the kernel."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(dtype)


def _leaves(D, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(3, 7, D, generator=g) * 3 + 0.5).to(dtype)
    norm = nn.LayerNorm(D, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(D, generator=g))
        norm.bias.copy_(0.1 * torch.randn(D, generator=g))
    dy = torch.randn(3, 7, D, generator=g).to(dtype)
    return x, norm, dy


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_plain_path_equals_the_expression_before_the_kernel(D, dtype):
    x, norm, dy = _leaves(D, dtype)
    outs = []
    for fn in (lambda t: ln.layer_norm(t, norm.weight, norm.bias, norm.eps, dtype),
               lambda t: _before_the_kernel(t, norm, dtype)):
        norm.zero_grad()
        xx = x.clone().requires_grad_()
        y = fn(xx)
        y.backward(dy)
        outs.append((y, xx.grad, norm.weight.grad.clone(), norm.bias.grad.clone()))
    for got, ref in zip(*outs):
        assert got.dtype == ref.dtype
        assert torch.equal(got, ref)


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_counters_count_one_call_a_call(D, dtype):
    x, norm, _ = _leaves(D, dtype)
    before = (ln.launches.count, ln.bwd_launches.count, ln.plain_calls.count)
    for n in range(1, 4):
        ln.layer_norm(x, norm.weight, norm.bias, norm.eps, dtype)
        assert (ln.launches.count, ln.bwd_launches.count, ln.plain_calls.count) == (
            before[0], before[1], before[2] + n)
    counts = tracing.counters()
    assert counts["layer_norm.plain_calls"] == before[2] + 3
    assert tracing.counter("layer_norm.launches").launches  # a graph replay adds its own
    assert tracing.counter("layer_norm.plain_calls").launches


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_transformer_block_goes_through_the_function(D, dtype):
    """Both norms of a block are the function's calls, each the expression
    before the kernel (the block's output equals one computed with it)."""
    torch.manual_seed(0)
    blk = TransformerBlock(D, num_heads=D // 48, mlp_ratio=2.0, dtype=dtype).eval()
    x, _, _ = _leaves(D, dtype)
    before = ln.plain_calls.count
    with torch.no_grad():
        y = blk(x)
    assert ln.plain_calls.count == before + 2
    old = blk._norm
    blk._norm = lambda t, norm: _before_the_kernel(t, norm, dtype)
    try:
        with torch.no_grad():
            assert torch.equal(y, blk(x))
    finally:
        blk._norm = old


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_predict_pixels_goes_through_the_function(dtype):
    D = 48
    enc = tiny_vit.TinyViT(embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                           num_heads=(1, 2, 3, 4), num_stages=3, dtype=dtype)
    model = mae.TinyVideoMAE(enc, clip_len=2, img_size=32, decoder_embed_dim=D,
                             decoder_depth=1, decoder_num_heads=2, dtype=dtype)
    x, _, _ = _leaves(D, dtype)
    before = ln.plain_calls.count
    pred = model.predict_pixels(x)
    assert ln.plain_calls.count == before + 1
    norm = model.decoder_norm
    want = F.linear(_before_the_kernel(x, norm, dtype), model.decoder_pred.weight.to(dtype),
                    model.decoder_pred.bias.to(dtype))
    assert pred.dtype == dtype and torch.equal(pred, want)


def test_the_plain_version_runs_under_a_trace_and_nothing_runs_off_the_cpu(monkeypatch):
    """A tensor on no CPU and no card (here ``meta``) is refused; under a
    compile or export trace (``torch.compiler.is_compiling``) every tensor
    takes the plain version, as ``layers.use_prepared`` reads it."""
    w, b = torch.ones(16, device="meta"), torch.zeros(16, device="meta")
    x = torch.empty(4, 16, device="meta", dtype=torch.bfloat16)
    before = (ln.launches.count, ln.plain_calls.count)
    with pytest.raises(ValueError, match="no layer_norm kernel for device meta"):
        ln.layer_norm(x, w, b, 1e-5, torch.bfloat16)
    assert (ln.launches.count, ln.plain_calls.count) == before
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    y = ln.layer_norm(x, w, b, 1e-5, torch.bfloat16)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert (ln.launches.count, ln.plain_calls.count) == (before[0], before[1] + 1)


def test_a_compiled_block_runs_the_plain_version():
    """``torch.export`` traces a block through the plain version (the
    serving export keeps today's program)."""
    torch.manual_seed(0)
    blk = TransformerBlock(32, num_heads=2, dtype=torch.float32).eval()
    x = torch.randn(2, 5, 32)
    with torch.no_grad():
        want = blk(x)
    program = torch.export.export(blk, (x,))
    assert torch.equal(program.module()(x), want)


def test_rows_are_a_view_where_one_stride_allows_and_a_copy_where_not():
    fused = torch.randn(2, 5, 3 * 16)
    qkv_third = fused[..., 16:32]                       # row stride 48: a view
    rows = ln._rows(qkv_third)
    assert rows.shape == (10, 16) and rows.stride() == (48, 1)
    assert rows.data_ptr() == qkv_third.data_ptr()
    tokens = torch.randn(2, 16, 5).transpose(1, 2)      # a channels-first map's tokens
    rows = ln._rows(tokens)
    assert rows.shape == (10, 16) and rows.is_contiguous()
    assert torch.equal(rows, tokens.reshape(10, 16))
    batch_cut = torch.randn(4, 5, 16)[:, 1:4]           # rows of no one stride
    rows = ln._rows(batch_cut)
    assert rows.shape == (12, 16) and torch.equal(rows, batch_cut.reshape(12, 16))


@pytest.mark.parametrize("dtype,D,stride,offset,vec", [
    (torch.bfloat16, 192, 192, 0, True), (torch.bfloat16, 192, 576, 192, True),
    (torch.bfloat16, 100, 100, 0, False), (torch.bfloat16, 192, 200, 1, False),
    (torch.float32, 100, 100, 0, True), (torch.float32, 102, 102, 0, False),
    (torch.float32, 192, 196, 2, False)])
def test_rows_load_as_16_byte_vectors_where_width_stride_and_pointers_allow(
        dtype, D, stride, offset, vec):
    x = torch.zeros(3 * stride + 16, dtype=dtype)[offset:].as_strided((3, D), (stride, 1))
    w = torch.ones(D)
    assert ln._vectorized(D, stride, x, w, w) is vec


def test_spans_wrap_the_call_and_its_backward():
    x, norm, dy = _leaves(64, torch.bfloat16)
    xx = x.clone().requires_grad_()
    tracing.enable()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            ln.layer_norm(xx, norm.weight, norm.bias, norm.eps, torch.bfloat16).backward(dy)
    finally:
        tracing.disable()
    names = {e.name for e in prof.events()}
    assert {"ssl_vit.layer_norm", "ssl_vit.layer_norm.bwd"} <= names
    norm.zero_grad()
    ref = x.clone().requires_grad_()
    _before_the_kernel(ref, norm, torch.bfloat16).backward(dy)
    assert torch.equal(xx.grad, ref.grad)
