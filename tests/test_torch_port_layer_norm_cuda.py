"""The LayerNorm kernels (ops/layer_norm.py, csrc/layer_norm.cu) on the card
against their plain PyTorch version on the same CUDA tensors: forward and
backward, bf16 and fp32, at every width the port's blocks use and at widths
that are no multiple of 8, at one row and at a ragged row count, on strided
and misaligned views; determinism of the weight and bias gradients; what
the kernels refuse; a CUDA graph's capture of the forward.

This file imports torch and the port only, so it runs on a machine without
JAX; the repo's conftest imports JAX, so on the card run it as

    python -m pytest tests/test_torch_port_layer_norm_cuda.py --noconftest -q -p no:cacheprovider

Without a CUDA card every test skips (the kernels have no CPU mode).
Tolerances: both versions compute in fp32 in another order (fp32 noise,
1e-5 of a row's magnitudes), and in bf16 each rounds its fp32 result once,
so an element may land one bf16 step (2^-7 relative) apart. The weight and
bias gradients are fp32 sums over the rows in another order: 1e-4 of the
largest magnitude in fp32, and in bf16, where dy and x are the same bf16
inputs for both, the same.
"""
import pytest
import torch

from ssl_vit_video_analytics_tpu_torch.ops import layer_norm as ln

pytestmark = pytest.mark.cuda

EPS = 1e-5
BF16_STEP = 2.0 ** -7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, rows, D, dtype, seed=0, width=None, offset=0):
    """x [rows, D] in dtype (a view at ``offset`` columns into rows of
    ``width`` where given), fp32 weight and bias, as a model's: a shifted,
    scaled activation and a weight about 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    full = (torch.randn(rows, width or D, device=dev, generator=g) * 3 + 0.5).to(dtype)
    x = full[:, offset:offset + D]
    w = 1 + 0.1 * torch.randn(D, device=dev, generator=g)
    b = 0.1 * torch.randn(D, device=dev, generator=g)
    return x, w, b


def _close(got, ref, dtype, share):
    """Each element within ``share`` of ref's largest magnitude, and in bf16
    one bf16 step of its own more."""
    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    rtol = BF16_STEP if dtype == torch.bfloat16 else 0.0
    excess = ((got - ref).abs() - rtol * ref.abs() - share * scale).max().item()
    assert excess <= 0, (excess, scale)


def _both(x, w, b, out_dtype, dy):
    """The kernels' and the plain version's y, dx, dw, db on the same inputs."""
    outs = []
    for fn in (ln.layer_norm, ln.layer_norm_plain):
        xx = x.detach().clone().requires_grad_()
        ww, bb = w.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
        y = fn(xx, ww, bb, EPS, out_dtype)
        y.backward(dy)
        outs.append((y.detach(), xx.grad, ww.grad, bb.grad))
    return outs


def _check(kern, plain, x_dtype, out_dtype):
    (y, dx, dw, db), (y0, dx0, dw0, db0) = kern, plain
    assert y.dtype == y0.dtype == out_dtype and dx.dtype == dx0.dtype == x_dtype
    assert dw.dtype == db.dtype == torch.float32
    _close(y, y0, out_dtype, 1e-5)
    # dx's terms are of the size of dy * w * rstd, and cancel: fp32 noise of
    # their size, not of dx's own
    _close(dx, dx0, x_dtype, 1e-4)
    _close(dw, dw0, torch.float32, 1e-4)
    _close(db, db0, torch.float32, 1e-4)


WIDTHS = (144, 192, 240, 384, 512, 100, 1024)
ROWS = (1, 1000)
DTYPES = (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_kernels_match_plain(dev, dtype, D, rows):
    x, w, b = _inputs(dev, rows, D, dtype)
    dy = torch.randn(rows, D, device=dev).to(dtype)
    before = (ln.launches.count, ln.bwd_launches.count, ln.plain_calls.count)
    kern, plain = _both(x, w, b, dtype, dy)
    torch.cuda.synchronize()
    # the kernel pass launched one forward and one backward; the plain pass
    # runs the plain version by name, not through the dispatch
    assert (ln.launches.count, ln.bwd_launches.count, ln.plain_calls.count) == (
        before[0] + 1, before[1] + 1, before[2])
    _check(kern, plain, dtype, dtype)


@pytest.mark.parametrize("x_dtype,out_dtype", [(torch.bfloat16, torch.float32),
                                               (torch.float32, torch.bfloat16)],
                         ids=["bf16_to_fp32", "fp32_to_bf16"])
@pytest.mark.parametrize("D", (384, 100))
def test_mixed_dtypes_match_plain(dev, x_dtype, out_dtype, D):
    x, w, b = _inputs(dev, 333, D, x_dtype)
    dy = torch.randn(333, D, device=dev).to(out_dtype)
    kern, plain = _both(x, w, b, out_dtype, dy)
    _check(kern, plain, x_dtype, out_dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("view", ["fused_slice", "misaligned", "transposed", "batched"])
def test_views_match_plain(dev, dtype, view):
    """A fused projection's slice (row stride 3D: no copy, 16-byte vectors),
    a view one element off 16-byte alignment (element by element), a
    transposed map's tokens (last dim strided: a contiguous copy), and a
    [B, L, D] batch whose rows are one stride."""
    D = 192
    if view == "fused_slice":
        x, w, b = _inputs(dev, 517, D, dtype, width=3 * D, offset=D)
    elif view == "misaligned":
        x, w, b = _inputs(dev, 517, D, dtype, width=D + 8, offset=1)
    elif view == "transposed":
        x, _, _ = _inputs(dev, D, 517, dtype)
        x = x.t()
        _, w, b = _inputs(dev, 1, D, dtype)
    else:
        x, w, b = _inputs(dev, 6 * 49, D, dtype)
        x = x.reshape(6, 49, D)
    dy = torch.randn(x.shape, device=dev).to(dtype)
    _check(*_both(x, w, b, dtype, dy), dtype, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_weight_and_bias_gradients_are_deterministic(dev, dtype):
    x, w, b = _inputs(dev, 125440 // 16, 384, dtype)
    dy = torch.randn(x.shape, device=dev).to(dtype)
    runs = []
    for _ in range(2):
        xx, ww, bb = (t.detach().clone().requires_grad_() for t in (x, w, b))
        ln.layer_norm(xx, ww, bb, EPS, dtype).backward(dy)
        runs.append((xx.grad, ww.grad, bb.grad))
    for a, c in zip(*runs):
        assert torch.equal(a, c)


def test_what_the_kernels_do_not_take_raises_with_nothing_launched(dev):
    x, w, b = _inputs(dev, 8, 192, torch.bfloat16)
    cases = [
        (x.half(), w, b, torch.float16, TypeError),                # fp16 activations
        (x, w, b, torch.float16, TypeError),                       # fp16 output
        (x, w.cpu(), b, torch.bfloat16, ValueError),               # weight on the CPU
        (x, w, b.cpu(), torch.bfloat16, ValueError),               # bias on the CPU
        (x, w.bfloat16(), b, torch.bfloat16, ValueError),          # weight below fp32
        (x, w[:100], b, torch.bfloat16, ValueError),               # weight of another width
        (torch.zeros(4, 1025, device=dev), torch.ones(1025, device=dev),
         torch.zeros(1025, device=dev), torch.float32, ValueError),  # wider than the kernels
    ]
    before = (ln.launches.count, ln.bwd_launches.count, ln.plain_calls.count)
    for xx, ww, bb, out_dtype, err in cases:
        with pytest.raises(err):
            ln.layer_norm(xx, ww, bb, EPS, out_dtype)
    torch.cuda.synchronize()
    assert (ln.launches.count, ln.bwd_launches.count, ln.plain_calls.count) == before


@pytest.mark.parametrize("D", (144, 192, 240))
def test_a_cuda_graph_replays_the_forward_as_eager(dev, D):
    """MobileViT-S's widths, as serving's frame graph holds them: a capture
    and replay of the forward with grad off, against the eager call."""
    x, w, b = _inputs(dev, 8 * 196, D, torch.bfloat16)
    with torch.no_grad():
        eager = ln.layer_norm(x, w, b, EPS, torch.bfloat16)
        static_x = x.clone()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            ln.layer_norm(static_x, w, b, EPS, torch.bfloat16)  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = ln.layer_norm(static_x, w, b, EPS, torch.bfloat16)
        for seed in (1, 2):
            x2, _, _ = _inputs(dev, 8 * 196, D, torch.bfloat16, seed=seed)
            static_x.copy_(x2)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, ln.layer_norm(x2, w, b, EPS, torch.bfloat16))
        static_x.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
