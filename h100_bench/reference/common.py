"""Plain fp32 building blocks of the benchmark's references.

Written from the published descriptions (TinyViT, VideoMAE, MobileViT) and
the configurations' stated conventions, not from the program: flax-style
BatchNorm (biased batch variance, eps 1e-5), LayerNorm eps 1e-5, GELU in its
tanh form, stochastic depth as per-sample keep factors handed in by the
caller. Modules carry the parameter names of the models they stand for, so
that one state dict made by the benchmark loads into both sides.

Every matrix product and convolution takes its operands through a
:class:`Precision`: ``fp32`` (identity; the reference) or ``fp8`` (operands
rounded to float8 e4m3 with a per-tensor scale, gradients to e5m2: the
control, one precision below the configurations' bfloat16).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NORM_EPS = 1e-5
# logits a block of plain attention may hold (fp32: 1 GiB)
ATTN_BLOCK_ELEMS = 1 << 28


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (a float8) under a per-tensor scale that
    maps its largest magnitude to the format's largest finite value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Precision:
    """What a matrix product's operands are rounded to: ``"fp32"`` (not at
    all) or ``"fp8"``."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}: fp32 or fp8")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        return _Fp8Operand.apply(x)


FP32 = Precision("fp32")


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and cuDNN inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def normalize(clip_u8: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., 3]`` pixels -> ImageNet-standardized fp32."""
    mean = torch.tensor(IMAGENET_MEAN, device=clip_u8.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=clip_u8.device) * 255.0
    return (clip_u8.float() - mean) / std


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh form."""
    return F.gelu(x, approximate="tanh")


def remat(fn, *args, on: bool):
    """``fn(*args)``, recomputed in the backward pass (with ``on``) instead
    of keeping its intermediates: the same arithmetic, less memory."""
    return checkpoint(fn, *args, use_reentrant=False) if on else fn(*args)


def dense(x: torch.Tensor, layer: nn.Linear, p: Precision) -> torch.Tensor:
    y = p(x) @ p(layer.weight).t()
    return y if layer.bias is None else y + layer.bias


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + NORM_EPS) * ln.weight + ln.bias


class ConvBN(nn.Module):
    """Conv (no bias) -> BatchNorm -> SiLU (``act``), NCHW. Training:
    batch statistics with the biased variance; eval: running statistics."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=NORM_EPS)
        self.act = act

    def forward(self, x: torch.Tensor, p: Precision) -> torch.Tensor:
        c = self.conv
        y = F.conv2d(p(x), p(c.weight), None, c.stride, c.padding, 1, c.groups)
        bn = self.bn
        # training: the batch's mean and biased variance; eval: the running ones
        y = F.batch_norm(y, None if self.training else bn.running_mean,
                         None if self.training else bn.running_var, bn.weight, bn.bias,
                         self.training, 0.0, NORM_EPS)
        return F.silu(y) if self.act else y


def drop_path(x: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
    """Stochastic depth: ``keep`` per sample (0 or 1/keep_prob), or None."""
    if keep is None:
        return x
    return x * keep.reshape((-1,) + (1,) * (x.dim() - 1))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: Precision) -> torch.Tensor:
    s = (p(q) @ p(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return p(torch.softmax(s, dim=-1)) @ p(v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              p: Precision) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over packed ``[B, L, H*d]`` inputs, in
    blocks of rows and queries of at most ``ATTN_BLOCK_ELEMS`` logits; with
    gradients on, each block is recomputed in the backward pass instead of
    keeping its logits."""
    B, Lq, HD = q.shape
    Lk, d = k.shape[1], HD // heads
    qh = q.reshape(B, Lq, heads, d).transpose(1, 2)
    kh = k.reshape(B, Lk, heads, d).transpose(1, 2)
    vh = v.reshape(B, Lk, heads, d).transpose(1, 2)
    per_row = heads * Lq * Lk
    rows = max(1, min(B, ATTN_BLOCK_ELEMS // per_row))
    qc = Lq if rows > 1 or per_row <= ATTN_BLOCK_ELEMS else max(
        1, ATTN_BLOCK_ELEMS // (heads * Lk))
    grad = torch.is_grad_enabled() and q.requires_grad
    out = []
    for b in range(0, B, rows):
        parts = []
        for lo in range(0, Lq, qc):
            args = (qh[b:b + rows, :, lo:lo + qc], kh[b:b + rows], vh[b:b + rows])
            parts.append(checkpoint(_attend, *args, p, use_reentrant=False) if grad
                         else _attend(*args, p))
        out.append(torch.cat(parts, dim=2))
    return torch.cat(out).transpose(1, 2).reshape(B, Lq, HD)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        hd = heads * (dim // heads)
        self.qkv = nn.Linear(dim, 3 * hd)
        self.proj = nn.Linear(hd, dim)

    def forward(self, x: torch.Tensor, p: Precision) -> torch.Tensor:
        q, k, v = dense(x, self.qkv, p).chunk(3, dim=-1)
        return dense(attention(q, k, v, self.heads, p), self.proj, p)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, p: Precision) -> torch.Tensor:
        return dense(gelu(dense(x, self.fc1, p)), self.fc2, p)


class Block(nn.Module):
    """Pre-norm transformer block; ``keep`` is the pair of per-sample
    stochastic-depth factors of its two branches, or None."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, p: Precision, keep=None) -> torch.Tensor:
        k_attn, k_mlp = keep if keep is not None else (None, None)
        x = x + drop_path(self.attn(layer_norm(x, self.norm1), p), k_attn)
        return x + drop_path(self.mlp(layer_norm(x, self.norm2), p), k_mlp)
