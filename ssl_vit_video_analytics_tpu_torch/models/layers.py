"""Building blocks of the MobileViT and TinyViT backbones and the MAE decoder
(counterparts of the JAX package's ``models/layers.py``).

Parameters are kept in fp32 and cast to the module's compute ``dtype`` at
use, as flax's ``dtype=`` does: convs and dense layers run in ``dtype``,
BatchNorm and LayerNorm normalize in fp32 and return ``dtype``. Convolutional
modules take and return NCHW tensors (cuDNN's layout); the transformer
modules take tokens ``[B, L, D]``.

Training mode follows flax, not torch:
- BatchNorm normalizes with the biased batch variance and updates its
  running statistics as ``0.9 * old + 0.1 * batch`` with the BIASED
  variance (torch's own update uses the unbiased one). Inside
  :func:`frozen_bn_stats` of a module (its recompute under activation
  checkpointing) it normalizes with the batch statistics and updates
  nothing, as ``nn.remat`` does not re-mutate.
- Stochastic depth takes its decisions as an argument: a per-sample keep
  tensor (0 or ``1/keep_prob``) drawn by the caller from an explicit
  generator, so a recompute sees the same decisions and tests can inject
  them. A module in training with a drop rate but no decisions raises.

Under a ``data`` or ``seq`` mesh (:func:`global_batch`), train-mode
BatchNorm takes its statistics over the batch of every rank of the group,
as flax's ``BatchNorm`` does over a batch GSPMD shards, and the MoE
auxiliary its token means over the same batch. Under model sharding
(``parallel/ep.py``, ``parallel/tp.py``) a cut ``MoeMlp`` applies its own
experts, and a cut ``MultiHeadAttention`` or ``Mlp`` its own heads or
hidden units, with the collectives those modules name; a module that was
not cut runs as on one device.

Inference runs on prepared weights: where :func:`use_prepared` holds (grad
off, eval mode, no compile or export trace), :func:`linear` takes its
layer's weight and bias cast to ``dtype`` once, and a bf16 :class:`ConvBNAct`
one conv whose weight and bias carry the eval BatchNorm folded in
(:func:`fold_bn`; a 1x1 conv over a channels-last input as one GEMM with
the bias in its epilogue), so that no call casts a weight or runs a
BatchNorm and its fp32 copies. A module's prepared tensors are a plain
attribute (no parameter or buffer: ``state_dict`` does not see them), made
from its source tensors and stamped with each one's storage and version
counter: a change in place (``load_state_dict``, an optimizer step,
train-mode BatchNorm's running statistics) rebuilds them into the same
storage, new storage builds new ones (:func:`prepared`). A change that
bypasses the version counter (through ``.data``, a fused optimizer) is not
seen. Counters (``utils/tracing.py``): the launch counters
``weights.prepared_calls`` and ``weights.cast_calls``, a call of either path
each, and ``weights.prepares``, each (re)build of a module's prepared
tensors.

Traps kept from the reference: flax's ``nn.gelu`` is the tanh approximation,
LayerNorm and BatchNorm use eps 1e-5.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention_packed
from ..parallel.collectives import (all_gather_cat, all_gather_own, all_reduce,
                                    copy_to_group, reduce_from_group)
from ..utils import tracing

PREPARED_CALLS = tracing.counter("weights.prepared_calls", launches=True)
CAST_CALLS = tracing.counter("weights.cast_calls", launches=True)
PREPARES = tracing.counter("weights.prepares")


def use_prepared(module: nn.Module) -> bool:
    """Whether a call of ``module`` runs on its prepared weights: grad off,
    the module in eval mode and no ``torch.compile`` or ``torch.export``
    trace running (an exported program keeps the per-call casts)."""
    return not (torch.is_grad_enabled() or module.training or torch.compiler.is_compiling())


def prepared(module: nn.Module, sources: tuple, dtype: torch.dtype, make) -> tuple | None:
    """``make(*sources)``, the tensors ``module`` runs on in ``dtype``, made
    once per version of ``sources`` and held on ``module``. A source changed
    in place is rebuilt into the same storage (a CUDA graph captured over
    them reads them there); a source in new storage gets new tensors. None
    where a source is an inference tensor, which tracks no version."""
    try:
        stamp = (dtype, tuple(t.data_ptr() for t in sources),
                 tuple(t._version for t in sources))
    except RuntimeError:
        return None
    held = module.__dict__.get("_prepared")
    if held is not None and held[0] == stamp:
        return held[1]
    with torch.inference_mode(False), torch.no_grad():
        made = make(*sources)
        if held is not None and held[0][:2] == stamp[:2]:
            for dst, src in zip(held[1], made):
                if dst is not src:
                    dst.copy_(src)
            made = held[1]
    module._prepared = (stamp, made)
    PREPARES.count += 1
    return made


def refresh_prepared(module: nn.Module) -> None:
    """Brings every prepared set in ``module`` up to its sources' versions:
    what a CUDA graph captured over them reads is then current."""
    for m in module.modules():
        held = m.__dict__.get("_prepared")
        if held is None:
            continue
        if isinstance(m, ConvBNAct):
            m.prepare()
        else:
            prepare_linear(m, held[0][0])


def prepare_linear(layer: nn.Linear, dtype: torch.dtype) -> tuple | None:
    """``layer``'s weight and bias (None without one) cast to ``dtype``,
    prepared (:func:`prepared`)."""
    if layer.bias is None:
        w = prepared(layer, (layer.weight,), dtype, lambda w: (w.to(dtype),))
        return None if w is None else w + (None,)
    return prepared(layer, (layer.weight, layer.bias), dtype,
                    lambda w, b: (w.to(dtype), b.to(dtype)))


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``nn.Dense(dtype=dtype)``: input, kernel and bias cast to ``dtype``;
    kernel and bias once per version where :func:`use_prepared` holds."""
    wb = prepare_linear(layer, dtype) if use_prepared(layer) else None
    if wb is not None:
        PREPARED_CALLS.count += 1
        return F.linear(x.to(dtype), *wb)
    CAST_CALLS.count += 1
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class _GroupBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the batch of every rank of ``group``: one
    fp32 all-reduce of the per-channel sum, sum of squares and count
    forward (the biased variance from them, as flax's one-pass variance),
    one of the two per-channel gradient sums backward. Returns the
    normalized ``x`` (its dtype) and the global mean and biased variance.
    The weight and bias gradients are this rank's sums: the gradient
    reduction adds the ranks' up."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        C = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                           xf.new_full((1,), x.numel() // max(C, 1))])
        dist.all_reduce(stats, group=group)
        n = stats[-1].clamp_min(1.0)
        mean = stats[:C] / n
        var = (stats[C:2 * C] / n - mean * mean).clamp_min(0.0)
        # torch's own kernel normalizes with the global statistics (its
        # inference form), so that the rounding is the one-device path's
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        C = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = (1, C) + (1,) * (x.dim() - 2)
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        g = gy.float()
        local = torch.cat([g.sum(dims), (g * xhat).sum(dims)])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        gx = (g - (sums[:C] / ctx.n).view(shape) - xhat * (sums[C:] / ctx.n).view(shape)) \
            * (invstd * weight).view(shape)
        return gx.to(x.dtype), local[C:], local[:C], None, None


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, training: bool,
               update_stats: bool = True) -> torch.Tensor:
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=bn.eps)`` over NCHW (or the
    rows of ``[N, C]``), with fp32 statistics and parameters.

    Eval: normalizes in fp32. Training: batch statistics, and with
    ``update_stats`` the running mean and (biased) variance move 0.1 of the
    way to them. A bf16 input is normalized by torch's
    mixed-dtype kernel (fp32 statistics, bf16 output, as flax's
    ``dtype=bfloat16``) so that autograd saves the bf16 activation, not an
    fp32 copy of it. Inside :func:`global_batch` the statistics are the
    group's (:class:`_GroupBatchNorm`; it too saves the activation in its
    own dtype).
    """
    if not training:
        return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            False, 0.0, bn.eps)
    group = getattr(bn, "stat_group", None)
    if group is not None:
        y, mean, var = _GroupBatchNorm.apply(x, bn.weight, bn.bias, bn.eps, group)
        if update_stats:
            with torch.no_grad():
                bn.running_mean.mul_(0.9).add_(0.1 * mean)
                bn.running_var.mul_(0.9).add_(0.1 * var)
        return y
    # torch updates copies of the statistics: autograd saves the tensors it
    # is given, and the recompute of a checkpointed region must save as many
    mean, var = bn.running_mean.clone(), bn.running_var.clone()
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, 0.1, bn.eps)
    if update_stats:
        with torch.no_grad():
            # torch moved the variance toward the UNBIASED batch variance
            # (n/(n-1) times the biased one); take it back to the biased one
            n = x.numel() // x.shape[1]
            old = 0.9 * bn.running_var
            bn.running_mean.copy_(mean)
            bn.running_var.copy_((var - old) * ((n - 1) / n) + old)
    return y


@contextlib.contextmanager
def global_batch(module: nn.Module, group, split: str = "rows"):
    """Inside this context (forward AND backward: a checkpointed region
    recomputes its forward in the backward), ``module``'s train-mode
    BatchNorms take their statistics, and its MoE MLPs their auxiliary's
    token means and their routing of one global group (``group_size`` 0),
    over the batch of every rank of ``group`` (a ``data`` or ``seq``
    mesh's); None is this rank's batch alone. ``split``: whether the group
    splits the clips (``"rows"``, a ``data`` axis) or each clip's tokens
    (``"tokens"``, a ``seq`` axis)."""
    mods = [m for m in module.modules()
            if isinstance(m, (nn.modules.batchnorm._BatchNorm, MoeMlp))]
    prev = [(getattr(m, "stat_group", None), getattr(m, "stat_split", "rows")) for m in mods]
    for m in mods:
        m.stat_group, m.stat_split = group, split
    try:
        yield
    finally:
        for m, (g, s) in zip(mods, prev):
            m.stat_group, m.stat_split = g, s


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm -> SiLU (optional), NCHW.

    The JAX package's stride-2 stem runs as ``StemConvS2D`` (space-to-depth)
    for the TPU's matrix unit; that is the same math as this symmetric pad-1
    3x3 stride-2 conv with the same kernel. ``bn_zero_init`` is flax's
    ``bn_scale_init=zeros`` (the last BN of a residual MBConv).
    """

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True, dtype: torch.dtype = torch.float32,
                 bn_zero_init: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, stride=stride,
                              padding=kernel // 2, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5)
        self.bn_zero_init = bn_zero_init
        if bn_zero_init:
            nn.init.zeros_(self.bn.weight)
        self.act = act
        self.dtype = dtype
        self.update_stats = True  # off inside frozen_bn_stats
        self.pointwise = kernel == 1 and stride == 1 and groups == 1

    def prepare(self) -> tuple | None:
        """The conv's weight and bias with the eval BatchNorm folded in, in
        ``dtype`` (:func:`fold_bn`), prepared."""
        c, bn = self.conv, self.bn
        return prepared(self, (c.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var),
                        self.dtype, lambda *ts: fold_bn(*ts, bn.eps, self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        # fp32 casts nothing and its eval BatchNorm is one pass: the per-call
        # path is as short, and folding would only move its rounding
        prep = self.prepare() if self.dtype != torch.float32 and use_prepared(self) else None
        if prep is not None:
            PREPARED_CALLS.count += 1
            x = x.to(self.dtype)
            if self.pointwise and x.is_contiguous(memory_format=torch.channels_last):
                # a 1x1 conv over channels-last rows is one GEMM whose
                # epilogue adds the bias; cuDNN's conv adds it by a kernel
                N, C, H, W = x.shape
                w, b = prep
                x = F.linear(x.permute(0, 2, 3, 1).reshape(N * H * W, C), w.view(-1, C), b)
                x = x.view(N, H, W, -1).permute(0, 3, 1, 2)
            else:
                x = F.conv2d(x, *prep, c.stride, c.padding, c.dilation, c.groups)
            return F.silu(x, inplace=True) if self.act else x
        CAST_CALLS.count += 1
        x = F.conv2d(x.to(self.dtype), c.weight.to(self.dtype), None, c.stride,
                     c.padding, c.dilation, c.groups)
        x = batch_norm(x, self.bn, self.training, self.update_stats).to(self.dtype)
        return F.silu(x) if self.act else x


def fold_bn(weight: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor, eps: float,
            dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """A conv ``weight`` ``[C_out, C_in/groups, k, k]`` and the eval
    BatchNorm after it as one conv: ``weight * s`` and the bias ``beta -
    mean * s``, with ``s = gamma / sqrt(var + eps)`` a channel (one scale an
    output channel, grouped convs too), computed in fp32 and cast to
    ``dtype`` once. A bias in ``dtype`` keeps the conv's bias add a kernel
    of one dtype (with an fp32 bias it casts, about 1.6 times as long on an
    H100)."""
    s = gamma.float() / torch.sqrt(var.float() + eps)
    return ((weight.float() * s[:, None, None, None]).to(dtype),
            (beta.float() - mean.float() * s).to(dtype))


@contextlib.contextmanager
def frozen_bn_stats(module: nn.Module, frozen: bool = True):
    """Inside this context, train-mode BatchNorm in ``module``'s ConvBNActs
    updates no running statistics (with ``frozen``)."""
    convs = [m for m in module.modules() if isinstance(m, ConvBNAct)]
    prev = [m.update_stats for m in convs]
    for m in convs:
        m.update_stats = not frozen
    try:
        yield
    finally:
        for m, p in zip(convs, prev):
            m.update_stats = p


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual: pw-expand -> dw -> pw-project."""

    def __init__(self, in_ch: int, features: int, expand: int = 4, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(in_ch * expand)
        self.use_res = stride == 1 and in_ch == features
        self.expand = ConvBNAct(in_ch, hidden, kernel=1, dtype=dtype)
        self.dw = ConvBNAct(hidden, hidden, kernel=3, stride=stride, groups=hidden,
                            dtype=dtype)
        self.project = ConvBNAct(hidden, features, kernel=1, act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.dw(self.expand(x)))
        return x + y if self.use_res else y


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm ``DropPath``), with the decisions
    passed in: ``keep`` is ``[N]``, 0 for a dropped sample and
    ``1/(1-rate)`` for a kept one (see :meth:`draw`)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def draw(self, n: int, generator: torch.Generator,
             device: torch.device | None = None) -> torch.Tensor | None:
        """This module's decisions for ``n`` samples, or None at rate 0."""
        if not self.rate:
            return None
        keep_prob = 1.0 - self.rate
        kept = torch.rand(n, generator=generator, device=generator.device) < keep_prob
        return (kept.float() / keep_prob).to(device or generator.device)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        if not (self.rate and self.training):
            return x
        if keep is None:
            raise ValueError(f"DropPath(rate={self.rate}) in training needs its "
                             "decisions: pass keep from draw() (explicit generator)")
        return x * keep.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))


class Mlp(nn.Module):
    """Dense -> GELU (tanh approximation, as flax) -> Dense. Cut over a
    ``model`` line (``parallel/tp.py``: ``tp_group`` set), this rank holds a
    block of the hidden units: ``f`` before the first linear, ``g`` after
    the second, whose bias is added once after the sum."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.dtype = dtype
        self.tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is None:
            return linear(gelu(linear(x, self.fc1, self.dtype)), self.fc2, self.dtype)
        h = gelu(linear(copy_to_group(x, self.tp_group), self.fc1, self.dtype))
        return row_parallel(h, self.fc2, self.dtype, self.tp_group)


def row_parallel(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype, group) -> torch.Tensor:
    """A row-parallel linear: this rank's columns of ``layer`` on its part
    of the input, summed over ``group`` (``g``), then the bias."""
    y = reduce_from_group(F.linear(x.to(dtype), layer.weight.to(dtype)), group)
    return y + layer.bias.to(dtype)


# MoeMlp's counters (see its docstring)
MOE_CALLS = tracing.counter("moe.calls")
MOE_TOKENS = tracing.counter("moe.tokens")
MOE_SLOTS = tracing.counter("moe.slots")
MOE_KEPT = tracing.device_counter("moe.kept")


class MoeMlp(nn.Module):
    """Top-1-routed mixture-of-experts MLP (the JAX package's opt-in
    ``MoeMlp``, GShard-style static-shape dispatch).

    Tokens route within groups of ``group_size`` (all ``B*L`` tokens when
    0; a size that does not divide them raises, as in JAX: one flat group
    would make the dispatch quadratic in tokens). The router (``nn.Linear``)
    runs in fp32 on fp32 inputs, then softmax; each token takes the argmax
    expert, gated by that expert's probability. Its slot in the expert's
    buffer of ``C = max(1, ceil(S * capacity_factor / E))`` per group is
    ``cumsum(onehot) - 1``; tokens past C are dropped (their output is 0, so
    the block's residual passes them through). Dispatch ``[G, S, E, C]`` in
    the compute dtype feeds the ``gsec,gsd->egcd`` einsum, the expert bank
    (``w1 [E, D, H]``, ``b1``, ``w2 [E, H, D]``, ``b2``) runs as batched
    matmuls over experts (JAX's ``expert_parallel_apply``), and the gated
    combine ``gsec,egcd->gsd`` brings the outputs back.

    ``forward`` returns ``(y, aux)``: ``aux`` is the Switch load-balance
    auxiliary ``E * sum_e mean(onehot_e) * mean(probs_e)``, differentiable
    through the probabilities: 1 when the tokens spread evenly, E when every
    token picks one expert with certainty, never under 1/E (a token's
    argmax probability is at least 1/E), and it can dip just under 1.
    Inside :func:`global_batch` the means are over the group's tokens and
    ``aux`` is this rank's share of it (the ranks' shares sum to it). There
    the capacity groups of ``group_size`` > 0 lie within a rank's tokens;
    with 0 every token of the global batch routes as one group, as in JAX:
    the capacity is the global count's, and a rank's slots in each expert's
    buffer follow those of the tokens before its own in the global order
    (one all-gather of the per-clip counts). Each rank's buffer holds its
    own tokens' slots; the expert MLP is per slot, so no token moves.

    Cut over an ``expert`` line (``parallel/ep.py``: ``expert_group`` set)
    the rank holds experts ``expert_lo ..`` of the bank, feeds them their
    slots and gathers every expert's output over the line for the combine.

    Traced (``utils/tracing.py``): spans ``moe.route``, ``moe.dispatch``,
    ``moe.experts``, ``moe.combine`` in the forward and ``moe.bwd`` around
    the layer's backward. Counters, each a call's routing once (not again
    where activation checkpointing recomputes the call): ``moe.calls``,
    ``moe.tokens`` (B*L), ``moe.slots`` (E*G*C, every expert's buffer) and
    the device counter ``moe.kept``, the tokens that fit their expert's
    buffer.
    """

    def __init__(self, dim: int, hidden: int, num_experts: int,
                 capacity_factor: float = 2.0, group_size: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        E = num_experts
        self.num_experts, self.capacity_factor, self.group_size = E, capacity_factor, group_size
        self.router = nn.Linear(dim, E)
        self.w1 = nn.Parameter(torch.empty(E, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(E, hidden))
        self.w2 = nn.Parameter(torch.empty(E, hidden, dim))
        self.b2 = nn.Parameter(torch.zeros(E, dim))
        for w in (self.w1, self.w2):
            nn.init.normal_(w, 0.0, w.shape[1] ** -0.5)
        self.dtype = dtype
        self.expert_group, self.expert_lo = None, 0

    def capacity(self, tokens: int) -> tuple[int, int, int]:
        """``(G, S, C)``: groups, tokens a group and slots an expert a group
        for ``tokens`` tokens."""
        if self.group_size > 0 and tokens % self.group_size:
            raise ValueError(
                f"moe group_size={self.group_size} must divide the token count "
                f"B*L={tokens}; pick a divisor of the per-clip token count")
        S = self.group_size if self.group_size > 0 else tokens
        C = max(1, int(-(-S * self.capacity_factor // self.num_experts)))
        return tokens // S, S, C

    def _route(self, x: torch.Tensor):
        """Router probabilities ``[N, E]`` (fp32), each token's one-hot
        expert ``[G, S, E]``, its slot in the group, the one-hot of the
        tokens that fit their expert's buffer, and ``(G, S, C)``."""
        B, L, D = x.shape
        E = self.num_experts
        probs = torch.softmax(F.linear(x.reshape(B * L, D).float(), self.router.weight,
                                       self.router.bias), -1)
        onehot = F.one_hot(probs.argmax(-1), E).float()
        group = getattr(self, "stat_group", None)
        if group is None or self.group_size > 0:
            G, S, C = self.capacity(B * L)
            onehot = onehot.reshape(G, S, E)
            pos = onehot.cumsum(1) - 1.0                          # slot in group
        else:
            # one global group: every rank holds as many tokens
            G, S = 1, B * L
            _, _, C = self.capacity(B * L * dist.get_world_size(group))
            pos = self._global_slots(onehot.reshape(B, L, E), group).reshape(1, S, E)
            onehot = onehot.reshape(1, S, E)
        return probs, onehot, pos, (pos < C).float() * onehot, (G, S, C)

    def _global_slots(self, onehot: torch.Tensor, group) -> torch.Tensor:
        """Each of this rank's tokens' slot ``[B, L, E]`` in its expert's
        buffer of one group over the global batch, whose tokens run clip by
        clip and, within a clip, rank by rank (``stat_split`` "tokens"), or
        rank by rank (``"rows"``)."""
        counts = onehot.sum(1)                                    # [B, E]
        every = all_gather_cat(counts, group)
        every = every.reshape(-1, *counts.shape)                  # [R, B, E]
        r = dist.get_rank(group)
        if getattr(self, "stat_split", "rows") == "rows":
            before = every[:r].sum((0, 1))[None, None]            # [1, 1, E]
            return before + onehot.reshape(1, -1, onehot.shape[-1]).cumsum(1).reshape(
                onehot.shape) - 1.0
        per_clip = every.sum(0)
        before = (per_clip.cumsum(0) - per_clip + every[:r].sum(0))[:, None]  # [B, 1, E]
        return before + onehot.cumsum(1) - 1.0

    @torch.no_grad()
    def assignments(self, x: torch.Tensor) -> torch.Tensor:
        """Each token's expert ``[B*L]``, or -1 where its expert's buffer
        was full (the token was dropped)."""
        _, onehot, _, keep, _ = self._route(x)
        expert = onehot.argmax(-1).flatten()
        return torch.where(keep.sum(-1).flatten() > 0, expert, -1)

    def _dispatch(self, dispatch: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
        """The slots ``dispatch [G, S, E, C]`` gives this rank's experts
        from ``xt [G, S, D]``: ``[n, G*C, D]``."""
        G, C, D = dispatch.shape[0], dispatch.shape[-1], xt.shape[-1]
        n = self.w1.shape[0]
        if self.expert_group is not None:
            # each rank feeds its own experts: the tokens' gradient through
            # them is a part that the line sums
            dispatch = dispatch[:, :, self.expert_lo:self.expert_lo + n]
            xt = copy_to_group(xt, self.expert_group)
        return torch.einsum("gsec,gsd->egcd", dispatch, xt).reshape(n, G * C, D)

    def _experts(self, expert_in: torch.Tensor, G: int, C: int) -> torch.Tensor:
        """Every expert's outputs ``[E, G, C, D]`` for this rank's experts'
        slots ``expert_in``: this rank's experts run here, the rest arrive
        over the expert line."""
        dt = self.dtype
        h = gelu(torch.bmm(expert_in, self.w1.to(dt)) + self.b1.to(dt)[:, None])
        out = torch.bmm(h, self.w2.to(dt)) + self.b2.to(dt)[:, None]
        if self.expert_group is not None:
            out = all_gather_own(out, 0, self.expert_group)
        return out.reshape(self.num_experts, G, C, -1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        B, L, D = x.shape
        E, dt = self.num_experts, self.dtype
        group = getattr(self, "stat_group", None)
        bwd = None
        if tracing.enabled() and torch.is_grad_enabled() and x.requires_grad:
            bwd = tracing.BackwardRange("moe.bwd")
            x, = bwd.inputs(x)
        with tracing.span("moe.route"):
            probs, onehot, pos, keep, (G, S, C) = self._route(x)
            gate = probs.amax(-1)                                 # top-1 prob
            onehot = onehot.reshape(B * L, E)
            if group is None:
                aux = E * (onehot.mean(0) * probs.mean(0)).sum()
            else:
                # this rank's share of the global auxiliary: the global
                # one-hot mean times this rank's probability sum over the
                # global count
                counts = all_reduce(torch.cat([onehot.sum(0), probs.new_full((1,), B * L)]),
                                    group)
                n = counts[-1]
                aux = E * (counts[:E] / n * probs.sum(0) / n).sum()
        if not tracing.recomputing():
            MOE_CALLS.count += 1
            MOE_TOKENS.count += B * L
            MOE_SLOTS.count += E * G * C
            MOE_KEPT.add(torch.count_nonzero(keep))
        with tracing.span("moe.dispatch"):
            slots = torch.arange(C, device=x.device, dtype=pos.dtype)
            dispatch = (keep[..., None] * (pos[..., None] == slots)).to(dt)  # [G, S, E, C]
            expert_in = self._dispatch(dispatch, x.reshape(G, S, D).to(dt))
        with tracing.span("moe.experts"):
            out = self._experts(expert_in, G, C)
        with tracing.span("moe.combine"):
            combine = dispatch * gate.reshape(G, S, 1, 1).to(dt)
            y = torch.einsum("gsec,egcd->gsd", combine, out).reshape(B, L, D).to(dt)
        if bwd is not None:
            y, aux = bwd.outputs(y, aux)
        return y, aux


class SELayer(nn.Module):
    """Squeeze-and-excitation over NCHW, bias-free denses
    (ref: src/models/tiny_vit.py:20-34)."""

    def __init__(self, ch: int, reduction: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(ch, ch // reduction, bias=False)
        self.fc2 = nn.Linear(ch // reduction, ch, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(2, 3))
        y = torch.sigmoid(linear(torch.relu(linear(y, self.fc1, self.dtype)),
                                 self.fc2, self.dtype))
        return x * y[:, :, None, None]


class MBConv(nn.Module):
    """TinyViT's MBConv over NCHW: expand -> dw -> SE -> project, GELU
    activations (ref: src/models/tiny_vit.py:36-56). The final BN scale is
    zero-initialised on residual blocks only, as in the JAX package
    (models/layers.py:234-249): on a non-residual block it locks training."""

    def __init__(self, in_ch: int, features: int, expand: int = 4, stride: int = 1,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = int(in_ch * expand)
        self.use_res = stride == 1 and in_ch == features
        self.expand = ConvBNAct(in_ch, mid, kernel=1, act=False, dtype=dtype)
        self.dw = ConvBNAct(mid, mid, kernel=3, stride=stride, groups=mid, act=False,
                            dtype=dtype)
        self.se = SELayer(mid, dtype=dtype)
        self.project = ConvBNAct(mid, features, kernel=1, act=False, dtype=dtype,
                                 bn_zero_init=self.use_res)
        self.drop_path = DropPath(drop_path if self.use_res else 0.0)

    def draw_drop_path(self, n: int, generator: torch.Generator, device=None):
        return self.drop_path.draw(n, generator, device)

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        y = self.se(gelu(self.dw(gelu(self.expand(x)))))
        y = self.project(y)
        return x + self.drop_path(y, keep) if self.use_res else y


class MultiHeadAttention(nn.Module):
    """Fused-QKV multi-head self-attention over ``[B, L, D]``.

    The thirds of the fused qkv output go to the packed attention entry as
    strided ``[B, L, H*d]`` views: no head split, no copy. The head width is
    ``dim // num_heads``, so ``H*d`` may be narrower than ``dim`` (as flax's
    ``key_dim``). ``attn_impl="sp"`` is the sequence-parallel branch: ``x``
    is this rank's block of a ``seq`` mesh's sequence, and the attention
    runs over the whole sequence (``ops/attention.attention_packed``,
    ``parallel/sp.py``). Cut over a ``model`` line (``parallel/tp.py``) it
    holds ``local_heads`` whole heads, rows ``[q_r | k_r | v_r]`` of ``qkv``
    and their columns of ``proj``, and runs the attention on them.
    """

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 attn_impl: str | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * num_heads * self.head_dim)
        self.proj = nn.Linear(num_heads * self.head_dim, dim)
        self.dtype = dtype
        self.attn_impl = attn_impl
        # cut over a model line (parallel/tp.py): this rank's heads and group
        self.local_heads, self.tp_group = num_heads, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            x = copy_to_group(x, self.tp_group)
        H = self.local_heads
        hd = H * self.head_dim
        qkv = linear(x, self.qkv, self.dtype)
        # a rank without heads feeds its empty block to the projection, so
        # that its input still takes part in the backward's collectives
        o = (attention_packed(qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:], H,
                              self.attn_impl) if H else qkv[..., :0])
        if self.tp_group is None:
            return linear(o, self.proj, self.dtype)
        return row_parallel(o, self.proj, self.dtype, self.tp_group)


class TransformerBlock(nn.Module):
    """Pre-norm transformer block: x + attn(ln(x)); x + mlp(ln(x)). The two
    residual branches have their own stochastic-depth decisions.
    ``moe_experts`` > 0 puts a :class:`MoeMlp` in the MLP's place."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32,
                 attn_impl: str | None = None, moe_experts: int = 0,
                 moe_capacity_factor: float = 2.0, moe_group_size: int = 0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadAttention(dim, num_heads, dtype=dtype, attn_impl=attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        hidden = int(dim * mlp_ratio)
        self.mlp = (MoeMlp(dim, hidden, moe_experts, moe_capacity_factor, moe_group_size,
                           dtype=dtype) if moe_experts else Mlp(dim, hidden, dtype=dtype))
        self.drop_path = DropPath(drop_path)
        self.dtype = dtype

    def _norm(self, x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
        return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                            ln.eps).to(self.dtype)

    def draw_drop_path(self, n: int, generator: torch.Generator, device=None):
        if not self.drop_path.rate:
            return None
        return (self.drop_path.draw(n, generator, device),
                self.drop_path.draw(n, generator, device))

    def forward(self, x: torch.Tensor, keep: tuple | None = None,
                with_aux: bool = False):
        """``x``, or ``(x, aux)`` with ``with_aux`` (the MoE load-balance
        auxiliary, None for a dense MLP)."""
        k_attn, k_mlp = keep if keep is not None else (None, None)
        x = x + self.drop_path(self.attn(self._norm(x, self.norm1)), k_attn)
        h = self.mlp(self._norm(x, self.norm2))
        h, aux = h if isinstance(self.mlp, MoeMlp) else (h, None)
        x = x + self.drop_path(h, k_mlp)
        return (x, aux) if with_aux else x


class TransformerEncoder(nn.Module):
    """Stack of pre-norm TransformerBlocks (flax names ``block{i}``), with
    MoE MLPs when ``moe_experts`` > 0."""

    def __init__(self, dim: int, depth: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32, attn_impl: str | None = None,
                 moe_experts: int = 0, moe_capacity_factor: float = 2.0,
                 moe_group_size: int = 0):
        super().__init__()
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_ratio=mlp_ratio, dtype=dtype,
                             attn_impl=attn_impl, moe_experts=moe_experts,
                             moe_capacity_factor=moe_capacity_factor,
                             moe_group_size=moe_group_size)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, with_aux: bool = False):
        """``x``, or ``(x, auxes)`` with ``with_aux``: each MoE block's
        load-balance auxiliary, in block order (empty when dense). The
        blocks hand them back as values: no module keeps one."""
        auxes = []
        for blk in self.blocks:
            x, aux = blk(x, with_aux=True)
            if aux is not None:
                auxes.append(aux)
        return (x, auxes) if with_aux else x


def adaptive_avg_pool_nhwc(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Adaptive average pool ``[B, H, W, C]`` -> ``[B, s, s, C]`` with torch's
    bins ``[floor(i*H/s), ceil((i+1)*H/s))``, the JAX package's rule: 7 -> 3
    pools the overlapping rows [0,3), [2,5), [4,7)."""
    if x.shape[1] == out_size and x.shape[2] == out_size:
        return x
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out_size).permute(0, 2, 3, 1)
