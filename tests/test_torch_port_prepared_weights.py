"""Prepared inference weights (``models/layers.py``): with grad off and the
module in eval mode, a bf16 ``ConvBNAct`` runs one conv with the eval
BatchNorm folded into its weight and bias, and ``linear`` its weight and
bias cast once; with grad on or in train mode both run the per-call casts
and the BatchNorm as before.

Toy shapes on the CPU. The per-call formula is the reference: the fold in
fp32 to 1e-5; in bf16 no further from the fp32 formula than the per-call
bf16 formula is, to one bf16 ulp at the fp32 result's scale. A change in place of
a source tensor rebuilds the prepared tensors into the same storage, new
storage builds new ones, and ``state_dict`` sees none of them.
"""
import math

import pytest
import torch
from torch import nn

from ssl_vit_video_analytics_tpu_torch.models import dynamic, layers
from ssl_vit_video_analytics_tpu_torch.utils import tracing

torch.set_num_threads(2)  # six test workers share the host

COUNTERS = ("weights.prepared_calls", "weights.cast_calls", "weights.prepares")


def _counted(fn):
    before = tracing.counters()
    out = fn()
    after = tracing.counters()
    return out, {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


class Lin(nn.Module):
    """``layers.linear`` over one ``nn.Linear``, as the port's blocks call it."""

    def __init__(self, bias=True, dtype=torch.float32):
        super().__init__()
        self.fc = nn.Linear(12, 10, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        return layers.linear(x, self.fc, self.dtype)


# name: (module of dtype, input shape)
CASES = {
    "dense": (lambda dt: layers.ConvBNAct(4, 6, kernel=3, stride=2, dtype=dt), (2, 4, 9, 9)),
    "depthwise": (lambda dt: layers.ConvBNAct(6, 6, kernel=3, groups=6, dtype=dt), (2, 6, 7, 7)),
    "no_act": (lambda dt: layers.ConvBNAct(6, 5, kernel=1, act=False, dtype=dt), (2, 6, 5, 5)),
    # a 1x1 conv over a channels-last input: prepared, one GEMM
    "pointwise_nhwc": (lambda dt: layers.ConvBNAct(6, 5, kernel=1, dtype=dt), (2, 6, 5, 5)),
    "linear": (lambda dt: Lin(dtype=dt), (3, 4, 12)),
    "linear_no_bias": (lambda dt: Lin(bias=False, dtype=dt), (3, 12)),
}


def _module(case, dtype, seed=0):
    """The case's module, every tensor drawn away from its init: BatchNorm
    scales, shifts and running statistics far from 1 and 0."""
    make, _ = CASES[case]
    g = torch.Generator().manual_seed(seed)
    m = make(dtype)
    with torch.no_grad():
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            if t.is_floating_point():
                r = torch.randn(t.shape, generator=g)
                t.copy_(torch.rand(t.shape, generator=g) * 1.5 + 0.5 if name.endswith("var")
                        else r * 0.5 + 1.0 if name.endswith("bn.weight") else r * 0.3)
    return m.eval()


def _x(case, seed=1):
    x = torch.randn(CASES[case][1], generator=torch.Generator().manual_seed(seed))
    return x.contiguous(memory_format=torch.channels_last) if case.endswith("nhwc") else x


def _per_call(m, x):
    """The per-call path: the module's forward with grad on."""
    with torch.enable_grad():
        return m(x).detach()


def _fp32_ref(case, seed=0):
    return _per_call(_module(case, torch.float32, seed), _x(case))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_prepared_weights_match_the_per_call_formula(case, dtype):
    """A linear in either dtype and a bf16 ConvBNAct run on prepared
    weights; an fp32 ConvBNAct keeps the per-call path, whose eval
    BatchNorm is one pass and which casts nothing, bit for bit."""
    m, x = _module(case, dtype), _x(case)
    ref = _fp32_ref(case)
    with torch.inference_mode():
        got, counted = _counted(lambda: m(x))
        again, counted_again = _counted(lambda: m(x))
    assert got.dtype == dtype and torch.equal(got, again)
    on_prepared = case.startswith("linear") or dtype != torch.float32
    assert counted == {"weights.prepared_calls": int(on_prepared),
                       "weights.cast_calls": int(not on_prepared),
                       "weights.prepares": int(on_prepared)}
    assert counted_again == {**counted, "weights.prepares": 0}
    if case.startswith("linear") or dtype == torch.float32:
        assert torch.equal(got, _per_call(m, x))  # a cast once is the cast each call makes
    else:
        # no further from the fp32 formula than the per-call bf16 formula
        # is, to one bf16 ulp at the fp32 result's scale
        ulp = 2.0 ** (math.floor(math.log2(ref.abs().max())) - 7)
        err = lambda y: float((y.float() - ref).abs().max())  # noqa: E731
        assert err(got) <= err(_per_call(m, x)) + ulp


@pytest.mark.parametrize("case", ["dense", "depthwise", "no_act", "pointwise_nhwc"])
def test_the_fold_in_fp32_is_the_conv_and_its_eval_batchnorm(case):
    m, x = _module(case, torch.float32), _x(case)
    c, bn = m.conv, m.bn
    w, b = layers.fold_bn(c.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                          bn.eps, torch.float32)
    with torch.no_grad():
        y = torch.nn.functional.conv2d(x, w, b, c.stride, c.padding, c.dilation, c.groups)
    torch.testing.assert_close(torch.nn.functional.silu(y) if m.act else y, _fp32_ref(case),
                               atol=1e-5, rtol=1e-5)


def _load_state_dict(m, other):
    m.load_state_dict(other.state_dict())


def _copy(m, other):
    with torch.no_grad():
        for a, b in zip(m.parameters(), other.parameters()):
            a.copy_(b)
        for a, b in zip(m.buffers(), other.buffers()):
            a.copy_(b)


@pytest.mark.parametrize("change", [_load_state_dict, _copy], ids=["load_state_dict", "copy_"])
@pytest.mark.parametrize("case", ["dense", "linear"])
def test_a_change_in_place_rebuilds_in_place_and_new_storage_anew(case, change):
    m, other = _module(case, torch.bfloat16), _module(case, torch.bfloat16, seed=5)
    x = _x(case)
    with torch.no_grad():
        m(x)
        held = m.__dict__.get("_prepared") or m.fc.__dict__["_prepared"]
        ptrs = [t.data_ptr() for t in held[1]]
        change(m, other)
        (got, counted) = _counted(lambda: m(x))
        assert counted["weights.prepares"] == 1
        now = m.__dict__.get("_prepared") or m.fc.__dict__["_prepared"]
        assert [t.data_ptr() for t in now[1]] == ptrs
        assert torch.equal(got, other(x))

        for p in m.parameters():  # new storage: new prepared tensors
            p.data = p.data.clone()
        (again, counted) = _counted(lambda: m(x))
        now = m.__dict__.get("_prepared") or m.fc.__dict__["_prepared"]
        assert counted["weights.prepares"] == 1
        assert [t.data_ptr() for t in now[1]] != ptrs
        assert torch.equal(again, got)


def test_a_train_step_moves_the_running_statistics_and_eval_rebuilds():
    m = _module("dense", torch.bfloat16)
    x = _x("dense")
    with torch.no_grad():
        before = m(x)
        m.train()
        m(x)  # moves the running statistics in place
        m.eval()
        after, counted = _counted(lambda: m(x))
    assert counted["weights.prepares"] == 1
    assert not torch.equal(before, after)
    m32 = _module("dense", torch.float32)
    m32.load_state_dict(m.state_dict())
    ref = _per_call(m32, x)
    ulp = 2.0 ** (math.floor(math.log2(ref.abs().max())) - 7)
    err = lambda y: float((y.float() - ref).abs().max())  # noqa: E731
    assert err(after) <= err(_per_call(m, x)) + ulp


def _parent(m, x):
    """The module's per-call formula as the forward ran it before weights
    were prepared."""
    if isinstance(m, Lin):
        b = None if m.fc.bias is None else m.fc.bias.to(m.dtype)
        return torch.nn.functional.linear(x.to(m.dtype), m.fc.weight.to(m.dtype), b)
    c = m.conv
    y = torch.nn.functional.conv2d(x.to(m.dtype), c.weight.to(m.dtype), None, c.stride,
                                   c.padding, c.dilation, c.groups)
    y = layers.batch_norm(y, m.bn, m.training, m.update_stats).to(m.dtype)
    return torch.nn.functional.silu(y) if m.act else y


@pytest.mark.parametrize("mode", ["eval_grad_on", "train_grad_on", "train_grad_off"])
@pytest.mark.parametrize("case", ["dense", "no_act", "linear"])
def test_grad_on_or_train_mode_runs_the_per_call_path(case, mode):
    """Outputs, running statistics and gradients bit for bit those of the
    per-call formula; no prepared call, no prepare."""
    m, twin = _module(case, torch.bfloat16), _module(case, torch.bfloat16)
    if mode.startswith("train"):
        m.train(), twin.train()
    grad = mode.endswith("grad_on")
    x = _x(case).requires_grad_(grad)
    xt = x.detach().clone().requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        y, counted = _counted(lambda: m(x))
        yt = _parent(twin, xt)
    assert counted == {"weights.prepared_calls": 0, "weights.cast_calls": 1,
                       "weights.prepares": 0}
    assert torch.equal(y, yt)
    for a, b in zip(m.buffers(), twin.buffers()):
        assert torch.equal(a, b)
    if grad:
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(3)).to(y.dtype)
        got = torch.autograd.grad(y, [x, *m.parameters()], g)
        want = torch.autograd.grad(yt, [xt, *twin.parameters()], g)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["dense", "linear"])
def test_prepared_tensors_are_no_parameters_or_buffers(case):
    m = _module(case, torch.bfloat16)
    keys, storage = list(m.state_dict()), dynamic._storage(m)
    with torch.inference_mode():
        m(_x(case))
    assert list(m.state_dict()) == keys
    assert dynamic._storage(m) == storage
    assert len(list(m.parameters())) + len(list(m.buffers())) == len(storage)


def test_a_module_built_under_inference_mode_keeps_the_per_call_path():
    """Its parameters are inference tensors, which keep no version counter:
    nothing could tell a change in place, so nothing is prepared."""
    with torch.inference_mode():
        m = _module("dense", torch.bfloat16)
        x = _x("dense")
        got, counted = _counted(lambda: m(x))
    assert counted == {"weights.prepared_calls": 0, "weights.cast_calls": 1,
                       "weights.prepares": 0}
    with torch.inference_mode():
        assert torch.equal(got, _parent(m, x))
