"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the last
steps or batches, the benchmark's own host ranges, the attention probe, and
the reduction of the trace to device busy time, idle gaps by what the host
was doing, device time by kernel and by group, and each attention call's
device time beside its bound.

The attention probe wraps the one name through which the port's models
call attention (``models.layers.attention_packed``): for each call it
records (B, Lq, Lk, H, d, dtype), brackets the forward with a profiler
range, and puts identity autograd functions on the inputs and the output
whose backward passes open and close a range around the call's backward.
A range's device time is that of the kernels launched inside it, whatever
their names, so the rooflines read the same work whichever implementation
runs attention.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.autograd.profiler import record_function

from .yardstick import attention_bound

PREFIX = "h100_bench."

# device time by group: the first group whose pattern a kernel's name holds
GROUPS = (
    ("K1 flash_fwd", ("flash_fwd",)),
    ("K2 flash_bwd", ("flash_bwd",)),
    ("batch_norm", ("batch_norm", "bn_fw", "bn_bw", "batchnorm")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "depthwise")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
    ("softmax_reduce", ("softmax", "reduce")),
    ("elementwise_copy", ("elementwise", "vectorized", "unrolled", "copy", "cat", "index")),
    ("memcpy_memset", ("memcpy", "memset")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, patterns in GROUPS:
        if any(p in low for p in patterns):
            return group
    return "other"


def span(name: str, on: bool):
    """A host range named ``h100_bench.<name>`` while tracing, else nothing."""
    return record_function(PREFIX + name) if on else contextlib.nullcontext()


class _OutputHook(torch.autograd.Function):
    """Identity forward; its backward opens the call's backward range."""

    @staticmethod
    def forward(ctx, probe, i, out):
        ctx.probe, ctx.i = probe, i
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        rf = record_function(f"{PREFIX}attn_bwd#{ctx.i}")
        rf.__enter__()
        ctx.probe.open[ctx.i] = rf
        return None, None, g


class _InputHook(torch.autograd.Function):
    """Identity forward; its backward closes the call's backward range."""

    @staticmethod
    def forward(ctx, probe, i, q, k, v):
        ctx.probe, ctx.i = probe, i
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        rf = ctx.probe.open.pop(ctx.i, None)
        if rf is not None:
            rf.__exit__(None, None, None)
        return None, None, gq, gk, gv


class AttentionProbe:
    """While entered, every call of the port's ``attention_packed`` through
    its models is recorded and bracketed (see the module docstring)."""

    def __init__(self):
        self.calls: list[tuple] = []
        self.open: dict[int, object] = {}

    def __enter__(self):
        from ssl_vit_video_analytics_tpu_torch.models import layers

        self._layers, self._orig = layers, layers.attention_packed
        orig = self._orig

        def probed(q, k, v, num_heads, impl=None):
            i = len(self.calls)
            B, Lq, HD = q.shape
            self.calls.append((B, Lq, k.shape[1], num_heads, HD // num_heads, q.dtype))
            grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                                or v.requires_grad)
            if grad:
                q, k, v = _InputHook.apply(self, i, q, k, v)
            with record_function(f"{PREFIX}attn_fwd#{i}"):
                out = orig(q, k, v, num_heads, impl)
            return _OutputHook.apply(self, i, out) if grad else out

        layers.attention_packed = probed
        return self

    def __exit__(self, *exc):
        self._layers.attention_packed = self._orig
        return False


def _kernels_under(evt) -> list:
    out = list(evt.kernels)
    for child in evt.cpu_children:
        out.extend(_kernels_under(child))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Profiled:
    """``torch.profiler`` over a block of steps, timed by the host clock
    between two device synchronisations."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.device = device

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        return False

    def summary(self, probe: AttentionProbe | None = None, top: int = 10) -> dict:
        """Busy seconds, the window, device seconds by kernel and group, the
        longest idle gaps by host range, and the attention calls' device
        seconds beside their bounds."""
        events = list(self.prof.events())
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(PREFIX)]
        by_kernel, by_group = defaultdict(float), defaultdict(float)
        for e in dev:
            s = e.time_range.elapsed_us() / 1e6
            by_kernel[e.name] += s
            by_group[group_of(e.name)] += s
        merged = _merge((e.time_range.start, e.time_range.end) for e in dev)
        busy_s = sum(e - s for s, e in merged) / 1e6
        gaps = self._gaps(events, merged)
        out = {
            "busy_s": busy_s, "window_s": self.window_s,
            "device_ops": sorted(([n[:120], s] for n, s in by_kernel.items()),
                                 key=lambda r: -r[1])[:top],
            "groups": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
            "idle_gaps": gaps[:top],
        }
        if probe is not None:
            out["attention"] = self._attention(events, probe)
        return out

    @staticmethod
    def _gaps(events, merged) -> list:
        """Idle seconds between device work, summed by what the host's main
        thread was inside when the gap ended: the innermost benchmark range
        and the innermost operator below it."""
        ranges = [e for e in events if e.device_type == DeviceType.CPU
                  and e.name.startswith(PREFIX) and "#" not in e.name]
        if not ranges:
            return []
        main = ranges[0].thread
        cpu = sorted((e for e in events if e.device_type == DeviceType.CPU and e.thread == main),
                     key=lambda e: e.time_range.start)
        totals = defaultdict(float)
        active, nxt = [], 0
        for (_, end), (start, _) in zip(merged, merged[1:]):
            t = start
            while nxt < len(cpu) and cpu[nxt].time_range.start <= t:
                active.append(cpu[nxt])
                nxt += 1
            active = [e for e in active if e.time_range.end >= t]
            inside = active
            bench = [e for e in inside if e.name.startswith(PREFIX)]
            ops = [e for e in inside if not e.name.startswith(PREFIX)]
            name = (max(bench, key=lambda e: e.time_range.start).name[len(PREFIX):].split("#")[0]
                    if bench else "outside")
            if ops:
                name += ">" + max(ops, key=lambda e: e.time_range.start).name
            totals[name] += (start - end) / 1e6
        return sorted(([n, s] for n, s in totals.items()), key=lambda r: -r[1])

    @staticmethod
    def _attention(events, probe: AttentionProbe) -> dict:
        """Per direction: the probed calls' bounds summed, the device
        seconds of the kernels launched in their ranges summed, and the
        count of ranges."""
        out = {}
        for kind, backward in (("fwd", False), ("bwd", True)):
            bound = dev_s = 0.0
            n = 0
            for e in events:
                if e.device_type != DeviceType.CPU or not e.name.startswith(
                        f"{PREFIX}attn_{kind}#"):
                    continue
                B, Lq, Lk, H, d, dtype = probe.calls[int(e.name.rsplit("#", 1)[1])]
                bound += attention_bound(B, Lq, Lk, H, d, dtype, backward)[0]
                dev_s += sum(k.duration for k in _kernels_under(e)) / 1e6
                n += 1
            out[kind] = {"calls": n, "bound_s": bound, "device_s": dev_s}
        return out
