"""The port's spans and counters: its one tracing API.

Spans are off by default. While off, :func:`span` returns one shared null
context, so a span costs one branch. While on (:func:`enable`), each span is
a ``record_function`` range named ``ssl_vit.<name>``, with its attrs, where
it has any, in brackets after the name (:func:`range_name`): in a
``torch.profiler`` trace it sits on one clock with the kernels launched
inside it. Nothing is kept in memory; the profiler's trace is the record
(``logging.profile_dir``, ``scripts/profile_step.py``).

Counters count whether spans are on or off: a :class:`Counter` is
registered by name (:func:`counter`) and counts with a plain int add. The
kernels' launch counters are counters of this kind, marked as launch
counters: a CUDA graph's capture takes what it added to them back off
(:func:`uncounted_launches`), since nothing launches while a stream
captures, and each replay adds it on again (:func:`count_launches`), so
they count the kernels that ran. Every blocking
device-to-host read on the serving and pipeline-B training paths goes
through :func:`host_read`, which counts ``host_syncs``. A
:class:`DeviceCounter` (:func:`device_counter`) counts a value the device
computed: it adds it to an int64 accumulator on that device, with no host
read, and :func:`counters` reads it.

What the port records:

- ``train.step`` (counter ``train.steps``) -> ``train.forward``,
  ``train.backward``, ``train.update``; on a card autograd runs the
  backward on a thread of its own, so its kernels hang off that thread's
  ranges (``attn.bwd``, the autograd nodes), and ``train.backward`` holds
  only the host's wait for them;
- ``attn.fwd``, ``attn.bwd`` (attrs ``B``, ``Lq``, ``Lk``, ``H``, ``d``,
  ``dtype``; ``ops/attention.py``);
- ``store.gather`` (a batch gathered from a device-resident store);
- ``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine`` and
  ``moe.bwd`` (``models/layers.MoeMlp``; the backward's range as
  ``attn.bwd``'s, by :class:`BackwardRange`);
- counters ``host_syncs``, ``train.steps``, ``early_exit.batches``,
  ``early_exit.frames``, ``early_exit.graph_replays``,
  ``early_exit.graph_captures``, ``early_exit.graph_capture_us``,
  ``moe.calls``, ``moe.tokens``, ``moe.slots``, the device counter
  ``moe.kept``, the kernels' ``*.launches`` (launch counters), and
  ``models/layers``' ``weights.prepared_calls`` and ``weights.cast_calls``
  (launch counters: a conv or linear call on prepared weights or on the
  per-call casts) and ``weights.prepares`` (a module's prepared weights
  made or remade).
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd.profiler import record_function

PREFIX = "ssl_vit."


class Counter:
    """A count under a name; ``count`` is a plain int. ``launches``: it
    counts a kernel's launches."""

    __slots__ = ("name", "count", "launches")

    def __init__(self, name: str, launches: bool = False) -> None:
        self.name = name
        self.count = 0
        self.launches = launches

    def reset(self) -> None:
        self.count = 0


_counters: dict[str, Counter] = {}


def counter(name: str, launches: bool = False) -> Counter:
    """The counter registered under ``name`` (registered on first use);
    ``launches`` marks it as a launch counter."""
    c = _counters.get(name)
    if c is None:
        c = _counters[name] = Counter(name)
    if not isinstance(c, Counter):
        raise TypeError(f"counter {name!r} counts on the device")
    c.launches = c.launches or launches
    return c


class DeviceCounter:
    """A count the device keeps: :meth:`add` adds an integer tensor to an
    int64 accumulator on its device, with no host read; ``count`` reads the
    accumulators, one blocking read a device. That read is the tracer's,
    made once after the work, and is not counted under ``host_syncs``."""

    __slots__ = ("name", "_acc")
    launches = False

    def __init__(self, name: str) -> None:
        self.name = name
        self._acc: dict[torch.device, torch.Tensor] = {}

    def add(self, t: torch.Tensor) -> None:
        acc = self._acc.get(t.device)
        if acc is None:
            acc = self._acc[t.device] = torch.zeros((), dtype=torch.int64, device=t.device)
        acc.add_(t)

    @property
    def count(self) -> int:
        return sum(int(a) for a in self._acc.values())

    def reset(self) -> None:
        self._acc = {}


def device_counter(name: str) -> DeviceCounter:
    """The device counter registered under ``name`` (registered on first use)."""
    c = _counters.get(name)
    if c is None:
        c = _counters[name] = DeviceCounter(name)
    if not isinstance(c, DeviceCounter):
        raise TypeError(f"counter {name!r} counts on the host")
    return c


def counters() -> dict[str, int]:
    """Every registered counter's count, by name."""
    return {name: c.count for name, c in _counters.items()}


def recomputing() -> bool:
    """Whether the running forward is a recomputation inside a backward pass
    (an activation-checkpointed region's): counters count the first pass."""
    return torch._C._current_graph_task_id() != -1


def uncounted_launches(fn) -> tuple:
    """Runs ``fn()``, a CUDA graph's capture, and takes what it added to the
    launch counters back off: the kernel wrappers ran, but no kernel did.
    Returns those additions, ``((counter, n), ...)``, a replay's launches."""
    before = [(c, c.count) for c in _counters.values() if c.launches]
    fn()
    launched = []
    for c, n in before:
        if c.count != n:
            launched.append((c, c.count - n))
            c.count = n
    return tuple(launched)


def count_launches(launched: tuple) -> None:
    """Adds a replay's launches (:func:`uncounted_launches`) to their counters."""
    for c, n in launched:
        c.count += n


HOST_SYNCS = counter("host_syncs")


def host_read(t: torch.Tensor):
    """``t`` on the host: a read that waits for the device to reach it, a
    Python number for a 0-d tensor, else a host tensor. Counted under
    ``host_syncs`` (on the CPU as well, where it waits for nothing)."""
    HOST_SYNCS.count += 1
    return t.item() if t.dim() == 0 else t.cpu()


_on = False
_OFF = contextlib.nullcontext()


def range_name(name: str, attrs: dict | None = None) -> str:
    """The profiler range of span ``name``: ``ssl_vit.<name>``, and its attrs
    as ``(key=value,...)`` (a dtype without ``torch.``)."""
    if not attrs:
        return PREFIX + name
    vals = ",".join(f"{k}={str(v).removeprefix('torch.')}" for k, v in attrs.items())
    return f"{PREFIX}{name}({vals})"


def span(name: str, attrs: dict | None = None):
    """A ``record_function`` range of span ``name`` while tracing is on, else
    the shared null context."""
    if not _on:
        return _OFF
    return record_function(range_name(name, attrs))


def enable() -> None:
    """Turn spans on."""
    global _on
    _on = True


def disable() -> None:
    """Turn spans off."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _RangeOpen(torch.autograd.Function):
    """Identity on a call's outputs; its backward, the first of the call's,
    opens the range named in ``box``."""

    @staticmethod
    def forward(ctx, box, *ts):
        ctx.box = box
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        ctx.box["range"] = record_function(ctx.box["name"])
        ctx.box["range"].__enter__()
        return (None, *gs)


class _RangeClose(torch.autograd.Function):
    """Identity on a call's inputs; its backward, the last of the call's,
    closes the range :class:`_RangeOpen` opened."""

    @staticmethod
    def forward(ctx, box, *ts):
        ctx.box = box
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        rf = ctx.box.pop("range", None)
        if rf is not None:
            rf.__exit__(None, None, None)
        return (None, *gs)


class BackwardRange:
    """The range of span ``name`` around one call's backward. The call's
    inputs pass through :meth:`inputs` before it and its outputs through
    :meth:`outputs` after it: identity autograd functions whose backwards,
    the first and the last of the call's, open and close the range, so that
    it holds the kernels the call's own autograd nodes launch."""

    def __init__(self, name: str, attrs: dict | None = None) -> None:
        self.box = {"name": range_name(name, attrs)}

    def inputs(self, *ts: torch.Tensor) -> tuple:
        return _RangeClose.apply(self.box, *ts)

    def outputs(self, *ts: torch.Tensor) -> tuple:
        return _RangeOpen.apply(self.box, *ts)
