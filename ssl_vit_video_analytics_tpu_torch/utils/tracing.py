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
kernels' launch counters are counters of this kind, and every blocking
device-to-host read on the serving and pipeline-B training paths goes
through :func:`host_read`, which counts ``host_syncs``.

What the port records:

- ``train.step`` (counter ``train.steps``) -> ``train.forward``,
  ``train.backward``, ``train.update``; on a card autograd runs the
  backward on a thread of its own, so its kernels hang off that thread's
  ranges (``attn.bwd``, the autograd nodes), and ``train.backward`` holds
  only the host's wait for them;
- ``attn.fwd``, ``attn.bwd`` (attrs ``B``, ``Lq``, ``Lk``, ``H``, ``d``,
  ``dtype``; ``ops/attention.py``);
- ``store.gather`` (a batch gathered from a device-resident store);
- counters ``host_syncs``, ``train.steps``, ``early_exit.batches`` and the
  kernels' ``*.launches``.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd.profiler import record_function

PREFIX = "ssl_vit."


class Counter:
    """A count under a name; ``count`` is a plain int."""

    __slots__ = ("name", "count")

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


_counters: dict[str, Counter] = {}


def counter(name: str) -> Counter:
    """The counter registered under ``name`` (registered on first use)."""
    c = _counters.get(name)
    if c is None:
        c = _counters[name] = Counter(name)
    return c


def counters() -> dict[str, int]:
    """Every registered counter's count, by name."""
    return {name: c.count for name, c in _counters.items()}


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
