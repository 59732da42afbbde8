"""Where the pretraining step's device time goes: ``torch.profiler`` over a
few steps (2, after 3 warm-up steps and 4 updates' timed ones) of the port's
``entry.train_ssl_mae.run`` on ``configs/ssl_mae.yaml`` (or another
pipeline-B config: ``--config``; over ``configs/base.yaml``) as it stands,
on a synthetic 40-clip split of 64-frame 112x112 videos with random weights.

    python -m ssl_vit_video_analytics_tpu_torch.scripts.profile_step
    python -m ssl_vit_video_analytics_tpu_torch.scripts.profile_step \
        --config configs/ssl_mae_moe.yaml
    python -m ssl_vit_video_analytics_tpu_torch.scripts.profile_step \
        --set model.decoder_num_heads=3          # the decoder repack

Prints one JSON object: the host-clock ms of each profiled step, the
device time per step summed over every kernel, the idle share (1 - device
time / wall time of the window; one stream, so kernels do not overlap),
K1's and K2's part, the forward MoE dispatch and combine (the device time
under ``aten::einsum``: no other op of the step is an einsum; their
backward runs as batched matmuls among the expert bank's and is not told
apart), the kernels with the most device time per step, and the device time
of every 3x3 depthwise conv (cuDNN's, forward and backward, by input shape,
with the kernels each launched). The port's spans are on while it profiles
(``utils/tracing.py``): it also prints each span's calls and the device time
of the kernels launched inside it a step (``train.update``: the optimizer;
``attn.bwd``: K2 and what the backward launches around it), the
``host_syncs`` reads a step, and the host-clock ms of the unprofiled
steps before, taken in turns with the spans on and off a whole update at
a time, so that each side holds as many updates (their on cost).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae
from ssl_vit_video_analytics_tpu_torch.utils import tracing
from ssl_vit_video_analytics_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# kernel names of K1 and K2 (each kernel's instantiations, both dtypes)
GROUPS = {"K1 flash_fwd": ("flash_fwd_",), "K2 flash_bwd": ("flash_bwd_",)}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def _kernels(evt) -> dict[str, float]:
    """Device us of the kernels an op launched, its children's included."""
    out: dict[str, float] = {}
    for k in evt.kernels:
        out[k.name] = out.get(k.name, 0.0) + k.duration
    for child in evt.cpu_children:
        for name, us in _kernels(child).items():
            out[name] = out.get(name, 0.0) + us
    return out


def depthwise_3x3(events, steps: int) -> list[dict]:
    """Device ms per step of the 3x3 depthwise convs (weight ``[C, 1, 3, 3]``):
    ``aten::convolution`` (forward, recomputed stages included) and
    ``aten::convolution_backward`` (input and weight gradients), by input
    shape, with each kernel they launched."""
    rows: dict[tuple, dict] = {}
    for e in events:
        if e.name not in ("aten::convolution", "aten::convolution_backward"):
            continue
        shapes = e.input_shapes
        x, wt = (shapes[0], shapes[1]) if e.name == "aten::convolution" else (shapes[1], shapes[2])
        if len(wt) != 4 or wt[1:] != [1, 3, 3]:
            continue
        key = (e.name, tuple(x))
        row = rows.setdefault(key, {"op": e.name, "input": list(x), "calls": 0, "us": 0.0,
                                    "kernels": {}})
        row["calls"] += 1
        row["us"] += e.device_time_total
        for name, us in _kernels(e).items():
            row["kernels"][name] = row["kernels"].get(name, 0.0) + us
    return [{"op": r["op"], "input": r["input"], "calls_per_step": r["calls"] / steps,
             "ms_per_step": r["us"] / 1e3 / steps,
             "kernels_ms_per_step": {k[:120]: us / 1e3 / steps
                                     for k, us in sorted(r["kernels"].items(),
                                                         key=lambda kv: -kv[1])}}
            for r in sorted(rows.values(), key=lambda r: -r["us"])]


def spans(events, steps: int) -> dict[str, dict]:
    """Calls and device ms per step of each of the port's spans, by name
    (the host's ``ssl_vit.<name>`` ranges, attrs left out): the kernels
    launched inside a range, those of the spans inside it included, and of
    them K1's and K2's."""
    rows: dict[str, dict] = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.name.startswith(tracing.PREFIX):
            continue
        name = e.name[len(tracing.PREFIX):].split("(", 1)[0]
        row = rows.setdefault(name, {"calls_per_step": 0.0, "device_ms_per_step": 0.0,
                                     **{g: 0.0 for g in GROUPS}})
        row["calls_per_step"] += 1 / steps
        for kernel, us in _kernels(e).items():
            row["device_ms_per_step"] += us / 1e3 / steps
            for g, prefixes in GROUPS.items():
                if any(p in kernel for p in prefixes):
                    row[g] += us / 1e3 / steps
    return dict(sorted(rows.items()))


def run(warm: int = 3, steps: int = 2, top: int = 25, timed: int = 2,
        config: str = os.path.join(REPO, "configs", "ssl_mae.yaml"),
        overrides: tuple[str, ...] = ()) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs an NVIDIA GPU")
    cfg = load_config(config, base=os.path.join(REPO, "configs", "base.yaml"),
                      overrides=overrides)
    with tempfile.TemporaryDirectory() as tmp:
        splits = make_synthetic_dataset(os.path.join(tmp, "data"), num_classes=8,
                                        videos_per_class=6, num_frames=64, image_size=112,
                                        seed=0)
        cfg["dataset"]["train_split"] = splits["train"]
        cfg["paths"] = {"split_root": ""}
        cfg["training"]["save_dir"] = os.path.join(tmp, "out")
        cfg.setdefault("logging", {})["tensorboard"] = False
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True)
        marks, syncs = {}, {}
        accum = int(cfg["training"].get("accumulation_steps", 1))
        start = warm + 2 * timed * accum  # the first profiled step follows this one

        def spans_on(i):  # whether timed step i + 1 runs with the spans on
            return (i - warm) // accum % 2 == 0

        def on_step(i, state, metrics):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()
            syncs[i] = tracing.HOST_SYNCS.count
            if warm <= i < start:  # the timed steps: an update on, one off, ...
                (tracing.enable if spans_on(i) else tracing.disable)()
            elif i == start:
                prof.start()
                tracing.enable()
            elif i == start + steps:
                tracing.disable()
                prof.stop()

        train_ssl_mae.run(cfg, log=lambda m: None, max_steps=start + steps, on_step=on_step,
                          device="cuda")
    timed_ms = {i: 1e3 * (marks[i + 1] - marks[i]) for i in range(warm, start)}
    wall_ms = 1e3 * (marks[start + steps] - marks[start])
    # device events, less the ranges that annotate the timeline (the
    # optimizer step's) and would count their kernels twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    by_name = sorted(kernels, key=_device_us, reverse=True)
    groups = {g: sum(_device_us(e) for e in kernels if any(p in e.key for p in prefixes))
              / 1e3 / steps for g, prefixes in GROUPS.items()}
    groups["MoE dispatch+combine forward (aten::einsum)"] = sum(
        e.device_time_total for e in prof.events() if e.name == "aten::einsum") / 1e3 / steps
    return {
        "device": torch.cuda.get_device_name(0),
        "config": os.path.relpath(config, REPO), "overrides": list(overrides),
        "steps": steps,
        "step_ms": [1e3 * (marks[i + 1] - marks[i]) for i in range(start, start + steps)],
        "device_ms_per_step": device_ms / steps,
        "idle_share": 1.0 - device_ms / wall_ms,
        "groups_ms_per_step": groups,
        "top_kernels_ms_per_step": [
            {"name": e.key[:120], "ms": _device_us(e) / 1e3 / steps, "calls": e.count // steps}
            for e in by_name[:top]],
        "depthwise_3x3_ms_per_step": depthwise_3x3(prof.events(), steps),
        "spans_per_step": spans(prof.events(), steps),
        "host_syncs_per_step": (syncs[start + steps] - syncs[start]) / steps,
        "spans_on_step_ms": [ms for i, ms in timed_ms.items() if spans_on(i)],
        "spans_off_step_ms": [ms for i, ms in timed_ms.items() if not spans_on(i)],
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=os.path.join(REPO, "configs", "ssl_mae.yaml"))
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override a config entry, as the entries' --set")
    args = p.parse_args()
    print(json.dumps(run(config=os.path.abspath(args.config), overrides=tuple(args.set))))


if __name__ == "__main__":
    main()
