"""Pipeline-B pretraining with the mixture-of-experts decoder
(``configs/ssl_mae_moe.yaml``) as ``entry/train_ssl_mae.run`` builds and
drives it, on one card: ``pixel_mae_train``'s program, window and
comparison (taken from it by import), with the MoE reference
(``reference/tinyvit_mae_moe.py``) as the weights' template and as the
plain reference the checked updates are compared with.

Besides ``pixel_mae_train``'s numbers it compares the routing: at the first
checked micro-step each MoE block's ``MoeMlp.assignments`` (each token's
expert, or -1 where its expert's buffer was full) against the reference's
route of the same block, as ``route_differ``, the share of the decoder's
tokens over the blocks whose expert or kept state differs.

In its traced tail the port's spans are on (``tracing.enable()``), so that
the ``ssl_vit.moe.*`` ranges are in the trace; the device time of the
kernels launched inside them is read from the profiler's events. The run
needs the program's MoE counters (``moe.kept``, a device counter, and
``moe.tokens``, ``moe.slots``), which the per-layer metrics read, and stops
at once without them.
"""
from __future__ import annotations

import gc
import time

import torch
from torch.autograd import DeviceType

from h100_bench import harness, inputs, trace, yardstick
from h100_bench.paths import pixel_mae_train as P
from h100_bench.reference import common as ref_common
from h100_bench.reference import tinyvit_mae_moe as moe_ref

MOE_PREFIX = "ssl_vit.moe."
# ``pixel_mae_train``'s numbers, and the routing's
CHECKS = P.CHECKS + ("route_differ",)


def require_counters() -> None:
    """Stops the run where the program does not count its MoE routing."""
    from ssl_vit_video_analytics_tpu_torch.models import layers  # noqa: F401  (registers them)
    from ssl_vit_video_analytics_tpu_torch.utils import tracing

    missing = {"moe.tokens", "moe.slots", "moe.kept"} - set(tracing.counters())
    if missing:
        raise SystemExit(f"the program has no MoE counters {sorted(missing)}: "
                         "this cell's metrics cannot be read")


class Program(P.Program):
    """``pixel_mae_train.Program`` whose weights are drawn for the MoE
    reference's state dict (``pixel_mae_train`` builds its template from
    the module it names ``ref``, here the MoE reference while it builds)."""

    def __init__(self, cell: harness.Cell, device: torch.device):
        dense, P.ref = P.ref, moe_ref
        try:
            super().__init__(cell, device)
        finally:
            P.ref = dense


def checked_steps(prog: Program, gen: torch.Generator) -> dict:
    """``pixel_mae_train.checked_steps``, and ``routes``: each MoE block's
    assignments at the first checked micro-step, in block order."""
    from ssl_vit_video_analytics_tpu_torch.models.layers import MoeMlp

    mods = [m for m in prog.model.modules() if isinstance(m, MoeMlp)]
    routes = []

    def record(mod, args):
        if len(routes) < len(mods):
            routes.append(mod.assignments(args[0]).cpu())

    hooks = [m.register_forward_pre_hook(record) for m in mods]
    try:
        rec = P.checked_steps(prog, gen)
    finally:
        for h in hooks:
            h.remove()
    rec["routes"] = routes
    return rec


def reference_follow(cfg, rec, weights0, steps_per_epoch, device,
                     p=ref_common.FP32) -> dict:
    """The MoE reference through the checked updates, from the same weights,
    clips, masks and decisions; its losses, first gradient, parameters and
    first micro-step's routes."""
    with ref_common.exact_fp32():
        model = moe_ref.TinyVideoMAE(cfg).to(device)
        model.load_state_dict({k: v.to(device) for k, v in weights0.items()})
        trainer = moe_ref.Trainer(model, cfg, steps_per_epoch, p)
        losses = [trainer.step(c.to(device), m.to(device), P._to(k, device))
                  for c, m, k in zip(rec["clips"], rec["masks"], rec["keeps"])]
        out = {"losses": losses,
               "first_grad": {n: g.cpu() for n, g in zip(trainer.names, trainer.first_grad)},
               "params": {n: q.detach().cpu() for n, q in model.named_parameters()},
               "routes": [r.cpu() for r in trainer.routes]}
    del model, trainer
    return out


def route_differ(prog_routes: list, ref_routes: list) -> float:
    """The share of tokens, over every block, whose expert or kept state
    (-1: dropped) differs; 1 where the blocks or tokens do not pair up."""
    if len(prog_routes) != len(ref_routes) or not ref_routes or any(
            a.shape != b.shape for a, b in zip(prog_routes, ref_routes)):
        return 1.0
    differ = sum(int((a != b).sum()) for a, b in zip(prog_routes, ref_routes))
    return differ / sum(b.numel() for b in ref_routes)


def compare(rec: dict, out: dict, weights0: dict, accum: int) -> dict:
    """``pixel_mae_train.compare``'s readings and ``route_differ``."""
    readings = P.compare(rec, out, weights0, accum)
    readings["route_differ"] = route_differ(rec["routes"], out["routes"])
    return readings


def moe_device_s(events) -> float:
    """Device seconds of the kernels launched inside the port's
    ``ssl_vit.moe.*`` ranges, each kernel once: a range inside another
    (a recomputed forward inside ``moe.bwd``) is read through the outer."""

    def is_moe(e):
        return e.device_type == DeviceType.CPU and e.name.startswith(MOE_PREFIX)

    total = 0.0
    for e in events:
        if not is_moe(e):
            continue
        up = e.cpu_parent
        while up is not None and not is_moe(up):
            up = up.cpu_parent
        if up is None:
            total += sum(k.duration for k in trace._kernels_under(e))
    return total / 1e6


def run(cell: harness.Cell) -> dict:
    require_counters()
    from ssl_vit_video_analytics_tpu_torch.utils import tracing

    device = torch.device(cell.device)
    log = cell.log
    prog = Program(cell, device)
    built = time.time() - cell.t0
    gen = torch.Generator(device=prog.device).manual_seed(inputs.stream_seed(cell.seed, 3))
    rec = checked_steps(prog, gen)
    checked = time.time() - cell.t0
    for _ in range(prog.accum):  # the window's own call, once per micro-step of an update
        prog.step(prog.next_batch())
    P._sync(prog.device)

    # the window
    t_start = time.perf_counter()
    setup_s = time.time() - cell.t0
    log(f"set-up: program built {built:.3f} s, checked steps done {checked:.3f} s, "
        f"window from {setup_s:.3f} s")
    n = 0
    while True:
        prog.step(prog.next_batch())
        n += 1
        if time.perf_counter() - t_start >= cell.seconds:
            break
    P._sync(prog.device)
    window_s = time.perf_counter() - t_start
    clips = n * prog.B
    log(f"window: {n} micro-steps of {prog.B} clips in {window_s:.3f} s")

    profile = None
    if cell.trace:
        probe = trace.AttentionProbe()
        steps = P.PROFILED_UPDATES * prog.accum
        tracing.enable()
        try:
            with P._update_span(), probe, trace.Profiled(prog.device) as prof:
                with trace.span("window", True):
                    for _ in range(steps):
                        prog.step(prog.next_batch(spans=True), spans=True)
        finally:
            tracing.disable()
        profile = prof.summary(probe)
        profile["units"] = steps
        profile["moe_s"] = moe_device_s(prof.prof.events())
        log(f"profiled {steps} micro-steps in {profile['window_s']:.3f} s: "
            f"{steps * prog.B / profile['window_s']:.3f} clips/s traced against "
            f"{clips / window_s:.3f} untraced; groups {profile['groups']}; "
            f"attention {profile['attention']}; moe {profile['moe_s']:.6f} device s")
    P._sync(prog.device)
    peak = torch.cuda.max_memory_allocated(prog.device) if prog.device.type == "cuda" else 0
    skipped = prog.skipped()
    log(f"counters: { {k: v for k, v in tracing.counters().items() if k.startswith('moe.')} }")

    weights0, spe, cfg = prog.weights0, prog.steps_per_epoch, prog.cfg
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_ref = time.perf_counter()
    out = reference_follow(cfg, rec, weights0, spe, device)
    readings = compare(rec, out, weights0, int(cfg["training"].get("accumulation_steps", 1)))
    checks = {k: readings[k] for k in CHECKS}
    log(f"reference: {time.perf_counter() - t_ref:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == 'cuda' else 0:.2f} GiB;"
        f" readings {readings}")

    res = {"checks": checks, "attempted": n, "failed": skipped,
           "device": harness.device_info(device, peak, profile),
           "metrics": {"train_clips_per_s": clips / window_s,
                       "train_peak_gib": peak / 2 ** 30, "setup_s": setup_s}}
    if profile is not None:
        res["breakdown"] = {"device_ops": profile["device_ops"],
                            "idle_gaps": profile["idle_gaps"]}
        # a top-1 MoE MLP runs one expert a token: the dense MLP's model FLOPs
        # (dispatch, combine and padded slots are not counted)
        flops_per_clip = yardstick.pipeline_b_flops_per_clip(
            int(cfg["dataset"]["clip_len"]), image_size=int(cfg["dataset"]["image_size"]),
            embed_dims=tuple(cfg["model"]["embed_dims"]),
            decoder_embed_dim=int(cfg["model"]["decoder_embed_dim"]),
            decoder_depth=int(cfg["model"]["decoder_depth"]))
        res["ctx"] = {"model_flops": clips * flops_per_clip, "model_s": window_s,
                      "unit_s": window_s / n,
                      "profile": profile}
    return res
