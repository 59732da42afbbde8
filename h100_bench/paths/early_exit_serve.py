"""Early-exit serving as ``entry/run_dynamic.run_early_exit`` composes it,
on one card, open loop: batches of clips come due at the traffic's fixed
rate and are served one at a time, as the entry serves them. The
classifier is built as ``load_classifier`` builds it (the entry's ``build_model``, in eval mode,
the benchmark's seeded weights in place of a checkpoint), ``fn_full`` =
``normalize_clip`` -> the entry's ``auto`` early exit -> the model's
``frame_embedding`` and ``classify_embedding``, under
``torch.inference_mode()``, batches cycling through the resident pool in
the entry's order. A batch's latency is the host clock from when it came
due to the host copy of its ``final_conf``; its service time starts when
its call does. Clips completed over the window's seconds
(``serve_clips_per_s``) are returned beside the p95, for a cell that
offers more than the system sustains.

After the window the plain reference serves every batch the window served
from the same clips, and the logits and frame counts are compared.
"""
from __future__ import annotations

import gc
import itertools
import statistics
import time

import numpy as np
import torch

from h100_bench import harness, inputs, trace, yardstick
from h100_bench.reference import common as ref_common
from h100_bench.reference import mobilevit_ee as ref

WARM_BATCHES = 3
PROFILED_BATCHES = 12
REF_BLOCK_CLIPS = 64


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test, built as the serving entry builds it."""

    def __init__(self, cell: harness.Cell, device: torch.device):
        from ssl_vit_video_analytics_tpu_torch.entry import common, run_dynamic
        from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
        from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as eng

        cfg, log, seed = cell.cfg, cell.log, cell.seed
        d, m, dyn = cfg["dataset"], cfg["model"], cfg["dynamic"]
        self.cfg, self.log = cfg, log
        self.device = common.device_from(cfg, device)
        dtype = common.compute_dtype_from(cfg, self.device)
        self.B = int(cfg["runtime"]["batch_size"])
        self.split = inputs.SyntheticSplit(int(cell.traffic["pool_clips"]), int(d["clip_len"]),
                                           int(d["image_size"]), seed, "supervised",
                                           int(d["num_classes"]))
        self.ds = common.maybe_device_resident(cfg, self.split, self.device, log)
        with torch.device("meta"):
            self.template = ref.Classifier(cfg)
            model = eng.build_model(int(d["num_classes"]), int(m["embed_dim"]), dtype=dtype,
                                    backbone=str(m.get("backbone", "mobilevit_s")),
                                    backbone_kwargs=m.get("backbone_kwargs"))
        weights = inputs.make_weights(self.template, seed, self.device)
        self.weights0 = {k: v.to("cpu", copy=True) for k, v in weights.items()}
        model.to_empty(device=self.device)
        model.load_state_dict(weights)
        del weights
        self.model = model.eval()
        ee_fn = run_dynamic._early_exit_fn(cfg, log)
        kwargs = run_dynamic._ee_kwargs(dyn)
        self.threshold = float(cell.traffic["threshold"])
        self.ee = dict(kwargs)

        def fn_full(raw, thr):
            return ee_fn(model.frame_embedding, model.classify_embedding,
                         normalize_clip(raw), thr, **kwargs)

        self.fn_full = fn_full
        self.batches_per_pass = -(-len(self.split) // self.B)
        self.feed = self._batches()

    def _batches(self):
        """The entry's batches over the pool, in its order, pass after pass."""
        from ssl_vit_video_analytics_tpu_torch.entry import common

        while True:
            yield from common.epoch_batches(self.ds, self.B, shuffle=False, seed=0, epoch=0,
                                            device=self.device, drop_last=False)

    def serve(self, spans: bool = False):
        """One batch: fetch, serve, host copy of ``final_conf``. Returns its
        latency in seconds, its logits and frame counts (on the device)."""
        with trace.span("fetch", spans):
            batch = next(self.feed)
        t0 = time.perf_counter()
        with trace.span("serve", spans):
            logits, stats = self.fn_full(batch["clip"], self.threshold)
        with trace.span("host_read", spans):
            stats.final_conf.cpu()
        return time.perf_counter() - t0, logits, stats.used_frames


def reference_check(cfg: dict, split, served: list, threshold: float, ee: dict,
                    weights0: dict, B: int, device, p=ref_common.FP32) -> dict:
    """The reference serves the clips of every served batch (``served``:
    ``(batch index, logits, used frames)``, on the host); returns the widest
    logit gap over the RMS of the reference's logits, and the clips whose
    frame counts differ."""
    ref_logits, ref_used = reference_serve(cfg, split, [b for b, _, _ in served], threshold,
                                           ee, weights0, B, device, p)
    prog_logits = torch.cat([lg for _, lg, _ in served]).float()
    prog_used = torch.cat([u for _, _, u in served])
    return compare(prog_logits, prog_used, ref_logits, ref_used)


def reference_serve(cfg, split, batch_ids, threshold, ee, weights0, B, device,
                    p=ref_common.FP32):
    n = len(split)
    # the entry pads a pool's tail batch with its last clip
    idx = [min(b * B + j, n - 1) for b in batch_ids for j in range(B)]
    with ref_common.exact_fp32():
        model = ref.Classifier(cfg).to(device)
        model.load_state_dict({k: v.to(device) for k, v in weights0.items()})
        logits, used = [], []
        for lo in range(0, len(idx), REF_BLOCK_CLIPS):
            clips = torch.from_numpy(
                np.stack([split.get_clip(i) for i in idx[lo:lo + REF_BLOCK_CLIPS]]))
            lg, u = ref.early_exit(model, clips.to(device), threshold,
                                   int(ee["min_frames"]), int(ee["max_frames"] or clips.shape[1]),
                                   int(ee["frame_step"]), p)
            logits.append(lg.cpu())
            used.append(u.cpu())
    del model
    return torch.cat(logits), torch.cat(used)


def compare(prog_logits, prog_used, ref_logits, ref_used) -> dict:
    rms = float(ref_logits.double().square().mean().sqrt())
    gap = float((prog_logits.double() - ref_logits.double()).abs().max()) / max(rms, 1e-30)
    frames = int((prog_used.long() != ref_used.long()).sum())
    return {"logit_gap": gap, "frames_differ": float(frames)}


def flops_per_frame(cfg) -> float:
    """Forward FLOPs of one frame's embedding, counted by
    ``torch.utils.flop_counter`` on the reference model."""
    from torch.utils.flop_counter import FlopCounterMode

    S = int(cfg["dataset"]["image_size"])
    with torch.device("meta"):  # shapes alone
        model = ref.Classifier(cfg).eval()
        frame = torch.zeros(1, S, S, 3, dtype=torch.uint8)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.embed(frame)
    return float(counter.get_total_flops())


def open_loop(prog: Program, rate_clips_per_s: float, seconds: float) -> dict:
    """Batches due every ``B / rate`` seconds from now for ``seconds``,
    served one at a time as they come due, each waited for. A batch's
    latency runs from when it was due to its host copy, so it holds the
    wait behind a late one; its service time from its start."""
    interval = prog.B / rate_clips_per_s
    out = {"latency": [], "service": [], "late": [], "served": []}
    t0 = time.perf_counter()
    for k in itertools.count():
        due = t0 + k * interval
        if due - t0 >= seconds:
            break
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        start = time.perf_counter()
        service, logits, used = prog.serve()
        out["latency"].append(time.perf_counter() - due)
        out["service"].append(service)
        out["late"].append(start - due)
        out["served"].append(((WARM_BATCHES + k) % prog.batches_per_pass, logits, used))
    _sync(prog.device)
    out["window_s"] = time.perf_counter() - t0
    return out


def run(cell: harness.Cell) -> dict:
    device = torch.device(cell.device)
    log = cell.log
    prog = Program(cell, device)
    built = time.time() - cell.t0
    rate = float(cell.traffic["rate_clips_per_s"])
    with torch.inference_mode():
        for _ in range(WARM_BATCHES):
            prog.serve()
        _sync(prog.device)
        setup_s = time.time() - cell.t0
        log(f"set-up: program built {built:.3f} s, window from {setup_s:.3f} s")
        win = open_loop(prog, rate, cell.seconds)
        profile = None
        if cell.trace:
            probe = trace.AttentionProbe()
            with probe, trace.Profiled(prog.device) as prof:
                with trace.span("window", True):
                    for _ in range(PROFILED_BATCHES):
                        prog.serve(spans=True)
            profile = prof.summary(probe)
            profile["units"] = PROFILED_BATCHES
            log(f"profiled {PROFILED_BATCHES} batches back to back in {profile['window_s']:.3f}"
                f" s: {profile['window_s'] / PROFILED_BATCHES * 1e3:.3f} ms a batch traced "
                f"against a median service of {1e3 * statistics.median(win['service']):.3f} "
                f"untraced; groups {profile['groups']}; attention {profile['attention']}")
    peak = torch.cuda.max_memory_allocated(prog.device) if prog.device.type == "cuda" else 0
    n = len(win["latency"])
    clips = n * prog.B
    served = [(b, lg.cpu(), u.cpu()) for b, lg, u in win["served"]]
    used_all = torch.cat([u for _, _, u in served]).double()
    frames_encoded = sum(float(u.max()) * prog.B for _, _, u in served)
    failed = int((~torch.isfinite(torch.cat([lg for _, lg, _ in served]).float())).any(1).sum())
    log(f"window: {n} batches of {prog.B} clips due at {rate} clips/s, done in "
        f"{win['window_s']:.3f} s; latency p50 {1e3 * yardstick.percentile(win['latency'], 50):.3f}"
        f" p95 {1e3 * yardstick.percentile(win['latency'], 95):.3f} ms; service p95 "
        f"{1e3 * yardstick.percentile(win['service'], 95):.3f} ms; latest start "
        f"{1e3 * max(win['late']):.3f} ms after due")

    split, cfg, weights0, B = prog.split, prog.cfg, prog.weights0, prog.B
    threshold, ee = prog.threshold, prog.ee
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_ref = time.perf_counter()
    checks = reference_check(cfg, split, served, threshold, ee, weights0, B, device)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s over {clips} clips, peak "
        f"{torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == 'cuda' else 0:.2f} GiB")

    res = {"checks": checks, "attempted": clips, "failed": failed,
           "device": harness.device_info(device, peak, profile),
           "metrics": {"serve_batch_p95_ms": 1e3 * yardstick.percentile(win["latency"], 95),
                       "serve_clips_per_s": clips / win["window_s"], "setup_s": setup_s}}
    if profile is not None:
        res["breakdown"] = {"device_ops": profile["device_ops"],
                            "idle_gaps": profile["idle_gaps"]}
        res["ctx"] = {"model_flops": frames_encoded * flops_per_frame(cfg),
                      "model_s": sum(win["service"]),
                      "unit_s": statistics.fmean(win["service"]),
                      "service": win["service"], "latency": win["latency"],
                      "frames_per_clip": float(used_all.mean()),
                      "profile": profile}
    return res
