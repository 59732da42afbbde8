"""Pipeline-B pretraining as ``entry/train_ssl_mae.run`` builds and drives
it, on one card: the model built by the entry's ``build_model`` with the
benchmark's seeded weights, AdamW under the entry's warmup-cosine schedule
wrapped for accumulation and the non-finite skip, the train state and
``make_pixel_mae_step`` with the parallel knobs as ``setup_parallelism``
resolves them, batches from ``epoch_batches`` over the store the entry's
``auto`` rule picks, epochs looped as the entry loops them (its loss reads
every ``log_interval`` steps; no checkpoint is saved).

Set-up drives the step through its first ``CHECKED_UPDATES`` optimizer
updates with tube masks and stochastic-depth decisions drawn by the
benchmark, then one more update through the step's own draws (the
window's call), and hands the same state to the window. After the window
the plain reference follows the checked updates from the same weights,
clips, masks and decisions, and the losses, the first gradient the
optimizer got and the parameters' change are compared.
"""
from __future__ import annotations

import gc
import itertools
import re
import time

import torch

from h100_bench import harness, inputs, trace, yardstick
from h100_bench.reference import common as ref_common
from h100_bench.reference import tinyvit_mae as ref

CHECKED_UPDATES = 3
PROFILED_UPDATES = 2
ADAM_B1 = 0.9


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test, built as the entry builds it."""

    def __init__(self, cell: harness.Cell, device: torch.device):
        from ssl_vit_video_analytics_tpu_torch.entry import common, train_ssl_mae
        from ssl_vit_video_analytics_tpu_torch.train.mae_engine import (
            make_pixel_mae_step, wrap_accum_and_skip)
        from ssl_vit_video_analytics_tpu_torch.train.state import (
            create_train_state, make_optimizer, warmup_cosine_schedule)

        cfg, log, seed = cell.cfg, cell.log, cell.seed
        tr, ssl, d = cfg["training"], cfg.get("ssl", {}), cfg["dataset"]
        self.cfg, self.device, self.seed, self.log = cfg, device, seed, log
        self.B, self.T = int(tr["batch_size"]), int(d["clip_len"])
        self.S = int(d["image_size"])
        self.L = (self.S // 8) ** 2
        self.accum = int(tr.get("accumulation_steps", 1))
        self.log_interval = int(tr.get("log_interval", 20))
        self.device = common.init_distributed(cfg, device, log)
        par = common.setup_parallelism(cfg, self.B, log, allow_pp=True)
        self.mesh = par.mesh
        dtype = common.compute_dtype_from(cfg, self.device)
        self.split = inputs.SyntheticSplit(int(cell.traffic["split_clips"]), self.T, self.S,
                                           seed, "ssl")
        self.steps_per_epoch = max(1, len(self.split) // self.B)
        self.ds = common.maybe_device_resident(cfg, self.split, self.device, log)
        with torch.device("meta"):
            self.template = ref.TinyVideoMAE(cfg)
            model = train_ssl_mae.build_model(
                cfg, dtype, decoder_attn_impl="sp" if par.sp_on else None)
        weights = inputs.make_weights(self.template, seed, self.device)
        self.weights0 = {k: v.to("cpu", copy=True) for k, v in weights.items()}
        model.to_empty(device=self.device)
        model.load_state_dict(weights)
        del weights
        common.place_model(model, self.mesh, log)
        sched = warmup_cosine_schedule(
            float(tr.get("lr", 5e-4)), int(tr.get("warmup_epochs", 0)) * self.steps_per_epoch,
            int(tr["epochs"]) * self.steps_per_epoch, float(tr.get("min_lr", 0.0)))
        tx = make_optimizer(model.parameters(), sched,
                            weight_decay=float(tr.get("weight_decay", 0.05)),
                            grad_clip=(float(tr["clip_grad_norm"])
                                       if tr.get("clip_grad_norm") is not None else None))
        tx = wrap_accum_and_skip(tx, accum_steps=self.accum)
        self.model = model
        self.state = create_train_state(model, tx)
        self.step_fn = make_pixel_mae_step(
            model, mask_ratio=float(ssl.get("mask_ratio", 0.9)), patch_size=8,
            norm_pix_loss=bool(ssl.get("norm_pix_loss", True)), compute_dtype=dtype,
            moe_aux_weight=float(ssl.get("moe_aux_weight", 0.01)),
            mesh=None if par.pp_mesh is not None else self.mesh, pp_mesh=par.pp_mesh,
            pp_microbatches=par.pp_microbatches)
        self.step_gen = torch.Generator(device=self.device).manual_seed(
            inputs.stream_seed(seed, 2))
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.global_step = 0
        self.epoch_losses: list = []
        self.feed = self._batches()

    def _batches(self):
        """The entry's epochs of batches, endlessly."""
        from ssl_vit_video_analytics_tpu_torch.entry import common

        for epoch in itertools.count(1):
            self.epoch_losses = []
            yield from common.epoch_batches(self.ds, self.B, shuffle=True, seed=self.seed,
                                            epoch=epoch, device=self.device, mesh=self.mesh)
            if self.epoch_losses:  # the entry's end-of-epoch summary read
                float(torch.stack(self.epoch_losses).mean())

    def step(self, batch, spans: bool = False, **draws):
        """One call of the step as the entry makes it, with its host reads
        every ``log_interval`` steps."""
        with trace.span("step", spans):
            self.state, metrics = self.step_fn(self.state, batch, self.step_gen, **draws)
        self.epoch_losses.append(metrics["loss"])
        self.global_step += 1
        if self.global_step % self.log_interval == 0:
            with trace.span("host_read", spans):
                for key in ("loss", "pred_std", "grad_norm", "collapse"):
                    float(metrics[key])
        return metrics

    def next_batch(self, spans: bool = False):
        with trace.span("fetch", spans):
            return next(self.feed)

    def first_gradient(self) -> dict:
        """The first gradient the optimizer got, from its first moment after
        one update (``m = (1 - b1) g``), by parameter name."""
        sd = self.state.tx.state_dict()
        out = {}
        for key, m in sd.items():
            hit = re.search(r"(?:^|\.)(\d+)\.exp_avg$", key)
            if hit:
                p = self.state.params[int(hit.group(1))]
                out[self.names[id(p)]] = (m / (1.0 - ADAM_B1)).detach().to("cpu", copy=True)
        return out

    def params(self) -> dict:
        return {n: p.detach().float().to("cpu", copy=True) for n, p in self.model.named_parameters()}

    def skipped(self) -> int:
        sd = self.state.tx.state_dict()
        return int(sum(int(v) for k, v in sd.items() if k.endswith("total_notfinite")))


def checked_steps(prog: Program, gen: torch.Generator) -> dict:
    """The first ``CHECKED_UPDATES`` updates with the benchmark's draws;
    what the reference needs and what it is compared with."""
    rates = prog.template.drop_rates()
    rec = {"clips": [], "masks": [], "keeps": [], "losses": []}
    for i in range(CHECKED_UPDATES * prog.accum):
        batch = prog.next_batch()
        mask = inputs.tube_mask(gen, prog.B, prog.T, prog.L, float(
            prog.cfg.get("ssl", {}).get("mask_ratio", 0.9)))
        keeps = inputs.keep_factors(gen, rates, prog.B * prog.T)
        metrics = prog.step(batch, mask=mask.to(prog.device), drop=keeps)
        rec["clips"].append(batch["clip"].to("cpu", copy=True))
        rec["masks"].append(mask.cpu())
        rec["keeps"].append(_to(keeps, "cpu"))
        rec["losses"].append(metrics["loss"])
        if i + 1 == prog.accum:
            rec["first_grad"] = prog.first_gradient()
    rec["losses"] = [float(x) for x in rec["losses"]]
    rec["params"] = prog.params()
    return rec


def _to(keeps, device):
    def one(k):
        if k is None:
            return None
        if isinstance(k, tuple):
            return tuple(x.to(device) for x in k)
        return k.to(device)

    return [[one(k) for k in stage] for stage in keeps]


def reference_follow(cfg, rec, weights0, steps_per_epoch, device, p=ref_common.FP32) -> dict:
    with ref_common.exact_fp32():
        model = ref.TinyVideoMAE(cfg).to(device)
        model.load_state_dict({k: v.to(device) for k, v in weights0.items()})
        trainer = ref.Trainer(model, cfg, steps_per_epoch, p)
        losses = [trainer.step(c.to(device), m.to(device), _to(k, device))
                  for c, m, k in zip(rec["clips"], rec["masks"], rec["keeps"])]
        out = {"losses": losses,
               "first_grad": {n: g.cpu() for n, g in zip(trainer.names, trainer.first_grad)},
               "params": {n: q.detach().cpu() for n, q in model.named_parameters()}}
    del model, trainer
    return out


# the numbers compared; ``compare`` also reads the losses' gaps, which no
# control or fault separates from sound runs, and logs them
CHECKS = ("grad_gap", "grad_median_gap", "change_gap")


def compare(rec: dict, out: dict, weights0: dict, accum: int) -> dict:
    """Readings of the program (``rec``) against the reference (``out``):

    - ``loss_gap``: the worst relative loss gap over the micro-steps before
      the weights first move (the first update's rate is 0, so the first
      ``2 * accum``); ``loss_gap_all``: over every checked micro-step;
    - ``grad_gap``, ``grad_median_gap``: the worst and the median leaf's gap
      of the first gradient's norm (``yardstick.leaf_gaps``);
    - ``change_gap``, ``change_median_gap``: the same of the parameters'
      change over the checked updates, over the elements the reference's
      gradient moves (``yardstick.moving_elements``).
    """
    steady = 2 * accum
    moving = yardstick.moving_elements(out["first_grad"])
    d_prog = {n: (rec["params"][n] - weights0[n])[m] for n, m in moving.items()}
    d_ref = {n: (out["params"][n] - weights0[n])[m] for n, m in moving.items()}
    grad, grad_at = yardstick.norm_gap(rec["first_grad"], out["first_grad"])
    change, change_at = yardstick.norm_gap(d_prog, d_ref)
    return {"loss_gap": yardstick.relative_gap(rec["losses"][:steady], out["losses"][:steady]),
            "grad_gap": grad,
            "grad_median_gap": yardstick.median_gap(rec["first_grad"], out["first_grad"]),
            "change_gap": change,
            "loss_gap_all": yardstick.relative_gap(rec["losses"], out["losses"]),
            "change_median_gap": yardstick.median_gap(d_prog, d_ref),
            "grad_worst_leaf": grad_at, "change_worst_leaf": change_at}


def run(cell: harness.Cell) -> dict:
    device = torch.device(cell.device)
    log = cell.log
    prog = Program(cell, device)
    built = time.time() - cell.t0
    gen = torch.Generator(device=prog.device).manual_seed(inputs.stream_seed(cell.seed, 3))
    rec = checked_steps(prog, gen)
    checked = time.time() - cell.t0
    for _ in range(prog.accum):  # the window's own call, once per micro-step of an update
        prog.step(prog.next_batch())
    _sync(prog.device)

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
    _sync(prog.device)
    window_s = time.perf_counter() - t_start
    clips = n * prog.B
    log(f"window: {n} micro-steps of {prog.B} clips in {window_s:.3f} s")

    profile = None
    if cell.trace:
        probe = trace.AttentionProbe()
        steps = PROFILED_UPDATES * prog.accum
        with _update_span(), probe, trace.Profiled(prog.device) as prof:
            with trace.span("window", True):
                for _ in range(steps):
                    prog.step(prog.next_batch(spans=True), spans=True)
        profile = prof.summary(probe)
        profile["units"] = steps
        log(f"profiled {steps} micro-steps in {profile['window_s']:.3f} s: "
            f"{steps * prog.B / profile['window_s']:.3f} clips/s traced against "
            f"{clips / window_s:.3f} untraced; groups {profile['groups']}; "
            f"attention {profile['attention']}")
    _sync(prog.device)
    peak = torch.cuda.max_memory_allocated(prog.device) if prog.device.type == "cuda" else 0
    skipped = prog.skipped()

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
        flops_per_clip = yardstick.pipeline_b_flops_per_clip(
            int(cfg["dataset"]["clip_len"]), image_size=int(cfg["dataset"]["image_size"]),
            embed_dims=tuple(cfg["model"]["embed_dims"]),
            decoder_embed_dim=int(cfg["model"]["decoder_embed_dim"]),
            decoder_depth=int(cfg["model"]["decoder_depth"]))
        res["ctx"] = {"model_flops": clips * flops_per_clip, "model_s": window_s,
                      "unit_s": window_s / n,
                      "profile": profile}
    return res


class _update_span:
    """While entered, the step's optimizer call runs inside an ``update``
    host range (the name ``train/mae_engine.apply_updates`` wrapped)."""

    def __enter__(self):
        from ssl_vit_video_analytics_tpu_torch.train import mae_engine

        self.mod, self.orig = mae_engine, mae_engine.apply_updates
        orig = self.orig

        def apply_updates(*a, **k):
            with trace.span("update", True):
                return orig(*a, **k)

        mae_engine.apply_updates = apply_updates
        return self

    def __exit__(self, *exc):
        self.mod.apply_updates = self.orig
        return False
