#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py        # from the repo root; needs one CUDA card and nvcc
    python3 chip_smoke.py --step-seeds 6 7 8   # the build, then phases 12
                                                # and 14 on each seed (each
                                                # bf16 gradient's distances
                                                # per leaf into
                                                # chiprun_out/step_seeds.jsonl)

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi.
2. build: every kernel of the port, flash attention K1 (forward) and K2
   (backward), the depthwise conv P1, the unary chain P2 and the LayerNorm
   kernels, built from the repo's sources into build/kernels/, one nvcc each, all in parallel;
   seconds, registers, spills and static shared memory from ptxas, the
   count of bf16 tensor-core products (mma.sync, HMMA.16816.F32.BF16, and
   wgmma, HGMMA, from cuobjdump) in each flash kernel, the wide bf16
   kernels' dynamic shared memory at d = 300, 384, 512 and 1024, and the
   asynchronous copies (UTMALDG, the TMA's loads; LDGSTS, cp.async) in each
   P1 kernel: every bf16 flash kernel must have products, K1's wide one
   wgmma, every P1 kernel copies, and no P1 or P2 kernel may spill.
3. K1 vs plain: the forward kernel against its plain PyTorch version on the
   card, at the serving slice's shapes, at the pipeline-B shapes and at
   every head dim past the models' own (16, 20, 24, 80, 96, 128, 256: each
   at the least width built that holds it; then 300, 384, 512 and 1024 on
   the wide kernels, in chunks of 64 columns and column groups of 512: the
   one-head decoders of pipelines B and C among them), in fp32
   (TF32 off) and in bf16 (against the plain fp32 attention of the same
   bf16-rounded inputs): out to 1e-4 (fp32) or 2e-2 (bf16) of its largest
   magnitude, lse to the same numbers absolute; the
   time per call of each, of PyTorch's scaled_dot_product_attention on the
   same inputs (and which of its backends ran: its flash and cuDNN backends
   stop at d = 256), and the bound: the larger
   of 4*B*H*Lq*Lk*d flops over the peak (989 TFLOP/s bf16, 67 fp32) and
   the bytes in and out over 3.35 TB/s. Then what the kernels do not take
   must raise in K1 and K2, with nothing launched (no fallback): fp16, q/k/v
   of mismatched shapes, a bf16 view off 16-byte alignment, and a grid of
   2^31 CTAs or more (B = 2^19, L = 2^16 at d = 1024, expanded from one
   row).
4. K2 vs plain: the backward kernel against the plain fp32 backward of the
   same inputs (and K1's out and lse), at the same shapes, in fp32 (max abs
   error of each gradient over its max magnitude, tolerance 1e-4) and bf16
   (2e-2); the time per call of each, of the backward of
   scaled_dot_product_attention (autograd.grad on a retained forward), and
   the bound with 10*B*H*Lq*Lk*d flops. Then K1 and K2 at the long-clip
   decoder's attention (8 clips x 12544 tokens, 6 heads of 64): launched on
   the whole batch, held on its first and last clip against the plain
   versions of that clip (the plain logits of all 8 would take 30 GB), fp32
   and bf16 at the tolerances above; in bf16 the kernels' and SDPA's times
   and the bound at the whole batch, the plain versions' at one clip. The
   same at a rank's query shard of that attention under a seq mesh of 4
   and of 8 ranks (Lq 3136 and 1568 over the gathered Lk 12544), and at the
   head blocks a rank of a model mesh holds of pipeline B's decoder (4 x
   3136^2 with 3, 2 and 1 heads of 64: tp 2, and the 6 heads split 2, 2, 1,
   1 over tp 4).
5. train step, kernel vs plain: the full-width TinyVideoMAE (configs/
   ssl_mae.yaml widths) at B=2 clips, the same weights, mask and drop-path
   decisions through the kernels and through the plain versions: in fp32,
   TF32 off (the CUDA-core kernels), loss to 1e-4 relative and every
   gradient to 1e-3 relative L2; in bf16 (the tensor-core kernels), loss
   to 1e-3 and every gradient to 5e-2. Both hold a gradient's difference
   to at least 1e-4 of the largest gradient norm. The bf16 pass also
   reports how far each of its two runs lies from the fp32 plain run, at
   the leaf where they differ most from each other and at the leaf where
   bf16 alone moves the plain run most.
6. train: the port's entry.train_ssl_mae.run on configs/ssl_mae.yaml
   (batch 40, accumulation 2, remat on, bf16; the split device-resident,
   as dataset.device_resident: auto makes it on a card) with one departure,
   an encoder checkpoint every epoch (training.save_every: 1), on a
   synthetic 40-clip split of 64-frame 112x112 videos, random weights from
   a seeded generator, for 4 steps (2 optimizer updates). Per step: loss,
   gnorm, whether an update was applied or skipped, step ms (the checkpoint
   writes left out), clips/s, K1 and K2 calls (20 and 12 required) and peak
   device memory. The last epoch's encoder checkpoint feeds phase 11. The
   run has logging.tensorboard on (a phase departure only): its event files
   under the save dir, or the entry's tensorboardX warning, are reported.
7. serving slice: the port's run_dynamic early-exit sweep at full MobileViT-S
   width (configs/dynamic.yaml: 101 classes, embed 256, batch 8, clips of 32
   frames of which the sweep reads up to 16, 112x112, bf16) on a synthetic
   split, with random weights from a seeded generator (its one departure),
   once streaming and once batched. K1's launch count in these
   runs must be a positive multiple of 6 (3 MobileViT blocks x depth 2; a
   CUDA graph's replay adds the launches its capture took back), and the
   streaming run must step frames by replays (early_exit.graph_replays > 0).
   One batch is checked against the same weights run in fp32 through the
   plain path on the CPU.
8. P1 vs plain, and the probe_dw entry: the depthwise kernel against its
   plain version in fp32 at [2, 56*56, 384] (TF32 off, 1e-5 abs) and in
   bf16 at 8 images and on the 256 images that the probe's bench times
   (1e-5 plus one bf16 ulp of the output: the two fp32 sums round once
   each), and in both at [1, 9*300, 40], which crosses every edge of the
   kernel's tiles (a partial row band, column tiles, a partial channel
   chunk); then the port's scripts.probe_dw.run(256, "bench"): the
   kernel's times (forward, and on the input gradient's flipped taps), the
   plain version's, cuDNN's grouped conv times (forward and input gradient)
   and the bound.
9. P2 vs plain, and the probe_exp entry: the unary-chain kernel against its
   plain version for each op and working type at 896x6272, n = 1 (the
   remainder loop only), 4 (the probe's low end: one trip of the main loop
   of 4 applications), 13 (both), 64 and 516 (the probe's length), fp32
   1e-5 of the largest magnitude, bf16 two ulps of each element; the
   conversions to bf16 per element and application in each bf16 main loop
   (F2F.BF16.F32 and F2FP.* apart, from cuobjdump; none of the first may
   remain); then the port's scripts.probe_exp.run(): times at n = 4, 132
   and 516 (each the least of three windows queued behind a spin on the
   stream, so the host's launches are not timed; they must grow with n),
   the per-application slopes (4 to 516 as the JAX probe takes
   it; 132 to 516, both bound by operations, against the bound), and the
   plain version's.

10. finetune step, kernel vs plain: the full-width TinyViT classifier
   (stage limit 3, dims 96/192/384, 8 classes) at B=2 clips x 16 frames x
   112x112, the same weights and drop-path decisions through the kernels
   and through the plain versions, unfrozen (ft_ssl: K1 8, K2 8 calls) and
   with the backbone frozen (two_stage before its boundary: K1 8, K2 0), in
   fp32 (TF32 off; loss 1e-4 relative, every gradient 1e-3 relative L2) and
   bf16 (1e-3 and 5e-2), with phase 5's floor (bf16 holds the gradients
   that are not zero in the fp32 plain run: one that is zero in exact
   arithmetic is bf16 rounding noise in both runs, and that noise can pass
   the floor; their count and worst distance are reported; a gradient
   beyond 5e-2 of the plain run passes only if the kernel run lies within
   5e-2 of the fp32 plain run beyond the plain bf16 run's own distance from
   it, and a loss beyond 1e-3 likewise within 1e-3); then one real step of each
   mode through the kernels: the frozen one keeps every backbone param
   bit-unchanged and moves its BatchNorm statistics.
11. pipeline-B transfer: configs/finetune.yaml under the transfer
   campaign's pipeline-B overrides (tinyvit, 16 frames at stride 1,
   112x112, batch 16, bf16, dataset.device_resident: true), two_stage for 2
   epochs (1 frozen), from phase 6's encoder checkpoint, through the port's
   entry.train_finetune.run on a synthetic 64-clip split (8 classes;
   validation on the same split); per step loss, top-1, step ms, clips/s,
   K1 and K2 calls (8 each step, K2 0 while frozen) and peak memory; the
   SSL-load log line, finite params and a best checkpoint whose name
   encodes its top-1; one training batch of each device store (resident,
   and chunked in two shards) bit-equal to the host path's; then
   entry.evaluate.run on the best checkpoint with latency on: its top-1
   equals the best epoch's, K1 8 calls per batch, and its p50 batch
   latency.

12. pipeline-A step, kernel vs plain: the full-width TemporalSSL
   (configs/ssl_train.yaml: MobileViT-S, embed 256, a 4-layer temporal
   transformer of 4 heads) at B=2 clips x 32 frames x 112x112, TOP on
   (subsample 2 clips), the same weights, EMA teacher, BatchNorm statistics,
   frame mask and TOP draws through the kernels and through the plain
   versions, fp32 and bf16, held as phase 10 holds its step (K1 30, K2 20
   calls); the bf16 pass also reports how far each run's loss lies from the
   fp32 plain run's.
13. pipeline A: the port's entry.train_ssl.run on configs/ssl_train.yaml
   (B=48 clips x 32 frames = 1536 MobileViT frames, bf16, the split
   device-resident) with its departures (top_start_epoch 1, so steps with
   and without TOP alternate; a checkpoint every epoch) on a synthetic
   96-clip split of 64-frame videos, 6 steps. Per step: TOP on or off, loss,
   step ms (the checkpoint writes left out), clips/s, K1 and K2 calls (20
   and 10 without TOP, 30 and 20 with it) and peak memory; the last
   checkpoint's encoder then fills the MobileViT classifier.
14. pipeline-C step, kernel vs plain: the full-width TinyViTMAE
   (configs/mae_train.yaml: the four-stage TinyViT-21M, 3x3 pooled tokens,
   decoder 512 wide, 2 blocks of 8 heads) at B=2 clips x 32 frames, the same
   weights, tube mask and drop-path decisions, fp32 and bf16, as phase 12
   (K1 22, K2 12 calls: 10 TinyViT layers, each recomputed once under remat,
   and 2 decoder layers). Then the same with mae.decoder.num_heads: 1 (one
   head of 512: the decoder's 2 K1 and 2 K2 calls on the wide kernels).
15. pipeline C: the port's entry.train_mae.run on configs/mae_train.yaml
   with the batch cut to 16 clips x 32 frames (the published 256 x 32 do not
   fit one card) and a checkpoint every epoch, bf16, resident split of 32
   clips of 128-frame videos: 4 steps (2 epochs), then a second run that
   resumes from its own checkpoint at epoch 3 for 2 more; per step as phase
   13 (K1 22, K2 12). The first run has mae.vis_every 2 (a phase departure
   only): at its epoch 2 it draws mae_vis_epoch_2.png through
   reporting/visualize.save_mae_vis, whose forward runs K1 12 times (10
   TinyViT and 2 decoder layers, no recompute) and K2 none; without
   matplotlib no picture and no forward, which the phase reports.
16. sanity check: the port's entry.sanity_check_mae on the card
   (configs/mae_train.yaml, one clip of 32 frames): PASSED, K1 24 and K2 12.

17. FedAvg client step, kernel vs plain: the full-width MobileViT-S
   classifier of configs/federated.yaml (embed 256, 101 classes) at B=2
   clips x 32 frames, the client step's loss and gradients through the
   kernels and through the plain versions, on a full step and on a step with
   one padded row, fp32 and bf16, held as phase 10 holds its step (K1 6, K2
   6); then one client's update through the kernels a step at a time: K1/K2
   6/6 on each real step, 0/0 on a fully padded third step, which leaves
   params, BatchNorm statistics and the AdamW count bit-unchanged; then the
   steady time of a client step at the config's 16 clips (512 frames) and
   of an eval batch there.
18. privacy: the port's entry.run_privacy.run on configs/privacy.yaml (embed
   256, batch 8 x 32 frames, bf16, device-resident split) with one
   departure, the feature grid cut to sigma {0, 0.5} x r {0, 0.2} (attacker
   10 epochs as the yaml), on 32 synthetic 224x224 face frames
   (data/fixtures.make_synthetic_faces) and a synthetic split of 160 clips:
   the detector that ran (YuNet from assets/yunet.onnx where the card
   machine's cv2 has FaceDetectorYN, else the stub), visual frames/s, clean
   top-1 and entropy, embedding ms per batch, K1 6 per embedding batch and
   K2 none; one frame anonymized on the card against the CPU within 1 grey
   level.
19. federated: the port's entry.run_federated.run on configs/federated.yaml
   (5 clients, batch 16 x 32 frames, lr 3e-4, wd 0.01, bf16) with three
   departures: 2 rounds, min_samples_per_client 32 (so that the 160-clip
   split shards to 32 clips a client) and the centralized baseline at 1
   epoch. Per round: seconds, client steps, avg_local_loss, val top-1/5,
   model_mb (equal to the formula over params + BN mean/var), K1/K2 6/6 per
   client step, K1 6 per eval batch, peak memory; the centralized epoch's
   K1/K2; the three CSVs with the JAX entry's headers; then
   privacy.system_federated.run_federated_from_privacy once, in-process.

20. MoE step, kernel vs plain: the full-width TinyVideoMAE of
   configs/ssl_mae_moe.yaml (8 top-1 experts in each decoder block, capacity
   1.25, groups of 392 tokens) at B=2 clips, its loss with the load-balance
   auxiliary weighted 0.01 as the step adds it, the same weights, mask and
   drop-path decisions through the kernels and the plain versions, fp32 and
   bf16, held as phase 10 holds its step (K1 20, K2 12); the auxiliary
   (held to [1/E, E]) and, per decoder block, the tokens the two runs route
   differently (another expert, or the other side of the capacity).
21. MoE pretraining: the port's entry.train_ssl_mae.run on
   configs/ssl_mae_moe.yaml as it stands (B=40, accumulation 2, bf16,
   resident split; expert_parallel 4 is ignored on one device with JAX's
   warning) with phase 6's departure (a checkpoint every epoch) and
   logging.profile_dir set, on phase 6's split, 4 steps. Per step: loss,
   moe_aux, gnorm, update applied or skipped, ms, clips/s, MFU against the
   H100's 989 TFLOP/s bf16, K1 20 and K2 12, peak memory; the warning; the
   profiler's two log lines and its trace's size and whether it names K1's
   and K2's kernels.
22. Long-clip step, kernel vs plain: as phase 20 for
   configs/ssl_mae_longclip.yaml (T=64, a 12544-token decoder) at one clip,
   with its peak memory.
23. Long-clip pretraining: entry.train_ssl_mae.run on
   configs/ssl_mae_longclip.yaml as it stands (B=8 x 64 frames at stride 1,
   accumulation 2, bf16; sequence_parallel falls back to the single-device
   kernel with JAX's warning) on phase 6's split of 64-frame videos, 4
   steps, per step as phase 21.
24. Finetune augmentation: one real step of phase 10's classifier (fp32,
   ft_ssl) with training.augment: true through the kernels (K1 8, K2 8),
   whose augmented clip the CPU reproduces from the same draws to 1e-6;
   then phase 11's entry run with training.augment: true (two_stage, 2
   epochs, phase 6's checkpoint): the enabling line, K1 8 a step, K2 0
   while frozen and 8 after.

25. The multi-process runtime over a one-rank NCCL group in this process
   (file:// store, rank 0 of 1; the card holds one rank, and NCCL refuses
   two ranks on one card): a data mesh, a seq mesh and a client mesh built
   directly, so that the BatchNorm all-reduces, the gradient reduction, the
   decoder's K/V all-gather and its reduce-scatter and the FedAvg
   all-reduce all run through NCCL. 2 pipeline-B steps of configs/
   ssl_mae.yaml (2 clips) over the data mesh and 2 of configs/
   ssl_mae_longclip.yaml (one 64-frame clip, the decoder through
   parallel/sp.sp_attention_packed) over the seq mesh, each against the
   same steps without the runtime from the same weights and draws, fp32
   and bf16 held by phase 10's rule (judge_step, the runtime run in the
   kernel run's place), K1/K2 20/12 a step on both; one FedAvg round of 2
   clients over the client mesh against the round without it (fp32, cuDNN
   deterministic; 1e-5). Then model sharding over one-rank meshes, the
   model cut over the mesh's model axis (parallel/shard.py): 2 steps of
   configs/ssl_mae_moe.yaml (2 clips, 8 experts in groups of 392 tokens)
   over {data: 1, expert: 1}, 2 of configs/ssl_mae.yaml over {data: 1,
   model: 1} and 2 over {pipe: 1} in 2 microbatches (the split and the
   stage's schedule), each against the same steps without the mesh by
   judge_step, K1/K2 20/12 a step (24/16 in the pipe's microbatches: the
   decoder's 4 layers run once a microbatch). Each path's bf16 second step,
   host-timed with and without its mesh, goes on a line of its own. A
   failed NCCL init fails the phase.
26. The launcher: torchrun --standalone --nproc_per_node 1 of
   entry.train_ssl_mae on configs/ssl_mae.yaml (phase 6's split; one epoch
   of 2 steps of 20 clips, every step logged, a checkpoint at its end):
   exit 0, NCCL up (the entry's process-group line), rank 0's log and
   checkpoint.

27. visualize_mae: the port's entry.visualize_mae main at configs/
   ssl_mae.yaml's full width (TinyViT cut at stage 3, TinyVideoMAE decoder,
   16 x 112x112, bf16) on phase 6's split and its encoder checkpoint, 2
   samples: the encoder-only warning, 2 PNGs and K1 12 a sample (2 stage-1,
   6 stage-2, 4 decoder layers). Then sample 0's triptych arrays
   (reporting/visualize.triptych_arrays) through K1 and through the plain
   attention, the same mask and weights, in fp32 (TF32 off) and in bf16:
   in fp32 no recon pixel may differ by more than 1 grey level; in bf16 at
   most 1% of them by more than TRIPTYCH_BF16_LEVELS; both shares printed.
28. plotting: the port's entry.plotting main on configs/plotting.yaml, in a
   temporary directory where docs/examples/csv/ is laid out as the yaml and
   generate_all's defaults expect: whether matplotlib imports; with it, the
   7 figures and results/summary.csv, equal as text to the committed
   docs/examples/csv/summary.csv; without it generate_all returns [] (the
   JAX module's behaviour), and the phase says so.
29. ablations: entry.ablations --dry_run over the four groups, each command
   checked against its expected port entry module; then one real cell,
   --groups dynamic --max_per_group 1 on phase 7's config and split, run as
   a subprocess started just before phase 26, whose launcher run it
   overlaps (neither is timed): it (and its run_dynamic, K1 on the card;
   their launches are those processes' and are not counted here) exits 0,
   its CSV and ablation_index.json (exit 0) exist.
30. export: tools.export_serving at configs/dynamic.yaml's MobileViT-S
   classifier (101 classes, embed 256, 32 x 112x112, fp32, TF32 off):
   exported on the card with a symbolic batch through the plain attention
   for --platforms cpu cuda (the program moved to the CPU for the cpu
   artifact), both saved, torch.export.load'ed and served at batches 2 and
   8, the cpu one from the CPU; each batch's served logits held to the live
   model's (K1, 6 a forward) within EXPORT_TOL of the largest live logit;
   served (card and CPU) and live ms per batch of 8 (a host sync after each
   call), with the card's name and power limit.
31. campaigns: the port's research campaign scripts at the campaign's full
   width (16 x 112x112 clips, batch 16, embed 256, bf16) on a hard fixture
   of 4 classes x 10 clips: ssl_transfer_campaign (1 SSL epoch, then
   ft_ssl, ft_random and linear_probe for 2 epochs each, then the 8 x 3
   feature-privacy grid) as the sweep cell A_lab100; mae_evidence (1 epoch
   of configs/ssl_mae.yaml at batch 16); the pipeline-B cell B_lab50 from
   its encoder (ft_ssl and two_stage on TinyViT, half the labels); then
   make_campaign_artifacts and make_sweep_artifacts. Each entry call is a
   path: seconds, step ms, peak memory, K1/K2 launches (K1 on every path,
   K2 on every one that trains a backbone, none on linear_probe and the
   privacy grid) and the (B, Lq, Lk, H, d) of every K1/K2 call, each of
   which must be one of phases 3-4's shapes; 24 privacy rows, 1 MAE epoch
   row, a sweep row a mode, finite losses.
32. decoder repack: entry.train_ssl_mae on configs/ssl_mae.yaml with
   --set model.decoder_num_heads=3 (the decoder's 6 heads of 64 as 3 of
   128; phase 6's split and departure), TRAIN_STEPS steps: per step the
   loss (finite), step ms, peak memory, K1/K2 20/12 and the K1/K2 calls by
   head dim (the decoder's 4 layers at d = 128); the same with --set
   model.decoder_num_heads=1 (one head of 384: the decoder's 4 layers on
   the wide kernels; REPACK_ARMS); then the ported probe
   scripts/probe_decoder_repack (6x64 against 3x128 from the same weights)
   on phase 31's hard fixture at batch 16 with REPACK_PROBE_STEPS steps an
   arm: its lines, both arms' ms a step and the trajectory deviation.
33. dataset front end without JAX: cv2 writes FRONT_END's videos (UCF101's
   320x240 at 25 fps, MJPG .avi, a class name that needs normalizing);
   experiments/torch/run_full_pipeline_dataset.sh runs over them at 112
   (standardize, extract + pack, splits, verify) with a jax that cannot be
   imported first on its path; each stage's seconds, the packed arrays'
   count and shape; then one train_finetune epoch (ft_ssl, phase 6's
   encoder, the campaign's pipeline-B overrides, device-resident) and
   evaluate on the test split read the packed store (K1/K2 8/8 a step, K1 8
   an eval batch), and the batches of the packed store, host and
   device-resident, equal those read from the JPEG frames.

34. LayerNorm kernels vs plain (run after phase 9): the forward and
   backward kernels (csrc/layer_norm.cu) against their plain version, bf16
   in and out with fp32 weight, bias and statistics, at each LN_SHAPES row:
   pipeline B's two widths at a micro-step's rows (forward and backward)
   and serving's MobileViT-S blocks at a frame step of 8 clips (forward);
   y and dx to 1e-5 (1e-4 for dx) of their largest magnitude plus one bf16
   step, the weight and bias gradients to 1e-4; the time per call of each
   (queued behind a spin, so that the host's launch cost is not counted),
   of torch's fp32 layer_norm on the fp32 copy (its backward by
   autograd.grad) and the bound by bytes (each input read and output
   written once). Phase 6 holds the pipeline-B step to 41 forward and 25
   backward launches (LN_FWD_PER_STEP, LN_BWD_PER_STEP) and phase 7 the
   streaming path to two LayerNorms an attention call (12 a frame).

Each phase's config is configs/<name>.yaml over configs/base.yaml, as an
entry's --config loads it, with the departures the phase names
(*_SMOKE_OVERRIDES, CAMPAIGN_B, LAUNCH_OVERRIDES, REPACK_ARMS) and its own
splits, output directories and device.

Every kernel launch count is set to 0 just before each path (train,
serving, each probe, finetune, evaluate, the pipeline-A and -C entries, the
sanity check, privacy, the federated baseline, client steps, evaluation and
the in-process bridge, the MoE and long-clip pretraining, the augmented
finetune, the runtime's data steps, seq steps, FedAvg round and
expert, model and pipe steps, pipeline C's picture, visualize_mae, the
export's live model, each entry call of the campaigns, the repacked
pretraining at 3 heads and at 1 and its probe, and the finetune and
evaluate on the front end's packed store) is driven and read just after.
The wide kernels' launches (d > 256) are also counted apart, and the line
of kernels lists them apart, their launches from the one-head repacked
pretraining. The line before the
last lists the kernels, each with its launches on every path, its time,
the plain version's, the library call's and the bound; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or without the rest of
the repo beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
K1_TPU = "ssl_vit_video_analytics_tpu/ops/flash_attention.py:147"
K1_SOURCE = "ssl_vit_video_analytics_tpu_torch/ops/csrc/flash_fwd.cu"
K2_TPU = "ssl_vit_video_analytics_tpu/ops/flash_attention.py:214"
K2_SOURCE = "ssl_vit_video_analytics_tpu_torch/ops/csrc/flash_bwd.cu"
P1_TPU = "scripts/probe_dw.py:31"
P1_SOURCE = "ssl_vit_video_analytics_tpu_torch/ops/csrc/dw3x3.cu"
P2_TPU = "scripts/probe_exp.py:35"
P2_SOURCE = "ssl_vit_video_analytics_tpu_torch/ops/csrc/unary_chain.cu"
LN_SOURCE = "ssl_vit_video_analytics_tpu_torch/ops/csrc/layer_norm.cu"
LN_REPLACES = ("none: added for the port's fp32 round trip around torch's LayerNorm "
               "(the JAX package leaves LayerNorm to XLA, which fuses the casts)")
PATHS = ("train_ssl_mae", "run_dynamic_streaming", "run_dynamic_batched", "probe_dw",
         "probe_exp", "train_finetune", "evaluate", "train_ssl", "train_mae",
         "sanity_check_mae", "run_privacy", "fed_centralized", "fed_client_steps", "fed_eval",
         "system_federated", "train_ssl_mae_moe", "train_ssl_mae_longclip",
         "train_finetune_augment", "runtime_data_steps", "runtime_seq_steps",
         "runtime_fedavg", "runtime_expert_steps", "runtime_model_steps",
         "runtime_pipe_steps", "train_mae_vis", "visualize_mae", "export_live",
         "campaign_train_ssl", "campaign_ft_ssl", "campaign_ft_random",
         "campaign_linear_probe", "campaign_run_privacy", "mae_evidence",
         "campaign_b_ft_ssl", "campaign_b_two_stage", "train_ssl_mae_repack",
         "train_ssl_mae_repack_h1", "probe_decoder_repack", "train_finetune_packed",
         "evaluate_packed")

CONFIGS = os.path.join(ROOT, "configs")
# every phase's own keys: the card, and splits given as paths
ON_CARD = {"device": {"name": "cuda"}, "paths": {"split_root": ""}}
# phase 7's one departure from configs/dynamic.yaml: no trained checkpoint
# is in a checkout, so random weights from a seeded generator
SLICE_SMOKE_OVERRIDES = {"model": {"finetune_ckpt": None}}
# the smoke's one departure from configs/ssl_mae.yaml: an encoder checkpoint
# every epoch, so that the 4 steps leave one for phase 11
SSL_MAE_SMOKE_OVERRIDES = {"training": {"save_every": 1}}
TRAIN_STEPS = 4

# phases 20-23's pipeline-B yamls, by regime
OPT_IN_CONFIGS = {"moe": "ssl_mae_moe", "longclip": "ssl_mae_longclip"}
OPT_IN_STEPS = 4  # each opt-in entry run: 2 optimizer updates at accumulation 2
# the warning each opt-in run logs where the JAX entry logs it on one device
OPT_IN_WARNING = {
    "moe": "[WARN] expert_parallel requested on 1 device; ignoring",
    "longclip": "[WARN] sequence_parallel requested on 1 device; attention falls back "
                "to the single-device kernel"}
# clips in each opt-in step check: phase 5's 2 for the MoE decoder; one
# 64-frame clip for the long clip (the plain decoder attention of one clip
# takes [6, 12544, 12544] fp32 logits, 3.8 GB, and as much for each of the
# backward's four such terms)
OPT_IN_STEP_CLIPS = {"moe": 2, "longclip": 1}
# the long-clip decoder's attention (B, Lq, Lk, H, d), and a rank's query
# shard of it under a seq mesh of 4 and of 8 ranks (parallel/sp.py: Lq =
# L/n over the gathered Lk = L): each held to the plain version on its
# first and last clip, timed at the config's batch
LONGCLIP_SHAPES = [("longclip_decoder", 8, 12544, 12544, 6, 64),
                   ("longclip_seq_shard4", 8, 3136, 12544, 6, 64),
                   ("longclip_seq_shard8", 8, 1568, 12544, 6, 64)]
# the head blocks that a rank of a model mesh holds of pipeline B's decoder
# attention (parallel/tp.py: whole heads, 6 over tp 2 is 3 a rank, over tp 4
# 2, 2, 1, 1), held and timed as the long-clip shapes
TP_SHAPES = [("mae_decoder_tp_h3", 4, 3136, 3136, 3, 64),
             ("mae_decoder_tp_h2", 4, 3136, 3136, 2, 64),
             ("mae_decoder_tp_h1", 4, 3136, 3136, 1, 64)]
# the runtime over a one-rank NCCL group (phase 25): pipeline-B steps of
# configs/ssl_mae.yaml at 2 clips and of configs/ssl_mae_longclip.yaml at one
RUNTIME_STEPS = 2
RUNTIME_CLIPS = {"ssl_mae": 2, "longclip": 1, "moe": 2}
# the pipe mesh's microbatches (device.pp_microbatches); the decoder's 4
# attention layers run once a microbatch
RUNTIME_MICROBATCHES = 2
# phase 6's departure: TensorBoard scalars (the yaml has none)
SSL_MAE_TENSORBOARD = {"logging": {"tensorboard": True}}
# phase 15's departure: a picture at epoch 2 of its first run
MAE_VIS_EVERY = 2
# pipeline C's picture forward: 10 TinyViT and 2 decoder attention layers
MAE_VIS_K1_CALLS = 12
# phase 27: visualize_mae's samples, K1 a sample (2 + 6 encoder and 4
# decoder layers), and the bf16 triptych bound: at most 1% of the recon
# pixels of the kernel and plain runs more than this many grey levels apart
VIS_SAMPLES, VIS_K1_PER_SAMPLE = 2, 12
TRIPTYCH_BF16_LEVELS = 4
# phase 28: docs/examples/csv/ laid out as configs/plotting.yaml and
# generate_all's defaults expect
PLOTTING_LAYOUT = {
    "results/dynamic/early_exit_results.csv": "early_exit_results.csv",
    "results/dynamic/frame_gating_results.csv": "frame_gating_results.csv",
    "results/privacy/feature_privacy.csv": "feature_privacy.csv",
    "results/privacy/federated/fed_summary.csv": "fed_summary.csv",
    "results/ema_ssl_vicreg/ssl_metrics.csv": "ssl_metrics.csv",
    **{f"results/finetune/{mode}/metrics.csv": f"finetune_{mode}_metrics.csv"
       for mode in ("ft_random", "linear_probe", "ft_ssl", "two_stage")}}
PLOTTING_FIGURES = 7
# phase 29: the entry each ablation group runs, and its cells
ABLATION_GROUPS = {"sampling": ("train_finetune", 4), "ssl_objective": ("train_ssl", 4),
                   "privacy": ("run_privacy", 3), "dynamic": ("run_dynamic", 3)}
# phase 30: the served batches, and the served logits' bound against the
# live model's, of the largest live logit: phase 3's for K1 fp32 against
# plain (TOL_FP32), held end to end over the forward's 6 calls
EXPORT_BATCHES = (2, 8)
EXPORT_TOL = 1e-4
# the export's --platforms: exported on the card, one artifact each; the
# cpu one served from the CPU
EXPORT_PLATFORMS = ("cpu", "cuda")
# phase 31: the research campaigns through the port's scripts at the
# campaign's full width (16 x 112x112 clips, batch 16, embed 256, bf16;
# mae_evidence at configs/ssl_mae.yaml's widths), counts cut for time: a
# hard fixture of 4 classes x 10 clips, 1 SSL epoch, 2 finetune epochs, 1
# MAE epoch; the default modes and privacy grid for pipeline A, then the
# pipeline-B family at half the labels (the sweep's B_lab50 cell)
CAMPAIGN_DATA = ["--classes", "4", "--clips", "10"]
CAMPAIGN_A_ARGS = ["--ssl_epochs", "1", "--ft_epochs", "2"]
MAE_EVIDENCE_ARGS = ["--epochs", "1", "--batch", "16", "--log_interval", "1"]
CAMPAIGN_B_ARGS = ["--ft_epochs", "2", "--skip_ssl", "--skip_privacy", "--backbone", "tinyvit",
                   "--ft_label_fraction", "0.5", "--modes", "ft_ssl,two_stage"]
CAMPAIGN_A_MODES = ("ft_ssl", "ft_random", "linear_probe")
CAMPAIGN_B_MODES = ("ft_ssl", "two_stage")
MAE_EVIDENCE_EPOCHS, PRIVACY_GRID_ROWS = 1, 8 * 3
# the campaign paths whose backbone is frozen or which train nothing: no K2
CAMPAIGN_NO_K2 = ("campaign_linear_probe", "campaign_run_privacy")
# phase 32: the decoder repack on phase 6's run, --set
# model.decoder_num_heads=3 (6 heads of 64 become 3 of 128) and its far end,
# =1 (one head of 384, the wide kernels): each arm's path, overrides and
# K1/K2 calls a step at each head dim: the decoder's 4 layers (not
# checkpointed) at 128 or 384, the encoder's 8 at 32 (K1 again in the
# checkpointed recompute)
REPACK_ARMS = {
    "train_ssl_mae_repack": ({"model": {"decoder_num_heads": 3}},
                             {"K1_d128": 4, "K2_d128": 4, "K1_d32": 16, "K2_d32": 8}),
    "train_ssl_mae_repack_h1": ({"model": {"decoder_num_heads": 1}},
                                {"K1_d384": 4, "K2_d384": 4, "K1_d32": 16, "K2_d32": 8}),
}
# the probe's steps an arm (its default 60, cut for the script's time)
REPACK_PROBE_STEPS = 10
# phase 33: videos as UCF101's (320x240, 25 fps, MJPG .avi) of a few classes,
# 7 a class so that the runner's 70/15/15 split leaves one for val; one
# class name with a space, as standardize_structure normalizes
FRONT_END = {"classes": ("ApplyEyeMakeup", "Basketball", "Jump Rope", "PlayingGuitar"),
             "videos_per_class": 7, "frames": 48, "width": 320, "height": 240, "fps": 25.0}
FRONT_END_MODE = "ft_ssl"

# phase 26: the launcher's pipeline-B run (configs/ssl_mae.yaml on phase 6's
# 40-clip split; departures: one epoch of 2 steps of 20 clips, every step
# logged, a checkpoint at its end)
LAUNCH_OVERRIDES = {"training": {"epochs": 1, "batch_size": 20, "save_every": 1,
                                 "log_interval": 1}}

# phase 11's departures from configs/finetune.yaml: the pipeline-B transfer
# campaign's overrides (scripts/ssl_transfer_campaign.py --backbone tinyvit
# --device_resident true: T=16, stride 1, 112x112, batch 16, bf16), cut to
# two epochs of two_stage
CAMPAIGN_B = {"model": {"backbone": "tinyvit"},
              "dataset": {"clip_len": 16, "stride": 1, "image_size": 112,
                          "device_resident": True},
              "training": {"batch_size": 16, "epochs": 2, "stage1_epochs": 1},
              "device": {"compute_dtype": "bfloat16"}}
FINETUNE_MODE = "two_stage"
FT_CLASSES = 8
# attention layers of the TinyViT classifier (stage limit 3): 2 in stage 1,
# 6 in stage 2; K1 once each per forward, K2 once each per backward through
# an unfrozen backbone
FT_K1_CALLS, FT_K2_CALLS = 8, 8
# attention layers of the pipeline-B step: 2 in TinyViT stage 1, 6 in
# stage 2, 4 in the decoder. Each runs K1 forward and K2 backward once; the
# 8 encoder layers run K1 once more when their checkpointed stage is
# recomputed in the backward pass (the decoder is not checkpointed).
K1_CALLS_PER_STEP, K2_CALLS_PER_STEP = 12 + 8, 12
# LayerNorms of the pipeline-B step: 2 a transformer block (4 in TinyViT
# stage 1, 12 in stage 2, 8 in the decoder) and the decoder's final one.
# The 16 encoder ones run forward once more in their stage's recompute.
LN_FWD_PER_STEP, LN_BWD_PER_STEP = 25 + 16, 25
# (name, rows, width, backward): pipeline B's micro-step of 40 clips x 16
# frames (TinyViT stage 1: 640 frames of 28x28 tokens at 192; stage 2 and
# the decoder: 125,440 tokens at 384), forward and backward; serving's
# MobileViT-S blocks at a streamed frame of 8 clips (14x14, 8x8 padded and
# 4x4 tokens at 128, 160 and 192), forward only
LN_SHAPES = (("tinyvit_stage1", 501760, 192, True), ("tinyvit_stage2", 125440, 384, True),
             ("mvit1", 8 * 196, 128, False), ("mvit2", 8 * 64, 160, False),
             ("mvit3", 8 * 16, 192, False))

# (B, Lq, Lk, H, d): the slice's MobileViT blocks at 8 clips x 16 frames,
# then pipeline-B's TinyViT stages, its decoder, and a sequence-parallel
# shard; then pipeline A's MobileViT blocks at 48 clips x 32 frames and its
# temporal transformer, pipeline C's TinyViT stages 1-3 at 16 clips x
# 32 frames and its decoder, and the MobileViT blocks at the FedAvg client
# step's 16 clips x 32 frames and the privacy embedding's 8 x 32; then the
# campaigns' (phase 31) at 16 clips x 16 frames that no earlier path has:
# pipeline A's temporal head, the TinyViT stages of the pipeline-B
# finetune and of mae_evidence, and mae_evidence's decoder; then the head
# dims past the models' defaults: the decoder repack (phase 32, 3 x 128),
# pipeline A's temporal head at embed 384 (4 x 96), one row at each of d =
# 16, 20 (staged element by element), 24 and 80 at the serving length, and
# the widest width, d = 256; then the wide kernels: the one-head decoders
# of pipelines B (phase 32, 1 x 384) and C (phase 14, 1 x 512), a d staged
# element by element (300) and d = 1024
KERNEL_SHAPES = [
    ("mvit1", 128, 196, 196, 4, 32),
    ("mvit2", 128, 64, 64, 4, 40),
    ("mvit3", 128, 16, 16, 4, 48),
    ("tinyvit_stage1", 32, 784, 784, 6, 32),
    ("tinyvit_stage2", 128, 196, 196, 12, 32),
    ("mae_decoder", 4, 3136, 3136, 6, 64),
    ("decoder_seq_shard", 4, 784, 3136, 6, 64),
    ("mvit1_ssl", 1536, 196, 196, 4, 32),
    ("mvit2_ssl", 1536, 64, 64, 4, 40),
    ("mvit3_ssl", 1536, 16, 16, 4, 48),
    ("temporal", 48, 32, 32, 4, 64),
    ("tinyvit_stage1_mae", 512, 784, 784, 6, 32),
    ("tinyvit_stage2_mae", 512, 196, 196, 12, 32),
    ("tinyvit_stage3", 512, 49, 49, 18, 32),
    ("token_mae_decoder", 16, 288, 288, 8, 64),
    ("mvit1_fed", 512, 196, 196, 4, 32),
    ("mvit2_fed", 512, 64, 64, 4, 40),
    ("mvit3_fed", 512, 16, 16, 4, 48),
    ("mvit1_priv", 256, 196, 196, 4, 32),
    ("mvit2_priv", 256, 64, 64, 4, 40),
    ("mvit3_priv", 256, 16, 16, 4, 48),
    ("temporal_campaign", 16, 16, 16, 4, 64),
    ("tinyvit_stage1_campaign", 256, 784, 784, 6, 32),
    ("tinyvit_stage2_campaign", 256, 196, 196, 12, 32),
    ("mae_decoder_campaign", 16, 3136, 3136, 6, 64),
    ("mae_decoder_h3", 4, 3136, 3136, 3, 128),
    ("temporal_d96", 48, 32, 32, 4, 96),
    ("l196_d16", 128, 196, 196, 4, 16),
    ("l196_d20", 128, 196, 196, 4, 20),
    ("l196_d24", 128, 196, 196, 4, 24),
    ("l196_d80", 128, 196, 196, 4, 80),
    ("mae_decoder_d256", 4, 3136, 3136, 2, 256),
    ("mae_decoder_h1", 4, 3136, 3136, 1, 384),
    ("token_mae_decoder_h1", 16, 288, 288, 1, 512),
    ("l196_d300", 128, 196, 196, 1, 300),
    ("l784_d1024", 4, 784, 784, 1, 1024),
]
TRAIN_SHAPES = ("tinyvit_stage1", "tinyvit_stage2", "mae_decoder")
# the wide kernels' row on the line of kernels: phase 32's one-head decoder
WIDE_SHAPE = "mae_decoder_h1"
# pipeline C's one-head decoder (phase 14's second check), its K1/K2 calls
# on the wide kernels a step (2 decoder layers)
MAE_H1_OVERRIDES = {"mae": {"decoder": {"num_heads": 1}}}
MAE_H1_WIDE_CALLS = (2, 2)
HMMA_BF16 = "HMMA.16816.F32.BF16"
HGMMA = "HGMMA"
# the wide head dims of KERNEL_SHAPES, at which phase 2 reports the bf16
# wide kernels' dynamic shared memory
WIDE_DIMS = (300, 384, 512, 1024)
ASYNC_COPIES = ("UTMALDG", "LDGSTS")
# K1's bf16 kernel and K2's two, for each kernel width (flash_mma.cuh:
# 32, 40, 48, 64, 96, 128, 256) and the wide kernels (K1's on wgmma, K2's
# on mma.sync)
BF16_FLASH_KERNELS = 3 * (7 + 1)
# what bounds an attention call (h100_bench/yardstick.attention_bound), as
# the line of kernels names it
BOUND_BY = {"bytes": "bytes", "ops": "operations"}
TOL_FP32, TOL_BF16 = 1e-4, 2e-2
TOL_STEP_LOSS, TOL_STEP_GRAD = 1e-4, 1e-3
# bf16 attention outputs of two implementations differ by up to ~7e-3 of
# their magnitude (the port's plain version against the JAX kernels); the
# step's loss moves by about 1e-4 of itself
TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16 = 1e-3, 5e-2
# phases 12-13's departures from configs/ssl_train.yaml: TOP from the first
# epoch (steps with and without it alternate) and a checkpoint every epoch
SSL_TRAIN_SMOKE_OVERRIDES = {"ssl_objectives": {"top_start_epoch": 1},
                             "training": {"save_every": 1}}
SSL_TRAIN_STEPS = 6
# attention layers per forward_tokens: 3 MobileViT blocks x depth 2, and 4
# temporal layers. Teacher and student run K1, the student K2; the TOP
# branch one more forward and backward
SSL_K1_K2 = {False: (20, 10), True: (30, 20)}

# phases 14-16's departures from configs/mae_train.yaml: 16 clips a batch
# (256 x 32 frames through the full TinyViT do not fit one card) and a
# checkpoint every epoch
MAE_TRAIN_SMOKE_OVERRIDES = {"training": {"batch_size": 16, "save_every": 1}}
MAE_TRAIN_STEPS, MAE_RESUME_STEPS = 4, 2
# 10 TinyViT attention layers (2 + 6 + 2), each run again when its
# checkpointed stage is recomputed, and 2 decoder layers
MAE_K1_CALLS, MAE_K2_CALLS = 22, 12
# the sanity check: an eval forward, then a forward and backward (no remat)
SANITY_K1_CALLS, SANITY_K2_CALLS = 24, 12
# phase 18's one departure from configs/privacy.yaml: a 2 x 2 corner of the
# feature grid
PRIVACY_SMOKE_OVERRIDES = {"feature_privacy": {"noise_sigmas": [0.0, 0.5],
                                               "mask_ratios": [0.0, 0.2]}}
# phases 17 and 19's departures from configs/federated.yaml: 2 rounds,
# clients of 32 clips from a 160-clip split, and the centralized baseline at
# 1 epoch (rounds x local_epochs = 2)
FEDERATED_SMOKE_OVERRIDES = {"federated": {"rounds": 2,
                                           "non_iid": {"min_samples_per_client": 32}},
                             "centralized": {"epochs": 1}}
# 8 classes x 20 train videos of 64 frames (32 at stride 2) and 1 val video each
FED_DATA = {"num_classes": 8, "videos_per_class": 21}
# attention layers per MobileViT-S forward: 3 blocks x depth 2
MVIT_ATTN = 6
TOL_DW_FP32 = 1e-5                 # abs; bf16: this plus one ulp of the output
# (N, H, W, C) crossing every tile edge of P1: 9 rows (8-row bands), 300
# columns (column tiles), 40 channels (32 bf16 or 16 fp32 a chunk)
DW_EDGE_SHAPE = (1, 9, 300, 40)
TOL_CHAIN_FP32 = 1e-5              # of the largest magnitude; bf16: two ulps
CHAIN_CHECK_N = (1, 4, 13, 64, 516)  # see phase 9 above; 4 and 516 are the probe's


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def counters() -> dict:
    """Every kernel's launch counter, by the kernel's name in the last line."""
    from ssl_vit_video_analytics_tpu_torch.ops import depthwise, layer_norm, unary_chain
    from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa

    return {"flash_attention_fwd": fa.launches, "flash_attention_bwd": fa.bwd_launches,
            "flash_attention_fwd_wide": fa.wide_launches,
            "flash_attention_bwd_wide": fa.wide_bwd_launches,
            "dw3x3": depthwise.launches, "unary_chain": unary_chain.launches,
            "layer_norm_fwd": layer_norm.launches, "layer_norm_bwd": layer_norm.bwd_launches}


def reset_counts() -> None:
    for c in counters().values():
        c.reset()


def read_counts() -> dict:
    return {name: c.count for name, c in counters().items()}


def bf16_ulp(t):
    """The spacing of bf16 numbers at |t| (8 significant bits)."""
    import torch

    mag = t.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def rel_err(got, ref) -> float:
    """Max abs error over the reference's max magnitude."""
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Milliseconds per call on the card: CUDA events around 20 calls
    after 3 warm-up calls (the port's probe timer)."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.scripts import time_ms as card_time_ms

    return card_time_ms(fn, torch.device("cuda", 0), iters=20)


def heads(t, H: int):
    """Packed ``[B, L, H*d]`` as the ``[B, H, L, d]`` view that
    scaled_dot_product_attention takes."""
    return t.unflatten(-1, (H, t.shape[-1] // H)).transpose(1, 2)


def sdpa_backend(q, k, v) -> str:
    """The backend scaled_dot_product_attention picks for these inputs."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v)).name


def summed(rows: list[dict]) -> dict:
    """Times summed over the pipeline-B shapes; bound_by is that of the
    largest bound."""
    out = {key: sum(r[key] for r in rows) for key in ("ms", "plain_ms", "library_ms",
                                                      "bound_ms")}
    out["bound_by"] = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
    return out


def shape_lap(kernel: str, shape: str, t0: float) -> None:
    """Wall seconds that phases 3-4 spend on one shape, both dtypes: the
    checks, the three timings and the library call."""
    emit({"phase": "shape_seconds", "kernel": kernel, "shape": shape,
          "seconds": time.perf_counter() - t0})


def phase_kernel(fa, dev) -> dict:
    import torch
    import torch.nn.functional as F

    from h100_bench import yardstick

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    train_rows = []
    wide = {"max_abs_err": 0.0}  # the wide kernels' row of the line of kernels
    for name, B, Lq, Lk, H, d in KERNEL_SHAPES:
        t_shape = time.perf_counter()
        hd = H * d
        # strided thirds of a fused projection, as MultiHeadAttention passes them
        qkv = torch.randn(B, Lq, 3 * hd, device=dev, generator=g)
        kv = torch.randn(B, Lk, 2 * hd, device=dev, generator=g)
        for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            qkv_t, kv_t = qkv.to(dtype), kv.to(dtype)
            q, k, v = qkv_t[..., :hd], kv_t[..., :hd], kv_t[..., hd:]
            out, lse = fa.flash_attention_fwd(q, k, v, H)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), H)
            torch.cuda.synchronize()
            err_out = (out.float() - ref_out).abs().max().item()
            rel_out = rel_err(out, ref_out)
            err_lse = (lse - ref_lse).abs().max().item()
            ok = (out.shape == ref_out.shape and math.isfinite(rel_out)
                  and rel_out <= tol and err_lse <= tol)
            ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, H))
            plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, H))
            qh, kh, vh = heads(q, H), heads(k, H), heads(v, H)
            lib_out = F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2)
            lib_err = (lib_out.float().flatten(2) - ref_out).abs().max().item()
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            seconds, by = yardstick.attention_bound(B, Lq, Lk, H, d, dtype, backward=False)
            bound = (1e3 * seconds, BOUND_BY[by])
            emit({"phase": "kernel_vs_plain", "shape": name, "B": B, "Lq": Lq, "Lk": Lk,
                  "H": H, "d": d, "dtype": str(dtype).replace("torch.", ""),
                  "err_out": err_out, "rel_err_out": rel_out, "err_lse": err_lse,
                  "tol": tol,
                  "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "sdpa_backend": sdpa_backend(qh, kh, vh), "library_err_out": lib_err,
                  "bound_ms": bound[0], "bound_by": bound[1], "ok": ok})
            if not ok:
                raise AssertionError(f"K1 disagrees with the plain version at {name} "
                                     f"{dtype}: out {rel_out} relative, lse {err_lse} > "
                                     f"{tol}")
            max_err = max(max_err, err_out, err_lse)
            row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound[0], "bound_by": bound[1]}
            if name in TRAIN_SHAPES and dtype == torch.bfloat16:
                train_rows.append(row)
            if d > fa.KERNEL_WIDTHS[-1]:
                wide["max_abs_err"] = max(wide["max_abs_err"], err_out, err_lse)
                if name == WIDE_SHAPE and dtype == torch.bfloat16:
                    wide.update(row, sdpa_backend=sdpa_backend(qh, kh, vh))
            del lib_out
        shape_lap("K1", name, t_shape)
    refuses(fa, dev)
    return {"max_abs_err": max_err, **summed(train_rows), "wide": wide}


def refuses(fa, dev) -> None:
    """No fallback to the plain version: what the kernels do not take
    raises in K1 and K2 on the card (fp16, mismatched shapes, a bf16 view
    off 16-byte alignment, a grid of 2^31 CTAs or more at d = 1024), and
    nothing is launched. The grid: B = 2^19 rows of L = 2^16 at d = 1024, 2
    column groups of 32-row tiles: 2^31 CTAs."""
    import torch

    x = torch.zeros(1, 8, 64, device=dev)
    lse = torch.zeros(1, 8, 1, device=dev)
    off = torch.zeros(1, 8, 65, device=dev, dtype=torch.bfloat16)[..., 1:]
    big = torch.zeros(1, 1, 1024, device=dev).expand(2**19, 2**16, 1024)
    big_lse = torch.zeros(1, 1, 1, device=dev).expand(2**19, 2**16, 1)
    cases = {"dtype": (TypeError, (x.half(),) * 3, lse),
             "shape": (ValueError, (x, x[:, :4], x), lse),
             "alignment": (ValueError, (off,) * 3, lse),
             "grid": (ValueError, (big,) * 3, big_lse)}
    before = read_counts()
    refusals = {}
    for case, (exc, (q, k, v), stats) in cases.items():
        for kernel, call in (("K1", lambda: fa.flash_attention_fwd(q, k, v, 1)),
                             ("K2", lambda: fa.flash_attention_bwd(q, k, v, q, stats, q, 1))):
            try:
                call()
            except exc as e:
                refusals[f"{kernel}_{case}"] = str(e)
    emit({"phase": "kernel_refuses", "errors": refusals})
    if len(refusals) != 2 * len(cases) or read_counts() != before:
        raise AssertionError(f"the kernels took what they must refuse: {refusals}")


def phase_build() -> dict:
    from ssl_vit_video_analytics_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    libs = kernel_build.build()
    seconds = time.perf_counter() - t0
    out = {"phase": "build", "seconds": seconds}
    for name, kl in libs.items():
        out[name] = {"nvcc_seconds": kl.build_seconds,
                     "library": os.path.relpath(kl.path, ROOT),
                     "ptxas": ptxas_summary(kl.ptxas_log)}
    # bf16 tensor-core products in each flash kernel's SASS: mma.sync
    # (HMMA) and wgmma (HGMMA)
    hmma, hgmma = {}, {}
    for lib in ("flash_fwd", "flash_bwd"):
        listing = kernel_build.sass(libs[lib].path)
        counts = kernel_build.count_by_function(listing, HMMA_BF16)
        hmma.update({kernel_label(f): n for f, n in counts.items()})
        counts = kernel_build.count_by_function(listing, HGMMA)
        hgmma.update({kernel_label(f): n for f, n in counts.items()})
    out["hmma_16816_f32_bf16"] = hmma
    out["hgmma"] = {k: n for k, n in hgmma.items() if n}
    # the wide kernels: ptxas's registers, spills and static shared memory,
    # and the dynamic shared memory of the bf16 ones at each wide head dim
    out["wide_kernels"] = {
        "ptxas": [row for lib in ("flash_fwd", "flash_bwd") for row in out[lib]["ptxas"]
                  if "_wide_" in row],
        "bf16_dynamic_smem_bytes": {
            str(d): {"fwd": libs["flash_fwd"].lib.ssl_vit_flash_fwd_wide_smem(d),
                     "dkdv": libs["flash_bwd"].lib.ssl_vit_flash_bwd_wide_smem(d, 1),
                     "dq": libs["flash_bwd"].lib.ssl_vit_flash_bwd_wide_smem(d, 0)}
            for d in WIDE_DIMS}}
    # asynchronous copies in each P1 kernel's SASS
    listing = kernel_build.sass(libs["dw3x3"].path)
    copies = {}
    for opcode in ASYNC_COPIES:
        for f, n in kernel_build.count_by_function(listing, opcode).items():
            copies.setdefault(kernel_label(f), {})[opcode] = n
    out["p1_async_copies"] = copies
    emit(out)
    if set(libs) != {"flash_fwd", "flash_bwd", "dw3x3", "unary_chain", "layer_norm"}:
        raise AssertionError(f"built {sorted(libs)}, not the five kernel sources")
    bf16 = {k: n + hgmma[k] for k, n in hmma.items() if "_bf16_kernel" in k}
    if len(bf16) != BF16_FLASH_KERNELS or not all(bf16.values()):
        raise AssertionError(f"bf16 flash kernels without tensor-core products: {hmma} {hgmma}")
    if not any("fwd_wide_bf16" in k for k in out["hgmma"]):
        raise AssertionError(f"K1's wide bf16 kernel without wgmma: {hgmma}")
    if not copies or not all(sum(c.values()) for c in copies.values()):
        raise AssertionError(f"P1 kernels without asynchronous copies: {copies}")
    spills = [row for lib in ("dw3x3", "unary_chain") for row in out[lib]["ptxas"]
              if "spill 0/0" not in row]
    if spills:
        raise AssertionError(f"P1 or P2 kernels spill: {spills}")
    return out


# one mangled template argument: bf16, float, an int, a bool
_TEMPLATE_ARG = re.compile(r"(1\d__nv_bfloat16)|(f)|Li(\d+)E|Lb([01])E")


def kernel_label(mangled: str) -> str:
    """``name<args>`` of a mangled kernel template instantiation: the
    length-prefixed identifier ending in ``_kernel`` that opens the
    template arguments."""
    for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
        # the length prefix may follow other digits of a hashed namespace
        lengths = (int(m.group()[i:]) for i in range(len(m.group())))
        for name in (mangled[m.end():m.end() + n] for n in lengths):
            rest = mangled[m.end() + len(name):]
            if name.endswith("_kernel"):
                break
        else:
            continue
        if not rest.startswith("I"):  # not a template: the wide kernels
            return name
        args = re.match(r"I(\w*?)EE", rest)
        parts = ["bf16" if bf16 else "f32" if f else i if i else b
                 for bf16, f, i, b in _TEMPLATE_ARG.findall(args.group(1) + "E")]
        return f"{name}<{','.join(parts)}>"
    return mangled


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel instantiation: registers, spill stores/loads,
    static shared memory."""
    rows, kernel = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = kernel_label(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rows.append(f"{kernel}: spill {m.group(1)}/{m.group(2)}")
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1] += f", {m.group(1)} regs"
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                rows[-1] += f", {m.group(1)} B smem"
    return rows


def phase_backward(fa, dev) -> dict:
    import torch
    import torch.nn.functional as F

    from h100_bench import yardstick

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(1)
    max_abs, max_rel = 0.0, 0.0
    train_rows = []
    wide = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    for name, B, Lq, Lk, H, d in KERNEL_SHAPES:
        t_shape = time.perf_counter()
        hd = H * d
        qkv = torch.randn(B, Lq, 3 * hd, device=dev, generator=g)
        kv = torch.randn(B, Lk, 2 * hd, device=dev, generator=g)
        dout32 = torch.randn(B, Lq, hd, device=dev, generator=g)
        for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            qkv_t, kv_t, dout = qkv.to(dtype), kv.to(dtype), dout32.to(dtype)
            q, k, v = qkv_t[..., :hd], kv_t[..., :hd], kv_t[..., hd:]
            out, lse = fa.flash_attention_fwd(q, k, v, H)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, H)
            torch.cuda.synchronize()
            refs = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(),
                                                lse, dout.float(), H)
            torch.cuda.synchronize()
            errs = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, refs)}
            abs_err = max(float((a.float() - b).abs().max()) for a, b in zip(grads, refs))
            ok = (all(math.isfinite(e) and e <= tol for e in errs.values())
                  and all(a.shape == b.shape and a.dtype == dtype for a, b in zip(grads, refs)))
            ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, H))
            plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, H))
            # the library's backward, on a forward retained for it
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            views = [heads(t, H) for t in leaves]
            lib_out = F.scaled_dot_product_attention(*views)
            dout_h = heads(dout, H)
            library_ms = time_ms(lambda: torch.autograd.grad(lib_out, leaves, dout_h,
                                                             retain_graph=True))
            backend = sdpa_backend(*views)
            seconds, by = yardstick.attention_bound(B, Lq, Lk, H, d, dtype, backward=True)
            bound = (1e3 * seconds, BOUND_BY[by])
            emit({"phase": "k2_vs_plain", "shape": name, "B": B, "Lq": Lq, "Lk": Lk,
                  "H": H, "d": d, "dtype": str(dtype).replace("torch.", ""),
                  "rel_err": errs, "max_abs_err": abs_err, "tol": tol,
                  "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "sdpa_backend": backend, "bound_ms": bound[0], "bound_by": bound[1],
                  "ok": ok})
            if not ok:
                raise AssertionError(f"K2 disagrees with the plain backward at {name} "
                                     f"{dtype}: {errs} > {tol}")
            max_abs, max_rel = max(max_abs, abs_err), max(max_rel, *errs.values())
            row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound[0], "bound_by": bound[1]}
            if name in TRAIN_SHAPES and dtype == torch.bfloat16:
                train_rows.append(row)
            if d > fa.KERNEL_WIDTHS[-1]:
                wide.update(max_abs_err=max(wide["max_abs_err"], abs_err),
                            max_rel_err=max(wide["max_rel_err"], *errs.values()))
                if name == WIDE_SHAPE and dtype == torch.bfloat16:
                    wide.update(row, sdpa_backend=backend)
            del grads, refs, lib_out, leaves, views
        shape_lap("K2", name, t_shape)
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, **summed(train_rows),
            "wide": wide}


def phase_longclip_kernels(fa, dev, shape: tuple) -> dict:
    """K1 and K2 at a long-clip decoder shape (one of LONGCLIP_SHAPES:
    ``(name, B, Lq, Lk, H, d)``; q the strided third of a fused projection,
    k and v those of a fused pair): each launched on the whole batch and
    held on its first and last clip against the plain version of that
    clip, in fp32 (TF32 off) and bf16 at phases 3-4's tolerances; in bf16
    the kernels' and scaled_dot_product_attention's times at the whole
    batch, with the bound, and the plain version's at one clip (its logits
    of the whole batch would take up to 30 GB). Returns each kernel's
    row."""
    import torch
    import torch.nn.functional as F

    from h100_bench import yardstick

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, B, Lq, Lk, H, d = shape
    hd = H * d
    g = torch.Generator(device=dev).manual_seed(4)
    qkv32 = torch.randn(B, Lq, 3 * hd, device=dev, generator=g)
    kv32 = torch.randn(B, Lk, 2 * hd, device=dev, generator=g)
    dout32 = torch.randn(B, Lq, hd, device=dev, generator=g)
    timed = {}
    for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
        qkv, kv, dout = qkv32.to(dtype), kv32.to(dtype), dout32.to(dtype)
        q, k, v = qkv[..., :hd], kv[..., :hd], kv[..., hd:]
        out, lse = fa.flash_attention_fwd(q, k, v, H)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, H)
        torch.cuda.synchronize()
        errs = dict.fromkeys(("out", "lse", "dq", "dk", "dv"), 0.0)
        for b in (0, B - 1):
            one = [t[b:b + 1].float() for t in (q, k, v)]
            ref_out, ref_lse = fa.flash_attention_plain(*one, H)
            errs["out"] = max(errs["out"], rel_err(out[b:b + 1], ref_out))
            errs["lse"] = max(errs["lse"], float((lse[b:b + 1] - ref_lse).abs().max()))
            del ref_out, ref_lse
            refs = fa.flash_attention_bwd_plain(*one, out[b:b + 1].float(), lse[b:b + 1],
                                                dout[b:b + 1].float(), H)
            for key, got, ref in zip(("dq", "dk", "dv"), grads, refs):
                errs[key] = max(errs[key], rel_err(got[b:b + 1], ref))
            del refs, one
        ok = all(math.isfinite(e) and e <= tol for e in errs.values())
        row = {"phase": "longclip_kernels_vs_plain", "shape": name, "B": B, "Lq": Lq,
               "Lk": Lk, "H": H, "d": d, "dtype": str(dtype).replace("torch.", ""),
               "checked_clips": [0, B - 1], "rel_err": errs, "tol": tol, "ok": ok}
        if dtype == torch.bfloat16:
            q1, k1, v1, out1, lse1, dout1 = (t[:1] for t in (q, k, v, out, lse, dout))
            qh, kh, vh = heads(q, H), heads(k, H), heads(v, H)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            views = [heads(t, H) for t in leaves]
            lib_out = F.scaled_dot_product_attention(*views)
            dout_h = heads(dout, H)
            times = {
                "fwd": {"ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, H)),
                        "plain_ms_one_clip": time_ms(
                            lambda: fa.flash_attention_plain(q1, k1, v1, H)),
                        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                            qh, kh, vh))},
                "bwd": {"ms": time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                                                     H)),
                        "plain_ms_one_clip": time_ms(lambda: fa.flash_attention_bwd_plain(
                            q1, k1, v1, out1, lse1, dout1, H)),
                        "library_ms": time_ms(lambda: torch.autograd.grad(
                            lib_out, leaves, dout_h, retain_graph=True))}}
            for key, backward in (("fwd", False), ("bwd", True)):
                seconds, by = yardstick.attention_bound(B, Lq, Lk, H, d, dtype, backward)
                times[key].update(bound_ms=1e3 * seconds, bound_by=BOUND_BY[by])
            row["sdpa_backend"] = sdpa_backend(*views)
            row.update(times)
            timed = times
            del lib_out, leaves, views
        emit(row)
        if not ok:
            raise AssertionError(f"K1/K2 disagree with the plain versions at {name} {dtype}: "
                                 f"{errs} > {tol}")
        del out, lse, grads
    return timed


def yaml_cfg(name: str, *over: dict) -> dict:
    """configs/<name>.yaml over configs/base.yaml, as an entry's --config
    loads it, on the card (ON_CARD), with ``over`` merged on in order: the
    phase's named departures, then its own keys."""
    from ssl_vit_video_analytics_tpu_torch.utils.config import load_config, merge_configs

    cfg = load_config(os.path.join(CONFIGS, f"{name}.yaml"),
                      base=os.path.join(CONFIGS, "base.yaml"))
    return merge_configs(cfg, ON_CARD, *over)


def ssl_mae_cfg(split: str, save_dir: str) -> dict:
    """Phase 6's config, which phases 5, 25-27 and 32 build on."""
    return yaml_cfg("ssl_mae", SSL_MAE_SMOKE_OVERRIDES,
                    {"dataset": {"train_split": split}, "training": {"save_dir": save_dir}})


def opt_in_cfg(name: str, split: str, save_dir: str, profile_dir: str) -> dict:
    """Phases 20-23's config: ``OPT_IN_CONFIGS[name]`` (the MoE or long-clip
    pipeline-B yaml) with the smoke's split and save dir; the MoE run with
    phase 6's departure (an encoder checkpoint every epoch) and a profiler
    trace under ``profile_dir``, the long clip as the yaml stands."""
    over = ([SSL_MAE_SMOKE_OVERRIDES, {"logging": {"profile_dir": profile_dir}}]
            if name == "moe" else [])
    return yaml_cfg(OPT_IN_CONFIGS[name], *over,
                    {"dataset": {"train_split": split}, "training": {"save_dir": save_dir}})


def ssl_train_cfg(split: str, save_dir: str) -> dict:
    """Phases 12-13's config: configs/ssl_train.yaml with its departures."""
    return yaml_cfg("ssl_train", SSL_TRAIN_SMOKE_OVERRIDES,
                    {"dataset": {"train_split": split}, "training": {"save_dir": save_dir}})


def mae_train_cfg(split: str, out_dir: str) -> dict:
    """Phases 14-16's config: configs/mae_train.yaml with its departures."""
    return yaml_cfg("mae_train", MAE_TRAIN_SMOKE_OVERRIDES,
                    {"dataset": {"train_split": split}, "output": {"dir": out_dir}})


def finetune_cfg(train_split: str, val_split: str, pretrained_ssl: str, out: str) -> dict:
    """Phase 11's config: configs/finetune.yaml under the campaign's
    pipeline-B overrides, with the smoke's splits, class count, encoder
    checkpoint and output directories."""
    return yaml_cfg("finetune", CAMPAIGN_B, {
        "dataset": {"train_split": train_split, "val_split": val_split,
                    "num_classes": FT_CLASSES},
        "model": {"pretrained_ssl": pretrained_ssl},
        "paths": {"save_dir": os.path.join(out, "finetune"),
                  "result_dir": os.path.join(out, "results"),
                  "log_dir": os.path.join(out, "logs")}})


def privacy_cfg(split: str, frame_root: str, out: str) -> dict:
    """Phase 18's config: configs/privacy.yaml with its departure."""
    return yaml_cfg("privacy", PRIVACY_SMOKE_OVERRIDES, {
        "dataset": {"split": split}, "visual_privacy": {"frame_root": frame_root},
        "output": {"save_dir": out}})


def federated_cfg(train_split: str, val_split: str, split_root: str, out: str) -> dict:
    """Phases 17 and 19's config: configs/federated.yaml with its departures."""
    return yaml_cfg("federated", FEDERATED_SMOKE_OVERRIDES, {
        "dataset": {"train_split": train_split, "val_split": val_split},
        "output": {"save_dir": out}, "paths": {"split_root": split_root}})


def rel_l2_by_leaf(grads, ref) -> tuple[list[float], list[float]]:
    """Each gradient's L2 distance from its counterpart in ``ref`` over the
    norm of that counterpart, and the norms of ``ref``.

    A gradient that is zero in exact arithmetic is rounding noise in both
    runs: a per-channel shift ahead of a train-mode BatchNorm (the biases of
    stage 0's residual MBConvs, whose zero-scale BN adds only its bias, and
    of the stem) is taken out again by the next BN's batch mean. So no
    norm below 1e-4 of the largest is divided by."""
    norms = [float(r.float().norm()) for r in ref]
    floor = 1e-4 * max(norms)
    return ([float((a.float() - r.float()).norm()) / max(n, floor)
             for a, r, n in zip(grads, ref, norms)], norms)


def phase_train_step(fa, dev) -> list[dict]:
    """One full-width forward+backward through the kernels and through the
    plain versions, on the same weights, mask and drop-path decisions: in
    fp32 (TF32 off) and in bf16, the working type of configs/ssl_mae.yaml."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.masking import get_tube_mask
    from ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae import build_model
    from ssl_vit_video_analytics_tpu_torch.ops.patchify import patchify
    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
    from ssl_vit_video_analytics_tpu_torch.train.finetune_engine import init_model
    from ssl_vit_video_analytics_tpu_torch.train.losses import mae_loss_l2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ssl_mae_cfg("", "")
    B, T, S = 2, cfg["dataset"]["clip_len"], cfg["dataset"]["image_size"]
    L = (S // 8) ** 2
    g = torch.Generator(device=dev).manual_seed(2)
    clip = normalize_clip(torch.randint(0, 256, (B, T, S, S, 3), dtype=torch.uint8,
                                        device=dev, generator=g))
    mask = get_tube_mask(g, B, T, L, cfg["ssl"]["mask_ratio"])
    target = patchify(clip, 8)
    outs = []
    ref32 = {}  # the fp32 plain run: what bf16 rounding moves the step from
    for dtype, tol_loss, tol_grad in ((torch.float32, TOL_STEP_LOSS, TOL_STEP_GRAD),
                                      (torch.bfloat16, TOL_STEP_LOSS_BF16,
                                       TOL_STEP_GRAD_BF16)):
        model = build_model(cfg, dtype)
        init_model(model, torch.Generator().manual_seed(0))
        model.to(dev).train()
        if not outs:  # one set of decisions for both passes, drawn after the mask
            drop = model.draw_drop_path(B, T, g)
        params = [p for _, p in model.named_parameters()]
        names = [n for n, _ in model.named_parameters()]
        res = {}
        for impl in ("kernel", "plain", "kernel", "plain"):  # the first of each warms up
            set_attn_impl(model, impl)
            fa.launches.reset()
            fa.bwd_launches.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = mae_loss_l2(model(clip, mask, drop), target, mask.reshape(B, T * L))
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            res[impl] = {"loss": float(loss.detach()), "grads": grads,
                         "ms": 1e3 * (time.perf_counter() - t0),
                         "k1": fa.launches.count, "k2": fa.bwd_launches.count}
        kern, plain = res["kernel"], res["plain"]
        loss_rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
        rels, norms = rel_l2_by_leaf(kern["grads"], plain["grads"])
        floor = 1e-4 * max(norms)
        floored = sum(n < floor for n in norms)
        order = sorted(range(len(rels)), reverse=True,
                       key=lambda i: rels[i] if math.isfinite(rels[i]) else math.inf)
        worst, worst_name = rels[order[0]], names[order[0]]
        out = {"phase": "train_step_kernel_vs_plain", "B": B, "T": T,
               "dtype": str(dtype).replace("torch.", ""),
               "loss_kernel": kern["loss"], "loss_plain": plain["loss"], "loss_rel": loss_rel,
               "worst_grad_rel_l2": worst, "worst_grad": worst_name,
               "tol_loss": tol_loss, "tol_grad": tol_grad,
               "grads": len(names), "grads_below_floor": floored, "grad_norm_floor": floor,
               "ms_kernel": kern["ms"], "ms_plain": plain["ms"],
               "k1_calls": kern["k1"], "k2_calls": kern["k2"],
               "plain_k1_k2": [plain["k1"], plain["k2"]]}
        if not ref32:
            ref32 = {"loss": plain["loss"], "grads": plain["grads"]}
        else:
            # bf16 rounding alone, without a kernel: the plain run against
            # the fp32 plain run, beside the kernel run against it
            k32, _ = rel_l2_by_leaf(kern["grads"], ref32["grads"])
            p32, _ = rel_l2_by_leaf(plain["grads"], ref32["grads"])
            noisiest = max(range(len(p32)), key=p32.__getitem__)
            out.update({
                "loss_rel_vs_fp32": {impl: abs(r["loss"] - ref32["loss"]) / abs(ref32["loss"])
                                     for impl, r in (("kernel", kern), ("plain", plain))},
                "worst_grads": [{"grad": names[i], "kernel_vs_plain": rels[i],
                                 "kernel_vs_fp32": k32[i], "plain_vs_fp32": p32[i],
                                 "norm_over_largest": norms[i] / max(norms)}
                                for i in order[:3]],
                "bf16_noisiest_grad": {"grad": names[noisiest],
                                       "kernel_vs_plain": rels[noisiest],
                                       "kernel_vs_fp32": k32[noisiest],
                                       "plain_vs_fp32": p32[noisiest]}})
        emit(out)
        if not (loss_rel <= tol_loss and worst <= tol_grad and math.isfinite(worst)):
            raise AssertionError(f"kernel vs plain step in {dtype}: loss rel {loss_rel}, "
                                 f"grad {worst_name} rel L2 {worst}")
        if (kern["k1"], kern["k2"], plain["k1"], plain["k2"]) != (
                K1_CALLS_PER_STEP, K2_CALLS_PER_STEP, 0, 0):
            raise AssertionError(f"kernel calls in the step: {out}")
        outs.append(out)
        del model, params, res, kern, plain
    return outs


def phase_train(fa, dev, tmp: str) -> tuple[dict, str, str]:
    """The pipeline-B entry on configs/ssl_mae.yaml for TRAIN_STEPS steps.
    Returns the launches, the last encoder checkpoint (under ``tmp``) and
    the training split (64-frame videos, which phases 21 and 23 reuse)."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
    from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae
    from ssl_vit_video_analytics_tpu_torch.train.state import adamw_of
    from ssl_vit_video_analytics_tpu_torch.utils.checkpoint import find_latest_checkpoint
    from ssl_vit_video_analytics_tpu_torch.utils.config import merge_configs
    from ssl_vit_video_analytics_tpu_torch.utils.metrics import (
        pipeline_b_flops_per_clip, pipeline_b_model_kwargs)

    # 8 classes x 5 train videos = 40 clips of 64 frames (16 frames at
    # stride 4), 112x112
    splits = make_synthetic_dataset(os.path.join(tmp, "ssl_data"), num_classes=8,
                                    videos_per_class=6, num_frames=64, image_size=112, seed=0)
    cfg = merge_configs(ssl_mae_cfg(splits["train"], os.path.join(tmp, "ssl_out")),
                        SSL_MAE_TENSORBOARD)
    B = cfg["training"]["batch_size"]
    k = cfg["training"]["accumulation_steps"]
    d = cfg["dataset"]
    # model FLOPs (forward + backward, no recompute) per clip, analytic
    flops_per_clip = pipeline_b_flops_per_clip(d["clip_len"], d["image_size"],
                                               **pipeline_b_model_kwargs(cfg))
    steps, last = [], {"t": 0.0, "count": 0}
    final = {}

    def on_step(i, state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        count = adamw_of(state.tx).count
        due = i % k == 0
        launched = read_counts()
        for name, n in launched.items():
            totals[name] += n
        steps.append({"step": i, "includes_setup": i == 1,
                      "loss": float(metrics["loss"]),
                      "gnorm": float(metrics["grad_norm"]),
                      "update": ("applied" if count > last["count"] else "skipped")
                      if due else "accumulated",
                      "step_ms": 1e3 * (now - last["t"]),
                      "clips_per_s": B / (now - last["t"]),
                      "model_tflop_per_s": flops_per_clip * B / (now - last["t"]) / 1e12,
                      "k1_calls": launched["flash_attention_fwd"],
                      "k2_calls": launched["flash_attention_bwd"],
                      "layer_norm_launches": launched["layer_norm_fwd"],
                      "layer_norm_bwd_launches": launched["layer_norm_bwd"],
                      "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
        emit({"phase": "train_step", **steps[-1]})
        final["model"], final["count"] = state.model, count
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        last["count"] = count
        last["t"] = time.perf_counter()

    def on_log(msg: str) -> None:
        lines.append(msg)
        if "saved encoder checkpoint" in msg:  # the next step's time starts here
            last["t"] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    lines = []
    totals = dict.fromkeys(counters(), 0)
    reset_counts()
    last["t"] = t0 = time.perf_counter()
    out = train_ssl_mae.run(cfg, log=on_log, max_steps=TRAIN_STEPS, on_step=on_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for name, n in read_counts().items():  # anything after the last step
        totals[name] += n
    ckpt = find_latest_checkpoint(cfg["training"]["save_dir"])
    finite = all(bool(torch.isfinite(p).all()) for p in final["model"].parameters())
    events = [f for f in os.listdir(cfg["training"]["save_dir"])
              if f.startswith("events.out.tfevents")]
    tb_warning = [m for m in lines if "tensorboardX unavailable" in m]
    summary = {"phase": "train", "steps": out["steps"], "seconds": seconds,
               "last_loss": out["last_loss"], "updates_applied": final["count"],
               "params_finite": finite, "encoder_checkpoint": os.path.basename(ckpt or ""),
               "device_resident": any("device-resident store" in m for m in lines),
               "tensorboard_event_files": events, "tensorboard_warning": tb_warning,
               "log": lines[-3:]}
    emit(summary)
    if bool(events) == bool(tb_warning):
        raise AssertionError(f"train: logging.tensorboard gave event files {events} and "
                             f"warnings {tb_warning}; want exactly one of them")
    bad = [s for s in steps if (s["k1_calls"], s["k2_calls"], s["layer_norm_launches"],
                                s["layer_norm_bwd_launches"])
           != (K1_CALLS_PER_STEP, K2_CALLS_PER_STEP, LN_FWD_PER_STEP, LN_BWD_PER_STEP)]
    if out["steps"] != TRAIN_STEPS or bad:
        raise AssertionError(f"train: {out['steps']} steps; kernel calls off in {bad}")
    if not (finite and final["count"] >= 1 and all(math.isfinite(s["loss"]) for s in steps)):
        raise AssertionError(f"train: non-finite result or no update applied: {summary}")
    if ckpt is None or not ckpt.endswith(f"ckpt_epoch_{TRAIN_STEPS}.pt"):
        raise AssertionError(f"train: no encoder checkpoint of the last epoch: {ckpt}")
    return totals, ckpt, splits["train"]


def slice_cfg(split: str, save_dir: str, impl: str) -> dict:
    """Phase 7's config (and phases 29-30's): configs/dynamic.yaml with its
    departure, the split, save dir and early-exit impl under test."""
    return yaml_cfg("dynamic", SLICE_SMOKE_OVERRIDES, {
        "dataset": {"split": split}, "dynamic": {"early_exit_impl": impl},
        "output": {"save_dir": save_dir}})


def check_rows(rows: list[dict], impl: str, dyn: dict) -> None:
    """The early-exit sweep's rows against the config's ``dynamic`` keys."""
    from ssl_vit_video_analytics_tpu_torch.entry.run_dynamic import EARLY_EXIT_FIELDS

    thresholds = dyn["confidence_thresholds"]
    if len(rows) != len(thresholds):
        raise AssertionError(f"{impl}: {len(rows)} rows for {len(thresholds)} thresholds")
    for row, thr in zip(rows, thresholds):
        if tuple(row) != EARLY_EXIT_FIELDS or row["threshold"] != f"{thr:.2f}":
            raise AssertionError(f"{impl}: malformed row {row}")
        values = {k: float(v) for k, v in row.items()}
        if not all(math.isfinite(x) for x in values.values()):
            raise AssertionError(f"{impl}: non-finite row {row}")
        if not (0 <= values["top1"] <= values["top5"] <= 1
                and dyn["min_frames"] <= values["avg_frames"] <= dyn["max_frames"]
                and 0 < values["avg_conf"] <= 1 and values["avg_latency_ms"] > 0):
            raise AssertionError(f"{impl}: row out of range {row}")


def slice_data(root: str) -> dict:
    """Phase 7's synthetic split (32 classes, 112x112), made anew under
    ``root`` (phase 29 runs an ablation cell on it)."""
    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset

    return make_synthetic_dataset(os.path.join(root, "data"), num_classes=32,
                                  videos_per_class=2, num_frames=32, image_size=112, seed=0)


def phase_slice(fa, dev) -> dict:
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.loader import iterate_batches
    from ssl_vit_video_analytics_tpu_torch.entry import common, run_dynamic
    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
    from ssl_vit_video_analytics_tpu_torch.utils import tracing

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        splits = slice_data(tmp)
        rows_by_impl = {}
        for impl in ("streaming", "batched"):
            cfg = slice_cfg(splits["val"], os.path.join(tmp, f"out_{impl}"), impl)
            reset_counts()
            replays = tracing.counter("early_exit.graph_replays").count
            capture_us = tracing.counter("early_exit.graph_capture_us").count
            t0 = time.perf_counter()
            out = run_dynamic.run(cfg, mode="early_exit", log=lambda m: None)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[impl] = read_counts()
            replays = tracing.counter("early_exit.graph_replays").count - replays
            capture_us = tracing.counter("early_exit.graph_capture_us").count - capture_us
            k1 = launches[impl]["flash_attention_fwd"]
            rows = out["rows"]
            check_rows(rows, impl, cfg["dynamic"])
            if k1 <= 0 or k1 % 6:
                raise AssertionError(f"{impl}: K1 launched {k1} times, "
                                     "not a positive multiple of 6")
            if impl == "streaming" and replays <= 0:
                raise AssertionError("streaming: no frame stepped by a CUDA graph's replay")
            ln = launches[impl]["layer_norm_fwd"]
            if ln != 2 * k1:  # each transformer block: one attention, two LayerNorms
                raise AssertionError(f"{impl}: {ln} LayerNorm launches for {k1} K1 launches")
            rows_by_impl[impl] = rows
            emit({"phase": "slice", "impl": impl, "k1_launches": k1,
                  "layer_norm_launches": ln, "graph_replays": replays,
                  "graph_capture_s": capture_us / 1e6, "seconds": seconds,
                  "avg_latency_ms": {r["threshold"]: float(r["avg_latency_ms"]) for r in rows},
                  "avg_frames": {r["threshold"]: float(r["avg_frames"]) for r in rows},
                  "top1": {r["threshold"]: float(r["top1"]) for r in rows}})
        frames = {impl: [r["avg_frames"] for r in rows] for impl, rows in rows_by_impl.items()}
        if frames["streaming"] != frames["batched"]:
            raise AssertionError(f"streaming and batched avg_frames differ: {frames}")

        # bf16 on the card (K1) vs the same weights in fp32 on the CPU (plain
        # path), batch by batch over the whole split: with random weights the
        # 101 logits sit close together, so the required argmax agreement is
        # taken over all 512 frames; the 32 clips' agreement is reported
        cfg = slice_cfg(splits["val"], tmp, "streaming")
        ds = common.dataset_from_cfg(cfg, splits["val"], "supervised")
        gpu = run_dynamic.load_classifier(cfg, torch.bfloat16, dev, lambda m: None)
        cpu = run_dynamic.load_classifier(cfg, torch.float32, torch.device("cpu"),
                                          lambda m: None)
        T = cfg["dynamic"]["max_frames"]
        B = cfg["runtime"]["batch_size"]
        lg, lc, clip_lg, clip_lc = [], [], [], []
        fa.launches.reset()
        with torch.inference_mode():
            for batch in iterate_batches(ds, B, shuffle=False, seed=0, epoch=0,
                                         drop_last=False):
                raw = torch.from_numpy(batch["clip"])[:, :T]
                frames_u8 = raw.reshape((-1,) + tuple(raw.shape[2:]))  # [B*T, H, W, 3]
                emb = gpu.frame_embedding(normalize_clip(frames_u8.to(dev)))
                lg.append(gpu.classify_embedding(emb).float().cpu())
                clip_lg.append(gpu(normalize_clip(raw.to(dev))).float().cpu())
                emb_c = cpu.frame_embedding(normalize_clip(frames_u8))
                lc.append(cpu.classify_embedding(emb_c))
                # the classifier's forward is the head on the mean frame embedding
                clip_lc.append(cpu.classify_embedding(emb_c.reshape(len(raw), T, -1).mean(1)))
        torch.cuda.synchronize()
        if fa.launches.count <= 0:
            raise AssertionError("the bf16 check did not go through K1")
        lg, lc, clip_lg, clip_lc = (torch.cat(x) for x in (lg, lc, clip_lg, clip_lc))
        agree = float((lg.argmax(1) == lc.argmax(1)).float().mean())
        clip_agree = float((clip_lg.argmax(1) == clip_lc.argmax(1)).float().mean())
        emit({"phase": "slice_vs_cpu_fp32", "frames": int(lg.shape[0]),
              "max_abs_diff": (lg - lc).abs().max().item(),
              "logit_scale": lc.abs().max().item(), "argmax_agreement": agree,
              "clips": int(clip_lg.shape[0]),
              "clip_max_abs_diff": (clip_lg - clip_lc).abs().max().item(),
              "clip_argmax_agreement": clip_agree})
        if not (torch.isfinite(lg).all() and torch.isfinite(clip_lg).all()
                and agree >= 0.95):
            raise AssertionError(f"bf16 card logits vs fp32 CPU: argmax agreement "
                                 f"{agree} over {len(lg)} frames < 0.95")
    return launches


def phase_dw(dev) -> dict:
    """P1 against its plain version, then the probe_dw entry point."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.ops import depthwise
    from ssl_vit_video_analytics_tpu_torch.scripts import probe_dw

    torch.backends.cudnn.allow_tf32 = False
    max_err = 0.0

    def probe_case(dtype, N, seed):
        return (probe_dw.H, probe_dw.W) + probe_dw.inputs(N, dtype, dev, seed=seed)

    def edge_case(dtype):
        N, H, W, C = DW_EDGE_SHAPE
        g = torch.Generator(device=dev).manual_seed(5)
        return (H, W, torch.randn(N, H * W, C, device=dev, generator=g).to(dtype),
                torch.randn(9, C, device=dev, generator=g))

    # the check shape, a small bf16 batch, the inputs that
    # probe_dw.run(256, "bench") times (seed 0), and the tile edges
    for dtype, case in ((torch.float32, lambda: probe_case(torch.float32, 2, 1)),
                        (torch.bfloat16, lambda: probe_case(torch.bfloat16, 8, 1)),
                        (torch.bfloat16, lambda: probe_case(torch.bfloat16, 256, 0)),
                        (torch.float32, lambda: edge_case(torch.float32)),
                        (torch.bfloat16, lambda: edge_case(torch.bfloat16))):
        H, W, x, w = case()
        N, C = x.shape[0], x.shape[2]
        out = depthwise.dw3x3(x, w, H, W)
        torch.cuda.synchronize()
        ref = depthwise.dw3x3_plain(x, w, H, W)
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        tol = TOL_DW_FP32
        if dtype == torch.bfloat16:  # each fp32 sum rounds once to bf16
            tol = tol + bf16_ulp(torch.maximum(out.float().abs(), ref.float().abs()))
        ok = out.shape == ref.shape and out.dtype == dtype and bool((diff <= tol).all())
        emit({"phase": "p1_vs_plain", "N": N, "H": H, "W": W, "C": C,
              "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
              "elements_differing": int((diff > 0).sum()),
              "tol": TOL_DW_FP32 if dtype == torch.float32 else "1e-5 + one bf16 ulp",
              "ok": ok})
        if not ok:
            raise AssertionError(f"P1 disagrees with the plain version in {dtype} at "
                                 f"N={N}: {err}")
        max_err = max(max_err, err)
        del x, out, ref, diff, tol
        torch.cuda.empty_cache()

    reset_counts()
    rows = probe_dw.run(256, "bench", dev, log=lambda m: None)
    torch.cuda.synchronize()
    launched = read_counts()
    for row in rows:
        emit({"phase": "probe_dw", **row})
    if launched["dw3x3"] <= 0:
        raise AssertionError(f"probe_dw did not launch P1: {launched}")
    by = {r["name"]: r for r in rows}
    kern = by["dw3x3 fwd"]
    return {"launched": launched, "max_abs_err": max_err, "ms": kern["ms"],
            "plain_ms": by["plain shifted-sum fwd"]["ms"],
            "library_ms": by["cudnn grouped conv fwd"]["ms"],
            "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
            "bwd_dx_ms": by["dw3x3 bwd(dx)"]["ms"],
            "library_bwd_dx_ms": by["cudnn grouped conv bwd(dx)"]["ms"]}


def phase_layer_norm(dev) -> dict:
    """The LayerNorm kernels against their plain version at each LN_SHAPES
    row, with the times of each, of torch's fp32 layer_norm and the bound
    (phase 34). Returns the line of kernels' rows, forward and backward."""
    import torch
    import torch.nn.functional as F

    from h100_bench import yardstick
    from ssl_vit_video_analytics_tpu_torch.ops import layer_norm as lnk
    from ssl_vit_video_analytics_tpu_torch.scripts import time_ms as card_time_ms

    def timed(fn) -> float:
        return card_time_ms(fn, dev, iters=20, repeats=3, queued=True)

    def within(got, ref, share: float, bf16: bool) -> float:
        """The largest excess over ``share`` of ref's largest magnitude (and
        one bf16 step of each element in bf16); <= 0 passes."""
        got, ref = got.float(), ref.float()
        step = ref.abs() * 2.0 ** -7 if bf16 else 0.0
        return float(((got - ref).abs() - step - share * ref.abs().max()).max())

    eps, bf16 = 1e-5, torch.bfloat16
    out = {"fwd": {"max_excess": -math.inf}, "bwd": {"max_excess": -math.inf}}
    g = torch.Generator(device=dev).manual_seed(0)
    for name, R, D, backward in LN_SHAPES:
        x = (torch.randn(R, D, device=dev, generator=g) * 3 + 0.5).to(bf16)
        w = 1 + 0.1 * torch.randn(D, device=dev, generator=g)
        b = 0.1 * torch.randn(D, device=dev, generator=g)
        xf = x.float()
        y, mean, rstd = lnk.layer_norm_fwd(x, w, b, eps, bf16)
        excess = within(y, lnk.layer_norm_plain(x, w, b, eps, bf16), 1e-5, True)
        seconds, by = yardstick.bound_s(R * D * (2 + 2) + 2 * D * 4 + 2 * R * 4, 8 * R * D,
                                        yardstick.FP32_FLOP_PER_S)
        row = {"ms": timed(lambda: lnk.layer_norm_fwd(x, w, b, eps, bf16)),
               "bound_ms": 1e3 * seconds, "bound_by": BOUND_BY[by],
               "plain_ms": timed(lambda: lnk.layer_norm_plain(x, w, b, eps, bf16)),
               "library_ms": timed(lambda: F.layer_norm(xf, (D,), w, b, eps))}
        rows = {"fwd": (row, excess)}
        if backward:
            dy = torch.randn(R, D, device=dev, generator=g).to(bf16)
            dx, dw, db = lnk.layer_norm_bwd(x, dy, w, mean, rstd)
            leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
            y0 = lnk.layer_norm_plain(*leaves, eps, bf16)
            ref = torch.autograd.grad(y0, leaves, dy, retain_graph=True)
            excess = max(within(dx, ref[0], 1e-4, True), within(dw, ref[1], 1e-4, False),
                         within(db, ref[2], 1e-4, False))
            lib = [xf.clone().requires_grad_(), w.clone().requires_grad_(),
                   b.clone().requires_grad_()]
            y1, dyf = F.layer_norm(lib[0], (D,), lib[1], lib[2], eps), dy.float()
            seconds, by = yardstick.bound_s(
                R * D * (2 + 2 + 2) + 2 * R * 4 + 3 * D * 4, 14 * R * D,
                yardstick.FP32_FLOP_PER_S)
            row = {"ms": timed(lambda: lnk.layer_norm_bwd(x, dy, w, mean, rstd)),
                   "bound_ms": 1e3 * seconds, "bound_by": BOUND_BY[by],
                   "plain_ms": timed(lambda: torch.autograd.grad(y0, leaves, dy,
                                                                 retain_graph=True)),
                   "library_ms": timed(lambda: torch.autograd.grad(y1, lib, dyf,
                                                                   retain_graph=True))}
            rows["bwd"] = (row, excess)
            del dy, dx, dw, db, leaves, y0, ref, lib, y1, dyf
        for way, (row, excess) in rows.items():
            row["share"] = row["bound_ms"] / row["ms"]
            emit({"phase": "layer_norm_vs_plain", "shape": name, "rows": R, "D": D,
                  "way": way, "dtype": "bfloat16", "max_excess": excess, **row,
                  "ok": excess <= 0})
            if excess > 0:
                raise AssertionError(f"LayerNorm {way} kernel disagrees with the plain "
                                     f"version at {name}: excess {excess}")
            out[way][name] = row
            out[way]["max_excess"] = max(out[way]["max_excess"], excess)
        del x, xf, y, mean, rstd
        torch.cuda.empty_cache()
    return out


def phase_chain(dev) -> dict:
    """P2 against its plain version, then the probe_exp entry point."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.ops import kernel_build
    from ssl_vit_video_analytics_tpu_torch.ops import unary_chain as uc
    from ssl_vit_video_analytics_tpu_torch.scripts import probe_exp

    counts = probe_exp.sass_loop_counts(kernel_build.build()["unary_chain"].path)
    conversions = probe_exp.conversions(counts)
    emit({"phase": "p2_sass", "bf16_conversions_per_element": conversions,
          "per_element": counts})
    if len(conversions) != len(uc.OPS) or any(c["F2F.BF16.F32"]
                                              for c in conversions.values()):
        raise AssertionError(f"bf16 main loops still round with F2F: {conversions}")

    x = probe_exp.block(probe_exp.ROWS, probe_exp.LANES, dev)
    max_err = 0.0
    for op in uc.OPS:
        for dtype in uc.DTYPES:
            for n in CHAIN_CHECK_N:
                out = uc.unary_chain(x, n, dtype, op)
                torch.cuda.synchronize()
                ref = uc.unary_chain_plain(x, n, dtype, op)
                diff = (out - ref).abs()
                err = float(diff.max())
                if dtype == torch.float32:
                    ok = err <= TOL_CHAIN_FP32 * float(ref.abs().max())
                else:
                    ok = bool((diff <= 2 * bf16_ulp(ref)).all())
                ok = ok and bool(torch.isfinite(out).all()) and out.shape == x.shape
                emit({"phase": "p2_vs_plain", "op": op,
                      "dtype": str(dtype).replace("torch.", ""), "n": n,
                      "max_abs_err": err, "ref_max_abs": float(ref.abs().max()),
                      "elements_differing": int((diff > 0).sum()), "ok": ok})
                if not ok:
                    raise AssertionError(f"P2 disagrees with the plain version: {op} "
                                         f"{dtype} n={n}: {err}")
                max_err = max(max_err, err)

    reset_counts()
    rows = probe_exp.run(device=dev, log=lambda m: None)
    torch.cuda.synchronize()
    launched = read_counts()
    for row in rows:
        emit({"phase": "probe_exp", **row})
    if launched["unary_chain"] <= 0:
        raise AssertionError(f"probe_exp did not launch P2: {launched}")
    if not all(math.isfinite(r["per_application_ms"]) and r["t_hi_ms"] > r["t_mid_ms"] >
               r["t_lo_ms"] for r in rows):
        raise AssertionError("probe_exp: the time does not grow with the chain's length")
    return {"launched": launched, "max_abs_err": max_err,
            "ms": sum(r["t_hi_ms"] for r in rows),
            "plain_ms": sum(r["plain_t_hi_ms"] for r in rows),
            "bound_ms": sum(r["bound_hi_ms"] for r in rows)}


def set_attn_impl(model, impl: str) -> None:
    from ssl_vit_video_analytics_tpu_torch.models.layers import MultiHeadAttention

    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = impl


def compare_impls(model, run, want_k1_k2: tuple, record: dict) -> dict:
    """``run()`` (loss, grads) through the kernels and through the plain
    versions, twice each (the first of each warms up), from the same
    ``state_dict`` every time. Returns each impl's loss, grads, ms and
    launches; fails unless the kernel runs launch ``want_k1_k2`` and the
    plain ones none."""
    import torch

    start = {k: v.clone() for k, v in model.state_dict().items()}
    res = {}
    for impl in ("kernel", "plain", "kernel", "plain"):
        set_attn_impl(model, impl)
        model.load_state_dict(start)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = run()
        torch.cuda.synchronize()
        counts = read_counts()
        res[impl] = {"loss": float(loss), "grads": grads, "ms": 1e3 * (time.perf_counter() - t0),
                     "k1_k2": (counts["flash_attention_fwd"], counts["flash_attention_bwd"]),
                     "wide_k1_k2": (counts["flash_attention_fwd_wide"],
                                    counts["flash_attention_bwd_wide"])}
    set_attn_impl(model, "kernel")
    model.load_state_dict(start)
    if res["kernel"]["k1_k2"] != want_k1_k2 or res["plain"]["k1_k2"] != (0, 0):
        raise AssertionError(f"kernel calls in the step: kernel {res['kernel']['k1_k2']}, "
                             f"plain {res['plain']['k1_k2']}, want {want_k1_k2}: {record}")
    return res


# --step-seeds: each bf16 judgement's distances per leaf, collected here
LEAF_DISTANCES: list | None = None


def judge_step(out: dict, dtype, res: dict, names: list, ref32: dict) -> dict:
    """Phase 10's rule on one dtype's kernel and plain runs: the loss to
    TOL_STEP_LOSS(_BF16) relative, every gradient to TOL_STEP_GRAD(_BF16)
    relative L2 of the plain run's (a norm below 1e-4 of the largest taken
    as that floor). In bf16 only the gradients that are not zero in the
    fp32 plain run are held, and a loss or gradient beyond its limit passes
    if the kernel run lies within the limit of the fp32 plain run beyond
    the bf16 plain run's own distance from it. ``ref32`` keeps the fp32
    plain run for the bf16 pass. Emits ``out`` with the findings and raises
    on a failure."""
    import torch

    fp32 = dtype == torch.float32
    tol_loss, tol_grad = ((TOL_STEP_LOSS, TOL_STEP_GRAD) if fp32
                          else (TOL_STEP_LOSS_BF16, TOL_STEP_GRAD_BF16))
    kern, plain = res["kernel"], res["plain"]
    loss_rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    loss32 = {impl: 0.0 if fp32 else abs(r["loss"] - ref32["loss"]) / abs(ref32["loss"])
              for impl, r in (("kernel", kern), ("plain", plain))}
    loss_ok = loss_rel <= tol_loss or (
        not fp32 and loss32["kernel"] <= loss32["plain"] + tol_loss)
    rels, norms = rel_l2_by_leaf(kern["grads"], plain["grads"])
    if fp32:
        ref32.update(live=[n >= 1e-4 * max(norms) for n in norms], grads=plain["grads"],
                     loss=plain["loss"])
    checked = [i for i, on in enumerate(ref32["live"]) if on or fp32]
    k32 = p32 = [0.0] * len(rels)
    if not fp32:
        k32, _ = rel_l2_by_leaf(kern["grads"], ref32["grads"])
        p32, _ = rel_l2_by_leaf(plain["grads"], ref32["grads"])
    beyond = [i for i in checked if not rels[i] <= tol_grad]
    failed = [i for i in beyond if not k32[i] <= p32[i] + tol_grad]
    worst = max(checked, key=lambda i: rels[i] if math.isfinite(rels[i]) else math.inf)
    out.update({"dtype": str(dtype).replace("torch.", ""),
                "loss_kernel": kern["loss"], "loss_plain": plain["loss"], "loss_rel": loss_rel,
                "worst_grad_rel_l2": rels[worst], "worst_grad": names[worst],
                "grads": len(names), "grads_zero_in_fp32": len(rels) - len(checked),
                "worst_grads": [{"grad": names[i], "kernel_vs_plain": rels[i],
                                 "kernel_vs_fp32": k32[i], "plain_vs_fp32": p32[i]}
                                for i in sorted(checked, key=lambda i: -rels[i])[:3]],
                "beyond_tol_grad": len(beyond), "failed": len(failed),
                "tol_loss": tol_loss, "tol_grad": tol_grad,
                "ms_kernel": kern["ms"], "ms_plain": plain["ms"],
                "k1_k2": list(kern["k1_k2"])})
    if not fp32:  # how far bf16 rounding alone moves each run's loss
        out["loss_rel_vs_fp32"] = loss32
        out["loss_beyond_tol"] = not loss_rel <= tol_loss
        if LEAF_DISTANCES is not None:
            LEAF_DISTANCES.append({
                "phase": out["phase"], "seed": out.get("seed"),
                "failed": [names[i] for i in failed], "leaves": {
                    names[i]: {"kernel_vs_plain": rels[i], "kernel_vs_fp32": k32[i],
                               "plain_vs_fp32": p32[i]} for i in checked}})
    emit(out)
    if not (loss_ok and not failed and math.isfinite(kern["loss"])):
        raise AssertionError(f"{out['phase']} {dtype}: loss rel {loss_rel}, grad "
                             f"{names[worst]} rel L2 {rels[worst]}, failed "
                             f"{[names[i] for i in failed]}")
    return out


def phase_finetune_step(dev) -> list[dict]:
    """The full-width TinyViT classifier's finetune step through the kernels
    and through the plain versions, on the same weights and drop-path
    decisions, unfrozen (ft_ssl) and frozen (two_stage before its boundary),
    in fp32 (TF32 off) and in bf16, held by :func:`judge_step`; then one
    real step of each mode through the kernels."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
    from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as eng
    from ssl_vit_video_analytics_tpu_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = finetune_cfg("", "", "", "")
    B, T, S = 2, cfg["dataset"]["clip_len"], cfg["dataset"]["image_size"]
    training = cfg["training"]
    g = torch.Generator(device=dev).manual_seed(3)
    clip_u8 = torch.randint(0, 256, (B, T, S, S, 3), dtype=torch.uint8, device=dev, generator=g)
    labels = torch.randint(0, FT_CLASSES, (B,), dtype=torch.int32, device=dev, generator=g)
    outs, drop = [], None
    ref32 = {}  # by mode: the fp32 plain run (judge_step's reference)
    for dtype in (torch.float32, torch.bfloat16):
        model = eng.build_model(FT_CLASSES, 256, dtype=dtype, backbone="tinyvit")
        eng.init_model(model, torch.Generator().manual_seed(0))
        model.to(dev)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        clip = normalize_clip(clip_u8, dtype=dtype)
        if drop is None:  # one set of decisions for every run
            drop = model.draw_drop_path(B, T, g)
        for mode, freeze in (("ft_ssl", False), (FINETUNE_MODE, True)):
            params = eng.build_finetune_tx(training, mode, model, freeze).params
            names = {id(p): n for n, p in model.named_parameters()}
            k2_want = 0 if freeze else FT_K2_CALLS
            out = {"phase": "finetune_step_kernel_vs_plain", "B": B, "T": T, "mode": mode,
                   "frozen_backbone": freeze}
            res = compare_impls(model, lambda: eng.loss_and_grads(
                model, params, clip, labels, drop)[::2], (FT_K1_CALLS, k2_want), out)

            # one step of the mode through the kernels: the frozen backbone
            # keeps every param and moves its BatchNorm statistics
            state = create_train_state(model, eng.build_finetune_tx(training, mode, model,
                                                                    freeze))
            reset_counts()
            state, metrics = eng.make_train_step(model, dtype)(
                state, {"clip": clip_u8, "label": labels}, g, drop=drop)
            torch.cuda.synchronize()
            step_calls = read_counts()
            after = model.state_dict()
            backbone = [k for k, _ in model.backbone.named_parameters()]
            stats = [k for k in after if k.startswith("backbone.")
                     and k.endswith(("running_mean", "running_var"))]
            params_kept = all(torch.equal(after[f"backbone.{k}"], start[f"backbone.{k}"])
                              for k in backbone)
            stats_moved = sum(not torch.equal(after[k], start[k]) for k in stats)
            head_moved = not torch.equal(after["head.weight"], start["head.weight"])
            out.update({"step_k1_k2": [step_calls["flash_attention_fwd"],
                                       step_calls["flash_attention_bwd"]],
                        "step_loss": float(metrics["loss"]),
                        "backbone_params_unchanged": params_kept,
                        "backbone_bn_stats_moved": f"{stats_moved}/{len(stats)}",
                        "head_moved": head_moved})
            outs.append(judge_step(out, dtype, res, [names[id(p)] for p in params],
                                   ref32.setdefault(mode, {})))
            if out["step_k1_k2"] != [FT_K1_CALLS, k2_want]:
                raise AssertionError(f"kernel calls in the finetune step: {out}")
            if not (head_moved and stats_moved and params_kept == freeze
                    and math.isfinite(out["step_loss"])):
                raise AssertionError(f"finetune step state after one {mode} step: {out}")
            model.load_state_dict(start)
            del res, state
        del model, start
    return outs


def phase_transfer(fa, dev, tmp: str, ssl_ckpt: str) -> dict:
    """Pipeline-B transfer through the port's entries: phase 6's encoder
    checkpoint -> two_stage finetune of the TinyViT classifier on a
    device-resident split -> evaluate of the best checkpoint."""
    import numpy as np
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.device_store import (
        ChunkedDeviceClipStore, DeviceClipStore)
    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
    from ssl_vit_video_analytics_tpu_torch.data.loader import iterate_batches
    from ssl_vit_video_analytics_tpu_torch.entry import common, evaluate, train_finetune
    from ssl_vit_video_analytics_tpu_torch.utils.io import read_csv_dicts

    # 8 classes x 8 train videos = 64 clips of 16 frames at 112x112, 4 steps
    # an epoch (3 after the first unfrozen one); the fixture keeps one video
    # a class for val (8 clips), too few to be sure of a top-1 above 0 at
    # chance, so validation runs on the training split
    d = finetune_cfg("", "", "", "")["dataset"]
    splits = make_synthetic_dataset(os.path.join(tmp, "ft_data"), num_classes=FT_CLASSES,
                                    videos_per_class=9, num_frames=d["clip_len"],
                                    image_size=d["image_size"], seed=1)
    cfg = finetune_cfg(splits["train"], splits["train"], ssl_ckpt[:-len(".pt")],
                       os.path.join(tmp, "ft_out"))
    B = cfg["training"]["batch_size"]
    n_train = sum(1 for _ in open(splits["train"]))
    steps_per_epoch = n_train // B
    val_batches = -(-n_train // B)
    steps, evals, lines, last, final = [], [], [], {"t": 0.0}, {}
    totals = dict.fromkeys(counters(), 0)

    def take_counts() -> dict:
        launched = read_counts()
        for name, n in launched.items():
            totals[name] += n
        reset_counts()
        return launched

    def on_step(i, state, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        launched = take_counts()
        steps.append({"step": i, "epoch": (i - 1) // steps_per_epoch + 1,
                      "includes_setup": i == 1, "loss": float(metrics["loss"]),
                      "top1": float(metrics["top1"]), "step_ms": 1e3 * (now - last["t"]),
                      "clips_per_s": B / (now - last["t"]),
                      "k1_calls": launched["flash_attention_fwd"],
                      "k2_calls": launched["flash_attention_bwd"],
                      "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
        emit({"phase": "finetune_step", **steps[-1]})
        final["model"] = state.model
        torch.cuda.reset_peak_memory_stats()
        last["t"] = time.perf_counter()

    def on_log(msg: str) -> None:
        lines.append(msg)
        if msg.startswith("[INFO] val "):  # the validation pass has ended
            launched = take_counts()
            evals.append({"val": msg, "seconds": time.perf_counter() - last["t"],
                          "k1_calls": launched["flash_attention_fwd"],
                          "k2_calls": launched["flash_attention_bwd"]})
            emit({"phase": "finetune_validation", **evals[-1]})
        if "Epoch" in msg and "started" in msg:
            take_counts()
            last["t"] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = train_finetune.run(cfg, mode=FINETUNE_MODE, log=on_log, on_step=on_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    take_counts()
    launches = dict(totals)
    finite = all(bool(torch.isfinite(p).all()) for p in final["model"].parameters())
    best = out["best_ckpt"]
    name_top1 = (float(os.path.basename(best)[:-len(".pt")].split("_top1_")[1])
                 if best else None)
    summary = {"phase": "finetune", "steps": len(steps), "seconds": seconds,
               "best_top1": out["best_top1"], "best_ckpt": os.path.basename(best or ""),
               "params_finite": finite,
               "loaded_ssl": any(m.startswith("[INFO] Loaded SSL pretrain") for m in lines),
               "device_resident": sum("device-resident store" in m for m in lines),
               "launches": launches, "log": [m for m in lines if "val top1" in m]}
    emit(summary)
    want_k2 = [0 if s["epoch"] <= cfg["training"]["stage1_epochs"] else FT_K2_CALLS
               for s in steps]
    bad = [s for s, k2 in zip(steps, want_k2) if (s["k1_calls"], s["k2_calls"])
           != (FT_K1_CALLS, k2)]
    bad += [e for e in evals if (e["k1_calls"], e["k2_calls"]) != (FT_K1_CALLS * val_batches,
                                                                      0)]
    if len(steps) != steps_per_epoch * cfg["training"]["epochs"] or bad:
        raise AssertionError(f"finetune: {len(steps)} steps; kernel calls off in {bad}")
    if not (finite and summary["loaded_ssl"] and summary["device_resident"] == 2
            and all(math.isfinite(s["loss"]) for s in steps)):
        raise AssertionError(f"finetune: {summary}")
    if best is None or name_top1 != round(out["best_top1"], 4):
        raise AssertionError(f"finetune: no best checkpoint encoding its top-1: {summary}")

    # a training batch from the device stores against the host path's batch
    # of the same epoch and index (the chunked store in two shards, its
    # upload on a side stream)
    ds = common.dataset_from_cfg(cfg, splits["train"], "supervised", seed=cfg["seed"])
    epoch, index = 2, steps_per_epoch - 1
    host = list(iterate_batches(ds, B, shuffle=True, seed=cfg["seed"], epoch=epoch))[index]
    stores = {"resident": common.maybe_device_resident(cfg, ds, dev, log=lambda m: None),
              "chunked": ChunkedDeviceClipStore(ds, B * d["clip_len"] * d["image_size"] ** 2 * 3,
                                                B, dev, log=lambda m: None)}
    if not isinstance(stores["resident"], DeviceClipStore):
        raise AssertionError(f"device_resident: true gave {type(stores['resident'])}")
    same, shards = {}, stores["chunked"].num_shards
    for kind, store in stores.items():
        got = list(store.epoch_batches(B, shuffle=True, seed=cfg["seed"], epoch=epoch))[index]
        same[kind] = all(np.array_equal(np.asarray(host[k]), got[k].cpu().numpy())
                         for k in ("clip", "label", "valid")) and set(got) == set(host)
    del stores
    emit({"phase": "device_store_vs_host", "epoch": epoch, "batch": index,
          "bit_equal": same, "chunked_shards": shards})
    if not all(same.values()):
        raise AssertionError(f"device store batch differs from the host path's: {same}")

    # evaluate the best checkpoint through the entry, latency on
    reset_counts()
    ev_lines = []
    ev = evaluate.run(cfg, os.path.join(cfg["paths"]["save_dir"], FINETUNE_MODE, "best"),
                      None, log=ev_lines.append, measure_latency=True)
    torch.cuda.synchronize()
    ev_launches = read_counts()
    row = read_csv_dicts(ev["csv"])[0]
    eval_batches = val_batches + 1 + 10  # the split, then 1 warm and 10 timed
    emit({"phase": "evaluate", "top1": ev["acc"]["top1"], "best_top1": out["best_top1"],
          "p50_batch_latency_ms": float(row["p50_batch_latency_ms"]),
          "batch_size": int(row["batch_size"]), "eval_seconds": row["eval_seconds"],
          "k1_calls": ev_launches["flash_attention_fwd"],
          "k2_calls": ev_launches["flash_attention_bwd"], "batches": eval_batches,
          "log": ev_lines[-2:]})
    if ev["acc"]["top1"] != out["best_top1"]:
        raise AssertionError(f"evaluate top1 {ev['acc']['top1']} != the best epoch's "
                             f"{out['best_top1']}")
    if (ev_launches["flash_attention_fwd"], ev_launches["flash_attention_bwd"]) != (
            FT_K1_CALLS * eval_batches, 0):
        raise AssertionError(f"evaluate kernel calls: {ev_launches}")
    return {"train_finetune": launches, "evaluate": ev_launches}


def phase_ssl_step(dev, seed: int = 6) -> list[dict]:
    """Pipeline A's loss and gradients (teacher, student, TOP) at full width
    through the kernels and through the plain versions; ``seed`` draws the
    clips, the frame mask and the TOP draws."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.masking import frame_mask
    from ssl_vit_video_analytics_tpu_torch.entry.train_ssl import build_model
    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
    from ssl_vit_video_analytics_tpu_torch.train.finetune_engine import init_model
    from ssl_vit_video_analytics_tpu_torch.train.ssl_engine import SSLObjective

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ssl_train_cfg("", "")
    obj = SSLObjective(cfg["ssl_objectives"], with_top=True)
    B, T, S = 2, cfg["dataset"]["clip_len"], cfg["dataset"]["image_size"]
    g = torch.Generator(device=dev).manual_seed(seed)
    clip_u8 = torch.randint(0, 256, (B, T, S, S, 3), dtype=torch.uint8, device=dev, generator=g)
    mask = frame_mask(g, B, T, obj.mask_ratio)
    sel = torch.randperm(B, generator=g, device=dev)[:obj.top_count(B)]
    labels = torch.randint(0, 4, (len(sel),), generator=g, device=dev)
    outs, ref32 = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(cfg, T, dtype)
        init_model(model, torch.Generator().manual_seed(0))
        model.to(dev)
        clip = normalize_clip(clip_u8, dtype=dtype)
        with torch.no_grad():  # BatchNorm statistics of a trained model's kind
            model.train()
            for _ in range(3):
                model(clip)
        noise = torch.Generator().manual_seed(1)
        ema = {n: p.detach() + 0.01 * torch.randn(p.shape, generator=noise).to(dev)
               for n, p in model.named_parameters()}
        names, params = zip(*model.named_parameters())
        out = {"phase": "ssl_step_kernel_vs_plain", "B": B, "T": T, "top": True, "seed": seed}
        res = compare_impls(model, lambda: obj.loss_and_grads(
            model, list(params), ema, clip, mask, sel, labels)[::2], SSL_K1_K2[True], out)
        outs.append(judge_step(out, dtype, res, list(names), ref32))
        del model, ema, res
    return outs


class StepRecorder:
    """Callbacks for an entry run: each step's loss, ms since the previous
    one (a checkpoint write left out), clips/s, K1/K2 calls, peak memory and
    ``extra(metrics, state, row)`` (``row``: the step's entries so far); the
    launch counts summed in ``totals``; the log lines in ``lines``. Call
    :meth:`start` just before each run."""

    def __init__(self, batch: int, phase: str, extra=None):
        self.batch, self.phase, self.extra = batch, phase, extra
        self.steps, self.lines = [], []
        self.totals = dict.fromkeys(counters(), 0)
        self.t, self.setup = 0.0, False

    def start(self) -> None:
        import torch

        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        self.t, self.setup = time.perf_counter(), True

    def take_counts(self) -> dict:
        launched = read_counts()
        for name, n in launched.items():
            self.totals[name] += n
        reset_counts()
        return launched

    def on_step(self, i, state, metrics) -> None:
        import torch

        torch.cuda.synchronize()
        now = time.perf_counter()
        launched = self.take_counts()
        row = {"step": i, "includes_setup": self.setup, "loss": float(metrics["loss"]),
               "step_ms": 1e3 * (now - self.t), "clips_per_s": self.batch / (now - self.t),
               "k1_calls": launched["flash_attention_fwd"],
               "k2_calls": launched["flash_attention_bwd"],
               "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        self.steps.append({**row, **(self.extra(metrics, state, row) if self.extra else {})})
        emit({"phase": self.phase, **self.steps[-1]})
        torch.cuda.reset_peak_memory_stats()
        self.t, self.setup = time.perf_counter(), False

    def on_log(self, msg: str) -> None:
        self.lines.append(msg)
        if "saved" in msg:  # the next step's time starts after the write
            self.t = time.perf_counter()


def phase_ssl_train(dev, tmp: str) -> dict:
    """The pipeline-A entry on configs/ssl_train.yaml for SSL_TRAIN_STEPS
    steps; its last checkpoint then fills the MobileViT classifier."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
    from ssl_vit_video_analytics_tpu_torch.entry import train_ssl
    from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as eng
    from ssl_vit_video_analytics_tpu_torch.utils.checkpoint import read_checkpoint

    d = ssl_train_cfg("", "")["dataset"]
    # 8 classes x 12 train videos = 96 clips (2 steps an epoch) of 64 frames
    # (32 at stride 2), 112x112
    splits = make_synthetic_dataset(os.path.join(tmp, "ssl_a_data"), num_classes=8,
                                    videos_per_class=13, num_frames=d["clip_len"] * d["stride"],
                                    image_size=d["image_size"], seed=2)
    cfg = ssl_train_cfg(splits["train"], os.path.join(tmp, "ssl_a_out"))
    rec = StepRecorder(cfg["training"]["batch_size"], "ssl_train_step",
                       extra=lambda m, *_: {"top": "top" in m})
    rec.start()
    t0 = time.perf_counter()
    out = train_ssl.run(cfg, log=rec.on_log, max_steps=SSL_TRAIN_STEPS, on_step=rec.on_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec.take_counts()
    steps, lines = rec.steps, rec.lines
    ckpt = os.path.join(cfg["training"]["save_dir"],
                        f"ssl_epoch_{SSL_TRAIN_STEPS // 2}")
    clf = eng.build_model(8, cfg["model"]["embed_dim"], backbone="mobilevit_s")
    eng.load_pretrained_ssl(clf, read_checkpoint(ckpt))  # raises on a missing or extra key
    summary = {"phase": "ssl_train", "steps": out["steps"], "seconds": seconds,
               "device_resident": any("device-resident store" in m for m in lines),
               "checkpoint_into_classifier": os.path.basename(ckpt), "log": lines[-3:]}
    emit(summary)
    bad = [s for s in steps if (s["k1_calls"], s["k2_calls"]) != SSL_K1_K2[s["top"]]]
    if out["steps"] != SSL_TRAIN_STEPS or bad or [s["top"] for s in steps] != [
            i % 2 == 0 for i in range(1, SSL_TRAIN_STEPS + 1)]:
        raise AssertionError(f"train_ssl: {out['steps']} steps; kernel calls or TOP off "
                             f"in {bad or steps}")
    if not (all(math.isfinite(s["loss"]) for s in steps) and summary["device_resident"]):
        raise AssertionError(f"train_ssl: {summary}")
    return rec.totals


def phase_mae_step(dev, seed: int = 7, overrides: dict | None = None,
                   wide_k1_k2: tuple = (0, 0)) -> list[dict]:
    """Pipeline C's loss and gradients at full width through the kernels
    and through the plain versions; ``seed`` draws the clips, the token
    mask and the drop-path decisions; ``overrides`` go over the config, and
    the kernel runs must make ``wide_k1_k2`` of their calls on the wide
    kernels."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.masking import get_mask_ratio, make_token_mask
    from ssl_vit_video_analytics_tpu_torch.entry.train_mae import build_model
    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
    from ssl_vit_video_analytics_tpu_torch.train.finetune_engine import init_model
    from ssl_vit_video_analytics_tpu_torch.train.losses import build_mae_loss
    from ssl_vit_video_analytics_tpu_torch.train.mae_engine import token_mae_loss_and_grads
    from ssl_vit_video_analytics_tpu_torch.utils.config import merge_configs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = merge_configs(mae_train_cfg("", ""), overrides or {})
    mae = cfg["mae"]
    B, T, S = 2, cfg["dataset"]["clip_len"], cfg["dataset"]["image_size"]
    P = mae["stage4_pool"] ** 2
    g = torch.Generator(device=dev).manual_seed(seed)
    clip_u8 = torch.randint(0, 256, (B, T, S, S, 3), dtype=torch.uint8, device=dev, generator=g)
    mask = make_token_mask(g, B, T, P, get_mask_ratio(1, mae["mask_ratio_schedule"],
                                                      mae["mask_ratio"]), mae["mask_mode"])
    loss_fn = build_mae_loss(mae["loss"]["type"], mae["loss"]["normalize_target"])
    outs, ref32, drop = [], {}, None
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(cfg, dtype)
        init_model(model, torch.Generator().manual_seed(0))
        model.to(dev)
        if drop is None:  # one set of decisions for both dtypes
            drop = model.draw_drop_path(B, T, g)
        clip = normalize_clip(clip_u8, dtype=dtype)
        names, params = zip(*model.named_parameters())
        out = {"phase": "mae_step_kernel_vs_plain", "B": B, "T": T, "seed": seed,
               "decoder_num_heads": mae["decoder"]["num_heads"]}
        res = compare_impls(model, lambda: token_mae_loss_and_grads(
            model, list(params), clip, mask, drop, loss_fn)[::3], (MAE_K1_CALLS, MAE_K2_CALLS),
            out)
        out["wide_k1_k2"] = list(res["kernel"]["wide_k1_k2"])
        outs.append(judge_step(out, dtype, res, list(names), ref32))
        if res["kernel"]["wide_k1_k2"] != tuple(wide_k1_k2):
            raise AssertionError(f"pipeline C step: wide kernel calls {out['wide_k1_k2']}, "
                                 f"want {list(wide_k1_k2)}")
        del model, res
    return outs


def phase_mae_train(dev, tmp: str) -> dict:
    """The pipeline-C entry on configs/mae_train.yaml (batch 16) for
    MAE_TRAIN_STEPS steps, then a resume from its own checkpoint for
    MAE_RESUME_STEPS more; then the sanity check on the same config."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
    from ssl_vit_video_analytics_tpu_torch.entry import sanity_check_mae, train_mae
    from ssl_vit_video_analytics_tpu_torch.reporting import visualize
    from ssl_vit_video_analytics_tpu_torch.utils.config import merge_configs

    d = mae_train_cfg("", "")["dataset"]
    # 8 classes x 4 train videos = 32 clips (2 steps an epoch) of 128
    # frames (32 at stride 4), 112x112
    splits = make_synthetic_dataset(os.path.join(tmp, "mae_c_data"), num_classes=8,
                                    videos_per_class=5, num_frames=d["clip_len"] * d["stride"],
                                    image_size=d["image_size"], seed=3)
    cfg = merge_configs(mae_train_cfg(splits["train"], os.path.join(tmp, "mae_c_out")),
                        {"mae": {"vis_every": MAE_VIS_EVERY}})
    B = cfg["training"]["batch_size"]
    rec = StepRecorder(B, "mae_train_step", extra=lambda m, *_: {
        "pred_std": float(m["pred_std"]), "grad_norm": float(m["grad_norm"])})
    vis = []
    save_mae_vis = visualize.save_mae_vis

    def counted_vis(*args):  # the picture's launches, apart from the steps'
        rec.take_counts()
        path = save_mae_vis(*args)
        torch.cuda.synchronize()
        vis.append({"path": path, "counts": rec.take_counts()})
        return path

    t0 = time.perf_counter()
    rec.start()
    visualize.save_mae_vis = counted_vis
    try:
        first = train_mae.run(cfg, log=rec.on_log, max_steps=MAE_TRAIN_STEPS,
                              on_step=rec.on_step)
        rec.start()
        resumed = train_mae.run(cfg, log=rec.on_log,
                                max_steps=MAE_TRAIN_STEPS + MAE_RESUME_STEPS, on_step=rec.on_step)
    finally:
        visualize.save_mae_vis = save_mae_vis
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec.take_counts()
    steps, lines = rec.steps, rec.lines
    epoch = MAE_TRAIN_STEPS // 2 + 1
    summary = {"phase": "mae_train", "steps": [first["steps"], resumed["steps"]],
               "seconds": seconds, "best": resumed["best"],
               "resumed": [m for m in lines if m.startswith("[INFO] resumed from")],
               "vis": [{"path": v["path"], "k1_calls": v["counts"]["flash_attention_fwd"],
                        "k2_calls": v["counts"]["flash_attention_bwd"]} for v in vis],
               "vis_warnings": [m for m in lines if m.startswith("[WARN] vis failed")
                                or "mae.vis_every" in m],
               "matplotlib": visualize.plt is not None,
               "device_resident": sum("device-resident store" in m for m in lines),
               "checkpoints": sorted(f for f in os.listdir(cfg["output"]["dir"])
                                     if f.endswith(".pt"))}
    emit(summary)
    bad = [s for s in steps if (s["k1_calls"], s["k2_calls"]) != (MAE_K1_CALLS, MAE_K2_CALLS)]
    if (first["steps"], resumed["steps"]) != (MAE_TRAIN_STEPS,
                                              MAE_TRAIN_STEPS + MAE_RESUME_STEPS) or bad:
        raise AssertionError(f"train_mae: steps {summary['steps']}; kernel calls off in {bad}")
    if not (len(summary["resumed"]) == 1 and summary["resumed"][0].endswith(f"epoch {epoch}")
            and summary["device_resident"] == 2
            and all(math.isfinite(s["loss"]) for s in steps)):
        raise AssertionError(f"train_mae: {summary}")
    # one picture, at epoch MAE_VIS_EVERY of the first run: with matplotlib
    # a PNG from a K1 forward, without it no forward at all
    want_png = os.path.join(cfg["output"]["dir"], "vis", f"mae_vis_epoch_{MAE_VIS_EVERY}.png")
    want = ((want_png, MAE_VIS_K1_CALLS) if visualize.plt is not None else (None, 0))
    got = [(v["path"], v["counts"]["flash_attention_fwd"]) for v in vis]
    if (got != [want] or summary["vis_warnings"]
            or (want[0] is not None and not os.path.exists(want_png))
            or any(v["counts"]["flash_attention_bwd"] for v in vis)):
        raise AssertionError(f"train_mae picture: {got}, want {[want]}: {summary}")

    reset_counts()
    sanity = []
    sanity_check_mae.run(cfg, device=dev, log=sanity.append)
    torch.cuda.synchronize()
    sanity_counts = read_counts()
    emit({"phase": "sanity_check_mae", "log": sanity,
          "k1_calls": sanity_counts["flash_attention_fwd"],
          "k2_calls": sanity_counts["flash_attention_bwd"]})
    if sanity[-1] != "[SANITY] PASSED" or (sanity_counts["flash_attention_fwd"],
                                           sanity_counts["flash_attention_bwd"]) != (
            SANITY_K1_CALLS, SANITY_K2_CALLS):
        raise AssertionError(f"sanity_check_mae: {sanity[-2:]}, {sanity_counts}")
    return {"train_mae": rec.totals, "sanity_check_mae": sanity_counts,
            "train_mae_vis": vis[0]["counts"]}


def phase_fed_client_step(dev) -> list[dict]:
    """A FedAvg client's step at full MobileViT-S width through the kernels
    and through the plain versions (a full step, a step with a padded row),
    held by :func:`judge_step`; one client's update a step at a time with a
    fully padded last step; the steady time of a client step and of an eval
    batch at the config's batch of 16 clips."""
    import numpy as np
    import torch

    from ssl_vit_video_analytics_tpu_torch.federated import core
    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
    from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as eng
    from ssl_vit_video_analytics_tpu_torch.train.state import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = federated_cfg("", "", "", "")
    fed, d = cfg["federated"], cfg["dataset"]
    classes, embed = d["num_classes"], cfg["model"]["embed_dim"]
    B, T, S = 2, d["clip_len"], d["image_size"]
    rng = np.random.default_rng(8)
    clips = rng.integers(0, 256, (3, B, T, S, S, 3), dtype=np.uint8)
    labels = rng.integers(0, classes, (3, B)).astype(np.int32)
    valid = np.ones((3, B), bool)
    valid[1, 1] = False  # a partly padded step
    valid[2] = False     # a fully padded one
    clips[~valid] = 0    # as the round sampler pads
    outs, ref32 = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        model = eng.build_model(classes, embed, dtype=dtype)
        eng.init_model(model, torch.Generator().manual_seed(0))
        model.to(dev)
        names, params = zip(*model.named_parameters())
        for step in (0, 1):
            clip = normalize_clip(torch.from_numpy(clips[step]).to(dev), dtype=dtype)
            y = torch.from_numpy(labels[step]).to(dev)
            v = torch.from_numpy(valid[step]).to(dev)
            out = {"phase": "fed_client_step_kernel_vs_plain", "B": B, "T": T, "step": step,
                   "padded_rows": int((~valid[step]).sum())}
            res = compare_impls(model, lambda: core.client_loss_and_grads(
                model, params, clip, y, v), (MVIT_ATTN, MVIT_ATTN), out)
            outs.append(judge_step(out, dtype, res, list(names), ref32.setdefault(step, {})))

        # one client's update through the kernels, a step at a time
        start = {k: t.clone() for k, t in model.state_dict().items()}
        tx = make_optimizer(model.parameters(), fed["lr"], weight_decay=fed["weight_decay"])
        norm = (lambda c, dt=dtype: normalize_clip(c, dtype=dt))
        per_step, before = [], None
        for step in range(3):
            before = {k: t.clone() for k, t in model.state_dict().items()}
            reset_counts()
            loss_sum, count = core.client_update(model, tx, norm, clips[step:step + 1],
                                                 labels[step:step + 1],
                                                 valid[step:step + 1], 1)
            torch.cuda.synchronize()
            counts = read_counts()
            per_step.append({"k1_k2": [counts["flash_attention_fwd"],
                                       counts["flash_attention_bwd"]],
                             "loss": float(loss_sum / count.clamp_min(1)),
                             "rows": float(count), "adamw_count": tx.count})
        after = model.state_dict()
        unchanged = all(torch.equal(after[k], before[k]) for k in after)
        moved = sum(not torch.equal(after[k], start[k]) for k in after)
        out = {"phase": "fed_client_update", "dtype": str(dtype).replace("torch.", ""),
               "steps": per_step, "padded_step_left_state_unchanged": unchanged,
               "tensors_moved_by_the_update": f"{moved}/{len(after)}"}
        emit(out)
        want = [[MVIT_ATTN, MVIT_ATTN], [MVIT_ATTN, MVIT_ATTN], [0, 0]]
        if ([s_["k1_k2"] for s_ in per_step] != want
                or [s_["adamw_count"] for s_ in per_step] != [1, 2, 2]
                or [s_["rows"] for s_ in per_step] != [2.0, 1.0, 0.0]
                or not unchanged or not moved
                or not all(math.isfinite(s_["loss"]) for s_ in per_step[:2])):
            raise AssertionError(f"fed client update: {out}")
        del model, start, before, after, tx
    return outs + [phase_fed_step_time(dev, cfg)]


def phase_fed_step_time(dev, cfg: dict) -> dict:
    """The steady time of one client step (upload, forward, backward, AdamW)
    at the config's 16 clips x 32 frames in bf16, and of an eval batch
    there: host clock after a sync, the least of 5 after 2 warm-up calls."""
    import numpy as np
    import torch

    from ssl_vit_video_analytics_tpu_torch.federated import core
    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
    from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as eng
    from ssl_vit_video_analytics_tpu_torch.train.state import make_optimizer

    fed, d = cfg["federated"], cfg["dataset"]
    B, T, S = fed["batch_size"], d["clip_len"], d["image_size"]
    model = eng.build_model(d["num_classes"], cfg["model"]["embed_dim"], dtype=torch.bfloat16)
    eng.init_model(model, torch.Generator().manual_seed(0))
    model.to(dev)
    rng = np.random.default_rng(9)
    clips = rng.integers(0, 256, (1, B, T, S, S, 3), dtype=np.uint8)
    labels = rng.integers(0, d["num_classes"], (1, B)).astype(np.int32)
    valid = np.ones((1, B), bool)
    tx = make_optimizer(model.parameters(), fed["lr"], weight_decay=fed["weight_decay"])
    norm = (lambda c: normalize_clip(c, dtype=torch.bfloat16))
    eval_step = eng.make_eval_step(model, torch.bfloat16)
    batch = {"clip": torch.from_numpy(clips[0]).to(dev)}

    def least(fn) -> float:
        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return min(times[2:])

    torch.cuda.reset_peak_memory_stats()
    step_ms = least(lambda: core.client_update(model, tx, norm, clips, labels, valid, 1))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    eval_ms = least(lambda: eval_step(batch))
    out = {"phase": "fed_step_time", "B": B, "T": T, "frames": B * T,
           "client_step_ms": step_ms, "eval_batch_ms": eval_ms,
           "client_step_peak_gb": peak, "timer": "host clock after a sync, least of 5"}
    emit(out)
    del model, tx
    return out


def fed_data(tmp: str) -> dict:
    """Phases 18-19's synthetic split: 160 training clips and 8 val clips of
    64 frames at 112x112 (8 classes)."""
    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset

    d = federated_cfg("", "", "", "")["dataset"]
    return make_synthetic_dataset(os.path.join(tmp, "fed_data"), seed=5,
                                  num_frames=d["clip_len"] * d["stride"],
                                  image_size=d["image_size"], **FED_DATA)


def phase_privacy(dev, tmp: str, splits: dict) -> dict:
    """The port's privacy entry on configs/privacy.yaml (feature grid cut to
    2 x 2) on synthetic face frames and the synthetic split."""
    import cv2
    import numpy as np
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_faces
    from ssl_vit_video_analytics_tpu_torch.entry import run_privacy
    from ssl_vit_video_analytics_tpu_torch.privacy import StubFaceDetector, VisualAnonymizer
    from ssl_vit_video_analytics_tpu_torch.utils.io import read_csv_dicts

    faces = make_synthetic_faces(os.path.join(tmp, "faces"), num_frames=32, size=224, seed=4)
    cfg = privacy_cfg(splits["train"], faces, os.path.join(tmp, "privacy_out"))
    B = cfg["runtime"]["batch_size"]
    n_clips = sum(1 for _ in open(splits["train"]))
    lines = []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = run_privacy.run(cfg, log=lines.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    visual = read_csv_dicts(out["visual_csv"])[0]
    grid = read_csv_dicts(out["feature_csv"])
    clean = next(m for m in lines if m.startswith("[INFO] Clean embeddings"))
    embedded = next(m for m in lines if m.startswith("[INFO] embedded "))
    total_ms = float(embedded.split(": ")[1].split(" ms")[0])
    first_ms = float(embedded.rsplit("first batch ", 1)[1].split(" ms")[0])
    batches = -(-n_clips // B)

    # one frame anonymized on the card against the CPU (the stub's box)
    img = cv2.imread(sorted(os.path.join(faces, f) for f in os.listdir(faces))[0])
    card, _ = VisualAnonymizer(StubFaceDetector(), 31, device=dev).apply(img)
    host, _ = VisualAnonymizer(StubFaceDetector(), 31, device="cpu").apply(img)
    blur_diff = int(np.abs(card.astype(int) - host.astype(int)).max())

    summary = {"phase": "privacy", "seconds": seconds,
               "detector": next(m for m in lines if m.startswith("[INFO] detector: ")),
               "visual_frames": int(visual["total_frames"]),
               "visual_frames_per_s": int(visual["total_frames"]) / float(visual["seconds"]),
               "face_frame_rate_before": float(visual["face_frame_rate_before"]),
               "face_frame_rate_after": float(visual["face_frame_rate_after"]),
               "blur_card_vs_cpu_max_grey_levels": blur_diff,
               "clean": clean, "embedding_batches": batches, "batch": B,
               "embedding_ms_per_batch": (total_ms - first_ms) / max(1, batches - 1),
               "embedding_first_batch_ms": first_ms,
               "grid": [{k: r[k] for k in ("sigma", "mask_ratio", "top1", "attacker_top1")}
                        for r in grid],
               "k1_calls": launches["flash_attention_fwd"],
               "k2_calls": launches["flash_attention_bwd"],
               "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "warned_random_weights": any("[WARN] finetune ckpt not found" in m
                                            for m in lines),
               "device_resident": any("device-resident store" in m for m in lines)}
    emit(summary)
    clean_top1 = float(clean.split("Top-1=")[1].split(",")[0])
    if (launches["flash_attention_fwd"], launches["flash_attention_bwd"]) != (
            MVIT_ATTN * batches, 0):
        raise AssertionError(f"privacy kernel calls: {launches}, {batches} embedding batches")
    if not (blur_diff <= 1 and len(grid) == 4 and summary["device_resident"]
            and f"{float(grid[0]['top1']):.4f}" == f"{clean_top1:.4f}"
            and all(math.isfinite(float(r["attacker_top1"])) for r in grid)):
        raise AssertionError(f"privacy: {summary}")
    return launches


def phase_federated(dev, tmp: str, splits: dict) -> dict:
    """The port's federated entry on configs/federated.yaml with the smoke's
    departures, then the in-process bridge of privacy/system_federated."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.entry import run_federated
    from ssl_vit_video_analytics_tpu_torch.federated.comm_cost import bytes_to_mb
    from ssl_vit_video_analytics_tpu_torch.privacy import system_federated
    from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as eng
    from ssl_vit_video_analytics_tpu_torch.utils.io import read_csv_dicts

    cfg = federated_cfg(splits["train"], splits["val"], os.path.join(tmp, "fed_splits"),
                        os.path.join(tmp, "fed_out"))
    B = cfg["federated"]["batch_size"]
    n_train = sum(1 for _ in open(splits["train"]))
    val_batches = -(-sum(1 for _ in open(splits["val"])) // B)
    paths = {name: dict.fromkeys(counters(), 0) for name in (
        "fed_centralized", "fed_client_steps", "fed_eval")}
    rounds, lines, last = [], [], {"t": 0.0}

    def take(path: str) -> dict:
        launched = read_counts()
        for name, n in launched.items():
            paths[path][name] += n
        reset_counts()
        return launched

    def on_log(msg: str) -> None:
        lines.append(msg)
        if msg.startswith("[INFO][Centralized] ep="):
            launched = take("fed_centralized")
            emit({"phase": "fed_centralized", "log": msg,
                  "k1_calls": launched["flash_attention_fwd"],
                  "k2_calls": launched["flash_attention_bwd"]})
        elif " selected_clients=" in msg:
            if read_counts()["flash_attention_fwd"]:
                raise AssertionError(f"federated: kernel calls outside a segment before {msg}")
            torch.cuda.reset_peak_memory_stats()
            last["t"] = time.perf_counter()
        elif " local updates: " in msg:
            launched = take("fed_client_steps")
            rounds.append({"round": len(rounds) + 1,
                           "client_steps": int(msg.split(": ")[1].split()[0]),
                           "local_seconds": time.perf_counter() - last["t"],
                           "k1_calls": launched["flash_attention_fwd"],
                           "k2_calls": launched["flash_attention_bwd"],
                           "max_memory_allocated_gb":
                               torch.cuda.max_memory_allocated() / 2 ** 30})
        elif msg.startswith("[INFO] Round ") and " val_top1=" in msg:
            launched = take("fed_eval")
            rounds[-1].update({"seconds": time.perf_counter() - last["t"], "log": msg,
                               "eval_k1_calls": launched["flash_attention_fwd"],
                               "eval_k2_calls": launched["flash_attention_bwd"]})
            emit({"phase": "fed_round", **rounds[-1]})

    reset_counts()
    t0 = time.perf_counter()
    out = run_federated.run(cfg, log=on_log)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rows = out["records"]
    model = eng.build_model(cfg["dataset"]["num_classes"], cfg["model"]["embed_dim"])
    formula_mb = bytes_to_mb(4 * (sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for n, b in model.named_buffers() if n.endswith(("running_mean",
                                                                   "running_var")))))
    csvs = {name: list(read_csv_dicts(os.path.join(cfg["output"]["save_dir"], name))[0])
            for name in ("fed_summary.csv", "centralized_summary.csv",
                         "system_privacy_summary.csv", "fed_client_stats.csv")}
    summary = {"phase": "federated", "seconds": seconds, "rounds": rows,
               "model_mb_formula": round(formula_mb, 6),
               "client_splits": next(m for m in lines if m.startswith("[INFO] client splits")),
               "mesh": next(m for m in lines if m.startswith("[INFO] mesh")),
               "csv_headers": csvs, "launches": paths}
    emit(summary)
    steps_centralized = n_train // B
    bad = [r for r in rounds if (r["k1_calls"], r["k2_calls"], r["eval_k1_calls"],
                                 r["eval_k2_calls"]) != (
        MVIT_ATTN * r["client_steps"], MVIT_ATTN * r["client_steps"],
        MVIT_ATTN * val_batches, 0)]
    if bad or len(rounds) != cfg["federated"]["rounds"] or (
            paths["fed_centralized"]["flash_attention_fwd"],
            paths["fed_centralized"]["flash_attention_bwd"]) != (
            MVIT_ATTN * (steps_centralized + val_batches), MVIT_ATTN * steps_centralized):
        raise AssertionError(f"federated kernel calls: {bad or rounds}, {paths}")
    if not (all(float(r["model_mb"]) == round(formula_mb, 6) for r in rows)
            and all(math.isfinite(float(r["avg_local_loss"])) for r in rows)
            and csvs["fed_summary.csv"] == list(run_federated.FED_SUMMARY_FIELDS)
            and csvs["centralized_summary.csv"] == list(run_federated.CENTRALIZED_FIELDS)
            and csvs["system_privacy_summary.csv"] == list(
                run_federated.SYSTEM_PRIVACY_FIELDS)
            and csvs["fed_client_stats.csv"] == ["client", "num_samples", "num_classes",
                                                 "classes"]
            and summary["mesh"].startswith("[INFO] mesh: None")
            and all(r["client_steps"] >= cfg["federated"]["num_clients"] for r in rounds)):
        raise AssertionError(f"federated: {summary}")

    # the in-process bridge of the privacy package, once
    reset_counts()
    bridge_lines = []
    t0 = time.perf_counter()
    bridged = system_federated.run_federated_from_privacy(cfg, log=bridge_lines.append)
    torch.cuda.synchronize()
    bridge = read_counts()
    emit({"phase": "system_federated", "seconds": time.perf_counter() - t0,
          "rounds": len(bridged["records"]), "k1_calls": bridge["flash_attention_fwd"],
          "k2_calls": bridge["flash_attention_bwd"],
          "same_records": bridged["records"] == rows})
    if len(bridged["records"]) != len(rows) or not bridge["flash_attention_bwd"]:
        raise AssertionError(f"system_federated: {bridged['records']}, {bridge}")
    return {**paths, "system_federated": bridge}


def routing_differences(model, clip, mask, drop) -> dict:
    """Tokens that a train-mode forward through the kernels and one through
    the plain versions, on the same weights and inputs, route differently
    in each MoE block: to another expert, or on either side of its
    expert's capacity. Leaves the weights and BatchNorm statistics as it
    found them."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.models.layers import MoeMlp

    moes = [m for m in model.modules() if isinstance(m, MoeMlp)]
    start = {k: v.clone() for k, v in model.state_dict().items()}
    routes = {}
    for impl in ("kernel", "plain"):
        set_attn_impl(model, impl)
        model.load_state_dict(start)
        seen = routes[impl] = []
        hooks = [m.register_forward_hook(lambda mod, args, out: seen.append(
            mod.assignments(args[0]))) for m in moes]
        with torch.no_grad():
            model.train()
            model(clip, mask, drop)
        for h in hooks:
            h.remove()
    set_attn_impl(model, "kernel")
    model.load_state_dict(start)
    kern, plain = routes["kernel"], routes["plain"]
    return {"tokens_per_block": int(kern[0].numel()),
            "routed_differently": [int((a != b).sum()) for a, b in zip(kern, plain)],
            "to_another_expert": [int(((a != b) & (a >= 0) & (b >= 0)).sum())
                                  for a, b in zip(kern, plain)],
            "dropped_kernel": [int((a < 0).sum()) for a in kern],
            "dropped_plain": [int((b < 0).sum()) for b in plain]}


def phase_opt_in_step(dev, name: str) -> list[dict]:
    """The full-width pipeline-B step of an opt-in config (``name``: "moe",
    8 top-1 experts in each decoder block; "longclip", 64 frames) through the
    kernels and through the plain versions, on the same weights, tube mask
    and drop-path decisions, fp32 (TF32 off) and bf16, held by
    :func:`judge_step` (K1 20, K2 12 calls). The MoE loss adds the
    load-balance auxiliary as the step does; its value and the tokens the
    two runs route differently are reported, the auxiliary held to [1/E,
    E]."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.masking import get_tube_mask
    from ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae import build_model
    from ssl_vit_video_analytics_tpu_torch.ops.patchify import patchify
    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
    from ssl_vit_video_analytics_tpu_torch.train.finetune_engine import init_model
    from ssl_vit_video_analytics_tpu_torch.train.losses import mae_loss_l2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = opt_in_cfg(name, "", "", "")
    B, T, S = OPT_IN_STEP_CLIPS[name], cfg["dataset"]["clip_len"], cfg["dataset"]["image_size"]
    L = (S // 8) ** 2
    experts = cfg["model"].get("decoder_moe_experts", 0)
    weight = cfg["ssl"].get("moe_aux_weight", 0.01)
    g = torch.Generator(device=dev).manual_seed(8)
    clip_u8 = torch.randint(0, 256, (B, T, S, S, 3), dtype=torch.uint8, device=dev, generator=g)
    mask = get_tube_mask(g, B, T, L, cfg["ssl"]["mask_ratio"])
    outs, ref32, drop = [], {}, None
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(cfg, dtype)
        init_model(model, torch.Generator().manual_seed(0))
        model.to(dev)
        if drop is None:  # one set of decisions for both dtypes
            drop = model.draw_drop_path(B, T, g)
        clip = normalize_clip(clip_u8, dtype=dtype)
        target = patchify(clip.float(), 8)
        names, params = zip(*model.named_parameters())
        auxes = []

        def run():
            model.train()
            pred, aux = model(clip, mask, drop, with_aux=True)
            loss = mae_loss_l2(pred, target, mask.reshape(B, T * L))
            if aux:  # as the step with ssl.moe_aux_weight
                aux = torch.stack(aux).mean()
                auxes.append(float(aux.detach()))
                loss = loss + weight * aux
            return loss.detach(), torch.autograd.grad(loss, params)

        out = {"phase": f"{name}_step_kernel_vs_plain", "B": B, "T": T}
        torch.cuda.reset_peak_memory_stats()
        res = compare_impls(model, run, (K1_CALLS_PER_STEP, K2_CALLS_PER_STEP), out)
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if experts:
            # compare_impls runs kernel, plain, kernel, plain
            out["moe_aux"] = {"kernel": auxes[2], "plain": auxes[3]}
            out["routing"] = routing_differences(model, clip, mask, drop)
            if not all(1 / experts <= a <= experts for a in auxes):
                raise AssertionError(f"{name} step: moe_aux outside [1/E, E]: {auxes}")
        outs.append(judge_step(out, dtype, res, list(names), ref32))
        del model, res
    return outs


def phase_opt_in_train(dev, tmp: str, name: str, split: str) -> dict:
    """The pipeline-B entry on an opt-in config (``name``: "moe" or
    "longclip", :func:`opt_in_cfg`) for OPT_IN_STEPS steps on phase 6's
    split of 64-frame videos: per step loss, gnorm, update applied or
    skipped, ms, clips/s, MFU, K1/K2 (20/12 required), peak memory and the
    MoE auxiliary; JAX's one-device warning; the MoE run's profiler trace
    (its size, and whether it names K1's and K2's kernels)."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae
    from ssl_vit_video_analytics_tpu_torch.train.state import adamw_of
    from ssl_vit_video_analytics_tpu_torch.utils.metrics import (
        pipeline_b_mfu, pipeline_b_model_kwargs)

    profile_dir = os.path.join(tmp, f"{name}_trace")
    cfg = opt_in_cfg(name, split, os.path.join(tmp, f"{name}_out"), profile_dir)
    tr, d = cfg["training"], cfg["dataset"]
    experts = cfg["model"].get("decoder_moe_experts", 0)
    mfu_kwargs = pipeline_b_model_kwargs(cfg)
    applied = {"count": 0}

    def extra(metrics, state, row):
        count = adamw_of(state.tx).count
        due = row["step"] % tr["accumulation_steps"] == 0
        update = ("applied" if count > applied["count"] else "skipped") if due else "accumulated"
        applied["count"] = count
        return {"gnorm": float(metrics["grad_norm"]), "update": update,
                "mfu": pipeline_b_mfu(row["clips_per_s"], d["clip_len"], d["image_size"],
                                      **mfu_kwargs),
                **({"moe_aux": float(metrics["moe_aux"])} if "moe_aux" in metrics else {})}

    rec = StepRecorder(tr["batch_size"], f"{name}_train_step", extra=extra)
    rec.start()
    t0 = time.perf_counter()
    out = train_ssl_mae.run(cfg, log=rec.on_log, max_steps=OPT_IN_STEPS, on_step=rec.on_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rec.take_counts()
    steps, lines = rec.steps, rec.lines
    summary = {"phase": f"{name}_train", "steps": out["steps"], "seconds": seconds,
               "last_loss": out["last_loss"], "updates_applied": applied["count"],
               "warnings": [m for m in lines if m.startswith("[WARN]")],
               "device_resident": any("device-resident store" in m for m in lines)}
    if name == "moe":
        trace = os.path.join(profile_dir, "train_ssl_mae_trace.json")
        with open(trace) as f:
            text = f.read()
        summary["profiler"] = {
            "lines": [m for m in lines if "profil" in m], "trace_bytes": os.path.getsize(trace),
            "names_k1": "flash_fwd_bf16_kernel" in text,
            "names_k2": all(k in text for k in ("flash_bwd_dkdv_bf16_kernel",
                                                "flash_bwd_dq_bf16_kernel"))}
        del text
    emit(summary)
    bad = [s for s in steps if (s["k1_calls"], s["k2_calls"]) != (K1_CALLS_PER_STEP,
                                                                  K2_CALLS_PER_STEP)]
    if out["steps"] != OPT_IN_STEPS or bad:
        raise AssertionError(f"{name} train: {out['steps']} steps; kernel calls off in {bad}")
    if not (all(math.isfinite(s["loss"]) for s in steps) and applied["count"] >= 1
            and OPT_IN_WARNING[name] in lines and summary["device_resident"]):
        raise AssertionError(f"{name} train: {summary}")
    if experts and not all(1 / experts <= s["moe_aux"] <= experts for s in steps):
        raise AssertionError(f"{name} train: moe_aux outside [1/E, E]: {steps}")
    prof = summary.get("profiler")
    if prof and not (prof["names_k1"] and prof["names_k2"] and prof["lines"] == [
            f"[INFO] profiling first steps to {profile_dir}", "[INFO] profiler trace written"]):
        raise AssertionError(f"{name} train: profiler trace {prof}")
    return rec.totals


def phase_finetune_augment(dev, tmp: str, ssl_ckpt: str) -> dict:
    """Finetuning with training.augment: true. One real step of phase 10's
    classifier (fp32, TF32 off, full width, ft_ssl) through the kernels,
    whose augmented clip the CPU's augment_clip reproduces from the same
    draws to 1e-6 (K1 8, K2 8 calls); then phase 11's entry run (two_stage,
    2 epochs, from phase 6's checkpoint) with augmentation on: the enabling
    line, K1 8 a step and K2 0 while frozen, 8 after."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_synthetic_dataset
    from ssl_vit_video_analytics_tpu_torch.entry import train_finetune
    from ssl_vit_video_analytics_tpu_torch.ops import augment
    from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as eng
    from ssl_vit_video_analytics_tpu_torch.train.state import create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = finetune_cfg("", "", "", "")
    B, T, S = 2, cfg["dataset"]["clip_len"], cfg["dataset"]["image_size"]
    training = cfg["training"]
    g = torch.Generator(device=dev).manual_seed(9)
    clip_u8 = torch.randint(0, 256, (B, T, S, S, 3), dtype=torch.uint8, device=dev, generator=g)
    labels = torch.randint(0, FT_CLASSES, (B,), dtype=torch.int32, device=dev, generator=g)
    model = eng.build_model(FT_CLASSES, 256, dtype=torch.float32, backbone="tinyvit")
    eng.init_model(model, torch.Generator().manual_seed(0))
    model.to(dev)
    on = augment.augment_from_cfg({"augment": True})  # training.augment: true
    seen = {}

    def recorded(clip, generator):
        seen["clip"], seen["draws"] = clip, augment.draw_augment(generator, clip.shape[0],
                                                                 **on.keywords)
        seen["out"] = on(clip, draws=seen["draws"])
        return seen["out"]

    state = create_train_state(model, eng.build_finetune_tx(training, "ft_ssl", model, False))
    reset_counts()
    state, metrics = eng.make_train_step(model, torch.float32, augment=recorded,
                                         seed=cfg["seed"])(
        state, {"clip": clip_u8, "label": labels}, g)
    torch.cuda.synchronize()
    step_calls = read_counts()
    draws = augment.AugmentDraws(*(None if t is None else t.cpu() for t in seen["draws"]))
    cpu = on(seen["clip"].cpu(), draws=draws)
    err = float((seen["out"].cpu() - cpu).abs().max())
    moved = float((seen["out"] - seen["clip"]).abs().max())
    emit({"phase": "finetune_augment_step", "B": B, "T": T, "dtype": "float32",
          "augmented_clip_max_abs_err_vs_cpu": err, "tol": 1e-6, "augment_moved_clip": moved,
          "loss": float(metrics["loss"]), "k1_k2": [step_calls["flash_attention_fwd"],
                                                    step_calls["flash_attention_bwd"]]})
    if not (err <= 1e-6 and moved > 0 and math.isfinite(float(metrics["loss"]))):
        raise AssertionError(f"augmented finetune step: clip {err} from the CPU's, moved {moved}")
    if (step_calls["flash_attention_fwd"], step_calls["flash_attention_bwd"]) != (
            FT_K1_CALLS, FT_K2_CALLS):
        raise AssertionError(f"kernel calls in the augmented finetune step: {step_calls}")
    del model, state, seen

    # phase 11's run with augmentation on: 8 classes x 8 train videos of 16
    # frames, 4 steps an epoch
    splits = make_synthetic_dataset(os.path.join(tmp, "ft_aug_data"), num_classes=FT_CLASSES,
                                    videos_per_class=9, num_frames=T, image_size=S, seed=5)
    cfg = finetune_cfg(splits["train"], splits["train"], ssl_ckpt[:-len(".pt")],
                       os.path.join(tmp, "ft_aug_out"))
    cfg["training"]["augment"] = True
    rec = StepRecorder(cfg["training"]["batch_size"], "finetune_augment_step")

    def on_log(msg: str) -> None:
        rec.on_log(msg)
        if msg.startswith("[INFO] val "):  # validation's launches are not a step's
            rec.take_counts()

    rec.start()
    out = train_finetune.run(cfg, mode=FINETUNE_MODE, log=on_log, on_step=rec.on_step)
    torch.cuda.synchronize()
    rec.take_counts()
    steps, lines = rec.steps, rec.lines
    per_epoch = len(steps) // cfg["training"]["epochs"]
    enabled = "[INFO] on-device augmentation enabled (training.augment)" in lines
    emit({"phase": "finetune_augment", "steps": len(steps), "best_top1": out["best_top1"],
          "augmentation_line": enabled, "launches": rec.totals})
    want = [(FT_K1_CALLS, 0 if i < per_epoch else FT_K2_CALLS) for i in range(len(steps))]
    if not (enabled and steps and [(s["k1_calls"], s["k2_calls"]) for s in steps] == want
            and all(math.isfinite(s["loss"]) for s in steps)):
        raise AssertionError(f"finetune with training.augment: {lines[-3:]}, {steps}")
    return rec.totals


class GradRecorder:
    """An optimizer wrapper that keeps a copy of the gradients each update
    is given (after the mesh's reduction), then passes them on."""

    def __init__(self, inner):
        self.inner = inner
        self.seen = []

    def update(self, grads, shards=None):
        self.seen.append([g.detach().clone() for g in grads])
        return self.inner.update(grads, shards)


# phase 25's initial weights by config, and its runs without a mesh by
# config and dtype: the meshes of one config share them
RUNTIME_CACHE: dict = {}


def runtime_steps(dev, name: str, mesh) -> list[dict]:
    """RUNTIME_STEPS pipeline-B steps of ``name`` ("ssl_mae", "longclip" or
    "moe", RUNTIME_CLIPS clips) through ``make_pixel_mae_step`` with the
    mesh's runtime (its BatchNorm all-reduces, the gradient reduction,
    under seq the decoder's sp attention with its K/V gather, and over a
    model axis the model cut by ``parallel/shard.shard_model`` with its
    collectives; a pipe mesh runs the decoder in RUNTIME_MICROBATCHES
    microbatches) and without it, from the same weights, clips, masks and
    drop-path decisions, fp32 (TF32 off) and bf16; each step's loss and
    gradients held by :func:`judge_step` (the runtime run in the kernel
    run's place), K1/K2 per step 20/12 on both (the pipe's 24/16). Returns
    each judged step and the runtime bf16 run's launches. The runs without
    the mesh, and the initial weights, are made once a config
    (RUNTIME_CACHE)."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.masking import get_tube_mask
    from ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae import build_model
    from ssl_vit_video_analytics_tpu_torch.ops import attention
    from ssl_vit_video_analytics_tpu_torch.parallel.shard import shard_model
    from ssl_vit_video_analytics_tpu_torch.train.finetune_engine import init_model
    from ssl_vit_video_analytics_tpu_torch.train.mae_engine import (
        make_pixel_mae_step, wrap_accum_and_skip)
    from ssl_vit_video_analytics_tpu_torch.train.state import (
        create_train_state, make_optimizer)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ssl_mae_cfg("", "") if name == "ssl_mae" else opt_in_cfg(name, "", "", "")
    seq = mesh.split_axis == "seq"
    pipe = mesh.model_axis == "pipe"
    axis = mesh.model_axis or mesh.split_axis
    k1_k2 = ((K1_CALLS_PER_STEP + 4 * (RUNTIME_MICROBATCHES - 1),
              K2_CALLS_PER_STEP + 4 * (RUNTIME_MICROBATCHES - 1)) if pipe
             else (K1_CALLS_PER_STEP, K2_CALLS_PER_STEP))
    B, T, S = RUNTIME_CLIPS[name], cfg["dataset"]["clip_len"], cfg["dataset"]["image_size"]
    L = (S // 8) ** 2
    g = torch.Generator(device=dev).manual_seed(9)
    clips = [torch.randint(0, 256, (B, T, S, S, 3), dtype=torch.uint8, device=dev,
                           generator=g) for _ in range(RUNTIME_STEPS)]
    masks = [get_tube_mask(g, B, T, L, cfg["ssl"]["mask_ratio"]) for _ in clips]
    drops, outs, ref32, launched = None, [], [{} for _ in clips], {}
    for dtype in (torch.float32, torch.bfloat16):
        runs = {}
        for path, m in (("runtime", mesh), ("direct", None)):
            if path == "direct" and (name, dtype) in RUNTIME_CACHE:
                runs[path] = RUNTIME_CACHE[name, dtype]
                continue
            model = build_model(cfg, dtype, decoder_attn_impl="sp" if m is not None and seq
                                else None)
            if name not in RUNTIME_CACHE:
                init_model(model, torch.Generator().manual_seed(0))
                RUNTIME_CACHE[name] = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(RUNTIME_CACHE[name])
            model.to(dev)
            if m is not None:
                shard_model(model, m)
            if drops is None:
                drops = [model.draw_drop_path(B, T, g) for _ in clips]
            names = [n for n, _ in model.named_parameters()]
            # learning rate 0: both runs start every step from the same
            # weights, so the runtime's arithmetic is compared, not AdamW's
            # sign of rounding noise on gradients that are zero in exact
            # arithmetic (a BatchNorm bias ahead of another BatchNorm)
            tx = GradRecorder(wrap_accum_and_skip(make_optimizer(model.parameters(), 0.0), 1))
            state = create_train_state(model, tx)
            step = make_pixel_mae_step(
                model, cfg["ssl"]["mask_ratio"], compute_dtype=dtype,
                moe_aux_weight=cfg["ssl"].get("moe_aux_weight", 0.0),
                mesh=None if pipe else m, pp_mesh=m if pipe else None,
                pp_microbatches=RUNTIME_MICROBATCHES if pipe else None)
            attention.set_sp_group(m.group() if m is not None and seq else None)
            runs[path] = []
            reset_counts()
            try:
                for clip, mask, drop in zip(clips, masks, drops):
                    before = read_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, metrics = step(state, {"clip": clip}, g, mask=mask, drop=drop)
                    torch.cuda.synchronize()
                    after = read_counts()
                    runs[path].append({
                        "loss": float(metrics["loss"]), "grads": tx.seen[-1],
                        "ms": 1e3 * (time.perf_counter() - t0),
                        "k1_k2": tuple(after[k] - before[k] for k in
                                       ("flash_attention_fwd", "flash_attention_bwd"))})
            finally:
                attention.set_sp_group(None)
            if path == "runtime" and dtype == torch.bfloat16:
                launched = read_counts()
            if path == "direct":
                RUNTIME_CACHE[name, dtype] = runs[path]
            del model, state, tx
        for i, (rt, direct) in enumerate(zip(runs["runtime"], runs["direct"])):
            out = {"phase": f"runtime_{axis}_step_vs_direct", "config": name, "B": B,
                   "T": T, "step": i + 1, "mesh": repr(mesh),
                   "runs": "kernel = through the one-rank runtime, plain = without it"}
            if rt["k1_k2"] != k1_k2 or direct["k1_k2"] != (K1_CALLS_PER_STEP,
                                                           K2_CALLS_PER_STEP):
                raise AssertionError(f"{out}: K1/K2 {rt['k1_k2']} with the runtime, "
                                     f"{direct['k1_k2']} without")
            outs.append(judge_step(out, dtype, {"kernel": rt, "plain": direct}, names,
                                   ref32[i]))
    return outs, launched


def runtime_fedavg(dev, mesh) -> tuple[dict, dict]:
    """One FedAvg round of 2 clients (configs/federated.yaml's MobileViT-S,
    one step of 2 clips x 32 frames each, fp32, cuDNN deterministic) with a
    client mesh of one rank (the padding, the block, the all-reduced
    aggregate, the gathered losses) and without one: the losses and every
    aggregated tensor to 1e-5 of its largest magnitude, integers equal."""
    import numpy as np
    import torch

    from ssl_vit_video_analytics_tpu_torch.federated import core
    from ssl_vit_video_analytics_tpu_torch.ops.preprocess import normalize_clip
    from ssl_vit_video_analytics_tpu_torch.train import finetune_engine as eng

    cfg = federated_cfg("", "", "", "")
    fed, d = cfg["federated"], cfg["dataset"]
    B, T, S = 2, d["clip_len"], d["image_size"]
    rng = np.random.default_rng(10)
    batches = {"clip": rng.integers(0, 256, (2, 1, B, T, S, S, 3), dtype=np.uint8),
               "label": rng.integers(0, d["num_classes"], (2, 1, B)).astype(np.int32),
               "valid": np.ones((2, 1, B), bool)}
    sizes = np.array([3.0, 1.0], np.float32)
    model = eng.build_model(d["num_classes"], cfg["model"]["embed_dim"])
    eng.init_model(model, torch.Generator().manual_seed(0))
    model.to(dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    update = core.make_parallel_client_update(model, fed["lr"], fed["weight_decay"],
                                              normalize_clip)
    torch.backends.cudnn.deterministic = True
    results, launched = {}, {}
    try:
        for path, m in (("runtime", mesh), ("direct", None)):
            reset_counts()
            results[path] = core.run_fedavg_round(update, start, batches, sizes, m)
            torch.cuda.synchronize()
            if m is not None:
                launched = read_counts()
    finally:
        torch.backends.cudnn.deterministic = False
    (agg, losses), (agg0, losses0) = results["runtime"], results["direct"]
    errs = {k: rel_err(agg[k], agg0[k].float()) for k in agg0 if agg0[k].is_floating_point()}
    ints_equal = all(torch.equal(agg[k], agg0[k]) for k in agg0
                     if not agg0[k].is_floating_point())
    loss_err = rel_err(losses, losses0)
    worst = max(errs, key=errs.get)
    out = {"phase": "runtime_client_fedavg_vs_direct", "mesh": repr(mesh), "clients": 2,
           "losses": losses.tolist(), "loss_rel_err": loss_err, "worst_tensor": worst,
           "worst_rel_err": errs[worst], "ints_equal": ints_equal, "tol": 1e-5,
           "k1_k2": [launched["flash_attention_fwd"], launched["flash_attention_bwd"]]}
    emit(out)
    if not (loss_err <= 1e-5 and errs[worst] <= 1e-5 and ints_equal
            and out["k1_k2"] == [2 * MVIT_ATTN, 2 * MVIT_ATTN]):
        raise AssertionError(f"FedAvg round over the client mesh: {out}")
    return out, launched


def phase_runtime(dev, tmp: str) -> dict:
    """Phase 25: the multi-process runtime over a one-rank NCCL group in
    this process (a file:// store): the data, seq and client meshes built
    directly, so that every collective of the port (the BatchNorm
    all-reduces, the gradient reduction, the K/V gather and its
    reduce-scatter, the FedAvg all-reduce) runs through NCCL on the card.
    Pipeline-B steps of configs/ssl_mae.yaml over the data mesh and of
    configs/ssl_mae_longclip.yaml over the seq mesh (through
    parallel/sp.sp_attention_packed), a FedAvg round over the client mesh,
    and the model-sharding meshes: configs/ssl_mae_moe.yaml over {data: 1,
    expert: 1}, configs/ssl_mae.yaml over {data: 1, model: 1} and over
    {pipe: 1}; each held to the same work without the runtime. A failed
    NCCL init fails the phase; nothing falls back to gloo or to the CPU."""
    import torch.distributed as dist

    from ssl_vit_video_analytics_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "nccl_store"),
                            rank=0, world_size=1, device_id=dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"runtime phase on backend {dist.get_backend()}")
        paths = {}
        _, paths["runtime_data_steps"] = runtime_steps(dev, "ssl_mae",
                                                       pmesh.make_mesh({"data": 1}))
        _, paths["runtime_seq_steps"] = runtime_steps(dev, "longclip",
                                                      pmesh.make_mesh({"seq": 1}))
        _, paths["runtime_fedavg"] = runtime_fedavg(dev, pmesh.make_mesh({"client": 1}))
        timed = {}
        for path, name, axes in (("runtime_expert_steps", "moe", {"data": 1, "expert": 1}),
                                 ("runtime_model_steps", "ssl_mae", {"data": 1, "model": 1}),
                                 ("runtime_pipe_steps", "ssl_mae", {"pipe": 1})):
            judged, paths[path] = runtime_steps(dev, name, pmesh.make_mesh(axes))
            second = judged[-1]  # bf16, step 2
            timed[path] = {"mesh": second["mesh"], "config": name,
                           "ms_with_mesh": second["ms_kernel"],
                           "ms_without": second["ms_plain"]}
        emit({"phase": "runtime_second_step_ms", "dtype": "bfloat16",
              "clock": "host, after a sync", "paths": timed})
    finally:
        dist.destroy_process_group()
    return paths


def phase_launch(tmp: str, split: str) -> dict:
    """Phase 26: ``torchrun --standalone --nproc_per_node 1`` of the
    pipeline-B entry (configs/ssl_mae.yaml with LAUNCH_OVERRIDES, on
    phase 6's split) with --device cuda: it must exit 0 with NCCL up (the
    entry's process-group line, logged after a barrier), rank 0's log with
    its 2 steps and its checkpoint. The config goes as JSON, which the YAML
    loader reads."""
    from ssl_vit_video_analytics_tpu_torch.utils.config import merge_configs

    out_dir = os.path.join(tmp, "launch")
    cfg = merge_configs(ssl_mae_cfg(split, os.path.join(out_dir, "ckpt")), LAUNCH_OVERRIDES,
                        {"paths": {"log_dir": os.path.join(out_dir, "logs")}})
    os.makedirs(out_dir, exist_ok=True)
    cfg_path = os.path.join(out_dir, "config.yaml")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "ssl_vit_video_analytics_tpu_torch.entry.train_ssl_mae", "--config", cfg_path,
         "--base", "", "--device", "cuda"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    log_path = os.path.join(out_dir, "logs", "train_ssl_mae.log")
    lines = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            lines = [ln.split("] ", 1)[-1].rstrip("\n") for ln in f]
    ckpts = sorted(os.listdir(os.path.join(out_dir, "ckpt"))) if os.path.isdir(
        os.path.join(out_dir, "ckpt")) else []
    group = [ln for ln in lines if ln.startswith("[INFO] process group:")]
    steps = [ln for ln in lines if ln.startswith("[INFO] ep=1 step=")]
    out = {"phase": "launch_torchrun", "returncode": proc.returncode, "seconds": seconds,
           "process_group": group, "steps_logged": steps, "checkpoints": ckpts,
           "stderr_tail": proc.stderr[-1500:] if proc.returncode else ""}
    emit(out)
    if not (proc.returncode == 0 and group == ["[INFO] process group: nccl, rank 0 of 1 on "
                                                "cuda:0"]
            and len(steps) == 2 and "ckpt_epoch_1.pt" in ckpts):
        raise AssertionError(f"torchrun launch: {out}")
    return out


def run_main(module, argv: list[str]) -> list[str]:
    """``module.main()`` under ``argv``; its printed lines."""
    import contextlib
    import io

    buf, saved = io.StringIO(), sys.argv
    sys.argv = argv
    try:
        with contextlib.redirect_stdout(buf):
            module.main()
    finally:
        sys.argv = saved
        sys.stdout.write(buf.getvalue())
    return buf.getvalue().splitlines()


def phase_visualize(dev, tmp: str, split: str, ssl_ckpt: str) -> dict:
    """Phase 27: entry.visualize_mae's main on phase 6's config, split and
    encoder checkpoint, then sample 0's triptych through K1 and through the
    plain attention in fp32 and bf16. Returns the main's launches."""
    import numpy as np
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.masking import get_tube_mask
    from ssl_vit_video_analytics_tpu_torch.entry import common, visualize_mae
    from ssl_vit_video_analytics_tpu_torch.reporting import visualize

    cfg = ssl_mae_cfg(split, os.path.join(tmp, "ssl_out"))
    out_dir = os.path.join(tmp, "mae_vis")
    os.makedirs(out_dir, exist_ok=True)
    cfg_path = os.path.join(out_dir, "config.yaml")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    reset_counts()
    t0 = time.perf_counter()
    lines = run_main(visualize_mae, [
        "visualize_mae", "--config", cfg_path, "--base", "", "--ckpt", ssl_ckpt,
        "--num_samples", str(VIS_SAMPLES), "--out_dir", out_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = read_counts()
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    have_mpl = visualize.plt is not None
    emit({"phase": "visualize_mae", "seconds": seconds, "matplotlib": have_mpl, "pngs": pngs,
          "k1_calls": launched["flash_attention_fwd"],
          "k2_calls": launched["flash_attention_bwd"], "log": lines})
    want_k1 = VIS_SAMPLES * VIS_K1_PER_SAMPLE if have_mpl else 0
    want_pngs = [f"recon_{i:03d}.png" for i in range(VIS_SAMPLES)] if have_mpl else []
    if (visualize_mae.NO_DECODER not in lines or pngs != want_pngs
            or (launched["flash_attention_fwd"], launched["flash_attention_bwd"]) != (want_k1, 0)):
        raise AssertionError(f"visualize_mae: pngs {pngs}, launches {launched}, log {lines}")

    # sample 0's triptych, the kernel against the plain attention
    ds = common.dataset_from_cfg(cfg, split, "ssl")
    T, S = ds.clip_len, ds.image_size
    mask = get_tube_mask(torch.Generator(device=dev).manual_seed(0), 1, T, (S // 8) ** 2,
                         cfg["ssl"]["mask_ratio"], dev)
    clip = ds.get_clip(0)
    for dtype in (torch.float32, torch.bfloat16):
        model = visualize_mae.load_model(cfg, ssl_ckpt, dev, dtype, log=lambda m: None)
        recon, k1 = {}, {}
        for impl in ("kernel", "plain"):
            set_attn_impl(model, impl)
            reset_counts()
            recon[impl] = visualize.triptych_arrays(model, clip, mask, 8, dtype,
                                                    norm_pix=cfg["ssl"]["norm_pix_loss"])[2]
            torch.cuda.synchronize()
            k1[impl] = read_counts()["flash_attention_fwd"]
        diff = np.abs(recon["kernel"].astype(np.int16) - recon["plain"].astype(np.int16))
        row = {"phase": "visualize_triptych", "dtype": str(dtype).replace("torch.", ""),
               "k1_calls": k1, "pixels": int(diff.size), "max_level_diff": int(diff.max()),
               "share_differing": float((diff > 0).mean()),
               "share_beyond_bf16_levels": float((diff > TRIPTYCH_BF16_LEVELS).mean())}
        emit(row)
        bad = (diff.max() > 1 if dtype == torch.float32
               else row["share_beyond_bf16_levels"] > 0.01)
        if bad or k1 != {"kernel": VIS_K1_PER_SAMPLE, "plain": 0}:
            raise AssertionError(f"visualize triptych, kernel vs plain: {row}")
    return launched


def phase_plotting(tmp: str) -> None:
    """Phase 28: entry.plotting's main on configs/plotting.yaml over
    docs/examples/csv/ laid out in a directory of its own."""
    import importlib.util
    import shutil

    from ssl_vit_video_analytics_tpu_torch.entry import plotting

    root = os.path.join(tmp, "plotting")
    for dst, src in PLOTTING_LAYOUT.items():
        os.makedirs(os.path.dirname(os.path.join(root, dst)), exist_ok=True)
        shutil.copy(os.path.join(ROOT, "docs", "examples", "csv", src), os.path.join(root, dst))
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    here = os.getcwd()
    os.chdir(root)
    t0 = time.perf_counter()
    try:
        lines = run_main(plotting, ["plotting", "--config",
                                    os.path.join(ROOT, "configs", "plotting.yaml")])
    finally:
        os.chdir(here)
    seconds = time.perf_counter() - t0
    fig_dir = os.path.join(root, "results", "figures")
    figures = sorted(os.listdir(fig_dir)) if os.path.isdir(fig_dir) else []
    summary = os.path.join(root, "results", "summary.csv")
    same = None
    if os.path.exists(summary):
        with open(summary) as f, open(os.path.join(ROOT, "docs", "examples", "csv",
                                                   "summary.csv")) as g:
            same = f.read() == g.read()
    emit({"phase": "plotting", "seconds": seconds, "matplotlib": have_mpl,
          "figures": figures, "summary_csv_equals_committed": same,
          "note": None if have_mpl else "no matplotlib: generate_all returns [] as JAX's does",
          "log": lines})
    if have_mpl and not (len(figures) == PLOTTING_FIGURES and same):
        raise AssertionError(f"plotting: {figures}, summary equal: {same}")
    if not have_mpl and (figures or same is not None):
        raise AssertionError(f"plotting without matplotlib wrote {figures}")


def start_ablation_cell(tmp: str) -> dict:
    """Phase 29's real cell, started in the background so that it overlaps
    phase 26's launcher run (its own process, its own launch counts):
    ``entry.ablations --groups dynamic --max_per_group 1`` as a subprocess,
    on phase 7's config and split."""
    out_dir = os.path.join(tmp, "ablations")
    split = slice_data(out_dir)["val"]
    cfg_path = os.path.join(out_dir, "dynamic.yaml")
    with open(cfg_path, "w") as f:
        json.dump(slice_cfg(split, os.path.join(out_dir, "unused"), "streaming"), f)
    pythonpath = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ssl_vit_video_analytics_tpu_torch.entry.ablations",
         "--groups", "dynamic", "--max_per_group", "1", "--dynamic_config", cfg_path,
         "--base", "", "--out_dir", os.path.join(out_dir, "cell")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=pythonpath), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    return {"proc": proc, "t0": time.perf_counter(), "out_dir": out_dir}


def stop_ablation_cell(cell: dict) -> None:
    """Kill the cell's process group (entry.ablations and its run_dynamic)
    if a failed phase left it running."""
    if cell["proc"].poll() is None:
        os.killpg(cell["proc"].pid, signal.SIGKILL)
        cell["proc"].wait()


def phase_ablations(tmp: str, cell: dict) -> None:
    """Phase 29: entry.ablations --dry_run over the four groups, then the
    real cell of :func:`start_ablation_cell`, waited for: exit 0, its CSV
    and ``ablation_index.json`` with exit 0."""
    from ssl_vit_video_analytics_tpu_torch.entry import ablations

    lines = run_main(ablations, ["ablations", "--dry_run", "--out_dir",
                                 os.path.join(tmp, "ablations", "dry")])
    modules = [ln.split(" -m ", 1)[1].split()[0] for ln in lines
               if ln.startswith("[ABLATION]")]
    want = [f"ssl_vit_video_analytics_tpu_torch.entry.{entry}"
            for entry, n in ABLATION_GROUPS.values() for _ in range(n)]
    emit({"phase": "ablations_dry_run", "commands": len(modules),
          "modules": sorted(set(modules))})
    if modules != want:
        raise AssertionError(f"ablations --dry_run: {modules}, want {want}")

    out, err = cell["proc"].communicate(timeout=600)
    seconds = time.perf_counter() - cell["t0"]
    cell_dir = os.path.join(cell["out_dir"], "cell")
    index_path = os.path.join(cell_dir, "ablation_index.json")
    index = json.load(open(index_path)) if os.path.exists(index_path) else None
    csv = os.path.join(cell_dir, "DYN_min_frames2", "dynamic", "early_exit_results.csv")
    emit({"phase": "ablations_cell", "seconds_from_start": seconds,
          "returncode": cell["proc"].returncode, "index": index, "csv": os.path.exists(csv),
          "log": [ln for ln in out.splitlines() if ln.startswith(("[ABLATION]", "[INFO] wrote"))],
          "stderr_tail": err[-1500:] if cell["proc"].returncode else ""})
    if not (cell["proc"].returncode == 0 and index and len(index) == 1
            and index[0]["exit"] == 0 and os.path.exists(csv)):
        raise AssertionError(f"ablation cell: index {index}, csv {os.path.exists(csv)}")


def phase_export(dev, tmp: str, smi: str) -> dict:
    """Phase 30: tools.export_serving on configs/dynamic.yaml's classifier,
    fp32, exported on the card for --platforms cpu cuda: each artifact,
    served on its platform, against the live model (K1). Returns the live
    forwards' launches."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.entry import run_dynamic
    from ssl_vit_video_analytics_tpu_torch.models.layers import MultiHeadAttention
    from ssl_vit_video_analytics_tpu_torch.tools import export_serving

    cfg = slice_cfg("", tmp, "streaming")
    T, S = cfg["dataset"]["clip_len"], cfg["dataset"]["image_size"]
    t0 = time.perf_counter()
    model = run_dynamic.load_classifier(cfg, torch.float32, dev, lambda m: None)
    program = export_serving.export_model(model, T, S, log=lambda m: None)
    out_path = os.path.join(tmp, "classifier.pt2")
    paths = {}
    for platform, prog in export_serving.to_platforms(program, list(EXPORT_PLATFORMS)).items():
        paths[platform] = export_serving.artifact_path(out_path, platform)
        torch.export.save(prog, paths[platform])
    export_s = time.perf_counter() - t0
    served = {platform: torch.export.load(path).module() for platform, path in paths.items()}
    impls = sorted({m.attn_impl or "kernel" for m in model.modules()
                    if isinstance(m, MultiHeadAttention)})
    g = torch.Generator(device=dev).manual_seed(30)
    launched = dict.fromkeys(counters(), 0)
    rows = []
    with torch.no_grad():
        for batch in EXPORT_BATCHES:
            clip = torch.randn(batch, T, S, S, 3, generator=g, device=dev)
            outs = {platform: fn(clip.to(platform)) for platform, fn in served.items()}
            reset_counts()
            live = model(clip)
            torch.cuda.synchronize()
            for name, n in read_counts().items():
                launched[name] += n
            for platform, got in outs.items():
                rows.append({"platform": platform, "batch": batch,
                             "served_device": str(got.device),
                             "served_shape": list(got.shape),
                             "max_abs_diff": float((got.to(dev) - live).abs().max()),
                             "live_max_abs": float(live.abs().max()),
                             "finite": bool(torch.isfinite(got).all())})

        def per_batch_ms(fn, x, calls=20) -> float:  # a host copy after each call
            for _ in range(3):
                float(fn(x)[0, 0])
            t = time.perf_counter()
            for _ in range(calls):
                float(fn(x)[0, 0])
            return (time.perf_counter() - t) / calls * 1e3

        served_ms = per_batch_ms(served["cuda"], clip)
        cpu_ms = per_batch_ms(served["cpu"], clip.cpu(), calls=3)
        live_ms = per_batch_ms(model, clip)
    out = {"phase": "export", "export_seconds": export_s,
           "artifact_mb": {p: os.path.getsize(path) / 1e6 for p, path in paths.items()},
           "attn_impl_after_export": impls, "batches": rows,
           "served_ms_batch8": served_ms, "served_cpu_ms_batch8": cpu_ms,
           "live_ms_batch8": live_ms, "nvidia_smi": smi,
           "k1_calls_live": launched["flash_attention_fwd"]}
    emit(out)
    bad = [r for r in rows if not (r["finite"] and r["served_shape"] == [
        r["batch"], cfg["dataset"]["num_classes"]]
        and r["served_device"].startswith(r["platform"])
        and r["max_abs_diff"] <= EXPORT_TOL * r["live_max_abs"])]
    if (bad or impls != ["kernel"] or len(rows) != len(EXPORT_PLATFORMS) * len(EXPORT_BATCHES)
            or launched["flash_attention_fwd"] != MVIT_ATTN * len(EXPORT_BATCHES)):
        raise AssertionError(f"export: {out}")
    return launched


def campaign_argvs(root: str) -> dict:
    """Phase 31's script command lines under ``root``, in the order they
    run: (a) the pipeline-A campaign as the sweep cell ``A_lab100``, (b)
    mae_evidence, (c) the pipeline-B cell ``B_lab50`` from (b)'s encoder,
    (d) the two artifact scripts; every entry on the card."""
    data, docs = os.path.join(root, "data"), os.path.join(root, "docs")
    a_out, mae_out = os.path.join(root, "A_lab100"), os.path.join(root, "mae_b")
    mae_ckpt = os.path.join(mae_out, "ckpt", f"ckpt_epoch_{MAE_EVIDENCE_EPOCHS}")
    return {
        "campaign_a": ["--out", a_out, "--data", data, *CAMPAIGN_DATA, *CAMPAIGN_A_ARGS,
                       "--device", "cuda"],
        "mae_evidence": ["--out", mae_out, "--data", data, *CAMPAIGN_DATA, *MAE_EVIDENCE_ARGS,
                         "--device", "cuda"],
        "campaign_b": ["--out", os.path.join(root, "B_lab50"), "--data", data, *CAMPAIGN_DATA,
                       *CAMPAIGN_B_ARGS, "--ssl_ckpt", mae_ckpt, "--device", "cuda"],
        "campaign_artifacts": ["--campaign", a_out, "--docs", docs],
        "sweep_artifacts": ["--root", root, "--docs", docs],
    }


def phase_campaigns(tmp: str) -> dict:
    """Phase 31: the research campaigns through the port's scripts
    (:func:`campaign_argvs`). Each entry call a script makes is a path: its
    launch counts set to 0 just before it and read just after, its steps
    timed (:class:`StepRecorder`), its peak device memory, and the (B, Lq,
    Lk, H, d) of each K1 and K2 call, every one of which must be a shape
    that phases 3-4 hold against the plain versions. Returns the paths'
    launches."""
    import contextlib
    import io

    import torch

    from ssl_vit_video_analytics_tpu_torch.entry import (run_privacy, train_finetune, train_ssl,
                                                         train_ssl_mae)
    from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa
    from ssl_vit_video_analytics_tpu_torch.scripts import (make_campaign_artifacts,
                                                           make_sweep_artifacts, mae_evidence,
                                                           ssl_transfer_campaign)
    from ssl_vit_video_analytics_tpu_torch.utils.io import read_csv_dicts

    root = os.path.join(tmp, "campaigns")
    argvs = campaign_argvs(root)
    paths, runs, shapes = {}, {}, {}
    current = {"family": "", "path": None}
    entries = {"train_ssl": train_ssl, "train_finetune": train_finetune,
               "run_privacy": run_privacy, "train_ssl_mae": train_ssl_mae}
    originals = {name: module.run for name, module in entries.items()}
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def counted(entry: str):
        def run(cfg, *args, **kw):
            name = {"train_ssl": "campaign_train_ssl", "run_privacy": "campaign_run_privacy",
                    "train_ssl_mae": "mae_evidence"}.get(
                entry, f"campaign_{current['family']}{kw.get('mode')}")
            batch = int(cfg.get("training", cfg.get("runtime", {}))["batch_size"])
            rec = StepRecorder(batch, "campaign_step")
            current["path"] = name
            shapes[name] = set()
            if entry != "run_privacy":
                kw["on_step"] = rec.on_step
            log = kw.get("log", print)

            def epoch_log(msg):  # an epoch's first step starts its clock at the epoch
                if "started" in msg:
                    torch.cuda.synchronize()
                    rec.t = time.perf_counter()
                log(msg)

            kw["log"] = epoch_log
            torch.cuda.synchronize()
            rec.start()
            t0 = time.perf_counter()
            out = originals[entry](cfg, *args, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rec.take_counts()
            paths[name] = rec.totals
            timed = [s["step_ms"] for s in rec.steps if not s["includes_setup"]]
            runs[name] = {
                "seconds": seconds, "steps": len(rec.steps),
                "step_ms": [s["step_ms"] for s in rec.steps],
                "step_ms_median": sorted(timed)[len(timed) // 2] if timed else None,
                "losses": [s["loss"] for s in rec.steps],
                "max_memory_allocated_gb": max(
                    [torch.cuda.max_memory_allocated() / 2 ** 30]
                    + [s["max_memory_allocated_gb"] for s in rec.steps]),
                "k1": rec.totals["flash_attention_fwd"], "k2": rec.totals["flash_attention_bwd"]}
            return out
        return run

    def fwd_recorded(q, k, v, num_heads):
        shapes[current["path"]].add(("K1", q.shape[0], q.shape[1], k.shape[1], num_heads,
                                     q.shape[2] // num_heads, str(q.dtype)))
        return fwd(q, k, v, num_heads)

    def bwd_recorded(q, k, v, out, lse, dout, num_heads):
        shapes[current["path"]].add(("K2", q.shape[0], q.shape[1], k.shape[1], num_heads,
                                     q.shape[2] // num_heads, str(q.dtype)))
        return bwd(q, k, v, out, lse, dout, num_heads)

    def script(module, key: str) -> list[str]:
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                module.main(argvs[key])
        except BaseException:
            sys.stdout.write(buf.getvalue()[-6000:])
            raise
        return buf.getvalue().splitlines()

    lines = {}
    here = os.getcwd()
    t0 = time.perf_counter()
    try:
        os.chdir(ROOT)  # mae_evidence reads configs/ssl_mae.yaml from the repo root
        for name, module in entries.items():
            module.run = counted(name)
        fa.flash_attention_fwd, fa.flash_attention_bwd = fwd_recorded, bwd_recorded
        lines["campaign_a"] = script(ssl_transfer_campaign, "campaign_a")
        lines["mae_evidence"] = script(mae_evidence, "mae_evidence")
        current["family"] = "b_"
        lines["campaign_b"] = script(ssl_transfer_campaign, "campaign_b")
        lines["campaign_artifacts"] = script(make_campaign_artifacts, "campaign_artifacts")
        lines["sweep_artifacts"] = script(make_sweep_artifacts, "sweep_artifacts")
    finally:
        os.chdir(here)
        for name, module in entries.items():
            module.run = originals[name]
        fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd
    seconds = time.perf_counter() - t0

    a, b, mae = (os.path.join(root, d) for d in ("A_lab100", "B_lab50", "mae_b"))
    tables = {os.path.relpath(p, root): read_csv_dicts(p) for p in [
        os.path.join(a, "ssl", "ssl_metrics.csv"),
        *[os.path.join(a, "finetune", m, "metrics.csv") for m in CAMPAIGN_A_MODES],
        os.path.join(a, "privacy", "feature_privacy.csv"),
        os.path.join(mae, "mae_pretrain_metrics.csv"), os.path.join(mae, "mae_pretrain_steps.csv"),
        *[os.path.join(b, "finetune", m, "metrics.csv") for m in CAMPAIGN_B_MODES],
        os.path.join(root, "sweep_summary.csv"),
        os.path.join(root, "docs", "csv", "ssl_transfer_sweep.csv")]}
    with open(os.path.join(a, "campaign_summary.json")) as f, \
            open(os.path.join(b, "campaign_summary.json")) as g:
        best = {"A_lab100": json.load(f)["best_top1"], "B_lab50": json.load(g)["best_top1"]}
    known = {s[1:] for s in KERNEL_SHAPES + LONGCLIP_SHAPES + TP_SHAPES}
    missing = sorted({s[1:6] for ss in shapes.values() for s in ss} - known)
    losses = [x for r in runs.values() for x in r["losses"]]
    losses += [float(r[k]) for name, rows in tables.items() for r in rows
               for k in ("total", "train_loss", "loss") if k in r]
    said = [ln for ln_list in lines.values() for ln in ln_list
            if ln.startswith(("[campaign]", "[mae-evidence]", "figure:", "csv:", "copied:",
                              "MISSING:", "[INFO] loaded finetune", "[WARN] finetune ckpt"))]
    summary = {"phase": "campaigns", "seconds": seconds, "paths": runs,
               "best_top1": best, "rows": {name: len(rows) for name, rows in tables.items()},
               "shapes": {name: sorted(ss) for name, ss in shapes.items()},
               "shapes_not_in_phases_3_4": missing, "log": said}
    emit(summary)
    no_k1 = [p for p in runs if runs[p]["k1"] == 0]
    k2_wrong = [p for p in runs if (runs[p]["k2"] == 0) != (p in CAMPAIGN_NO_K2)]
    rows = summary["rows"]
    if not (set(runs) == {p for p in PATHS if p.startswith("campaign_")} | {"mae_evidence"}
            and not no_k1 and not k2_wrong and not missing
            and rows[os.path.join("A_lab100", "privacy", "feature_privacy.csv")]
            == PRIVACY_GRID_ROWS
            and rows[os.path.join("mae_b", "mae_pretrain_metrics.csv")] == MAE_EVIDENCE_EPOCHS
            and rows["sweep_summary.csv"] == len(CAMPAIGN_A_MODES) + len(CAMPAIGN_B_MODES)
            and losses and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"campaigns: paths {sorted(runs)}, no K1 {no_k1}, K2 wrong "
                             f"{k2_wrong}, shapes missing {missing}, rows {rows}, "
                             f"{len(losses)} losses, not finite "
                             f"{[x for x in losses if not math.isfinite(x)]}")
    return paths


def phase_repack(dev, tmp: str, split: str) -> dict:
    """Phase 32: the decoder repack through entry.train_ssl_mae (phase 6's
    config and split with each arm's overrides of REPACK_ARMS: 3 heads of
    128, then 1 of 384), then the ported probe on phase 31's hard fixture.
    Returns the three paths' launches."""
    import contextlib
    import io

    import torch

    from ssl_vit_video_analytics_tpu_torch.data.fixtures import make_hard_synthetic_dataset
    from ssl_vit_video_analytics_tpu_torch.scripts import probe_decoder_repack

    paths = {path: repack_train(split, os.path.join(tmp, path), path, overrides, calls_by_d)
             for path, (overrides, calls_by_d) in REPACK_ARMS.items()}

    # the probe, from the repo root as a user runs it, on phase 31's fixture
    # (made again, the same clips, where phase 31 did not run)
    data = os.path.join(tmp, "campaigns", "data")
    make_hard_synthetic_dataset(data, num_classes=int(CAMPAIGN_DATA[1]),
                                videos_per_class=int(CAMPAIGN_DATA[3]), num_frames=16,
                                image_size=112)
    argv = ["--data", data, "--batch", "16", "--steps", str(REPACK_PROBE_STEPS)]
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = probe_decoder_repack.main(argv)
    except BaseException:
        sys.stdout.write(buf.getvalue()[-6000:])
        raise
    torch.cuda.synchronize()
    probe_launches = read_counts()
    lines = buf.getvalue().splitlines()
    probe = {"phase": "repack_probe", "argv": argv, "seconds": time.perf_counter() - t0,
             "ms_per_step_6x64": res["ms_6x64"], "ms_per_step_3x128": res["ms_3x128"],
             "max_rel_dev": res["max_rel_dev"], "mean_rel_dev": res["mean_rel_dev"],
             "launches": probe_launches, "lines": lines}
    emit(probe)
    losses = list(res["losses_6x64"]) + list(res["losses_3x128"])
    if not (len(lines) == 6 and lines[0].startswith("[heads=6 d=64]")
            and lines[1].startswith("[heads=3 d=128]") and all(map(math.isfinite, losses))
            and probe_launches["flash_attention_fwd"] and probe_launches["flash_attention_bwd"]):
        raise AssertionError(f"repack probe: {probe}")
    return {**paths, "probe_decoder_repack": probe_launches}


def repack_train(split: str, save_dir: str, path: str, overrides: dict,
                 calls_by_d: dict) -> dict:
    """One arm of phase 32: entry.train_ssl_mae on phase 6's config and
    split with ``overrides``, TRAIN_STEPS steps, each holding K1/K2 20/12,
    ``calls_by_d`` of them by head dim, its calls above d = 256 on the wide
    kernels, and a finite loss. Returns the run's launches."""
    import torch

    from ssl_vit_video_analytics_tpu_torch.entry import train_ssl_mae
    from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa
    from ssl_vit_video_analytics_tpu_torch.utils.config import merge_configs

    cfg = merge_configs(ssl_mae_cfg(split, save_dir), overrides)
    B = cfg["training"]["batch_size"]
    calls = {}
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def fwd_by_d(q, k, v, num_heads):
        key = f"K1_d{q.shape[2] // num_heads}"
        calls[key] = calls.get(key, 0) + 1
        return fwd(q, k, v, num_heads)

    def bwd_by_d(q, k, v, out, lse, dout, num_heads):
        key = f"K2_d{q.shape[2] // num_heads}"
        calls[key] = calls.get(key, 0) + 1
        return bwd(q, k, v, out, lse, dout, num_heads)

    def by_d(metrics, state, row):
        out = {"calls_by_d": dict(calls)}
        calls.clear()
        return out

    rec = StepRecorder(B, f"{path}_step", extra=by_d)
    fa.flash_attention_fwd, fa.flash_attention_bwd = fwd_by_d, bwd_by_d
    try:
        rec.start()
        t0 = time.perf_counter()
        out = train_ssl_mae.run(cfg, log=rec.lines.append, max_steps=TRAIN_STEPS,
                                on_step=rec.on_step)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd
    rec.take_counts()
    timed = [s["step_ms"] for s in rec.steps if not s["includes_setup"]]
    summary = {"phase": path, "decoder_num_heads": cfg["model"]["decoder_num_heads"],
               "steps": out["steps"], "seconds": seconds, "last_loss": out["last_loss"],
               "step_ms_median": sorted(timed)[len(timed) // 2] if timed else None,
               "max_memory_allocated_gb": max((s["max_memory_allocated_gb"] for s in rec.steps),
                                              default=None),
               "launches": rec.totals, "log": rec.lines[-2:]}
    emit(summary)
    wide = sum(n for key, n in calls_by_d.items() if int(key.split("_d")[1]) > 256)
    bad = [s for s in rec.steps if (s["k1_calls"], s["k2_calls"], s["calls_by_d"])
           != (K1_CALLS_PER_STEP, K2_CALLS_PER_STEP, calls_by_d)]
    wide_ok = (rec.totals["flash_attention_fwd_wide"] + rec.totals["flash_attention_bwd_wide"]
               == wide * TRAIN_STEPS)
    if out["steps"] != TRAIN_STEPS or bad or not wide_ok or not all(
            math.isfinite(s["loss"]) for s in rec.steps):
        raise AssertionError(f"{path}: {out['steps']} steps, wide launches "
                             f"{rec.totals}; calls or losses off in {bad}")
    return rec.totals


def write_videos(root: str) -> int:
    """FRONT_END's videos under ``root``/<class>/ as cv2 writes them; each
    frame a moving bar over noise, so that no two are alike. Returns the
    count."""
    import cv2
    import numpy as np

    fe = FRONT_END
    rng = np.random.default_rng(0)
    n = 0
    for c, cls in enumerate(fe["classes"]):
        os.makedirs(os.path.join(root, cls))
        for v in range(fe["videos_per_class"]):
            name = f"v_{cls.replace(' ', '')}_g01_c{v + 1:02d}.avi"  # UCF101's file names
            w = cv2.VideoWriter(os.path.join(root, cls, name),
                                cv2.VideoWriter_fourcc(*"MJPG"), fe["fps"],
                                (fe["width"], fe["height"]))
            if not w.isOpened():
                raise AssertionError("cv2.VideoWriter does not open an MJPG .avi")
            for t in range(fe["frames"]):
                frame = rng.integers(0, 64, (fe["height"], fe["width"], 3), dtype=np.uint8)
                x = (8 * t + 40 * v) % fe["width"]
                frame[:, x:x + 24] = 60 * c, 200, 255 - 30 * v
                w.write(frame)
            w.release()
            n += 1
    return n


def phase_front_end(dev, tmp: str, ssl_ckpt: str) -> dict:
    """Phase 33: the dataset front end on the card's machine without JAX
    (see the module doc). Returns the finetune's and evaluate's launches."""
    import numpy as np
    import torch

    from ssl_vit_video_analytics_tpu_torch.data.loader import iterate_batches
    from ssl_vit_video_analytics_tpu_torch.entry import common, evaluate, train_finetune
    from ssl_vit_video_analytics_tpu_torch.utils.config import merge_configs

    videos, frames, run_dir = (os.path.join(tmp, f"fe_{d}") for d in ("videos", "frames",
                                                                       "run"))
    splits = os.path.join(run_dir, "data", "splits")  # where the runner writes them
    os.makedirs(run_dir)
    t0 = time.perf_counter()
    n_videos = write_videos(videos)
    stages = {"write_videos": time.perf_counter() - t0}
    # a jax that cannot be imported, first on the path of every stage
    blocker = os.path.join(tmp, "fe_no_jax")
    os.makedirs(blocker)
    with open(os.path.join(blocker, "jax.py"), "w") as f:
        f.write("raise ImportError('the front end must not import jax')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([blocker, ROOT]), PYTHONUNBUFFERED="1")
    ends = (("standardize", "class_index.txt"), ("extract_and_pack", "[INFO] extracted "),
            ("splits", "UCF101_test.txt: "), ("verify", "[INFO] Dataset pipeline finished"))
    out_lines = []
    t_stage = time.perf_counter()
    proc = subprocess.Popen(["bash", os.path.join(ROOT, "experiments", "torch",
                                                  "run_full_pipeline_dataset.sh"),
                             videos, frames, "UCF101", "112"], cwd=run_dir, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for line in proc.stdout:
            out_lines.append(line.rstrip("\n"))
            for stage, marker in ends:
                if marker in line and stage not in stages:
                    stages[stage] = time.perf_counter() - t_stage
                    t_stage = time.perf_counter()
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    packed = sorted(os.path.relpath(os.path.join(d, f), frames)
                    for d, _, fs in os.walk(frames) for f in fs if f == "packed_112.npy")
    shape = list(np.load(os.path.join(frames, packed[0]), mmap_mode="r").shape) if packed \
        else None
    fe = {"phase": "front_end", "videos": n_videos, "rc": rc, "stage_seconds": stages,
          "packed_arrays": len(packed), "packed_shape": shape,
          "jax_on_the_machine": importlib.util.find_spec("jax") is not None,
          "log": out_lines[-12:]}
    emit(fe)
    if rc != 0 or len(packed) != n_videos or shape != [FRONT_END["frames"], 112, 112, 3] \
            or set(stages) != {"write_videos", *(s for s, _ in ends)}:
        raise AssertionError(f"front end: {fe}\n" + "\n".join(out_lines[-40:]))

    # one finetune epoch and evaluate on the packed store (device-resident)
    split = {n: os.path.join(splits, f"UCF101_{n}.txt") for n in ("train", "val", "test")}
    cfg = merge_configs(finetune_cfg(split["train"], split["val"], ssl_ckpt[:-len(".pt")],
                                     os.path.join(tmp, "fe_out")),
                        {"dataset": {"num_classes": len(FRONT_END["classes"])},
                         "training": {"epochs": 1}})
    B = cfg["training"]["batch_size"]
    rec = StepRecorder(B, "front_end_finetune_step")
    rec.start()
    t0 = time.perf_counter()
    out = train_finetune.run(cfg, mode=FRONT_END_MODE, log=rec.lines.append,
                             on_step=rec.on_step)
    torch.cuda.synchronize()
    ft_seconds = time.perf_counter() - t0
    rec.take_counts()
    best = os.path.join(cfg["paths"]["save_dir"], FRONT_END_MODE, "best")
    reset_counts()
    t0 = time.perf_counter()
    ev_lines = []
    ev = evaluate.run(cfg, best if out["best_ckpt"] else None, split["test"],
                      log=ev_lines.append, measure_latency=False)
    torch.cuda.synchronize()
    ev_seconds = time.perf_counter() - t0
    ev_launches = read_counts()
    n_test = sum(1 for _ in open(split["test"]))

    # the packed store's batches, host and device-resident, against the
    # JPEG frames'
    same = {}
    for name in ("train", "test"):
        jpeg = common.dataset_from_cfg(merge_configs(cfg, {"dataset": {"backend": "jpeg"}}),
                                       split[name], "supervised", seed=cfg["seed"])
        ds = common.dataset_from_cfg(cfg, split[name], "supervised", seed=cfg["seed"])
        kw = dict(shuffle=True, seed=cfg["seed"], epoch=0, drop_last=False)
        ref = list(iterate_batches(jpeg, B, **kw))
        host = list(iterate_batches(ds, B, **kw))
        store = common.maybe_device_resident(cfg, ds, dev, log=lambda m: None)
        resident = list(store.epoch_batches(B, **kw))
        same[name] = bool(ref) and len(ref) == len(host) == len(resident) and all(
            np.array_equal(np.asarray(r[k]), np.asarray(h[k]))
            and np.array_equal(np.asarray(r[k]), g[k].cpu().numpy())
            for r, h, g in zip(ref, host, resident) for k in ("clip", "label", "valid"))
        del store
    summary = {"phase": "front_end_transfer", "mode": FRONT_END_MODE,
               "finetune_seconds": ft_seconds, "steps": len(rec.steps),
               "best_top1": out["best_top1"], "evaluate_seconds": ev_seconds,
               "evaluate_top1": ev["acc"]["top1"], "evaluate_clips": n_test,
               "launches": {"train_finetune_packed": rec.totals, "evaluate_packed": ev_launches},
               "device_resident": sum("device-resident store" in m for m in rec.lines),
               "batches_equal_jpeg": same,
               "log": [m for m in rec.lines + ev_lines if "val top1" in m or "[WARN]" in m]}
    emit(summary)
    eval_batches = -(-n_test // B)
    bad = [s for s in rec.steps if (s["k1_calls"], s["k2_calls"]) != (FT_K1_CALLS, FT_K2_CALLS)]
    if not (rec.steps and not bad and all(math.isfinite(s["loss"]) for s in rec.steps)
            and summary["device_resident"] >= 1 and all(same.values())
            and (ev_launches["flash_attention_fwd"], ev_launches["flash_attention_bwd"])
            == (FT_K1_CALLS * eval_batches, 0)):
        raise AssertionError(f"front end transfer: {summary}; steps off {bad}")
    return summary["launches"]


def step_seeds(dev, seeds: list[int]) -> None:
    """Phases 12 and 14 on each of ``seeds`` (the clips and draws; the
    weights stay those of seed 0), every judgement emitted; fails at the
    end if any seed failed. Each bf16 judgement's relative L2 distances per
    leaf (kernel vs plain, each vs the fp32 plain run: the plain bf16 run's
    own distance is the noise yardstick) go to
    chiprun_out/step_seeds.jsonl, and per phase the leaves whose plain bf16
    run lies furthest from fp32 across the seeds to a line of their own."""
    global LEAF_DISTANCES
    LEAF_DISTANCES = []
    failed = []
    for seed in seeds:
        for phase in (phase_ssl_step, phase_mae_step):
            try:
                phase(dev, seed)
            except AssertionError as e:
                failed.append(f"{phase.__name__} seed {seed}: {e}")
                emit({"phase": "step_seed_failed", "seed": seed, "step": phase.__name__})
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "step_seeds.jsonl"), "w") as f:
        for row in LEAF_DISTANCES:
            f.write(json.dumps(row) + "\n")
    for phase in sorted({row["phase"] for row in LEAF_DISTANCES}):
        rows = [row for row in LEAF_DISTANCES if row["phase"] == phase]
        noise = {leaf: max(row["leaves"][leaf]["plain_vs_fp32"] for row in rows)
                 for leaf in rows[0]["leaves"]}
        emit({"phase": "step_seeds_noise", "step": phase, "seeds": [r["seed"] for r in rows],
              "failed": {r["seed"]: r["failed"] for r in rows if r["failed"]},
              "plain_bf16_vs_fp32_max_over_seeds": dict(
                  sorted(noise.items(), key=lambda kv: -kv[1])[:8])})
    if failed:
        raise AssertionError("; ".join(failed))


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    from ssl_vit_video_analytics_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run "
                         "needs an NVIDIA GPU")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "device_name": device_name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    def lap(after: str) -> None:  # where the run's seconds go
        emit({"phase": "elapsed", "after": after, "seconds": time.perf_counter() - t_start})

    phase_build()
    lap("build")
    if len(sys.argv) > 2 and sys.argv[1] == "--step-seeds":
        step_seeds(dev, [int(a) for a in sys.argv[2:]])
        return
    k1 = phase_kernel(fa, dev)
    k2 = phase_backward(fa, dev)
    k1_wide, k2_wide = k1.pop("wide"), k2.pop("wide")
    lap("kernels")
    longclip = {shape[0]: phase_longclip_kernels(fa, dev, shape)
                for shape in LONGCLIP_SHAPES + TP_SHAPES}
    lap("long-clip and head-block kernels")
    phase_train_step(fa, dev)
    with tempfile.TemporaryDirectory() as tmp:  # phase 6's checkpoint serves phase 11
        paths = {}
        paths["train_ssl_mae"], ssl_ckpt, ssl_split = phase_train(fa, dev, tmp)
        lap("pipeline B")
        serving = phase_slice(fa, dev)
        paths["run_dynamic_streaming"] = serving["streaming"]
        paths["run_dynamic_batched"] = serving["batched"]
        p1 = phase_dw(dev)
        paths["probe_dw"] = p1.pop("launched")
        p2 = phase_chain(dev)
        paths["probe_exp"] = p2.pop("launched")
        ln = phase_layer_norm(dev)
        lap("serving, probes and LayerNorm")
        phase_finetune_step(dev)
        paths.update(phase_transfer(fa, dev, tmp, ssl_ckpt))
        lap("transfer")
        phase_ssl_step(dev)
        paths["train_ssl"] = phase_ssl_train(dev, tmp)
        phase_mae_step(dev)
        phase_mae_step(dev, overrides=MAE_H1_OVERRIDES, wide_k1_k2=MAE_H1_WIDE_CALLS)
        paths.update(phase_mae_train(dev, tmp))
        lap("pipelines A and C")
        phase_fed_client_step(dev)
        splits = fed_data(tmp)
        paths["run_privacy"] = phase_privacy(dev, tmp, splits)
        paths.update(phase_federated(dev, tmp, splits))
        lap("privacy and federated")
        for regime in OPT_IN_CONFIGS:
            phase_opt_in_step(dev, regime)
            paths[f"train_ssl_mae_{regime}"] = phase_opt_in_train(dev, tmp, regime, ssl_split)
        paths["train_finetune_augment"] = phase_finetune_augment(dev, tmp, ssl_ckpt)
        lap("opt-in regimes")
        paths.update(phase_runtime(dev, tmp))
        lap("runtime")
        cell = start_ablation_cell(tmp)
        try:
            phase_launch(tmp, ssl_split)
            lap("launch")
            paths["visualize_mae"] = phase_visualize(dev, tmp, ssl_split, ssl_ckpt)
            lap("visualize_mae")
            phase_plotting(tmp)
            lap("plotting")
            phase_ablations(tmp, cell)
            lap("ablations")
        finally:
            stop_ablation_cell(cell)
        paths["export_live"] = phase_export(dev, tmp, smi)
        lap("export")
        paths.update(phase_campaigns(tmp))
        lap("campaigns")
        paths.update(phase_repack(dev, tmp, ssl_split))
        lap("decoder repack")
        paths.update(phase_front_end(dev, tmp, ssl_ckpt))
        lap("front end")

    def by_path(kernel: str) -> dict:
        return {path: paths[path][kernel] for path in PATHS}

    ms_is = ("sum over the pipeline-B shapes (tinyvit_stage1, tinyvit_stage2, "
             "mae_decoder) in bf16, one call each; library: "
             "torch.nn.functional.scaled_dot_product_attention")
    wide_is = (f"{WIDE_SHAPE} (the one-head decoder of --set model.decoder_num_heads=1, "
               f"d = 384) in bf16, one call; library: "
               f"torch.nn.functional.scaled_dot_product_attention")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_TPU, "launches": paths["train_ssl_mae"]["flash_attention_fwd"],
         "launches_by_path": by_path("flash_attention_fwd"), **k1, "ms_is": ms_is,
         **{name: t["fwd"] for name, t in longclip.items()}},
        {"name": "flash_attention_bwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_TPU, "launches": paths["train_ssl_mae"]["flash_attention_bwd"],
         "launches_is": "calls, each launching the dK/dV and the dQ kernel",
         "launches_by_path": by_path("flash_attention_bwd"), **k2,
         "ms_is": ms_is + " (backward, autograd.grad)",
         **{name: t["bwd"] for name, t in longclip.items()}},
        {"name": "flash_attention_fwd_wide", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_TPU,
         "launches": paths["train_ssl_mae_repack_h1"]["flash_attention_fwd_wide"],
         "launches_by_path": by_path("flash_attention_fwd_wide"), **k1_wide,
         "ms_is": wide_is, "max_abs_err_is": "over phase 3's shapes above d = 256"},
        {"name": "flash_attention_bwd_wide", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_TPU,
         "launches": paths["train_ssl_mae_repack_h1"]["flash_attention_bwd_wide"],
         "launches_is": "calls, each launching the wide dK/dV and dQ kernels",
         "launches_by_path": by_path("flash_attention_bwd_wide"), **k2_wide,
         "ms_is": wide_is + " (backward, autograd.grad)",
         "max_abs_err_is": "over phase 4's shapes above d = 256"},
        {"name": "dw3x3", "route": "cuda", "source": P1_SOURCE, "replaces": P1_TPU,
         "launches": paths["probe_dw"]["dw3x3"], "launches_by_path": by_path("dw3x3"),
         **p1, "ms_is": "bf16 [256, 56*56, 384], one call; library: cuDNN grouped "
                        "conv2d forward on a channels-last view; bwd_dx: the kernel on "
                        "the flipped taps and cuDNN's input gradient"},
        {"name": "unary_chain", "route": "cuda", "source": P2_SOURCE, "replaces": P2_TPU,
         "launches": paths["probe_exp"]["unary_chain"],
         "launches_by_path": by_path("unary_chain"), **p2, "library_ms": None,
         "bound_by": "operations",
         "ms_is": "sum over the 4 ops x 2 working types of one call at n = 516 on "
                  "896x6272; library: none, no single PyTorch call applies an n-step "
                  "chain"},
        {"name": "layer_norm_fwd", "route": "cuda", "source": LN_SOURCE,
         "replaces": LN_REPLACES, "launches": paths["train_ssl_mae"]["layer_norm_fwd"],
         "launches_by_path": by_path("layer_norm_fwd"), **ln["fwd"],
         "ms_is": "bf16 in and out, one call at each LN_SHAPES row; plain: x.float(), "
                  "torch's fp32 layer_norm, .to(bf16); library: torch's fp32 layer_norm "
                  "on the fp32 copy"},
        {"name": "layer_norm_bwd", "route": "cuda", "source": LN_SOURCE,
         "replaces": LN_REPLACES, "launches": paths["train_ssl_mae"]["layer_norm_bwd"],
         "launches_is": "calls, each launching the row kernel and the reduction",
         "launches_by_path": by_path("layer_norm_bwd"), **ln["bwd"],
         "ms_is": "as layer_norm_fwd's, backward (autograd.grad for plain and library)"},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
