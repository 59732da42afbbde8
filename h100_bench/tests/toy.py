"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: toy
widths and images, a few clips, the program's plain attention."""
import json
import os
import time

from h100_bench import harness

TOY_TRAIN = {"embed_dims": [24, 48, 96, 576], "decoder_embed_dim": 16, "decoder_num_heads": 2}


def bench() -> dict:
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(workload: str, seed: int = 3, seconds: float = 0.5, trace: bool = False,
         log=lambda m: None) -> harness.Cell:
    c = harness.resolve(bench(), workload)
    cfg = c.cfg
    if "split_clips" in c.traffic:
        cfg["model"].update(TOY_TRAIN)
        cfg["dataset"].update(image_size=32, clip_len=max(2, cfg["dataset"]["clip_len"] // 16))
        cfg["training"]["batch_size"] = 4
        c.traffic["split_clips"] = 16
    else:
        cfg["model"]["embed_dim"] = 32
        cfg["dataset"].update(image_size=32, clip_len=6, num_classes=7)
        c.traffic["pool_clips"] = 24
    cfg["dataset"]["device_resident"] = True  # the program's store, on the CPU too
    c.device, c.seed, c.seconds, c.trace, c.t0, c.log = "cpu", seed, seconds, trace, \
        time.time(), log
    return c
