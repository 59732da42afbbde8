"""Finds a cell's files by the names in ``BENCHMARK.json`` and assembles a
run's result line.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Its files, all under this folder:

- ``configs/<config>.json``: the configuration as it is run (``cfg``, the
  port's merged yaml), ``reduced``/``assumed``, and ``path``, the driven
  path;
- ``traffic/<traffic>.json``: the mix: its sizes, its order, and ``set``,
  keys of ``cfg`` it sets (``"training.batch_size"``: 8);
- ``paths/<path>.py``: builds the system under test, warms it up, drives
  the window and checks the outputs (``run(cell)``);
- ``limits/<workload>.json``: for each number compared, its ``limit`` and
  the two readings it was set from: ``lower``, the highest that sound runs
  gave, and ``upper``, the lowest that the control or a fault gave;
- ``metrics/<name>.py``: one reader a per-layer metric (``read(ctx)``,
  None where it finds nothing to read), or ``metrics/<family>.py`` for
  every metric ``<family>.<part>`` that has no reader of its own.

A later cell adds files and entries; none of these files needs an edit.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules the run may not hold once its window has closed: JAX and the JAX
# package, compared by whole top-level names (the port's name begins with
# the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ssl_vit_video_analytics_tpu")


def forbidden_modules(names) -> list[str]:
    """The top-level names among module names ``names`` that are forbidden."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def load_module(path: str, name: str):
    """The module in file ``path`` under ``name``, loaded once a process."""
    mod = sys.modules.get(name)
    if mod is not None and os.path.abspath(getattr(mod, "__file__", "") or "") == \
            os.path.abspath(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def set_key(cfg: dict, dotted: str, value) -> None:
    node = cfg
    *parents, leaf = dotted.split(".")
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = value


@dataclass
class Cell:
    """Everything a path needs to run one cell once."""
    workload: str
    config_name: str
    cfg: dict
    traffic: dict
    limits: dict                    # number compared -> its limit
    path: str
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"
    t0: float = 0.0                 # the process's start (time.time())
    log: object = field(default=print, repr=False)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(bench: dict, workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``bench`` (``BENCHMARK.json``'s content)
    with its files read from under ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfile = _read(os.path.join(root, conf["file"]))
    here = os.path.join(root, os.path.dirname(os.path.dirname(conf["file"])))
    traffic = _read(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    cfg = copy.deepcopy(cfile["cfg"])
    for key, value in traffic.get("set", {}).items():
        set_key(cfg, key, value)
    limits_path = os.path.join(here, "limits", f"{workload}.json")
    entries = _read(limits_path) if os.path.exists(limits_path) else {}
    limits = {name: e["limit"] for name, e in entries.items()}
    return Cell(workload=workload, config_name=conf["name"], cfg=cfg, traffic=traffic,
                limits=limits, path=os.path.join(here, "paths", f"{cfile['path']}.py"),
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def run_cell(cell: Cell) -> dict:
    """Run ``cell`` once through its path; returns the path's result."""
    path = load_module(cell.path, f"h100_bench.paths.{os.path.basename(cell.path)[:-3]}")
    return path.run(cell)


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Each number compared beside its limit, and whether every one is
    within it (a number without a limit, or not finite, fails)."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        good = limit is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok and bool(checks), out


def reader_path(metrics_dir: str, name: str) -> str:
    """The reader of metric ``name``: its own file, else its family's."""
    own = os.path.join(metrics_dir, f"{name}.py")
    return own if os.path.exists(own) else os.path.join(metrics_dir,
                                                        f"{name.split('.', 1)[0]}.py")


def per_layer_values(cell: Cell, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    metrics_dir = os.path.join(os.path.dirname(os.path.dirname(cell.path)), "metrics")
    for m in cell.per_layer:
        path = reader_path(metrics_dir, m["name"])
        reader = load_module(path, "h100_bench.metrics."
                             + os.path.basename(path)[:-3].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: Cell, res: dict) -> dict:
    """The run's last line: ``correct``, counts, the cell's metrics for this
    kind of run, the device, the traced run's breakdown, and last the
    numbers compared beside their limits."""
    correct, checks = judge(res["checks"], cell.limits)
    if cell.trace:
        metrics = per_layer_values(cell, res["ctx"])
    else:
        metrics = {m["name"]: {"value": res["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": res["device"]}
    if cell.trace and "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    return line


def device_info(device, peak_bytes: int, profile: dict | None = None) -> dict:
    """The result's ``device``: platform, the card's name, the cards used,
    the peak of allocated memory, and for a traced run the busy seconds of
    the profiled window beside its length."""
    import torch

    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak_bytes)}
    if profile is not None:
        out["busy_s"] = profile["busy_s"]
        out["window_s"] = profile["window_s"]
    return out
