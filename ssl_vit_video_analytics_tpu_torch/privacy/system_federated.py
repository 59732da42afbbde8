"""System-level privacy bridge: launch the federated evaluation from the
privacy pipeline (counterpart of the JAX package's
``privacy/system_federated.py``; ref: src/privacy/system_federated.py:4-10).

The reference shells out to run_federated.py; here the in-process call is
the default (no subprocess tax), with a subprocess variant for isolation.
"""
from __future__ import annotations

import subprocess
import sys

import torch


def run_federated_from_privacy(cfg: dict, log=print,
                               device: str | torch.device | None = None) -> dict:
    """In-process: the port's federated entry's ``run()``."""
    from ..entry.run_federated import run
    return run(cfg, log=log, device=device)


def run_federated_subprocess(config_path: str = "configs/federated.yaml",
                             base: str = "configs/base.yaml",
                             device: str | None = None) -> int:
    """``python -m ssl_vit_video_analytics_tpu_torch.entry.run_federated``;
    ``device`` None leaves the entry's default (the config's, else cuda)."""
    cmd = [sys.executable, "-m", "ssl_vit_video_analytics_tpu_torch.entry.run_federated",
           "--config", config_path, "--base", base]
    return subprocess.call(cmd + (["--device", device] if device else []))
