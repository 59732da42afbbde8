"""Environment preflight report (the port's copy of the repo's env_checker.py;
reference: env_checker.py:114-166).

Writes python/OS/torch/CUDA/nvcc/package versions, the kernel build
directory and the card inventory (each card's name and power limit) to
logs/env_report.txt and stdout, in place of the JAX report's jax and TPU
lines.

Usage: python -m ssl_vit_video_analytics_tpu_torch.tools.env_checker
"""
from __future__ import annotations

import importlib
import os
import platform
import shutil
import subprocess
import sys

PACKAGES = ["torch", "numpy", "einops", "scipy", "yaml", "cv2", "PIL", "matplotlib",
            "pandas", "tensorboardX"]


def _run(cmd: list[str]) -> str:
    """stdout of ``cmd``, or the reason it gave none."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"FAILED ({type(e).__name__}: {e})"
    return out.stdout.strip() if out.returncode == 0 else f"FAILED (rc {out.returncode})"


def gather() -> list[str]:
    lines = [f"python: {sys.version.split()[0]} ({sys.executable})",
             f"platform: {platform.platform()}",
             f"cpu_count: {os.cpu_count()}",
             f"ffmpeg: {shutil.which('ffmpeg') or 'NOT FOUND'}"]
    try:
        import torch

        lines.append(f"torch cuda: {torch.version.cuda} "
                     f"(available: {torch.cuda.is_available()})")
        for i in range(torch.cuda.device_count()):
            lines.append(f"device: {torch.cuda.get_device_name(i)} (id={i}, platform=gpu)")
        lines.append(f"device_count: {torch.cuda.device_count()}")
    except Exception as e:  # pragma: no cover
        lines.append(f"torch: FAILED ({type(e).__name__}: {e})")
    if shutil.which("nvidia-smi"):
        for i, row in enumerate(_run(["nvidia-smi", "--query-gpu=name,power.limit",
                                      "--format=csv,noheader"]).splitlines()):
            lines.append(f"nvidia-smi {i}: {row}")
    else:
        lines.append("nvidia-smi: NOT FOUND")
    from ..ops import kernel_build

    try:
        nvcc = kernel_build.find_nvcc()
        version = _run([nvcc, "--version"]).splitlines()
        lines.append(f"nvcc: {nvcc} ({version[-1] if version else '?'})")
    except RuntimeError as e:
        lines.append(f"nvcc: NOT FOUND ({e})")
    built = sorted(p.name for p in kernel_build.BUILD_DIR.glob("*.so"))
    lines.append(f"kernel build dir: {kernel_build.BUILD_DIR} "
                 f"({len(built)} libraries built: {', '.join(built) or 'none'})")
    for mod in PACKAGES:
        try:
            m = importlib.import_module(mod)
            lines.append(f"{mod}: {getattr(m, '__version__', '?')}")
        except ImportError:
            lines.append(f"{mod}: NOT INSTALLED")
    return lines


def main():
    lines = gather()
    report = "\n".join(lines)
    print(report)
    os.makedirs("logs", exist_ok=True)
    with open("logs/env_report.txt", "w") as f:
        f.write(report + "\n")
    print("\n[INFO] wrote logs/env_report.txt")


if __name__ == "__main__":
    main()
