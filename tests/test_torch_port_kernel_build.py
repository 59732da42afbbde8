"""The port's kernel build (ops/kernel_build.py), on the CPU with a
stand-in for nvcc: every source starts compiling at once, and a failed
compile raises and leaves no compiler running."""
import stat
import subprocess
import time

import pytest

from ssl_vit_video_analytics_tpu_torch.ops import kernel_build

# fails on one source, and compiles every other one for a minute
FAKE_NVCC = """#!/bin/sh
case "$*" in
  *{failing}*) echo "{failing}(1): error: stand-in failure"; exit 2;;
esac
exec sleep 60
"""


def test_failed_build_raises_and_leaves_no_compiler_running(tmp_path, monkeypatch):
    # _build collects the compiles in order, so the first one fails
    failing = next(iter(kernel_build.sources().values())).name
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(failing=failing))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kernel_build, "find_nvcc", lambda: str(nvcc))
    started = []

    def recording_popen(*args, **kwargs):
        started.append(real_popen(*args, **kwargs))
        return started[-1]

    real_popen = subprocess.Popen
    monkeypatch.setattr(kernel_build.subprocess, "Popen", recording_popen)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="stand-in failure"):
        kernel_build._build(tmp_path / "kernels")
    assert time.perf_counter() - t0 < 30  # the other compiles were not awaited
    assert len(started) == len(kernel_build.sources()) == 4
    assert [p.returncode for p in started] == [2, -9, -9, -9]
    assert not list((tmp_path / "kernels").glob("*.so"))
