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
    assert len(started) == len(kernel_build.sources()) == 5
    assert [p.returncode for p in started] == [2, -9, -9, -9, -9]
    assert not list((tmp_path / "kernels").glob("*.so"))


def test_build_key_covers_the_shared_headers(tmp_path):
    """A library is keyed by its source, every csrc/*.cuh beside it and the
    flags: editing the header that both flash kernels include rebuilds
    them, and nothing else under csrc/ does."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    source = csrc / "flash_fwd.cu"
    source.write_text('#include "flash_mma.cuh"\n')
    header = csrc / "flash_mma.cuh"
    header.write_text("constexpr int kTile = 64;\n")
    first = kernel_build.build_key(source)
    assert kernel_build.build_key(source) == first
    (csrc / "notes.txt").write_text("not a header")
    assert kernel_build.build_key(source) == first
    header.write_text("constexpr int kTile = 32;\n")
    second = kernel_build.build_key(source)
    assert second != first
    (csrc / "other.cuh").write_text("// a new header\n")
    assert kernel_build.build_key(source) not in (first, second)
    real = kernel_build.sources()["flash_fwd"]
    assert (real.parent / "flash_mma.cuh").is_file()
    assert kernel_build.build_key(real) != kernel_build.build_key(
        kernel_build.sources()["flash_bwd"])


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64EEEvPK13__nv_bfloat16
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0100*/                   LDSM.16.M88.4 R12, [R3] ;
        /*0110*/                   HMMA.16816.F32.BF16 R4, R12, R20, RZ ;
        /*0120*/                   HMMA.16816.F32.BF16 R8, R12, R22, R8 ;
        /*0130*/                   MUFU.EX2 R5, R5 ;
\t\tFunction : _ZN12_GLOBAL__N_121flash_fwd_fp32_kernelILi64EEEvPKfS2_
        /*0100*/                   FFMA R4, R12, R20, R4 ;
        /*0110*/               @P0 HMMA.1688.F32.TF32 R4, R12, R20, RZ ;
"""


def test_sass_counts_each_functions_tensor_core_products():
    counts = kernel_build.count_by_function(SASS, "HMMA.16816.F32.BF16")
    assert counts == {"_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64EEEvPK13__nv_bfloat16": 2,
                      "_ZN12_GLOBAL__N_121flash_fwd_fp32_kernelILi64EEEvPKfS2_": 0}
    assert sum(kernel_build.count_by_function(SASS, "HMMA").values()) == 3
