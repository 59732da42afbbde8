"""Compiles and loads every CUDA source of the port.

:data:`LIBRARIES` lists every kernel library of the port: its source
under ``csrc/`` and the C functions its wrapper calls, with their
``ctypes`` signatures. :func:`build` compiles every source that is not yet
built, one ``nvcc`` process per source, all started together, into
``build/kernels/`` at the repo root (git-ignored), each library keyed by a
hash of its source, every header under ``csrc/`` and the flags (see
:func:`build_key`), and loads them with ``ctypes``: the sources
have a plain C interface, so no PyTorch headers are compiled. A failed
``nvcc`` raises and leaves no compiler running.

Nothing here runs at import: the CPU path of every wrapper takes the plain
version and never calls :func:`build`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _i32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_ERROR_STRING = ([_i32], ctypes.c_char_p)
# name -> (source under csrc/, {C function: (argtypes, restype)})
LIBRARIES: dict[str, tuple[str, dict[str, tuple[list, object]]]] = {
    "flash_fwd": ("flash_fwd.cu", {
        "ssl_vit_flash_fwd": ([_i32, _i32, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32,
                               _i32, _i64, _i64, _i64, _i64, _i64, _i64, _f32, _vp], _i32),
        "ssl_vit_flash_fwd_wide_smem": ([_i32], _i32),
        "ssl_vit_cuda_error_string": _ERROR_STRING}),
    "flash_bwd": ("flash_bwd.cu", {
        "ssl_vit_flash_bwd": ([_i32, _i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                               _vp, _i32, _i32, _i32, _i32, _i64, _i64, _i64, _i64, _i64,
                               _i64, _i64, _i64, _f32, _vp], _i32),
        "ssl_vit_flash_bwd_wide_smem": ([_i32, _i32], _i32),
        "ssl_vit_flash_bwd_error_string": _ERROR_STRING}),
    "dw3x3": ("dw3x3.cu", {
        "ssl_vit_dw3x3": ([_i32, _vp, _vp, _vp, _i32, _i32, _i32, _i32, _vp], _i32),
        "ssl_vit_dw3x3_error_string": _ERROR_STRING}),
    "unary_chain": ("unary_chain.cu", {
        "ssl_vit_unary_chain": ([_i32, _i32, _vp, _vp, _i64, _i32, _vp], _i32),
        "ssl_vit_unary_chain_error_string": _ERROR_STRING}),
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    ptxas_log: str        # nvcc's -Xptxas -v report (empty when cached)


def sources() -> dict[str, Path]:
    """Every kernel source of the port, by library name."""
    return {name: CSRC / source for name, (source, _) in LIBRARIES.items()}


def build() -> dict[str, KernelLibrary]:
    """Compile every source not yet built in ``BUILD_DIR`` (one ``nvcc``
    process each, all started together) and load them, with their
    signatures set."""
    return _build(BUILD_DIR)


def build_key(source: Path) -> str:
    """The hash that names ``source``'s library: its bytes, those of every
    ``*.cuh`` beside it (the flash kernels share ``flash_mma.cuh``), and the
    flags, so that a change to any of them rebuilds."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def sass(library: str | Path) -> str:
    """``cuobjdump -sass`` of a built library (the toolkit's, beside nvcc)."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def count_by_function(listing: str, opcode: str) -> dict[str, int]:
    """Instructions of ``opcode`` (a prefix, e.g. ``HMMA.16816.F32.BF16``)
    in each function of a ``cuobjdump -sass`` listing, by mangled name."""
    pattern = re.compile(r"\s" + re.escape(opcode) + r"[\s.]")
    out = {}
    for chunk in listing.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        out[name.strip()] = sum(bool(pattern.search(line)) for line in body.splitlines())
    return out


def find_nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.lru_cache(maxsize=None)
def _build(build_dir: Path) -> dict[str, KernelLibrary]:
    jobs = {}
    try:
        for name, source in sources().items():
            key = build_key(source)
            so_path = build_dir / f"{name}_{key}.so"
            proc = tmp = None
            if not so_path.exists():
                build_dir.mkdir(parents=True, exist_ok=True)
                tmp = build_dir / f".{name}_{key}.{os.getpid()}.so"
                cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            jobs[name] = (so_path, tmp, proc, time.perf_counter())
        libs = {}
        for name, (so_path, tmp, proc, t0) in jobs.items():
            seconds, log = 0.0, ""
            if proc is not None:
                log = proc.communicate()[0]
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                       f"{' '.join(map(str, proc.args))}\n{log}")
                os.replace(tmp, so_path)  # atomic: a concurrent build sees a whole file
            lib = ctypes.CDLL(str(so_path))
            for fn, (argtypes, restype) in LIBRARIES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            libs[name] = KernelLibrary(lib, so_path, seconds, log)
    finally:  # a failed build leaves no compiler running
        for _, _, proc, _ in jobs.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs
