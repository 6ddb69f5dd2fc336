"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<hash>/libfyrox_kernels.so csrc/*.cu

The library is built at first use, from the sources in this package only,
into ``fyrox_tpu_torch/_build/<hash of the sources and flags>/``. A missing
``nvcc`` or a failed build raises with the compiler's output; nothing
falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["library", "build_seconds", "KernelBuildError", "check"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_VP, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float
# C entry points: name → argument types (pointers and the stream as void*)
_SIGNATURES = {
    "fyrox_plane_gather": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "fyrox_tgs_solve": [_VP] * 9 + [_I] * 7 + [_F] * 10 + [_VP],
}

_LIB = None
_BUILD_SECONDS = None


class KernelBuildError(RuntimeError):
    """nvcc is missing, or compiling or loading the kernels failed."""


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (not on PATH, no /usr/local/cuda/bin/nvcc): the "
            "CUDA kernels of fyrox_tpu_torch build only where the CUDA "
            "toolkit is installed. CPU tensors take the plain PyTorch "
            "versions and need no build.")
    return nvcc


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    hdrs = sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB, _BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    t0 = time.perf_counter()
    srcs, digest = _sources()
    out_dir = BUILD_ROOT / digest
    so = out_dir / "libfyrox_kernels.so"
    if not so.exists():
        nvcc = _find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise KernelBuildError(f"loading {so} failed: {e}") from e
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    _LIB = lib
    _BUILD_SECONDS = time.perf_counter() - t0
    return _LIB


def build_seconds():
    """Seconds the first ``library()`` call took (build + load)."""
    return _BUILD_SECONDS


def check(err: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
