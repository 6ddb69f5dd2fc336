"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -c -o _build/<hash>/<name>.o csrc/<name>.cu      (each file)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/<hash>/libfyrox_kernels.so _build/<hash>/*.o

No ``--use_fast_math``: the fused-step kernels reproduce their plain
versions' IEEE rounding (csrc/np_planes.cuh).

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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name → argument types (pointers and the stream as void*)
_SIGNATURES = {
    "fyrox_plane_gather": [_VP, _VP, _VP, _I, _I, _I, _I, _LL, _I, _I, _VP],
    "fyrox_gather_rows": [_VP, _VP, _VP, _I, _I, _I, _I, _LL, _I, _VP],
    "fyrox_plane_scatter": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "fyrox_tgs_solve": [_VP] * 21 + [_I] * 12 + [_F] * 10 + [_VP],
    "fyrox_fused_bp": [_VP] * 12 + [_I] * 12 + [_F] * 5 + [_VP],
    "fyrox_narrow_compact": [_VP] * 11 + [_I] * 8 + [_F] * 2 + [_VP],
    "fyrox_tile_raster": [_VP] * 7 + [_I] * 11 + [_VP] * 3,
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
        _build(_find_nvcc(), srcs, out_dir, so)
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


def _run_all(cmds):
    """Run the commands in parallel; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out, err)
    if failed is not None:
        cmd, rc, out, err = failed
        raise KernelBuildError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                               f"{out}\n{err}")


def _build(nvcc, srcs, out_dir, so):
    """One nvcc per source, all at once, then one link."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs = [tmp_dir / (src.stem + ".o") for src in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                  for src, o in zip(srcs, objs)])
        tmp_so = tmp_dir / so.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
                   *map(str, objs)]])
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def build_seconds():
    """Seconds the first ``library()`` call took (build + load)."""
    return _BUILD_SECONDS


def check(err: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
