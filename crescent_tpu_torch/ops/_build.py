"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``), written to
``build/kernels/`` at the repository root (gitignored) under a name keyed by
a hash of the sources, headers and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing is built at import: the first call of
``library(name)`` builds, and ``build_all()`` starts one nvcc per source
together and waits for all of them.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ctypes signatures of each library's C entry points (all return an int
# cudaError_t; pointers and the stream are c_void_p so they are not cut to
# 32 bits).
_u32p = ctypes.POINTER(ctypes.c_uint32)
_vp = ctypes.c_void_p
_ll = ctypes.c_longlong
_int = ctypes.c_int
_intp = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "ntt": {
        "crescent_mul": [_u32p, _vp, _vp, _vp, _ll, _ll, _ll, _ll, _vp],
        "crescent_butterfly": [_u32p, _vp, _vp, _vp, _ll, _int, _vp],
    },
    "ec": {
        "crescent_inv": [_u32p, _u32p, _vp, _vp, _ll, _vp],
        "crescent_batch_inv": [_u32p, _u32p, _vp, _vp, _ll, _int, _vp],
        "crescent_affine_denom": [_u32p] + [_vp] * 7 + [_ll, _vp],
        "crescent_affine_add": [_u32p] + [_vp] * 10 + [_ll, _vp],
        "crescent_jadd": [_u32p] + [_vp] * 9 + [_ll, _vp],
        "crescent_jdbl_n": [_u32p] + [_vp] * 6 + [_ll, _int, _vp],
        "crescent_jdbl": [_u32p] + [_vp] * 6 + [_ll, _vp],
        "crescent_jadd_wide": [_u32p] + [_vp] * 9 + [_ll, _vp],
        "crescent_jdbl_wide": [_u32p] + [_vp] * 6 + [_ll, _vp],
        "crescent_madd": [_u32p] + [_vp] * 5 + [_ll, _ll] + [_vp] * 5 + [_ll, _vp],
        "crescent_fixed_base": [_u32p] + [_vp] * 5 + [_ll, _vp],
        "crescent_bucket_reduce": [_u32p] + [_vp] * 6 + [_ll, _ll, _vp],
        "crescent_bucket_reduce_fit": [_ll, _ll, _intp],
    },
    "ec2": {
        "crescent_fq2_mul": [_u32p, _vp, _vp, _vp, _ll, _ll, _ll, _ll, _vp],
        "crescent_fq2_inv": [_u32p, _u32p, _vp, _vp, _ll, _vp],
        "crescent_fq2_batch_inv": [_u32p, _u32p, _vp, _vp, _ll, _int, _vp],
        "crescent_fq2_madd": [_u32p] + [_vp] * 5 + [_ll, _ll] + [_vp] * 5 + [_ll, _vp],
        "crescent_fq2_fixed_base": [_u32p] + [_vp] * 5 + [_ll, _vp],
        "crescent_fq2_affine_denom": [_u32p] + [_vp] * 7 + [_ll, _vp],
        "crescent_fq2_affine_add": [_u32p] + [_vp] * 10 + [_ll, _vp],
        "crescent_fq2_jadd": [_u32p] + [_vp] * 9 + [_ll, _vp],
        "crescent_fq2_jdbl_n": [_u32p] + [_vp] * 6 + [_ll, _int, _vp],
        "crescent_fq2_jdbl": [_u32p] + [_vp] * 6 + [_ll, _vp],
        "crescent_fq2_bucket_reduce": [_u32p] + [_vp] * 6 + [_ll, _ll, _vp],
        "crescent_fq2_bucket_reduce_fit": [_ll, _ll, _intp],
        "crescent_fq2_butterfly": [_u32p] + [_vp] * 5 + [_ll, _vp],
    },
}

_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a CUDA host")


def _so_path(name: str) -> str:
    h = hashlib.sha256()
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    ):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (process, tmp_path, so_path) or None."""
    so = _so_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", CSRC,
           "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so


def _finish(name: str, started) -> str:
    """Wait for one nvcc; raise with its output if it failed."""
    proc, tmp, so = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, so)
    return out


def build_all(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Build every library of `names` (default: all) not yet built, one nvcc
    per source, all at once.  Returns nvcc's output (register and spill
    report) per source built."""
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, s) for n, s in started.items() if s is not None}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        started = _start(name)
        if started is not None:
            _finish(name, started)
    lib = ctypes.CDLL(_so_path(name))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
