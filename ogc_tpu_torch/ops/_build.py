"""Build and load the port's CUDA kernels (ogc_tpu_torch/csrc/*.cu).

At first use, one nvcc process per source compiles it to an object, all
of them started together, and a last nvcc links the objects into one shared
library with a plain C interface,
``ogc_tpu_torch/_build/libogc_kernels-<hash>.so``, keyed by a hash of the
sources; ctypes loads it.  No PyTorch headers are included, so a build takes
seconds.  There is no fallback: a failed build raises.

Flags: ``sm_90a`` (Hopper), ``-O3``, no ``--use_fast_math`` (``sqrtf`` stays
correctly rounded), and ``-fmad=false`` on top of the ``__fmul_rn`` /
``__fadd_rn`` pins in the distance expressions, so no FMA contraction can
change a distance and with it a neighbour's tie order.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading
import time

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC_DIR = osp.join(_PKG, "csrc")
BUILD_DIR = osp.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (all return int = cudaError_t).
_SIGNATURES = {
    "ogc_fps": [_P, _I, _I, _I, _P, _P],
    "ogc_knn_exact": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "ogc_ball_query": [_P, _P, _I, _I, _I, _I, _F, _P, _P],
    "ogc_scatter_add_rows": [_P, _P, _P, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib = None
#: Seconds the last build took (0.0 when the library came from the cache).
build_seconds = 0.0


def _sources():
    return sorted(glob.glob(osp.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and osp.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(osp.basename(src).encode())
            h.update(f.read())
    return osp.join(BUILD_DIR, f"libogc_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if the cached library is missing; return its path."""
    global build_seconds
    out = library_path()
    if osp.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    try:
        for src in _sources():
            obj = f"{tmp}.{osp.basename(src)}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        # On a failed compile the other nvcc processes are stopped too.
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (*objs, tmp):
            if osp.exists(path):
                os.remove(path)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
