"""Build and load the port's CUDA kernels (ogc_tpu_torch/csrc/*.cu).

At first use, one nvcc process per source compiles it to an object, all
of them started together, and a last nvcc links the objects into one shared
library with a plain C interface,
``ogc_tpu_torch/_build/libogc_kernels-<hash>.so``, keyed by a hash of the
sources and the headers they include (csrc/*.cuh); ctypes loads it.  No
PyTorch headers are included, so a build takes seconds.  There is no
fallback: a failed build raises.  Builds take an exclusive file lock on
``_build/.lock``, so processes that start together (the ranks of a
data-parallel run) compile once: the first builds, the others wait and
find the library.  ``empty`` and ``raw_stream`` serve the wrappers'
launches.

Flags: ``sm_90a`` (Hopper), ``-O3``, no ``--use_fast_math`` (``sqrtf`` stays
correctly rounded), and ``-fmad=false`` on top of the ``__fmul_rn`` /
``__fadd_rn`` pins in the distance expressions, so no FMA contraction can
change a distance and with it a neighbour's tie order.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading
import time

import torch

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
_L = ctypes.c_longlong
# C entry points: name -> argtypes (all return int = cudaError_t).
_SIGNATURES = {
    "ogc_fps": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "ogc_knn_exact": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "ogc_ball_query": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P],
    "ogc_knn_blockmin": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                         _P],
    "ogc_scatter_csr": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "ogc_scatter_accumulate": [_P, _P, _P, _I, _I, _I, _P, _P],
    "ogc_scatter_add_rows": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P, _P, _P],
    "ogc_gather_rows_onehot": [_P, _P, _I, _I, _I, _I, _P, _P],
    "ogc_scatter_add_rows_onehot": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P],
    "ogc_rowgroup_pool": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "ogc_knn_exact_pruned": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P, _P, _P],
    "ogc_pruned_sort": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P],
    "ogc_pruned_select": [_P, _P, _I, _I, _I, _I, _P, _I, _I, _F, _I, _P, _P,
                          _P, _P, _P],
    "ogc_bs_gather": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                      _P],
    "ogc_bs_scatter": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P],
    "ogc_knn_cand": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _P, _P, _P],
    "ogc_iou_match": [_P, _P, _I, _I, _I, _P, _P],
    "ogc_affine_relu": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P, _P],
}

_get_fill = torch._C._get_deterministic_fill_uninitialized_memory
_set_fill = torch._C._set_deterministic_fill_uninitialized_memory
_lock = threading.Lock()
_lib = None
_devices = {}
#: Seconds the last build took (0.0 when the library came from the cache).
build_seconds = 0.0


def _sources():
    return sorted(glob.glob(osp.join(CSRC_DIR, "*.cu")))


def _headers():
    return sorted(glob.glob(osp.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and osp.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        with open(src, "rb") as f:
            h.update(osp.basename(src).encode())
            h.update(f.read())
    return osp.join(BUILD_DIR, f"libogc_kernels-{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _build_lock():
    """Hold the build directory's exclusive lock (released when the process
    ends, whatever the way)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(osp.join(BUILD_DIR, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> str:
    """Compile the kernels if the cached library is missing; return its
    path.  Under the build lock: a process that waited finds the library
    another one built."""
    out = library_path()
    if osp.exists(out):
        return out
    with _build_lock():
        if not osp.exists(out):
            _compile(out)
    return out


def _compile(out: str) -> None:
    global build_seconds
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


def _load(path: str, whole: bool = True) -> ctypes.CDLL:
    """A built library with its entry points typed: every one of them
    (``whole``; a missing one raises) or those it holds."""
    handle = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name) if whole else getattr(handle, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return handle


def variants(specs):
    """Each (source, defines) of ``specs`` built alone, ``-D`` each define,
    into a library of its own in BUILD_DIR (keyed by a hash as
    ``library_path`` is), all nvcc processes started together; returns the
    loaded libraries in order.  chip_smoke.py's pruned_crossover times
    with these the launch sizes the library is not built with."""
    with _build_lock():
        paths = _compile_variants(specs)
    return [_load(path, whole=False) for path in paths]


def _compile_variants(specs) -> list:
    nvcc, paths, procs = _nvcc(), [], []
    try:
        for source, defines in specs:
            flags = NVCC_FLAGS + [f"-D{n}={v}"
                                  for n, v in sorted(defines.items())]
            src = osp.join(CSRC_DIR, source)
            h = hashlib.sha256(" ".join(flags).encode())
            for f in [src] + _headers():
                with open(f, "rb") as fh:
                    h.update(fh.read())
            out = osp.join(BUILD_DIR, f"libogc_{osp.splitext(source)[0]}-"
                           f"{h.hexdigest()[:16]}.so")
            paths.append(out)
            if osp.exists(out):
                continue
            cmd = [nvcc, *flags, "-shared", "-o", f"{out}.tmp", src]
            procs.append((cmd, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for cmd, out, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
            os.replace(f"{out}.tmp", out)
    finally:
        for _, out, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if osp.exists(f"{out}.tmp"):
                os.remove(f"{out}.tmp")
    return paths


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; later calls take no
    lock).  ctypes keeps each entry point's function object once fetched."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = _load(build())
    return _lib


def empty(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.empty`` for an output that a kernel writes whole: without the
    NaN fill that deterministic mode gives ``torch.empty``
    (``torch.utils.deterministic.fill_uninitialized_memory``), a pass over
    the output's memory and one more launch that would buy nothing.  The
    setting is process-wide and is restored at once.  ``device`` is a
    ``torch.device`` or a CUDA device index; the sizes go to ``torch.empty``
    as separate integers and the device as a cached object, the call form
    that costs the host least."""
    if isinstance(device, int):
        device = _devices.get(device) or _devices.setdefault(
            device, torch.device("cuda", device))
    if not _get_fill():
        return torch.empty(*shape, dtype=dtype, device=device)
    _set_fill(False)
    try:
        return torch.empty(*shape, dtype=dtype, device=device)
    finally:
        _set_fill(True)


def raw_stream(device: int) -> int:
    """The current CUDA stream of device ``device`` (an index) as an integer
    handle, without building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(device)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
