"""Build and load the port's CUDA kernels.

At first use the sources under ``csrc/`` (``*.cu``; the ``*.cuh`` headers
they include are not compiled alone) are compiled with nvcc for
``sm_90a``, one nvcc per source in parallel, and linked into one shared
library with a plain C interface, written to
``build/vnlb_tpu_torch/`` at the repository root and loaded with ctypes.
The library's file name carries a hash of the sources and headers, so an
edited kernel is rebuilt and a stale library is never loaded.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "vnlb_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the exported functions: (argtypes, restype).  Every
# launcher returns the cudaError_t of its launch as an int.
SIGNATURES = {
    "vnlb_patch_dist": ([_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                         _I, _I, _I, _I, _P, _P], _I),
    "vnlb_patch_dist_tile": ([_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _P, _P], _I),
    "vnlb_patch_dist_plan": ([_I, _I, _I, _I, _P], _I),
    "vnlb_econ_filter": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                          _F, _F, _F, _F, _F, _I, _P, _P], _I),
    "vnlb_econ_filter_ws": ([_I, _I, _I], ctypes.c_longlong),
    "vnlb_econ_filter_tc": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                             _F, _F, _F, _F, _F, _P], _I),
    "vnlb_econ_filter_tc_plan": ([_I, _I, _P, _P], _I),
    "vnlb_econ_filter_tcw": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                              _F, _F, _F, _F, _F, _I, _P], _I),
    "vnlb_econ_filter_tcw_plan": ([_I, _I, _I, _P, _P], _I),
    "vnlb_econ_filter_tcg": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                              _P, _F, _F, _F, _F, _F, _I, _P], _I),
    "vnlb_econ_filter_tcg_plan": ([_I, _I, _I, _P, _P], _I),
    "vnlb_poly_filter": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                          _F, _F, _F, _F, _F, _F, _I, _P, _P], _I),
    "vnlb_poly_filter_ws": ([_I, _I, _I], ctypes.c_longlong),
    "vnlb_poly_filter_tc": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                             _F, _F, _F, _F, _F, _F, _I, _P], _I),
    "vnlb_poly_filter_tc_plan": ([_I, _I, _I, _P, _P], _I),
    "vnlb_poly_filter_tcb": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                              _P, _F, _F, _F, _F, _F, _F, _I, _P,
                              ctypes.c_longlong, _P], _I),
    "vnlb_poly_filter_tcb_plan": ([_I, _I, _I, _I, _P], _I),
    "vnlb_patch_gather": ([_P, _P, _I, _I, _I, _I, _P, ctypes.c_longlong,
                           _I, _I, _I, _P, _P, _P], _I),
    "vnlb_dense_dist": ([_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
                        _I),
    "vnlb_dense_dist_plan": ([_I, _I, _I, _I, _I, _I, _P], _I),
    "vnlb_scatter_rows": ([_P, _I, _P, ctypes.c_longlong, ctypes.c_longlong,
                           _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P,
                           _I, _I, _P], _I),
}


def _sources():
    """The translation units; each is compiled on its own."""
    return sorted(CSRC.glob("*.cu"))


def _headers():
    """Headers the sources include; never compiled alone."""
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvnlb_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the sources if their library is missing; returns (path,
    seconds spent compiling, 0.0 when the library already existed).

    One nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    ptxas = ["-Xptxas=-v"] if verbose else []
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *ptxas, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((src.name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    failed = []
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{err}")
        elif verbose and err:
            print(err)
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
