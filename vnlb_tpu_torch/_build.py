"""Build and load the port's CUDA kernels.

At first use the sources under ``csrc/`` are compiled with nvcc for
``sm_90a`` into one shared library with a plain C interface, written to
``build/vnlb_tpu_torch/`` at the repository root and loaded with ctypes.
The library's file name carries a hash of the sources, so an edited kernel
is rebuilt and a stale library is never loaded.  Nothing here runs at
import time.
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
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the exported functions: (argtypes, restype).  Every
# launcher returns the cudaError_t of its launch as an int.
SIGNATURES = {
    "vnlb_patch_dist": ([_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _P, _P], _I),
    "vnlb_econ_filter": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                          _F, _F, _F, _F, _F, _I, _P], _I),
    "vnlb_econ_filter_smem": ([_I, _I], ctypes.c_longlong),
}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvnlb_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the sources if their library is missing; returns (path,
    seconds spent compiling, 0.0 when the library already existed)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr)
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
