"""ctypes driver of the C++ oracle, and the passes composed from its ops
(the port's copy of vnlb_tpu/testing/oracle.py).

The oracle (``vnlb_tpu_torch/oracle/vnlb_oracle.cpp``, a byte copy of
``vnlb_tpu/oracle/vnlb_oracle.cpp``) is a sequential double-precision
implementation of every compute op of a pass: colour transform, lattice,
search, gather, flat areas, Bayes filter (Jacobi eigh) and aggregation.
``oracle_proc_nl`` composes them into one pass and ``oracle_denoise`` into
both.  The functions take the port's ``StageConfig`` / ``VnlbConfig`` (or
any object with its fields) and take and return numpy arrays, as the JAX
driver's do.  The oracle releases the GIL while it runs (ctypes), so a
thread can run it beside work on the card.

At first use ``lib()`` compiles the source with g++ into
``build/vnlb_tpu_torch/`` at the repository root.  The library's name
carries a hash of the source and the flags, so a stale library is never
loaded; each process compiles to a name of its own and renames it into
place, so processes that build at once all load a whole library.  A failed
build raises.  Nothing runs at import.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .. import _build

SRC = Path(__file__).resolve().parent.parent / "oracle" / "vnlb_oracle.cpp"
BUILD_DIR = _build.BUILD_DIR
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return Path(BUILD_DIR) / f"libvnlb_oracle_{h.hexdigest()[:16]}.so"


def _build_lib(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}) on {SRC}:\n"
                           f"{res.stderr}")
    os.replace(tmp, out)


def lib() -> ct.CDLL:
    """The loaded oracle library (built on first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build_lib(path)
        L = ct.CDLL(str(path))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i = ct.c_int
        d = ct.c_double
        f = ct.c_float

        L.vnlb_rgb2yuv.argtypes = [f32p, i, i, i, i]
        L.vnlb_yuv2rgb.argtypes = [f32p, i, i, i, i]
        L.vnlb_lattice.argtypes = [u8p, i, i, i, i, i, i, i]
        L.vnlb_lattice.restype = i
        L.vnlb_search.argtypes = [f32p, i, i, i, i, f32p, f32p, i32p, i,
                                  i, i, i, i, i, i, i, f, i, f32p, i32p]
        L.vnlb_fill_patches.argtypes = [f32p, i, i, i, i, i32p, i, i, i, i,
                                        f32p]
        L.vnlb_flat.argtypes = [f32p, i, i, i, i, i, d, d, u8p]
        L.vnlb_bayes.argtypes = [f32p, f32p, u8p, i, i, i, i, i, i, d, d, d,
                                 i]
        L.vnlb_agg.argtypes = [f32p, i32p, u8p, i, i, i, i, i, i, i, i,
                               f32p, f32p]
        _lib = L
        return L


def oracle_rgb2yuv(video):
    v = np.ascontiguousarray(video, np.float32).copy()
    lib().vnlb_rgb2yuv(v, *v.shape)
    return v


def oracle_yuv2rgb(video):
    v = np.ascontiguousarray(video, np.float32).copy()
    lib().vnlb_yuv2rgb(v, *v.shape)
    return v


def oracle_lattice(shape, cfg):
    t, c, h, w = shape
    mask = np.zeros((t, h, w), np.uint8)
    lib().vnlb_lattice(mask, t, c, h, w, cfg.ps, cfg.pt, cfg.step_s)
    return mask.astype(bool)


def oracle_search(video, sites, fflow, bflow, cfg):
    video = np.ascontiguousarray(video, np.float32)
    sites = np.ascontiguousarray(sites, np.int32)
    fflow = np.ascontiguousarray(fflow, np.float32)
    bflow = np.ascontiguousarray(bflow, np.float32)
    b = sites.shape[0]
    vals = np.zeros((b, cfg.npatches), np.float32)
    inds = np.zeros((b, cfg.npatches), np.int32)
    scales = cfg.needle_scales if cfg.stype == "needle" else 1
    lib().vnlb_search(video, *video.shape, fflow, bflow, sites, b,
                      cfg.ps, cfg.pt, cfg.dist_chnls, cfg.w_s,
                      cfg.nwt_b, cfg.nwt_f, cfg.npatches,
                      cfg.offset, scales, vals, inds)
    return vals, inds


def oracle_fill_patches(video, inds, pt, ps):
    """(B, K, pt, C, ps, ps) patches at the clipped corners of ``inds``."""
    video = np.ascontiguousarray(video, np.float32)
    inds = np.ascontiguousarray(inds, np.int32)
    b, k = inds.shape
    t, c, h, w = video.shape
    out = np.zeros((b, k, pt, c, ps, ps), np.float32)
    lib().vnlb_fill_patches(video, t, c, h, w, inds, b, k, pt, ps, out)
    return out


def oracle_flat(pnoisy, gamma, sigma2):
    pnoisy = np.ascontiguousarray(pnoisy, np.float32)
    b, k, pt, c, ps, _ = pnoisy.shape
    flags = np.zeros((b,), np.uint8)
    lib().vnlb_flat(pnoisy, b, k, pt, c, ps, gamma, sigma2, flags)
    return flags.astype(bool)


def oracle_bayes(pnoisy, pbasic, flat, cfg):
    pnoisy = np.ascontiguousarray(pnoisy, np.float32).copy()
    b, k, pt, c, ps, _ = pnoisy.shape
    if pbasic is None:
        pbasic = np.zeros_like(pnoisy)
    if flat is None:
        flat = np.zeros((b,), np.uint8)
    lib().vnlb_bayes(pnoisy, np.ascontiguousarray(pbasic, np.float32),
                     np.ascontiguousarray(flat, np.uint8), b, k, pt, c, ps,
                     cfg.rank, cfg.sigma2, cfg.sigmab2, cfg.thresh, cfg.step)
    return pnoisy


def oracle_agg(deno, weights, patches, inds, valid, pt, ps):
    t, c, h, w = deno.shape
    patches = np.ascontiguousarray(patches, np.float32)
    inds = np.ascontiguousarray(inds, np.int32)
    b, k = inds.shape
    valid = np.ascontiguousarray(
        np.broadcast_to(valid.reshape(b, -1), (b, k)), np.uint8) \
        if valid is not None else np.ones((b, k), np.uint8)
    lib().vnlb_agg(patches, inds, valid, b, k, pt, c, ps, t, h, w,
                   deno, weights)
    return deno, weights


def oracle_proc_nl(noisy, basic, fflow, bflow, cfg, bsize=64):
    """One pass composed from the native ops (as vnlb_tpu/pipeline.py and
    the port's pipeline.py order them)."""
    shape = noisy.shape
    t, c, h, w = shape
    noisy_yuv = oracle_rgb2yuv(noisy)
    basic_yuv = oracle_rgb2yuv(basic) if basic is not None else noisy_yuv
    srch = {"noisy": noisy_yuv, "basic": basic_yuv}[cfg.srch_img]

    mask = oracle_lattice(shape, cfg)
    sites = np.argwhere(mask).astype(np.int32)

    deno = np.zeros((t, c, h, w), np.float32)
    weights = np.zeros((t, h, w), np.float32)
    for s0 in range(0, sites.shape[0], bsize):
        sb = sites[s0:s0 + bsize]
        vals, inds = oracle_search(srch, sb, fflow, bflow, cfg)
        pnoisy = oracle_fill_patches(noisy_yuv, inds, cfg.pt, cfg.ps)
        if cfg.deno == "bayes":
            if cfg.step == 1:
                pbasic = oracle_fill_patches(basic_yuv, inds, cfg.pt, cfg.ps)
                flat = (oracle_flat(pnoisy, cfg.gamma, cfg.sigma2)
                        if cfg.flat_areas else np.zeros(sb.shape[0], np.uint8))
                pfilt = oracle_bayes(pnoisy, pbasic, flat.astype(np.uint8),
                                     cfg)
            else:
                pfilt = oracle_bayes(pnoisy, None, None, cfg)
        else:
            pfilt = pnoisy
        oracle_agg(deno, weights, pfilt, inds, None, cfg.pt, cfg.ps)

    wpos = weights > 0
    out = deno.copy()
    for ci in range(c):
        ch = out[:, ci]
        ch[wpos] /= weights[wpos]
        fb = basic_yuv[:, ci] if cfg.step == 1 else noisy_yuv[:, ci]
        ch[~wpos] = fb[~wpos]
        out[:, ci] = ch
    return oracle_yuv2rgb(out)


def oracle_denoise(noisy, sigma, cfg2, fflow=None, bflow=None):
    """Both passes (as the port's ``api.denoise``); returns (deno, basic)."""
    t = noisy.shape[0]
    if fflow is None:
        fflow = np.zeros((t, 2) + noisy.shape[2:], np.float32)
    if bflow is None:
        bflow = np.zeros_like(fflow)
    basic = oracle_proc_nl(noisy, None, fflow, bflow, cfg2.stage(0))
    deno = oracle_proc_nl(noisy, basic, fflow, bflow, cfg2.stage(1))
    return deno, basic
