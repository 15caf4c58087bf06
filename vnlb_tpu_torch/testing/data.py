"""Datasets and synthetic clips (numpy copies of vnlb_tpu/testing/data.py),
so a run on a machine without jax can build the same inputs from the same
seeds.

There is no download: ``load_dataset`` reads a local dataset root
(VNLB_TPU_DATA, else ``~/.cache/vnlb_tpu/data``) in the reference's layout
(frame sequences + sigma.txt) and otherwise generates the registered
synthetic stand-in; ``load_golden`` reads reference outputs when they are
on disk.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

DATASETS = {
    # name: (t, h, w) of the synthetic stand-in clip
    "davis_64x64": (5, 64, 64),
    "davis": (5, 480, 854),
    "gmobile": (5, 480, 854),
    "set8": (5, 480, 854),
    "cup_crop": (5, 256, 256),
}


def data_root() -> Path:
    return Path(os.environ.get("VNLB_TPU_DATA",
                               Path.home() / ".cache/vnlb_tpu/data"))


def synthetic_video(t: int, h: int, w: int, seed: int = 0,
                    motion: float = 1.5) -> np.ndarray:
    """Deterministic moving-texture clip, (t, 3, h, w) float32 in [0, 255]:
    band-limited random texture under a constant sub-pixel drift plus a
    moving bright square."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(motion * t)) + 8
    base = rng.uniform(0, 1, (3, h + 2 * pad, w + 2 * pad)).astype(np.float32)
    for _ in range(3):
        base = (np.roll(base, 1, -1) + base + np.roll(base, -1, -1)) / 3.0
        base = (np.roll(base, 1, -2) + base + np.roll(base, -2, -2)) / 3.0
    base = (base - base.min()) / (np.ptp(base) + 1e-8)

    frames = []
    for ti in range(t):
        dy = int(round(motion * ti))
        dx = int(round(0.5 * motion * ti))
        crop = base[:, pad + dy:pad + dy + h, pad + dx:pad + dx + w].copy()
        sy = (10 + 3 * ti) % max(h - 12, 1)
        sx = (14 + 2 * ti) % max(w - 12, 1)
        crop[:, sy:sy + 10, sx:sx + 10] = np.array([0.9, 0.7, 0.2])[:, None, None]
        frames.append(crop * 255.0)
    return np.stack(frames).astype(np.float32)


def drift_flows(t: int, h: int, w: int, motion: float = 1.5):
    """(T-1)-frame (fflow, bflow) stacks of ``synthetic_video``'s texture
    drift: frame i is the texture shifted by (dy_i, dx_i) = (round(motion*i),
    round(0.5*motion*i)), so fflow[i] = (dx_i - dx_{i+1}, dy_i - dy_{i+1})
    and the backward flow of frame i+1 is its negation.  The moving square
    is not tracked."""
    dy = np.array([round(motion * i) for i in range(t)], np.float32)
    dx = np.array([round(0.5 * motion * i) for i in range(t)], np.float32)
    fflow = np.zeros((t - 1, 2, h, w), np.float32)
    fflow[:, 0] = (dx[:-1] - dx[1:])[:, None, None]
    fflow[:, 1] = (dy[:-1] - dy[1:])[:, None, None]
    return fflow, -fflow


def synthetic_video_v2(t: int, h: int, w: int, seed: int = 0,
                       pan: float = 2.0) -> np.ndarray:
    """Second, structurally different synthetic clip: the content classes
    of the reference's real-frame protocol (docs/COMPARE.md) that
    ``synthetic_video`` lacks:

      * GLOBAL PAN: the whole scene translates by ``pan`` px/frame
        horizontally (+ pan/2 vertically) — flow-aware search matters;
      * FLAT GRADIENT REGIONS: a large smooth illumination ramp with no
        texture — exercises flat-area detection / basic centering;
      * HARD TEXT-LIKE EDGES: high-contrast glyph strokes — exercises
        edge preservation (where over-aggressive Wiener shrinkage smears);
      * OCCLUSION: a foreground block moving AGAINST the pan, so
        background patches appear/disappear — temporal matches must not
        hallucinate through the occluder.

    Returns (t, 3, h, w) float32 in [0, 255]; ground-truth background
    motion is exactly (round(pan*ti/2), round(pan*ti)) px at frame ti.
    """
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(abs(pan) * t)) + 8

    hp, wp = h + 2 * pad, w + 2 * pad
    yy = np.linspace(0, 1, hp, dtype=np.float32)[:, None]
    xx = np.linspace(0, 1, wp, dtype=np.float32)[None, :]
    # flat diagonal illumination ramp, per-channel gains
    ramp = 0.35 + 0.45 * (0.6 * yy + 0.4 * xx)
    base = np.stack([ramp * g for g in (1.0, 0.92, 0.80)]).astype(np.float32)
    # band-limited texture on the right half only (left half stays FLAT)
    tex = rng.uniform(-1, 1, (3, hp, wp)).astype(np.float32)
    for _ in range(2):
        tex = (np.roll(tex, 1, -1) + tex + np.roll(tex, -1, -1)) / 3.0
        tex = (np.roll(tex, 1, -2) + tex + np.roll(tex, -1, -2)) / 3.0
    xmask = (xx >= 0.5).astype(np.float32)
    base = np.clip(base + 0.12 * tex * xmask, 0.0, 1.0)
    # text-like strokes: thin high-contrast bars at irregular offsets
    for i in range(6):
        y0 = pad + (7 + 17 * i) % max(hp - 2 * pad - 4, 1) + 0
        x0 = pad + (11 + 23 * i) % max(wp - 2 * pad - 20, 1)
        ln = 8 + 3 * (i % 3)
        base[:, y0:y0 + 2, x0:x0 + ln] = 0.05 if i % 2 else 0.95

    frames = []
    for ti in range(t):
        dy = int(round(0.5 * pan * ti))
        dx = int(round(pan * ti))
        crop = base[:, pad + dy:pad + dy + h, pad + dx:pad + dx + w].copy()
        # occluder moving AGAINST the pan
        oy = (h // 3 - int(round(0.5 * pan * ti))) % max(h - 14, 1)
        ox = (w // 2 - int(round(pan * ti))) % max(w - 14, 1)
        crop[:, oy:oy + 12, ox:ox + 12] = \
            np.array([0.15, 0.55, 0.85])[:, None, None]
        frames.append(crop * 255.0)
    return np.stack(frames).astype(np.float32)


def add_noise(clean: np.ndarray, sigma: float, seed: int = 123) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (clean + rng.normal(0.0, sigma, clean.shape)).astype(np.float32)


def load_dataset(name: str, sigma: float = 20.0, seed: int = 0):
    """Returns dict(clean, noisy, std, fflow, bflow).

    Uses on-disk frames when available under ``data_root()/name``; otherwise
    generates the synthetic stand-in of the registered size.
    """
    root = data_root() / name
    if root.exists():
        from ..utils.video_io import read_video_sequence

        clean = read_video_sequence(root)
        std_file = root / "sigma.txt"
        std = float(std_file.read_text()) if std_file.exists() else sigma
    else:
        if name not in DATASETS:
            raise KeyError(f"unknown dataset [{name}]; "
                           f"registered: {sorted(DATASETS)}")
        t, h, w = DATASETS[name]
        clean = synthetic_video(t, h, w, seed=seed)
        std = sigma

    noisy = add_noise(clean, std, seed=seed + 1)
    t = clean.shape[0]
    fflow = np.zeros((t, 2) + clean.shape[2:], np.float32)
    bflow = np.zeros_like(fflow)
    return dict(clean=clean, noisy=noisy, std=std, fflow=fflow, bflow=bflow)


def _read_frame_seq(root: Path, pattern: str):
    """Read ``pattern % i`` frames (RGB, through ``utils.video_io``) until
    the first missing index; (T, 3, H, W) float32 or None."""
    from ..utils.video_io import _imread

    frames = []
    for i in range(10000):
        p = root / (pattern % i)
        if not p.exists():
            break
        frames.append(_imread(p))
    return np.stack(frames) if frames else None


def load_golden(name: str):
    """Load reference outputs under ``data_root()/name`` when present;
    None when absent.  Two layouts:

    * the ``.npy`` cache (``deno.npy`` / ``basic.npy`` / ``noisy.npy``);
    * the reference's tif layout: noisy ``%03d.tif``, basic
      ``bsic_%03d.tif``, denoised ``deno_%03d.tif``;

    and in both the TV-L1 flows ``tvl1_%03d_{f,b}.flo`` as (T, 2, H, W)
    stacks (vnlb_tpu's ``load_golden`` transposes ``read_flo``'s (2, H, W)
    once more, to (W, 2, H) a frame) and ``sigma.txt``.
    """
    root = data_root() / name
    out = {}
    if (root / "deno.npy").exists():
        out["deno"] = np.load(root / "deno.npy")
        for k in ("basic", "noisy"):
            f = root / f"{k}.npy"
            if f.exists():
                out[k] = np.load(f)
    else:
        deno = _read_frame_seq(root, "deno_%03d.tif") if root.exists() \
            else None
        if deno is None:
            return None
        out["deno"] = deno
        basic = _read_frame_seq(root, "bsic_%03d.tif")
        if basic is not None:
            out["basic"] = basic
        noisy = _read_frame_seq(root, "%03d.tif")
        if noisy is not None:
            out["noisy"] = noisy
    std_file = root / "sigma.txt"
    if std_file.exists():
        out["sigma"] = float(std_file.read_text())
    if (root / "tvl1_000_f.flo").exists():
        from ..utils.flow_io import read_flo

        ff, bf = [], []
        for i in range(out["deno"].shape[0]):
            fp = root / f"tvl1_{i:03d}_f.flo"
            bp = root / f"tvl1_{i:03d}_b.flo"
            if fp.exists():
                ff.append(read_flo(fp))
            if bp.exists():
                bf.append(read_flo(bp))
        if ff:
            out["fflow"] = np.stack(ff)
        if bf:
            out["bflow"] = np.stack(bf)
    return out
