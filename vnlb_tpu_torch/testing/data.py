"""Synthetic clips (numpy copies of vnlb_tpu/testing/data.py), so a run on
a machine without jax can build the same inputs from the same seeds."""

from __future__ import annotations

import numpy as np


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
