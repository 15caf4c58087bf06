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


def add_noise(clean: np.ndarray, sigma: float, seed: int = 123) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (clean + rng.normal(0.0, sigma, clean.shape)).astype(np.float32)
