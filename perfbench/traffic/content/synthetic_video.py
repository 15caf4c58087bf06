"""Content ``synthetic_video``: a frozen copy of
vnlb_tpu_torch/testing/data.py's ``synthetic_video`` (the same arithmetic;
the random stream comes from the generator the caller seeds), so later
changes to the program's test data do not move the benchmark's inputs.

Mix keys: ``motion``, the texture's drift in pixels per frame."""

import numpy as np


def make(mix: dict, t: int, h: int, w: int,
         rng: np.random.Generator) -> np.ndarray:
    """Deterministic moving-texture clip, (t, 3, h, w) float32 in [0, 255]:
    band-limited random texture under a constant sub-pixel drift plus a
    moving bright square."""
    motion = float(mix["motion"])
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
