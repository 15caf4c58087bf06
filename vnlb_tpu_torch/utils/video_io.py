"""Video / image IO.

Parity targets: reference lib/vnlb/utils/video_io.py:14-66 (frame-sequence
reading, burst/image/npy saving) and the cached-result readers (:85-175),
re-homed here without the reference's hardcoded home-directory paths: all
cache roots come from arguments or the VNLB_TPU_CACHE environment variable.

Frames are float32 (t, c, h, w) RGB in [0, 255].
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def _imread(path) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
    return img.transpose(2, 0, 1)  # (c, h, w)


def _imwrite(path, img: np.ndarray):
    from PIL import Image

    img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 3:
        img = img.transpose(1, 2, 0)
    Image.fromarray(img).save(path)


def read_video_sequence(path, nframes: int = -1, ext: str = "png",
                        fstart: int = 0) -> np.ndarray:
    """Read ``%03d.<ext>``-style frame sequences into (t, c, h, w)."""
    path = Path(path)
    frames = []
    idx = fstart
    while nframes < 0 or len(frames) < nframes:
        hits = [path / ("%03d.%s" % (idx, ext)), path / ("%05d.%s" % (idx, ext))]
        hit = next((p for p in hits if p.exists()), None)
        if hit is None:
            if nframes >= 0:
                raise FileNotFoundError(f"missing frame {idx} under {path}")
            break
        frames.append(_imread(hit))
        idx += 1
    if not frames:
        raise FileNotFoundError(f"no frames found under {path}")
    return np.stack(frames)


def save_burst(burst, path, name: str = "frame", fstart: int = 0,
               ext: str = "png"):
    """Save (t, c, h, w) as individual frames; returns written paths."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    burst = np.asarray(burst)
    out = []
    for ti in range(burst.shape[0]):
        p = path / ("%s_%03d.%s" % (name, ti + fstart, ext))
        _imwrite(p, burst[ti])
        out.append(p)
    return out


def save_image(image, path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    _imwrite(path, np.asarray(image))


def save_numpy(arr, path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.asarray(arr))


def cache_root() -> Path:
    return Path(os.environ.get("VNLB_TPU_CACHE", Path.home() / ".cache/vnlb_tpu"))


def _seq_cache_dir(method: str, vid_set: str, vid_name: str, sigma) -> Path:
    return cache_root() / "results" / method / vid_set / vid_name / str(int(sigma))


def save_result_sequence(deno, method: str, vid_set: str, vid_name: str, sigma):
    """Persist a denoised sequence (png + npy) into the result cache.

    Replaces the reference's ad-hoc per-script output dirs; keyed by
    (method, set, video, sigma) as SURVEY.md §5 prescribes.
    """
    d = _seq_cache_dir(method, vid_set, vid_name, sigma)
    d.mkdir(parents=True, exist_ok=True)
    deno = np.asarray(deno)
    np.save(d / "deno.npy", deno)
    save_burst(deno, d, "deno")
    return d


def read_result_sequence(method: str, vid_set: str, vid_name: str, sigma):
    """Read a cached result; returns None when absent."""
    d = _seq_cache_dir(method, vid_set, vid_name, sigma)
    f = d / "deno.npy"
    if not f.exists():
        return None
    return np.load(f)


# -- NN-interop readers (reference video_io.py:85-175: vnlb / udvd / pacnet) --

def read_nl_sequence(vid_set, vid_name, sigma):
    return read_result_sequence("vnlb", vid_set, vid_name, sigma)


def read_udvd_sequence(vid_set, vid_name, sigma):
    return read_result_sequence("udvd", vid_set, vid_name, sigma)


def read_pacnet_sequence(vid_set, vid_name, sigma):
    return read_result_sequence("pacnet", vid_set, vid_name, sigma)
