"""Flow IO and plumbing (numpy copy of vnlb_tpu/utils/flow_io.py:21-121).

Flows are float32 arrays of shape (T, 2, H, W): channel 0 = u (+x), channel
1 = v (+y).  ``fflow[i]`` maps frame i to frame i+1, ``bflow[i]`` frame i to
frame i-1.  ``read_flo`` / ``write_flo`` read and write Middlebury ``.flo``
files (one (2, h, w) flow each), the form in which the reference takes its
flows; ``flow_to_image`` renders a flow on the Baker et al. colour wheel.
"""

from __future__ import annotations

import numpy as np

_FLO_MAGIC = 202021.25


def read_flo(path) -> np.ndarray:
    """Read a Middlebury .flo file -> (2, h, w) float32 (u, v)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)[0]
        if not np.isclose(magic, _FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    flow = data.reshape(h, w, 2)
    return np.ascontiguousarray(flow.transpose(2, 0, 1))


def write_flo(path, flow: np.ndarray):
    """Write (2, h, w) float32 flow to a Middlebury .flo file."""
    if flow.ndim != 3 or flow.shape[0] != 2:
        raise ValueError(f"flow must be (2, h, w), got {flow.shape}")
    _, h, w = flow.shape
    with open(path, "wb") as f:
        np.float32(_FLO_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        np.ascontiguousarray(flow.transpose(1, 2, 0)).astype(
            np.float32).tofile(f)


def expand_flows(fflow: np.ndarray, bflow: np.ndarray, axis: int = 0):
    """Edge-replicate (T-1)-frame flow stacks to T frames: the last forward
    flow and the first backward flow are repeated."""
    if axis == 0:
        fflow = np.concatenate([fflow, fflow[-1:]], axis=0)
        bflow = np.concatenate([bflow[:1], bflow], axis=0)
    elif axis == 1:
        fflow = np.concatenate([fflow, fflow[:, -1:]], axis=1)
        bflow = np.concatenate([bflow[:, :1], bflow], axis=1)
    else:
        raise ValueError(f"invalid axis {axis}")
    return fflow, bflow


def zero_flows(shape, dtype=np.float32):
    """Zero fflow/bflow for a (t, c, h, w) video (reference alloc.py:66-72)."""
    t, _, h, w = shape
    return (np.zeros((t, 2, h, w), dtype),
            np.zeros((t, 2, h, w), dtype))


# ---------------------------------------------------------------------------
# Color-wheel visualization (Baker et al. convention)
# ---------------------------------------------------------------------------

def _make_colorwheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray, max_flow: float | None = None
                  ) -> np.ndarray:
    """(2, h, w) flow -> (h, w, 3) uint8 color-wheel image."""
    u, v = flow[0], flow[1]
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max_flow if max_flow else max(rad.max(), 1e-8)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u ** 2 + v ** 2)
    wheel = _make_colorwheel()
    ncols = wheel.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(u.shape + (3,), dtype=np.uint8)
    for ci in range(3):
        col0 = wheel[k0, ci] / 255.0
        col1 = wheel[k1, ci] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., ci] = np.floor(255 * col)
    return img
