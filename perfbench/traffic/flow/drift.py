"""Flow ``drift``: the exact flows of ``synthetic_video``'s texture drift
(a frozen copy of vnlb_tpu_torch/testing/data.py's ``drift_flows``), passed
as user flows, host numpy, as ``.flo`` files give them.  The moving square
is not tracked.

Mix keys: ``motion``, as the content's."""

import numpy as np


def make(mix: dict, clean: np.ndarray):
    """(fflow, bflow), each (T-1, 2, H, W) float32, u then v."""
    t, _, h, w = clean.shape
    motion = float(mix["motion"])
    dy = np.array([round(motion * i) for i in range(t)], np.float32)
    dx = np.array([round(0.5 * motion * i) for i in range(t)], np.float32)
    fflow = np.zeros((t - 1, 2, h, w), np.float32)
    fflow[:, 0] = (dx[:-1] - dx[1:])[:, None, None]
    fflow[:, 1] = (dy[:-1] - dy[1:])[:, None, None]
    return fflow, -fflow
