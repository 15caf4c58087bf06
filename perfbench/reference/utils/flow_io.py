"""``expand_flows``, frozen from vnlb_tpu_torch/utils/flow_io.py."""

from __future__ import annotations

import numpy as np


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
