"""Patch-group inspection plots (copy of vnlb_tpu/viz/explore_gp.py).

Plots the per-patch signals of a group as overlaid traces: how tight a
non-local group is and what the Bayes filter removes.  Matplotlib is
imported inside the function, so the package does not need it.
"""

from __future__ import annotations

import numpy as np


def plot_patch_group(patches, filtered=None, path="output/patch_group.png",
                     max_traces=32):
    """patches: (K, pt, c, ps, ps) one group; optional filtered counterpart.

    Saves a figure of the flattened per-patch signals (and the filtered
    signals when given).  Returns the save path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from pathlib import Path

    patches = np.asarray(patches)
    k = min(patches.shape[0], max_traces)
    sig = patches[:k].reshape(k, -1)

    nrows = 2 if filtered is not None else 1
    fig, axes = plt.subplots(nrows, 1, figsize=(10, 3 * nrows), squeeze=False)
    for i in range(k):
        axes[0, 0].plot(sig[i], lw=0.5, alpha=0.6)
    axes[0, 0].plot(sig.mean(0), "k-", lw=1.5, label="group mean")
    axes[0, 0].set_title(f"patch group signals (K={patches.shape[0]})")
    axes[0, 0].legend()

    if filtered is not None:
        fsig = np.asarray(filtered)[:k].reshape(k, -1)
        for i in range(k):
            axes[1, 0].plot(fsig[i], lw=0.5, alpha=0.6)
        axes[1, 0].plot(fsig.mean(0), "k-", lw=1.5)
        axes[1, 0].set_title("filtered")

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
