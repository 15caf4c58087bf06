"""Patch-group plots (vnlb_tpu/viz/)."""

from .explore_gp import plot_patch_group  # noqa: F401
