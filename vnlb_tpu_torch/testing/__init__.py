"""Subpackage of vnlb_tpu_torch."""
