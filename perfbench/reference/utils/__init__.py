"""Frozen helpers of the reference."""
