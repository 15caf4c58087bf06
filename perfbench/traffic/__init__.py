"""Clip pools made from a seed (``generator``) and the traffic mixes that
parameterize them (``<traffic>.json`` beside it)."""
