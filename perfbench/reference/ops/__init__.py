"""Frozen plain operations of the reference."""
