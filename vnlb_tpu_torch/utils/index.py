"""Flat index codec: a patch corner (t, y, x) of a (T, C, H, W) video is
``t*C*H*W + y*W + x`` (the temporal stride includes the colour planes),
int32 with -1 for an invalid entry, as in vnlb_tpu/utils/index.py."""

from __future__ import annotations


def check_codec_range(shape) -> None:
    """Fail loudly when flat indices would overflow int32."""
    t_len, c, h, w = shape
    if t_len * c * h * w >= 2 ** 31:
        raise ValueError(
            f"video of shape {tuple(shape)} overflows the int32 flat-index "
            f"codec (t*c*h*w = {t_len * c * h * w} >= 2^31); denoise in "
            f"temporal chunks")
