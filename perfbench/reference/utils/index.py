"""Flat index codec: a patch corner (t, y, x) of a (T, C, H, W) video is
``t*C*H*W + y*W + x`` (the temporal stride includes the colour planes),
int32 with -1 for an invalid entry, as in vnlb_tpu/utils/index.py.  The
codec functions are plain arithmetic: they take torch tensors, numpy
arrays or Python ints alike."""

from __future__ import annotations


def check_codec_range(shape) -> None:
    """Fail loudly when flat indices would overflow int32."""
    t_len, c, h, w = shape
    if t_len * c * h * w >= 2 ** 31:
        raise ValueError(
            f"video of shape {tuple(shape)} overflows the int32 flat-index "
            f"codec (t*c*h*w = {t_len * c * h * w} >= 2^31); denoise in "
            f"temporal chunks")


def coords2idx(t, y, x, c: int, h: int, w: int):
    return t * (c * h * w) + y * w + x


def idx2coords(idx, c: int, h: int, w: int):
    chw = c * h * w
    hw = h * w
    t = idx // chw
    y = (idx % hw) // w
    x = idx % w
    return t, y, x


def idx2coords_full(idx, c: int, h: int, w: int):
    """Also recover the colour plane."""
    chw = c * h * w
    hw = h * w
    t = idx // chw
    ci = (idx % chw) // hw
    y = (idx % hw) // w
    x = idx % w
    return t, ci, y, x
