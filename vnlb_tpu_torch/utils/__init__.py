"""Helpers of the port (vnlb_tpu/utils/__init__.py's exports): the flat
index codec, PSNR and SSIM, timing, the program's spans and logging."""

from .index import coords2idx, idx2coords, idx2coords_full  # noqa: F401
from .metrics import compute_psnr, compute_psnrs, compute_ssim  # noqa: F401
from .timer import Timer, span, span_names, sync, trace  # noqa: F401
from .logger import Logger, vprint  # noqa: F401
