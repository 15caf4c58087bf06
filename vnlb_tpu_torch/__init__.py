"""vnlb_tpu_torch: the Video Non-Local Bayes denoiser of ``vnlb_tpu`` ported
to PyTorch, with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

The port imports torch and never jax.  Its kernels (``csrc/*.cu``) build at
first use with nvcc (``_build.py``); every kernel wrapper dispatches by
device: a CPU tensor takes the plain PyTorch version, a CUDA tensor
launches the kernel or raises.

Ported so far: the two-pass ``denoise`` of the JAX API default (preset
iphone: step 3, sliding borders, needle search in the first pass) and the
``border_mode="mask"`` bench config, with zero or user-given flow, the
exact top-K and the econ polynomial filter.  Other configurations raise
NotImplementedError naming their ROADMAP item.
"""

from .api import denoise
from .config import StageConfig, VnlbConfig, config_from_jax, default_config
from .pipeline import KERNELS, PLAIN, Kernels, proc_nl

__version__ = "0.1.0"

__all__ = [
    "denoise", "proc_nl", "StageConfig", "VnlbConfig", "default_config",
    "config_from_jax", "Kernels", "KERNELS", "PLAIN",
]
