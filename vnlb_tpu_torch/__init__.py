"""vnlb_tpu_torch: the Video Non-Local Bayes denoiser of ``vnlb_tpu`` ported
to PyTorch, with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

The port imports torch and never jax.  Its kernels (``csrc/*.cu``) build at
first use with nvcc (``_build.py``); every kernel wrapper dispatches by
device: a CPU tensor takes the plain PyTorch version, a CUDA tensor
launches the kernel or raises.

Ported so far: the two-pass ``denoise`` of every preset (the API default
``iphone``: step 3, sliding borders, needle search in the first pass;
``default``, ``exp``, ``sss``, ``sss_v2``) and the ``border_mode="mask"``
bench config, with zero or user-given flow, both dense row modes (the
lattice-row search on K1, ``dense_rows="full"`` on K3), every top-K mode
and every Bayes-filter mode (``eig_method`` poly / xla / jacobi /
rational, the econ and two-factor polynomial filters, ``couple_channels``,
``deno="ave"``), ``denoise_streaming``, ``denoise_mod``, the cached-result
readers ``proc_nl_cache`` and ``proc_nn``, and ``parallel/`` over
``torch.distributed``: the halo-sharded pass on K1's tile entry
(``denoise_halo``, ``proc_nl_halo``, ``strip_runner``,
``denoise_streaming(mesh=...)``), site parallelism (``denoise_sharded``),
the filter batch split (``bayes_denoise_tp``) and ``denoise_pipelined``
over two devices or over two stage groups of one world (``meshes=``,
``parallel.pipe.stage_meshes``); every aggregation mode (``agg_weight="exp"``,
``only_frame``, ``agg_bf16``) and the econ filter's left regime
(``poly_gram=False``); optical-flow estimation
(``vnlb_tpu_torch.ops.flow.estimate_flows``: TV-L1 or Lucas-Kanade) and
``.flo`` IO (``utils/flow_io.py``); the reference-order pass
(``vnlb_tpu_torch.compat.denoise_compat``); the helpers of
``vnlb_tpu.utils`` (``vnlb_tpu_torch.utils``), the dataset registry
(``testing.data.load_dataset``) and ``viz.plot_patch_group``.
"""

from .api import (denoise, denoise_mod, denoise_streaming, proc_nl_cache,
                  proc_nn)
from .config import StageConfig, VnlbConfig, config_from_jax, default_config
from .pipeline import KERNELS, PLAIN, Kernels, proc_nl

__version__ = "0.1.0"

__all__ = [
    "denoise", "denoise_mod", "denoise_streaming", "proc_nl",
    "proc_nl_cache", "proc_nn", "StageConfig", "VnlbConfig",
    "default_config", "config_from_jax", "Kernels", "KERNELS", "PLAIN",
]
