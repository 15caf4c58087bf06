"""K5's batched design on a stale workspace, for chip_smoke.py and the
card tests: does the output depend on what its workspace held?"""

import torch

from ..ops import poly_filter as k5


def tcb_stale_workspace(xc: torch.Tensor, xn: torch.Tensor, cfg) -> dict:
    """Launch the batched ("tcb") design on (G, K, p) f32 CUDA groups three
    times: on a fresh workspace; on the block of a freed workspace of 0xFF
    bytes (NaN as f32 and as bf16), which the caching allocator hands back;
    and with the wrapper's own workspace.  Returns the three outputs as
    ``fresh``, ``stale`` and ``own``, ``reused`` (the stale workspace has
    the poisoned block's ``data_ptr``) and ``ws_bytes``."""
    g, k, p = xc.shape
    n = k5.tcb_plan(g, k, p, cfg.poly_bf16)["ws_bytes"]
    dev = xc.device
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    ws = torch.empty((n,), dtype=torch.uint8, device=dev)
    fresh = k5.poly_filter_kernel(xc, xn, cfg, _workspace=ws)
    torch.cuda.synchronize(dev)
    del ws
    poison = torch.full((n,), 0xFF, dtype=torch.uint8, device=dev)
    ptr = poison.data_ptr()
    torch.cuda.synchronize(dev)
    del poison
    ws = torch.empty((n,), dtype=torch.uint8, device=dev)
    reused = ws.data_ptr() == ptr
    stale = k5.poly_filter_kernel(xc, xn, cfg, _workspace=ws)
    own = k5.poly_filter_kernel(xc, xn, cfg)
    torch.cuda.synchronize(dev)
    return dict(fresh=fresh, stale=stale, own=own, reused=reused,
                ws_bytes=n)
