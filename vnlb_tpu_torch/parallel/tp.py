"""The Bayes filter's group batch split over the ranks of a mesh
(vnlb_tpu/parallel/tp.py).

The filter is independent per group, so the split is exact: every rank
passes the whole batch, filters its block (K2 / K5 on the card), and the
blocks are gathered back in rank order.  The batch is zero-padded to a
multiple of the world size; padded groups are filtered like real ones and
dropped.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import StageConfig
from ..ops.bayes import bayes_denoise
from .comm import Mesh, all_gather


def c_major(x: torch.Tensor) -> torch.Tensor:
    """(B, K, pt, c, ps, ps) patches -> the c-major rows (B, K, c,
    pt*ps*ps) that ``bayes_denoise`` takes; 4-D rows pass through."""
    if x.dim() == 4:
        return x
    b, k, pt, c, ps, _ = x.shape
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, k, c, pt * ps * ps)


def bayes_denoise_tp(pnoisy, pbasic, flat, cfg: StageConfig, mesh: Mesh
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ops.bayes.bayes_denoise`` with the group batch split over
    ``mesh``: pnoisy / pbasic (B, K, pt, c, ps, ps) or c-major rows, flat
    (B,) bool (both None in the first pass).  Returns (filtered (B, K, pt,
    c, ps, ps), rank_var) for the whole batch on the rank's device."""
    dev = mesh.device
    pnoisy = c_major(torch.as_tensor(pnoisy, dtype=torch.float32).to(dev))
    b = pnoisy.shape[0]
    pad = (-b) % mesh.size
    step2 = cfg.step == 1
    pbasic = (torch.zeros_like(pnoisy) if pbasic is None else
              c_major(torch.as_tensor(pbasic, dtype=torch.float32).to(dev)))
    flat = (torch.zeros((b,), dtype=torch.bool, device=dev) if flat is None
            else torch.as_tensor(flat, dtype=torch.bool).to(dev))
    if pad:
        zpatch = pnoisy.new_zeros((pad,) + pnoisy.shape[1:])
        pnoisy = torch.cat([pnoisy, zpatch])
        pbasic = torch.cat([pbasic, zpatch])
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    m = (b + pad) // mesh.size
    mine = slice(mesh.rank * m, (mesh.rank + 1) * m)
    out, rvar = bayes_denoise(pnoisy[mine], pbasic[mine] if step2 else None,
                              flat[mine] if step2 else None, cfg)
    return all_gather(out, mesh, dim=0)[:b], all_gather(rvar, mesh, dim=0)[:b]
