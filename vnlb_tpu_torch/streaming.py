"""The long-clip passes of ``api.denoise_streaming``.

The rolling stream (``stream_pass``, one device): a pass walks the whole
clip's lattice once, in steps of ``chunk`` site frames, with only the live
frames on the device:

* the image slab [lo, hi): every frame that a valid candidate of the
  step's sites reads (frames t - nwt_b .. t + nwt_f + pt - 1 of a site at
  frame t), uploaded from the host clip as it enters;
* the live accumulator: the rows of the frames a site of this or a later
  step can still deposit into, in a ring of ``chunk + nwt_b + nwt_f + pt -
  1`` frames (global frame g at slot g mod slots).

A step's sites are the whole clip's ``plan_sites`` cut to its frames
(interior, then border), searched on the slab under the clip's temporal
bounds (``pipeline.Live``), so each is searched, filtered and scattered
once, with the candidates it has in the whole clip.  After a step every
frame below the next step's reach is complete: its rows are folded
(``agg.fold_slab``, planes spilling past the retiring frames carried to
the next ones), normalised, converted to RGB, copied to the host and
recycled.  Device memory depends on ``chunk`` and the window, not on the
clip's length.  The output equals ``denoise`` up to the scatter's
summation order (interior and border sites interleave per step); with one
step (``chunk`` >= T) it is ``denoise`` bit for bit.

The windowed composition (``windows``, ``window_stream``): each pass over
fixed windows of a host clip, each window's lattice anchored at its first
global frame (vnlb_tpu/api.py:86-167, vnlb_tpu/parallel/pipe.py:35-50).
``denoise_streaming(mesh=...)`` and ``parallel.pipe.denoise_pipelined``
run it; their halo exchange and stage schedule are built around those
windows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import pipeline
from .ops import agg
from .pipeline import KERNELS, Kernels, Live, plan_sites, prep_flows, proc_nl
from .utils.index import check_codec_range
from .utils.timer import span


def host_inputs(noisy, flows):
    """(noisy, fflow, bflow, zero_flow) with the clip and the flows as host
    f32 arrays."""
    noisy = np.asarray(noisy.cpu() if isinstance(noisy, torch.Tensor)
                       else noisy, np.float32)
    fflow, bflow, zflow = prep_flows(noisy.shape, flows)
    return noisy, fflow.numpy(), bflow.numpy(), zflow


def live_slots(scfg, t_len: int, chunk: int) -> int:
    """Frames of rows the rolling stream's accumulator holds: a step's
    chunk site frames, the window's nwt_b + nwt_f and the pt - 1 planes
    past it, at most the clip."""
    return min(t_len, chunk + scfg.nwt_b + scfg.nwt_f + scfg.pt - 1)


class Slab(NamedTuple):
    """The frames [lo, hi) of a pass's inputs on the device: ``tensors``
    are ``pipeline.prepare``'s (noisy_yuv, basic_yuv, srch, fflow,
    bflow)."""

    tensors: list
    lo: int
    hi: int


def _upload(x: np.ndarray, device) -> torch.Tensor:
    with span("vnlb.sync.stream_in"):
        return torch.from_numpy(x).to(device)


def enter_step(scfg, clip, slab: Slab, s0: int, s1: int, groups, device):
    """Step [s0, s1) of site frames: the slab moved to the frames its
    sites reach (the frames entering uploaded from the host ``clip`` =
    (noisy, basic_full, fflow, bflow, zflow), those left behind dropped),
    and its sites, interior then border, in slab frames.  Returns (slab,
    sites, n_dense)."""
    noisy, basic_full, fflow, bflow, zflow = clip
    with span("vnlb.stream.step"):
        lo = max(0, s0 - scfg.nwt_b)
        hi = min(noisy.shape[0], s1 - 1 + scfg.nwt_f + scfg.pt)
        a = slab.hi
        nz = _upload(noisy[a:hi], device)
        bs = (None if basic_full is None
              else _upload(basic_full[a:hi], device))
        ff, bf = ((None, None) if zflow else
                  (_upload(fflow[a:hi], device),
                   _upload(bflow[a:hi], device)))
        new = pipeline.prepare(nz, bs, None, ff, bf, scfg, zflow)[:5]
        kept = []
        for i, t in enumerate(new):
            # the search image may be the noisy or the basic one: shared
            j = next(j for j in range(i + 1) if new[j] is t)
            kept.append(kept[j] if j < i else t if slab.tensors[i] is None
                        else torch.cat([slab.tensors[i][lo - slab.lo:], t]))
        cuts = [np.searchsorted(g[:, 0], (s0, s1)) for g in groups]
        sites = np.concatenate([g[i:j] for g, (i, j) in zip(groups, cuts)])
        sites[:, 0] -= lo
        return (Slab(kept, lo, hi),
                _upload(sites, device), int(cuts[0][1] - cuts[0][0]))


def retire(acc, start: int, stop: int, carry, slab: Slab, scfg,
           out: np.ndarray):
    """Frames [start, stop) of the slab, complete: their accumulator rows
    folded (``carry``: the planes spilling in from the frames before),
    normalised with the fallback image, converted to RGB and copied into
    the host ``out``, and the rows zeroed for later frames.  Returns the
    planes spilling past ``stop``."""
    _, c, h, w = out.shape
    lanes = acc.shape[1]
    rows = acc.view(-1, (h - scfg.ps + 1) * (w - scfg.ps + 1), lanes)
    slots = rows.shape[0]
    with span("vnlb.stream.retire"):
        g0 = start
        while g0 < stop:
            # a run of consecutive slots of the ring
            s = g0 % slots
            g1 = min(stop, g0 + slots - s)
            part = rows[s:s + g1 - g0]
            deno, wts, carry = agg.fold_slab(part.reshape(-1, lanes),
                                             scfg.pt, scfg.ps,
                                             (g1 - g0, c, h, w), carry)
            part.zero_()
            i0, i1 = g0 - slab.lo, g1 - slab.lo
            img = pipeline.finish(deno, wts, slab.tensors[0][i0:i1],
                                  slab.tensors[1][i0:i1], scfg)
            with span("vnlb.sync.stream_out"):
                out[g0:g1] = img.cpu().numpy()
            g0 = g1
    return carry


def stream_pass(scfg, noisy, basic_full, fflow, bflow, zflow, chunk: int,
                device, kernels: Kernels = KERNELS, verbose: bool = False
                ) -> np.ndarray:
    """One pass of the rolling stream over the host clip ``noisy`` (T, C,
    H, W) (pass 2: ``basic_full`` the host basic), flows as host arrays;
    returns the host RGB output.  Counts its steps, sites and most live
    accumulator frames on ``stream_pass.steps`` / ``.sites`` /
    ``.live_frames`` (the last the largest, the others summed), as the
    kernels count their launches."""
    shape = noisy.shape
    t_len, c, h, w = shape
    pt, ps = scfg.pt, scfg.ps
    sites, n_dense = plan_sites(shape, scfg, zflow)
    groups = (sites[:n_dense], sites[n_dense:])
    n_site_frames = t_len - pt + 1
    slots = live_slots(scfg, t_len, chunk)     # also the largest slab
    check_codec_range((slots, c, h, w))
    acc = torch.zeros((slots * (h - ps + 1) * (w - ps + 1),
                       pt * c * ps * ps + 1), dtype=torch.float32,
                      device=device)
    clip = (noisy, basic_full, fflow, bflow, zflow)
    out = np.empty_like(noisy)
    slab = Slab([None] * 5, 0, 0)
    done, carry = 0, None            # frames below done retired
    for s0 in range(0, n_site_frames, chunk):
        s1 = min(s0 + chunk, n_site_frames)
        slab, step, n_step_dense = enter_step(scfg, clip, slab, s0, s1,
                                              groups, device)
        pipeline.accumulate(*slab.tensors, step, n_step_dense, scfg, kernels,
                            live=Live(slab.lo, t_len, acc))
        stream_pass.steps += 1
        stream_pass.sites += step.shape[0]
        stream_pass.live_frames = max(stream_pass.live_frames,
                                      slab.hi - done)
        if verbose:
            print(f"[vnlb_tpu_torch] pass {scfg.step} streamed frames "
                  f"{s0}:{s1} (slab {slab.lo}:{slab.hi})")
        # no later site deposits below the next step's nwt_b
        upto = t_len if s1 == n_site_frames else s1 - scfg.nwt_b
        if upto > done:
            carry = retire(acc, done, upto, carry, slab, scfg, out)
            done = upto
    return out


stream_pass.steps = stream_pass.sites = stream_pass.live_frames = 0


def pass_ctx(scfg) -> int:
    """Context frames on each side of a window: an output frame takes
    deposits from sites up to nwt + pt - 1 frames away, whose windows reach
    as far again."""
    return 2 * max(scfg.nwt_b, scfg.nwt_f) + scfg.pt - 1


def windows(t_len: int, chunk: int, ctx: int):
    """[(start, stop, lo, hi)]: output frames [start, stop) computed in the
    fixed window [lo, hi) of chunk + 2*ctx frames (extra context only widens
    the exact-match region)."""
    win = min(t_len, chunk + 2 * ctx)
    out = []
    for start in range(0, t_len, chunk):
        lo = max(0, min(start - ctx, t_len - win))
        out.append((start, min(start + chunk, t_len), lo, lo + win))
    return out


def window_pass(scfg, noisy, basic_full, fflow, bflow, zflow, lo, hi,
                device) -> torch.Tensor:
    """``proc_nl`` on ``device`` over frames [lo, hi) of the host clip, its
    lattice anchored at frame lo."""
    nz = torch.from_numpy(noisy[lo:hi]).to(device)
    bs = (None if basic_full is None
          else torch.from_numpy(basic_full[lo:hi]).to(device))
    ff, bf = ((None, None) if zflow else
              (torch.from_numpy(fflow[lo:hi]).to(device),
               torch.from_numpy(bflow[lo:hi]).to(device)))
    return proc_nl(nz, bs, None, ff, bf, scfg, zero_flow=zflow, t_origin=lo)


def window_stream(scfg, noisy, basic_full, chunk: int, run,
                  verbose: bool = False) -> np.ndarray:
    """One pass of the windowed composition over the host clip: ``run(scfg,
    basic_full, lo, hi)`` computes window [lo, hi) (``window_pass``, or a
    halo-sharded pass), of which each chunk keeps its own frames."""
    out = np.empty_like(noisy)
    for start, stop, lo, hi in windows(noisy.shape[0], chunk,
                                       pass_ctx(scfg)):
        o = run(scfg, basic_full, lo, hi)
        out[start:stop] = o[start - lo:stop - lo].cpu().numpy()
        if verbose:
            print(f"[vnlb_tpu_torch] pass {scfg.step} streamed frames "
                  f"{start}:{stop} (ctx {lo}:{hi})")
    return out
