"""Entry ``denoise_streaming``: one timed call is
``vnlb_tpu_torch.denoise_streaming(noisy, sigma, flows=..., cfg=...)`` on
the host clip, with the API default ``chunk=12``; it returns host arrays,
which the call moves to the card for the check.  The reference is the
plain two-pass ``denoise`` of the whole clip, on the same flows and
configuration, and the two are compared on the card."""

import torch


def program(vt, noisy, clip, sigma, cfg, device, kernels):
    """(deno, basic) of one call of the program, on ``device``; the clip
    already on ``device`` (``noisy``) is not used: the entry streams the
    host clip."""
    deno, basic, _ = vt.denoise_streaming(clip.noisy, sigma, flows=clip.flows,
                                          cfg=cfg, device=device,
                                          kernels=kernels)
    return (torch.from_numpy(deno).to(device),
            torch.from_numpy(basic).to(device))


def reference(ref, clip, sigma, cfg, device, **kw):
    """(deno, basic) of the plain reference ``ref`` on the whole clip."""
    return ref.denoise(clip.noisy, sigma, clip.flows, cfg, device, **kw)
