"""Entry ``denoise``: one timed call is ``vnlb_tpu_torch.denoise(noisy,
sigma, flows=..., cfg=...)`` on the card, which ends in its own
synchronize; the reference is the plain two-pass ``denoise`` on the same
clip, flows and configuration."""


def program(vt, noisy, clip, sigma, cfg, device, kernels):
    """(deno, basic) of one call of the program; ``noisy`` is the clip
    already on ``device``."""
    deno, basic, _ = vt.denoise(noisy, sigma, flows=clip.flows, cfg=cfg,
                                device=device, kernels=kernels)
    return deno, basic


def reference(ref, clip, sigma, cfg, device, **kw):
    """(deno, basic) of the plain reference ``ref`` on the same request."""
    return ref.denoise(clip.noisy, sigma, clip.flows, cfg, device, **kw)
