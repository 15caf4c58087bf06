#!/usr/bin/env python3
"""Where the time of the port's two-pass ``denoise`` goes on one CUDA card.

    python3 scripts/torch_profile.py [dir holding vnlb_tpu_torch] [runs]
                                     [paths]

The package is imported from the directory given (default: this
repository), so a parent tree unpacked under build/ profiles the same way.
On the 5x480x854 clip of chip_smoke.py (sigma 20), for each path of
``paths`` (comma-separated; default ``bench,api_zero``: the bench config
and the API default with zero flow; also ``poly_pallas``, the API default
with ``poly_impl="pallas"``, and ``preset_default``): one warmup, ``runs``
(default 3) plain runs (walls), then

* one run under ``torch.profiler`` (CPU and CUDA activity): the device's
  kernel time by kernel name (CUPTI timestamps, so host gaps between
  launches are not counted), the union of the kernel intervals over the
  profiled wall (busy share), and the kernel time and launches of K1
  (``patch_dist_kernel``), K2 (``econ_*``) and K5 (``poly_*``);
* one run with a device synchronize around each phase of the pass (dense
  search, gather search, K4 gather, flat test, filter, scatter, fold):
  each phase's wall on the host clock, and the rest of the run.

Prints one ``[profile]`` line per path and measure.  Fails when the
profiler records no device event or there is no card.
"""

import os
import sys
import time
from collections import defaultdict

import torch


def profiled(vt, noisy, cfg, dev):
    """(profiled wall s, {kernel name: (ms, launches)}, busy union ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, sec = vt.denoise(noisy, 20.0, cfg=cfg, device=dev)
    spans, by_name = [], defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        by_name[ev.name][0] += (end - start) / 1e3
        by_name[ev.name][1] += 1
    if not spans:
        raise SystemExit("torch_profile: the profiler recorded no device "
                         "event")
    spans.sort()
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return sec, dict(by_name), busy / 1e3


def phases(vt, noisy, cfg, dev):
    """(wall s, {phase: s}) of one run with a synchronize around each
    phase."""
    from vnlb_tpu_torch import pipeline
    from vnlb_tpu_torch.ops import agg, flat

    times = defaultdict(float)

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize(dev)
            times[name] += time.perf_counter() - t0
            return out
        return run

    patches = [(pipeline, "exec_search_dense", "dense search"),
               (pipeline, "exec_search", "gather search"),
               (pipeline, "bayes_denoise", "filter"),
               (pipeline, "ave_denoise", "filter"),
               (flat, "flat_areas", "flat test"),
               (agg, "agg_rows", "scatter"),
               (agg, "fold", "fold")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, name in patches:
            setattr(mod, attr, timed(name, getattr(mod, attr)))
        kernels = vt.KERNELS._replace(
            patch_gather=timed("K4 gather", vt.KERNELS.patch_gather))
        _, _, sec = vt.denoise(noisy, 20.0, cfg=cfg, device=dev,
                               kernels=kernels)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return sec, dict(times)


def main():
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else \
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    wanted = (sys.argv[3] if len(sys.argv) > 3 else "bench,api_zero").split(",")
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: no CUDA device")
    sys.path.insert(0, root)
    import vnlb_tpu_torch as vt

    if not vt.__file__.startswith(root):
        raise SystemExit(f"imported {vt.__file__}, not the copy in {root}")
    from vnlb_tpu_torch import _build
    from vnlb_tpu_torch.testing.data import add_noise, synthetic_video

    _build.library()
    dev = torch.device("cuda", 0)
    noisy = torch.from_numpy(add_noise(synthetic_video(5, 480, 854, seed=0),
                                       20.0, seed=1)).to(dev)
    bench = vt.default_config(20.0, preset="iphone", eig_method="poly",
                              step_s=6, border_mode="mask", topk="exact")
    paths = {"bench": bench, "api_zero": None,
             "poly_pallas": vt.default_config(20.0, poly_impl="pallas"),
             "preset_default": vt.default_config(20.0, preset="default")}
    for name in wanted:
        cfg = paths[name]
        vt.denoise(noisy, 20.0, cfg=cfg, device=dev)
        walls = [vt.denoise(noisy, 20.0, cfg=cfg, device=dev)[2]
                 for _ in range(runs)]
        sec, by_name, busy = profiled(vt, noisy, cfg, dev)
        total = sum(ms for ms, _ in by_name.values())
        mine = {tag: [v for k, v in by_name.items() if key in k]
                for tag, key in (("k1", "patch_dist_kernel"),
                                 ("k2", "econ_"), ("k5", "poly_"))}
        print(f"[profile] path={name} walls={','.join(f'{w:.4f}' for w in walls)}"
              f" profiled_wall={sec:.4f} kernel_ms={total:.2f} "
              f"busy_ms={busy:.2f} busy_share={busy / 1e3 / sec:.3f} "
              + " ".join(f"{tag}_kernel_ms={sum(v[0] for v in vals):.2f} "
                         f"{tag}_launches={sum(v[1] for v in vals)}"
                         for tag, vals in mine.items()), flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        for kname, (ms, n) in top:
            print(f"[profile] path={name} kernel={kname[:60]!r} ms={ms:.2f} "
                  f"launches={n}", flush=True)
        sec, times = phases(vt, noisy, cfg, dev)
        rest = sec - sum(times.values())
        print(f"[profile] path={name} phases_wall={sec:.4f} " + " ".join(
            f"{k.replace(' ', '_')}={v:.4f}" for k, v in sorted(times.items()))
            + f" rest={rest:.4f}", flush=True)


if __name__ == "__main__":
    main()
