"""One run of one cell: set-up, the measured window, the traced window's
reduction and the correctness check.

The window drives the traffic mix's entry (``perfbench/traffic/entry/``;
``denoise``: ``vnlb_tpu_torch.api.denoise(noisy, sigma, flows=...,
cfg=...)``) from one client in a closed loop: the pool's clips go in round
robin, back to back, each call ending in the synchronize ``denoise`` makes
itself.  The window opens when the first timed call starts and closes when
the first call that ends ``seconds`` or more after that ends, so every call
of the window ends inside it and the rate takes all of its work and all of
its time.  The calls compared with the reference are a draw from the seed
over the whole window; their outputs stay on the card until it closes.

``setup_s`` runs from process start to the first timed call, less the
nvcc build of a checkout's first run (logged apart as ``build_s``, with
the other set-up phases).
"""

from __future__ import annotations

import contextlib
import importlib
import os
import resource
import sys
import time
from typing import Callable, Optional

from . import check, spec, stats, trace
from ..traffic.generator import Sample, make_pool, module

GIB = 2 ** 30


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def program_config(vt, config: dict):
    return vt.default_config(config["sigma"], preset=config["preset"],
                             **config["overrides"])


def host_usage() -> tuple:
    """(CPU seconds, involuntary context switches) of this process."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, ru.ru_nivcsw


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: str, t_start: float, vt=None,
             reference=None, root=spec.ROOT,
             call_hook: Optional[Callable] = None) -> dict:
    """The result of one run (the keys of the result line), without the
    device's name, which the caller adds.  ``vt`` and ``reference`` default
    to the program and the plain reference; ``call_hook(outputs)`` may
    replace a call's (deno, basic) (the harness's fault tests)."""
    import torch

    phase, t_phase = {}, time.perf_counter()

    def mark(name):
        nonlocal t_phase
        now = time.perf_counter()
        phase[name] = now - t_phase
        t_phase = now

    phase["imports"] = t_phase - t_start
    vt = vt or importlib.import_module("vnlb_tpu_torch")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    mark("program")
    build_s = 0.0
    if on_card:
        _, build_s = vt._build.build()
        mark("build")
        vt._build.library()
        torch.cuda.init()
        mark("library")
    conf, mix = cell.config, cell.traffic
    sigma = float(conf["sigma"])
    cfg = program_config(vt, conf)
    entry = module(mix, "entry", root)
    pool = make_pool(mix, conf["height"], conf["width"], sigma, seed, root)
    mark("pool")
    noisy = [torch.from_numpy(c.noisy).to(dev) for c in pool]
    mark("upload")
    sample = Sample(mix["check_calls"], seed)
    inst = trace.Instrument(vt, root) if traced else None
    kernels = inst.kernels if traced else vt.KERNELS

    def call(i):
        j = i % len(pool)
        out = entry.program(vt, noisy[j], pool[j], sigma, cfg, dev, kernels)
        return call_hook(out) if call_hook else out

    try:
        call(0)
        if on_card:
            torch.cuda.synchronize(dev)
        mark("warm_call")
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile

            inst.clear()
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if on_card else []))
            prof.__enter__()
            mark("profiler")
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start - build_s
        log(f"build_s={build_s} setup_s={setup_s} pool={len(pool)} "
            f"frames_per_call={mix['frames']} check_calls={sample.k}")
        log("setup_phases " + " ".join(f"{k}={v:.3f}"
                                       for k, v in phase.items()))

        lat = []
        window = (torch.profiler.record_function(trace.WINDOW) if traced
                  else contextlib.nullcontext())
        load, (cpu0, nivcsw0) = os.getloadavg()[0], host_usage()
        with window:
            t0 = time.perf_counter()
            i = 0
            while True:
                c0 = time.perf_counter()
                with (torch.profiler.record_function(trace.CALL) if traced
                      else contextlib.nullcontext()):
                    deno, basic = call(i)
                c1 = time.perf_counter()
                lat.append(c1 - c0)
                sample.offer(i, (deno, basic))
                del deno, basic
                i += 1
                if c1 - t0 >= seconds:
                    break
        window_s = c1 - t0
        cpu1, nivcsw1 = host_usage()
        log(f"host loadavg1={load} cpu_s_per_window_s="
            f"{(cpu1 - cpu0) / window_s} involuntary_switches="
            f"{nivcsw1 - nivcsw0} cpus={len(os.sched_getaffinity(0))}")
        if prof is not None:
            prof.__exit__(None, None, None)
    finally:
        if inst is not None:
            inst.undo()
    frames = mix["frames"] * len(lat)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    got_fps = stats.fps(frames, window_s)
    log(f"window_s={window_s} calls={len(lat)} frames={frames} "
        f"fps={got_fps} p90_samples={len(lat)} "
        f"median_call_s={stats.percentile(lat, 50)} "
        f"best_call_s={min(lat)} worst_call_s={max(lat)}")

    result = {"correct": None, "attempted": len(lat), "failed": 0}
    if traced:
        t_red = time.perf_counter()
        events = prof.profiler.kineto_results.events()
        rec = trace.reduce_events(events, inst.range_names, frames,
                                  inst.calls, inst.label_order())
        del events, prof
        log(f"traced_fps={got_fps} traced_window_s={rec.window_s} "
            f"busy_s={rec.busy_s} unattributed_s={rec.unattributed_s} "
            f"device_ops={rec.n_device_ops} "
            f"reduce_s={time.perf_counter() - t_red}")
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], root)(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = {"busy_s": rec.busy_s, "window_s": rec.window_s}
        result["breakdown"] = trace.breakdown(rec)
    else:
        values = {"fps": got_fps, "clip_p90_s": stats.percentile(lat, 90),
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = {}
    result["device"].update(platform="gpu" if on_card else dev.type,
                            count=int(cell.entry["chips"]),
                            memory_peak_bytes=int(peak))

    # the check: the program's state freed, the reference in its place
    del noisy
    if on_card:
        torch.cuda.empty_cache()
    reference = reference or importlib.import_module("perfbench.reference")
    rcfg = program_config(reference, conf)
    per_call = []
    t_ref = time.perf_counter()
    kept, ids = sample.kept, sorted(sample.kept)
    for i in ids:
        deno, basic = kept.pop(i)
        clip = pool[i % len(pool)]
        rd, rb = entry.reference(reference, clip, sigma, rcfg, dev)
        per_call.append(check.gaps(deno, basic, rd, rb))
        del deno, basic, rd, rb
    log(f"reference_s={time.perf_counter() - t_ref} compared_calls="
        f"{ids}")
    ok, table = check.judge(check.worst(per_call), cell.limits.get(
        "limits", {}))
    result["correct"] = ok
    result["checks"] = table
    return result
