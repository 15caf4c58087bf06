"""k2.roofline_pct: K2's share of its roofline, in percent: the least time
of its launched calls' work (``perfbench.work.models.econ_work`` through
``bound``: f32 products as split TF32 at 494.7 TFLOP/s, bf16 at 989, HBM
at 3.35 TB/s), counted from each call's logged arguments, over the CUPTI
time of K2's kernels (``econ_*``) launched inside those calls.

A call is ``econ_filter(xc2, xn2, cfg)``: (G, K, p) groups and the
stage's configuration."""

from perfbench.work.models import bound, econ_work

RANGE, KERNEL = "kernel.econ_filter", "econ_"


def work_ms(call):
    xc2, cfg = call["args"][0], call["args"][2]
    g, k, p = xc2.shape
    return bound(*econ_work(g, k, p, cfg))[0]


def read(rec):
    calls = [c for c in rec.kernel_calls.get(RANGE, []) if c["launched"]]
    seconds = rec.op_seconds(RANGE, KERNEL)
    if not calls or not seconds:
        return None
    return 100.0 * sum(work_ms(c) for c in calls) / (1e3 * seconds)
