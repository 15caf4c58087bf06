"""k1.roofline_pct: K1's share of its roofline, in percent: the least time
of its launched calls' work (``perfbench.work.models.k1_work``, counted
from each call's logged arguments whatever design ran) over the CUPTI time
of K1's kernels (``patch_dist_kernel``) launched inside those calls.

A call is ``patch_dist(vid, qt, qy, qx, dt_lo, n_dt, pt, ps, w_s, sy=None,
sx=None)``: (T, C, H, W) video, (S,) site coordinates, ``n_dt`` planes,
window starts ``sy``/``sx`` ((n_dt, S)) or None."""

from perfbench.work.models import k1_work

RANGE, KERNEL = "kernel.patch_dist", "patch_dist_kernel"


def work_ms(call):
    args, kw = call["args"], call["kwargs"]
    vid, qt = args[0], args[1]
    n_dt, pt, ps, w_s = args[5], args[6], args[7], args[8]
    sy = args[9] if len(args) > 9 else kw.get("sy")
    n = qt.shape[0]
    return k1_work(n, 3 * n * qt.element_size, vid.numel, vid.shape[1], pt,
                   ps, w_s, starts=0 if sy is None else 2, planes=n_dt)[0]


def read(rec):
    calls = [c for c in rec.kernel_calls.get(RANGE, []) if c["launched"]]
    seconds = rec.op_seconds(RANGE, KERNEL)
    if not calls or not seconds:
        return None
    return 100.0 * sum(work_ms(c) for c in calls) / (1e3 * seconds)
