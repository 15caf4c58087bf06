"""pass_host.idle_ms_per_frame: milliseconds a frame in which the device
idled while the host was in a pass's own work (the program's spans
``vnlb.pass.prepare``, ``vnlb.pass.plan`` and ``vnlb.pass.finish`` in
``pipeline.proc_nl``: config checks, rgb -> yuv, the site lattice and its
upload, normalisation, yuv -> rgb), per frame completed in the traced
window.  Absent where the program opens no such span."""

SPANS = ("vnlb.pass.prepare", "vnlb.pass.plan", "vnlb.pass.finish")


def read(rec):
    ran = [s for s in SPANS if s in rec.in_range]
    if rec.busy_s <= 0 or not ran or rec.frames <= 0:
        return None
    return 1e3 * sum(rec.idle_by_label.get(s, 0.0) for s in ran) / rec.frames
