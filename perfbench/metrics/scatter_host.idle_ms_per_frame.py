"""scatter_host.idle_ms_per_frame: milliseconds a frame in which the device
idled while the host was in the scatter (the program's spans
``vnlb.scatter.order``, the sort, ranks and the counts read back, and
``vnlb.scatter.rounds``, one round of index kernels a rank, in
``ops/agg.scatter_add_rows``), per frame completed in the traced window.
Absent where the program opens no such span."""

SPANS = ("vnlb.scatter.order", "vnlb.scatter.rounds")


def read(rec):
    ran = [s for s in SPANS if s in rec.in_range]
    if rec.busy_s <= 0 or not ran or rec.frames <= 0:
        return None
    return 1e3 * sum(rec.idle_by_label.get(s, 0.0) for s in ran) / rec.frames
