"""stream_host.idle_ms_per_frame: milliseconds a frame in which the device
idled while the host was in the rolling stream's own work (the ranges
around ``streaming.enter_step`` and ``streaming.retire``, which open the
program's spans ``vnlb.stream.step`` and ``vnlb.stream.retire``: a step's
uploads, colour conversion and sites, and the retiring frames' fold,
normalisation and copy out), per frame completed in the traced window.
Absent where the program has no such function."""

RANGES = ("streaming.enter_step", "streaming.retire")


def read(rec):
    ran = [r for r in RANGES if r in rec.in_range]
    if rec.busy_s <= 0 or not ran or rec.frames <= 0:
        return None
    return 1e3 * sum(rec.idle_by_label.get(r, 0.0) for r in ran) / rec.frames
