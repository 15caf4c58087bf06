"""agg.ms_per_frame: device milliseconds of the operations launched inside
the scatter (``ops.agg.agg_rows``) and the fold (``ops.agg.fold``), per
frame completed in the traced window."""

RANGES = ("ops.agg.agg_rows", "ops.agg.fold")


def read(rec):
    ran = [r for r in RANGES if r in rec.in_range]
    if rec.busy_s <= 0 or not ran or rec.frames <= 0:
        return None
    return 1e3 * sum(rec.in_range[r] for r in ran) / rec.frames
