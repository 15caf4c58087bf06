"""stream_retire.ms_per_frame: device milliseconds of the operations
launched inside the rolling stream's retire (the range around
``streaming.retire``, which opens the program's span
``vnlb.stream.retire``: the slab fold, normalisation, yuv -> rgb, the
copy out and the rows' recycling), per frame completed in the traced
window.  Absent where the program has no such function."""

RANGE = "streaming.retire"


def read(rec):
    if rec.busy_s <= 0 or RANGE not in rec.in_range or rec.frames <= 0:
        return None
    return 1e3 * rec.in_range[RANGE] / rec.frames
