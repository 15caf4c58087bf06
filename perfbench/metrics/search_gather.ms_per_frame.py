"""search_gather.ms_per_frame: device milliseconds of the operations
launched inside the per-site gather search (`pipeline.exec_search`), per
frame completed in the traced window."""

RANGE = "ops.search"


def read(rec):
    if rec.busy_s <= 0 or RANGE not in rec.in_range or rec.frames <= 0:
        return None
    return 1e3 * rec.in_range[RANGE] / rec.frames
