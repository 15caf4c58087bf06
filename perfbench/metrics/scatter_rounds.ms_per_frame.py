"""scatter_rounds.ms_per_frame: device milliseconds of the operations
launched inside the scatter's rounds (the program's span
``vnlb.scatter.rounds`` in ``ops/agg.scatter_add_rows``: one indexed
read-add-write a rank), per frame completed in the traced window.  Absent
where the program opens no such span."""

SPAN = "vnlb.scatter.rounds"


def read(rec):
    if rec.busy_s <= 0 or SPAN not in rec.in_range or rec.frames <= 0:
        return None
    return 1e3 * rec.in_range[SPAN] / rec.frames
