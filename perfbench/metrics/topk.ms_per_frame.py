"""topk.ms_per_frame: device milliseconds of the top-K selection of both
searches (the program's span ``vnlb.search.topk``: the sorts and merges of
``ops/search_dense`` and ``ops/search``, no distance kernel inside), per
frame completed in the traced window.  Absent where the program opens no
such span."""

SPAN = "vnlb.search.topk"


def read(rec):
    if rec.busy_s <= 0 or SPAN not in rec.in_range or rec.frames <= 0:
        return None
    return 1e3 * rec.in_range[SPAN] / rec.frames
