"""filter_glue.ms_per_frame: device milliseconds of the torch operations
around the Bayes filter's kernel (the program's spans ``vnlb.filter.prep``,
the centring and the flat switch, and ``vnlb.filter.finish``, the trace,
the un-centring and the layout, in ``ops/bayes.bayes_denoise``), per frame
completed in the traced window.  Absent where the program opens no such
span."""

SPANS = ("vnlb.filter.prep", "vnlb.filter.finish")


def read(rec):
    ran = [s for s in SPANS if s in rec.in_range]
    if rec.busy_s <= 0 or not ran or rec.frames <= 0:
        return None
    return 1e3 * sum(rec.in_range[s] for s in ran) / rec.frames
