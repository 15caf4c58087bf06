"""device.idle_pct: the share of the traced window in which no device
operation ran, in percent (100 minus the union of the kernel, copy and
fill intervals over the window)."""


def read(rec):
    if rec.window_s <= 0 or rec.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
