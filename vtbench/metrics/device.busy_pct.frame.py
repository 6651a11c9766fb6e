"""device.busy_pct.frame: the union of device operations over the traced
frames' wall time, % (a lower bound)."""

from vtbench import readers


def read(rec):
    return readers.busy_pct(rec, "frames")
