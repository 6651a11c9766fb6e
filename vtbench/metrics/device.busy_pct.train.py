"""device.busy_pct.train: the union of device operations over the traced steps'
wall time, % (a lower bound)."""

from vtbench import readers


def read(rec):
    return readers.busy_pct(rec, "steps")
