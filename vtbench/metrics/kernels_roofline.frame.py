"""kernels_roofline.frame: sum of bounds over sum of device times of the
frame's K1-K4 launches, %."""

from vtbench import readers


def read(rec):
    return readers.roofline_pct(rec, "frames")
