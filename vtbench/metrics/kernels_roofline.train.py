"""kernels_roofline.train: sum of bounds over sum of device times of the step's
K1-K4 and K4-bwd launches, %."""

from vtbench import readers


def read(rec):
    return readers.roofline_pct(rec, "steps")
