"""dispatch.kernels_per_frame: device kernels in the trace over the traced frames."""

from vtbench import readers


def read(rec):
    return readers.kernels_per_iteration(rec, "frames")
