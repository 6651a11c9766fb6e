"""dispatch.kernels_per_step: device kernels in the trace over the traced steps."""

from vtbench import readers


def read(rec):
    return readers.kernels_per_iteration(rec, "steps")
