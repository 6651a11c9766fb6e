"""step_rays_per_s: W x H rays of every training step completed in the window
over the window's seconds, in millions."""

from vtbench import readers


def read(rec):
    return readers.rate_mrays(rec, "steps")
