"""rays_per_s: primary rays (W x H x spp) of every frame completed in the
window over the window's seconds, in millions."""

from vtbench import readers


def read(rec):
    return readers.rate_mrays(rec, "frames")
