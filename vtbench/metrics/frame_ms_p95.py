"""frame_ms_p95: the 95th percentile of every frame's time in the window (host
clock to a synchronize), ms."""

from vtbench import readers


def read(rec):
    return readers.p95_ms(rec, "frames")
