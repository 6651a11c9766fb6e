"""bounce.idle_ms.frame: idle device ms a traced frame whose gaps' midpoints
fall under ``vt.bounce``, the bounces of the path loop."""

from vtbench import spans


def read(rec):
    return spans.figure(rec, "frames", "vt.bounce", "idle_ms")
