"""resolve.device_ms.frame: device ms a traced frame under ``vt.resolve``,
the reprojected frame's history resolve."""

from vtbench import spans


def read(rec):
    return spans.figure(rec, "frames", "vt.resolve", "device_ms")
