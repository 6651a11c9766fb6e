"""rng.device_ms.frame: device ms a traced frame under the program's RNG
spans (``vt.rng.hash``, ``vt.rng.threefry``)."""

from vtbench import spans


def read(rec):
    return spans.figure(rec, "frames", "vt.rng", "device_ms")
