"""rng.device_ms.train: device ms a traced step under the program's RNG
spans (``vt.rng.hash``, ``vt.rng.threefry``)."""

from vtbench import spans


def read(rec):
    return spans.figure(rec, "steps", "vt.rng", "device_ms")
