"""grad.idle_ms.train: idle device ms a traced step whose gaps' midpoints
fall under ``vt.train.grad``, the binned gradient half."""

from vtbench import spans


def read(rec):
    return spans.figure(rec, "steps", "vt.train.grad", "idle_ms")
