"""reorder.device_ms.frame: device ms a traced frame under the bounce
reorder's spans (``vt.reorder``: pack, key, sort, gather; and
``vt.reorder.undo``: the inverse permutation)."""

from vtbench import spans


def read(rec):
    return spans.figure(rec, "frames", "vt.reorder", "device_ms")
