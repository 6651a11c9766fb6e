"""train.step_ms_p95: the 95th percentile of the traced run's steps that ran
without the profiler, ms (the spans' synchronizes lengthen them)."""

from vtbench import readers


def read(rec):
    return readers.p95_ms(rec, "steps", "iteration")
