"""train.fwd_ms: the mean of the traced run's forward-half spans
(render_tiled in fused_step) over the steps that ran without the profiler, ms."""

from vtbench import readers


def read(rec):
    return readers.span_mean_ms(rec, "train.fwd")
