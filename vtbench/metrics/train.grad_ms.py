"""train.grad_ms: the mean of the traced run's gradient-half spans
(binned_grads and the Adam update) over the steps that ran without the profiler, ms."""

from vtbench import readers


def read(rec):
    return readers.span_mean_ms(rec, "train.grad")
