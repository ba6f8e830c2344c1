"""Device ms a train step in the traced calls that the program enqueued inside
its ``train.backward`` span (autograd's backward pass, whose kernels
autograd's device thread launches), by ``spans.attribute``. None without the
program's spans."""

from h100_bench import spans

UNIT = "ms"
LAYER = "train step"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
READS = ("train.backward",)


def read(r):
    return spans.phase_ms(r, READS[0])
