"""Device ms a train step in the traced calls that the program enqueued inside
its ``train.forward`` span (zero_grad and the forward pass: both rollouts
and the losses), by ``spans.attribute``. None without the program's spans."""

from h100_bench import spans

UNIT = "ms"
LAYER = "train step"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
READS = ("train.forward",)


def read(r):
    return spans.phase_ms(r, READS[0])
