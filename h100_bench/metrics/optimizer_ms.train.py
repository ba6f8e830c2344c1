"""Device ms a train step in the traced calls that the program enqueued inside
its ``train.optimizer`` span (the clip of the decoder's gradients and both
Adam steps, and the all-reduce on a mesh), by ``spans.attribute``. None
without the program's spans."""

from h100_bench import spans

UNIT = "ms"
LAYER = "train step"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
READS = ("train.optimizer",)


def read(r):
    return spans.phase_ms(r, READS[0])
