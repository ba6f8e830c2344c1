"""Device activities (kernels, copies, fills) a train step in the traced
calls: what the host dispatches a step."""

UNIT = "launches"
LAYER = "train dispatch"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
READS = ("every device activity",)


def read(r):
    steps = r.counts["trace"].get("train_steps")
    if not steps or not r.trace.ops:
        return None
    return len(r.trace.ops) / steps
