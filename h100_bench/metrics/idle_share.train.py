"""The share of a train step in which no operation runs on the card: one
less the device's busy time a step in the traced calls over the untraced
window's time a step (the profiler's own cost a launch would slow the
host-paced part of a traced step)."""

UNIT = "%"
LAYER = "device"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
READS = ("every device activity", "the untraced window's steps and length")


def read(r):
    w, t = r.counts["window"], r.counts["trace"]
    if not w.get("train_steps") or not t.get("train_steps"):
        return None
    busy = r.trace.busy_s / t["train_steps"]
    return 100.0 * (1.0 - busy / (w["elapsed_s"] / w["train_steps"]))
