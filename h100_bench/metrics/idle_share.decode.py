"""The share of a batch's time in which no operation runs on the card: one
less the device's busy time a batch in the traced calls over the untraced
window's time a batch."""

UNIT = "%"
LAYER = "device"
MOVES = "captions_per_s"
SOURCE = "device_trace"
READS = ("every device activity", "the untraced window's batches and length")


def read(r):
    w, t = r.counts["window"], r.counts["trace"]
    if not w.get("captions") or not t.get("captions"):
        return None
    busy = r.trace.busy_s / t["captions"]
    return 100.0 * (1.0 - busy / (w["elapsed_s"] / w["captions"]))
