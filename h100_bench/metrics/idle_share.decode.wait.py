"""The part of ``idle_share.decode`` whose gaps began while the host was in a
span with ``waits`` (the host read device data: a sync drained the queue):
``idle_share.decode`` times the traced idle of class "wait" over all the
traced idle (``spans.attribute``); the three classes sum to it. None without
the program's spans."""

from h100_bench import spans

UNIT = "%"
LAYER = "device"
MOVES = "captions_per_s"
SOURCE = "device_trace"
READS = ("wait",)


def read(r):
    return spans.decode_idle_share(r, READS[0])
