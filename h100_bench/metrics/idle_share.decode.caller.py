"""The part of ``idle_share.decode`` whose gaps began while the host was in no
span of the program (the caller's own code): ``idle_share.decode`` times the
traced idle of class "caller" over all the traced idle
(``spans.attribute``); the three classes sum to it. None without the
program's spans."""

from h100_bench import spans

UNIT = "%"
LAYER = "device"
MOVES = "captions_per_s"
SOURCE = "device_trace"
READS = ("caller",)


def read(r):
    return spans.decode_idle_share(r, READS[0])
