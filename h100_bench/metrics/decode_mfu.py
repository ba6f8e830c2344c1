"""The decode's share of the card's f32-exact peak: ``work
.decode_row_step_macs`` for every row-step the untraced window's batches
needed and U v once a video, over the window's length, over ``work
.F32_EXACT_FLOPS``."""

from h100_bench import work

UNIT = "%"
LAYER = "decode drivers"
MOVES = "captions_per_s"
SOURCE = "host_clock"
READS = ("the untraced window's batches and length",)


def read(r):
    w = r.counts["window"]
    if not w.get("decode_row_steps") or w["elapsed_s"] <= 0:
        return None
    macs = (w["decode_row_steps"] * work.decode_row_step_macs(r.config,
                                                              r.vocab)
            + work.uv_macs(r.config, w["captions"]))
    return 100.0 * 2 * macs / w["elapsed_s"] / work.F32_EXACT_FLOPS
