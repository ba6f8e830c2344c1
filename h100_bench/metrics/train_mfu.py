"""The train step's share of the card's f32-exact peak: ``work
.train_step_work``'s operations for every step of the untraced window,
over the window's length, over ``work.F32_EXACT_FLOPS``."""

from h100_bench import work

UNIT = "%"
LAYER = "train step"
MOVES = "train_samples_per_s"
SOURCE = "host_clock"
READS = ("the untraced window's steps and length",)


def read(r):
    w = r.counts["window"]
    if not w.get("train_steps") or w["elapsed_s"] <= 0:
        return None
    flops, _ = work.train_step_work(r.config, r.vocab, w["train_batch"])
    return 100.0 * flops * w["train_steps"] / w["elapsed_s"] \
        / work.F32_EXACT_FLOPS
