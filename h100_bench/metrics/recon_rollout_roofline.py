"""The reconstructor's whole-rollout kernels (``csrc/cell_rollout.cu``, f32
on three-term TF32 products), forward and backward: their least time,
``work.rollout_work`` of one direction per kernel call the steps need (two
a step: forward and backward), over their device time in the trace."""

from h100_bench import work

UNIT = "%"
LAYER = "training rollouts"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
READS = ("cell_rollout_tf32_kernel",)


def read(r):
    steps = r.counts["trace"].get("train_steps")
    spent = r.trace.time_s(*READS)
    if not steps or spent <= 0:
        return None
    c = r.config
    T = c["caption_max_len"] + 1
    bound = work.bound_f32_s(*work.rollout_work(
        c["reconstructor_model"], r.counts["trace"]["train_batch"], T,
        c["reconstructor_hidden_size"]))
    return 100.0 * 2 * steps * bound / spent
