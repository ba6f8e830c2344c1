"""K2, the whole-decode kernel run in segments (``csrc/whole_decode_tf32
.cu``, f32 on three-term TF32 products): the least time of the greedy
batches' decodes (each batch's row-steps to its stop, its weights, enc and
U v read once: ``work.decode_row_step_macs`` less U v, and
``work.decode_kernel_bytes``), over the kernel's device time."""

from h100_bench import work

UNIT = "%"
LAYER = "kernels"
MOVES = "captions_per_s"
SOURCE = "device_trace"
READS = ("tf32_decode_kernel",)


def read(r):
    steps = r.counts["trace"].get("decode_batch_steps")
    spent = r.trace.time_s(*READS)
    if not steps or r.counts["trace"].get("beam_width") or spent <= 0:
        return None
    B = r.counts["trace"]["decode_batch"]
    macs = work.decode_row_step_macs(r.config, r.vocab)
    bound = sum(work.bound_f32_s(
        2 * B * n * macs, work.decode_kernel_bytes(r.config, r.vocab, B, n))
        for n in steps)
    return 100.0 * bound / spent
