"""K3, the fused projection + top-K (``csrc/topk_proj.cu``, the f32 split
route: split and merge kernels): the least time of every beam step's
projection of B x K rows (``work.topk_work``), over the kernels' device
time."""

from h100_bench import work

UNIT = "%"
LAYER = "kernels"
MOVES = "captions_per_s"
SOURCE = "device_trace"
READS = ("topk_split_kernel", "topk_merge_kernel")


def read(r):
    calls = r.counts["trace"].get("topk_calls")
    spent = r.trace.time_s(*READS)
    if not calls or spent <= 0:
        return None
    bound = work.bound_f32_s(*work.topk_work(
        r.counts["trace"]["topk_rows"], r.config["decoder_hidden_size"], r.vocab,
        r.counts["trace"]["beam_width"]))
    return 100.0 * calls * bound / spent
