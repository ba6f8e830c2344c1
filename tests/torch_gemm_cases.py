"""The train step's matrix products at the train cells' shapes (B 1024,
T 31, 28 frames: the sizes of ``h100_bench/work.py``), for the GEMM's card
tests (``test_torch_cuda.py``, which imports no JAX) and
``chip_smoke.py --gemm``: each product's layouts as the step hands them to
``ops.cuda.gemm.mm``, its seeded operands, and the error measure."""

import torch

B, T, FRAMES = 1024, 31, 28
ROWS = B * T
# (name, kind, M, K, N, epilogue). kind "fwd": x W, both row-major (the
# wrapper swaps them); "dx": dy W^T, W^T column-major; "dw": X^T dy, X^T
# column-major. Epilogue "bias"; "out" into, or "acc" onto, a strided out
# (rows 128 floats past N, as the decoder rollout's buffers); "" none.
CASES = [
    ("recon_w_ih", "fwd", ROWS, 1024, 6144, "bias"),
    ("recon_w_ih.dx", "dx", ROWS, 6144, 1024, ""),
    ("recon_w_ih.dw", "dw", 1024, ROWS, 6144, ""),
    ("recon_w_hh.dw", "dw", 1536, ROWS, 6144, ""),
    ("ctx_w_enc", "fwd", B, 1536, 1536, "acc"),
    ("ctx_w_enc.dx", "dx", B, 1536, 1536, "out"),
    ("ctx_w_enc.dw", "dw", 1536, ROWS, 1536, ""),
    ("recon_out_w", "fwd", ROWS, 1536, 1536, "bias"),
    ("recon_out_w.dx", "dx", ROWS, 1536, 1536, ""),
    ("recon_out_w.dw", "dw", 1536, ROWS, 1536, ""),
    ("logits", "fwd", ROWS, 512, 4188, "bias"),
    ("logits.dx", "dx", ROWS, 4188, 512, ""),
    ("logits.dw", "dw", 512, ROWS, 4188, ""),
    ("h_w_cat", "fwd", B, 512, 1664, "out"),
    ("h_w_cat.dx", "dx", B, 1664, 512, "acc"),
    ("w_hh.dw", "dw", 512, ROWS, 1536, ""),
    ("attn_W.dw", "dw", 512, ROWS, 128, ""),
    ("emb_gates", "fwd", ROWS, 468, 1536, "bias"),
    ("emb_gates.dx", "dx", ROWS, 1536, 468, ""),
    ("emb_gates.dw", "dw", 468, ROWS, 1536, ""),
    ("uv", "fwd", B * FRAMES, 1536, 128, ""),
    ("uv.dw", "dw", 1536, B * FRAMES, 128, ""),
    # the local reconstructor's loop, a step
    ("local_x_w_ih", "fwd", B, 512, 6144, "bias"),
    ("local_h_w_hh", "fwd", B, 1536, 6144, "bias"),
    ("local_h_w_hh.dx", "dx", B, 6144, 1536, ""),
    ("local_h_w_hh.dw", "dw", 1536, B, 6144, ""),
    ("local_query_W", "fwd", B, 1536, 128, ""),
]


def operands(kind, M, K, N, epilogue, seed, device):
    """Seeded N(0, 1) operands of a CASES row: (a, b, bias, buf); the
    product's out is ``buf[:, :N]`` where the epilogue has one."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, device=device, generator=g)
    if kind == "fwd":
        a, b = r(M, K), r(K, N)
    elif kind == "dx":
        a, b = r(M, K), r(N, K).t()
    else:
        a, b = r(K, M).t(), r(K, N)
    bias = r(N) if epilogue == "bias" else None
    buf = r(M, N + 128) if epilogue in ("out", "acc") else None
    return a, b, bias, buf


def run(fn, a, b, bias, buf, epilogue, **kw):
    """``fn`` (``gemm.mm`` or ``gemm.mm_reference``) on the operands, into
    a fresh copy of ``buf`` where the epilogue writes one; the result."""
    N = b.shape[1]
    out = None if buf is None else buf.clone()[:, :N]
    got = fn(a, b, bias=bias, out=out, accumulate=epilogue == "acc", **kw)
    return got if out is None else out


def exact(a, b, bias, buf, epilogue, a_round=None, b_round=None):
    """The product in float64 (of the operands rounded by a_round /
    b_round where given)."""
    a = (a_round(a) if a_round else a).double()
    b = (b_round(b) if b_round else b).double()
    want = a @ b
    if bias is not None:
        want += bias.double()
    if epilogue == "acc":
        want += buf[:, :b.shape[1]].double()
    return want


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got.double() - want).abs().max() / want.abs().max())
