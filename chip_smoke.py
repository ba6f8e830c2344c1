"""Smoke run of the PyTorch/CUDA port (recnet_tpu_torch) on one Hopper card.

    python3 chip_smoke.py                        # from the repository root
    python3 chip_smoke.py --compare <other tree> # K1-K4 of two trees
    python3 chip_smoke.py --read-rates           # the card's L2 and HBM
                                                 # read rates

Phases, one line or more each; any failure exits non-zero before a result:

1. environment: torch, CUDA, the card, TF32 off;
2. build: nvcc builds the port's CUDA kernels from this checkout, one
   process per source, all at once;
3. kernels: K1 (whole decode) and K2 (decode segment) against their plain
   PyTorch twins at the flagship width, GRU and LSTM, f32 (CUDA-core
   body) and bf16 (tensor-core body: tokens on BF16_TOKENS, h and c on
   the rows that agree within 2 bf16 ulps, its token agreement beside the
   CUDA-core body's at B=256 and 1024); K3 (projection + top-k) against
   its twin at the flagship beam's shapes; K4 (fused attention + GRU
   step) against its twin, frame chunks 1 and 7: f32 (CUDA-core body),
   bf16 on the tensor-core route at B=256 and 1024 (and each of its two
   kernels against its plain stage), bf16 under ``cuda_cores``; the K5
   variants of K1: ``dual`` bit-equal to K1's CUDA-core step, each
   ``ablate`` part against its twin;
4. main paths, each with the launch counts set to 0 before it and read
   after it: greedy requests through the port's HTTP handler behind the
   MicroBatcher, from a flagship-width bf16 Captioner (use_pallas,
   greedy_segment=4), for K1 and K2, the bf16 captions held word by word
   against the twin's; beam-5 requests mixed with greedy
   ones through the same front, for K3; ``evaluation.evaluate`` with beam
   5 and greedy on an in-memory score corpus, for K3 and K2;
   ``decoding.greedy_decode_pallas`` at B=1024, for K4 (T launches, all
   on the tensor-core route in bf16, tokens held against the same loop
   through K4's twin);
   ``decoding.greedy_decode_whole(early_exit=True)`` on PAD-timed
   weights (blocks stop at different steps), for K5's early exit, held
   against the full K1 and, in bf16, against its twin;
5. times: each kernel at B=1024 (K3 at N=5120) beside its plain twin,
   its library route where one PyTorch route computes the same function
   (plain ``greedy_decode`` for K1/K2, the cuBLAS product and the top-K
   rounds for K3, the composed ``gru_attn_step_reference`` for K4) and
   its bound (operations at the bf16 peak or bytes at the device-memory
   rate); K4's CUDA-core body and the tensor-core route's two kernels
   apart; captions/s of the greedy and beam paths;
6. ablate: the profiling sweep of K1's CUDA-core body at B=1024 bf16
   (its production step, each ablated part, dual), each part's cost as
   full - variant and its tokens against its twin's;
7. train: training at the flagship width on an in-memory corpus of random
   features and captions (``examples/msvd_flagship.json``, data bundle
   off, short cadences): (a) three f32 train steps on the card against
   the same steps on the CPU from the same state, then 30 card steps on
   one batch whose loss must fall; (b) ``training.loop.train`` with k = 10
   steps a dispatch and the bf16 device feature cache, its val pass, its
   test pass through ``evaluate`` (greedy and beam 5: K2 and K3, counted
   from 0 around the pass), its checkpoints, and a resume from the last;
   (c) ms a train step by CUDA events over k-step dispatches (median of
   3) in f32 and bf16, the card's busy time and idle share by the
   profiler, the peak memory and the bound;
8. data: the data and checkpoint side. (a) A flagship-width reference
   (hobincar PyTorch) ``*_checkpoint.tar`` written from seeded numpy in
   the reference's keys, layout and parameter order, imported by
   ``cli.import_torch``, captioned on the card (256 videos, f32, greedy
   through K2 and beam 5 through K3, counted from 0) against the same
   Captioner on params this script transposes itself (equal captions on
   every row), then exported by ``cli.export_torch``'s main and compared
   with the original bit for bit (weights and every Adam moment). (b) The
   [train] corpus packed as a data bundle (from memory: the card's machine
   has no h5py), and ``training.loop.train`` on it with the bf16 device
   feature cache against the loop on the raw corpus: equal losses bit for
   bit, one upload of the score split for two test passes, the test pass
   with and without the device cache. (c) ``CaptionScorer.evaluate()`` at
   MSR-VTT test scale with the metrics' C++ core and on the pure-Python
   paths: bit-equal scores, host seconds of each.

``--compare`` times K1, K2 (seg_len 4), K3 and K4 with their library
routes, and the K4 loop, for this tree and another (an unpacked parent, say) in turns: this,
other, other, this, each in a process of its own. ``--read-rates`` times
a small read kernel over an L2-resident buffer and over device memory.

The weights are random, drawn from a numpy seed. The last three lines are
the card's name and power limit, one JSON line listing every kernel, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import functools
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
FLAGSHIP = REPO / "examples" / "msvd_flagship.json"
SEED = 0
DEVICE = "cuda"
VOCAB = 4188           # the flagship vocabulary size (MSVD, min_count 5)
CHECK_B = 256          # batch of the kernel-against-twin checks
TIME_B = 1024          # batch of the timed decodes
F32_ROWS = 0.99        # share of rows whose f32 tokens must equal the twin's
BF16_TOKENS = 0.98     # share of bf16 tokens that must equal the twin's
H_RTOL, H_ATOL = 1e-4, 1e-5   # f32 h against the twin (sum-order noise)
# the variant whose captions end lifts out_b[<EOS>] until <EOS> would win
# about this share of the later steps of a short plain-twin probe, so that
# every row ends within T and eos_stop fires
EOS_WIN_SHARE = 0.3
BEAM = 5               # the flagship preset's beam width
# K3 checks: (rows, k) at the flagship beam (B = 1024 x beam 5 = 5120 rows)
# and a ragged N
TOPK_CHECKS = ((5120, 1), (5120, 3), (5120, 5), (1001, 5))
TOPK_RTOL = TOPK_ATOL = 1e-5   # f32 sums of exact products, another order
BEAM_CHECK_VIDEOS = 256        # f32 beam captions, kernel against plain
EVAL_VIDEOS = 128              # the in-memory score corpus
K4_CHUNKS = (1, 7)             # K4's frame_chunk values (L = 28)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-2   # bf16 h: 2 bf16 ulps
ABLATE_PARTS = ("emb", "attn", "score1", "fma", "proj", "nativeargmax",
                "argmax")
# the PAD-timed variant: (z, n) of the GRU unit whose rise lifts <PAD>, and
# the step at which the lift would pass every max logit of a probe: past
# the flagship's T = 31, so that blocks stop over a wide span of steps
PAD_TIMER = (0.97, 0.9, 40)
EARLY_STOP_BLOCKS = 0.5        # share of blocks the early exit must stop
# the least time of a kernel's work: its operations at the bf16 tensor-core
# peak or its bytes (each input read once, each output written once) at
# the device-memory rate, whichever is longer (H100 SXM data sheet, dense)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
L2_PROBE_BYTES = 12 * 2 ** 20  # --read-rates: about one block-step of K1's
                               # weights
# [train]: the in-memory corpus (videos of the train, val and test splits,
# captions a video), the card-against-CPU steps and their tolerances (f32,
# TF32 off): the largest relative difference of a loss, or of a leaf's sum
# over its sum of |x| (params and Adam states); the grad norm's apart,
# since torch's float32 norm on the CPU drifts about 2e-4 on leaves of
# millions of elements where the per-leaf norms in float64 agree to 1e-9;
# the steps on one batch whose loss must fall, the loop's dispatches, the
# timed ones
TRAIN_VIDEOS = (400, 50, 100)
TRAIN_CAPTIONS = 3
CARD_CPU_STEPS = 3
TRAIN_RTOL = 1e-4
NORM_RTOL = 1e-3
REPEAT_STEPS = 30
TRAIN_DISPATCHES = 4
TIME_DISPATCHES = 3
# [data]: the videos captioned from the imported reference checkpoint; the
# scoring corpus at MSR-VTT test scale (videos, references a video, words
# of its Zipf vocabulary)
DATA_VIDEOS = 256
SCORE_VIDEOS = 2990
SCORE_REFS = 20
SCORE_WORDS = 3000


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def environment(torch):
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    major, minor = torch.cuda.get_device_capability(0)
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
               f"cuda {torch.version.cuda} device "
               f"{torch.cuda.get_device_name(0)} sm_{major}{minor} "
               f"count {torch.cuda.device_count()}")
    log("env", f"nvidia-smi: {card_line()}")
    log("env", "tf32 off for matmul and cudnn")


def build_kernels():
    """One nvcc per source, started together."""
    from concurrent.futures import ThreadPoolExecutor
    from recnet_tpu_torch.ops.cuda import build
    sources = ("whole_decode", "topk_proj", "fused_step")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(build.build, sources))
    for name in sources:
        build.load(name)
    log("build", f"nvcc {' '.join(build.NVCC_FLAGS)}: "
                 f"{', '.join(p.name for p in paths)} in "
                 f"{time.perf_counter() - t0:.2f} s")
    for path in paths:
        kernel = ""
        for line in path.with_suffix(".log").read_text().splitlines():
            entry = re.search(r"entry function .*?\d([a-z_]+_kernel)"
                              r"(I[A-Za-z0-9_]*?EE)?", line)
            if entry:     # the mangled name: kernel and template arguments
                kernel = entry.group(1) + (entry.group(2) or "")
            elif "registers" in line or "spill" in line:
                log("build", f"{path.stem} {kernel}: {line.strip()}")


# --------------------------------------------------------------------------
# 3. kernels against their plain twins
# --------------------------------------------------------------------------

def decode_operands(params, enc):
    from recnet_tpu_torch.ops.attention import precompute_uv
    import torch
    r = params["rnn"][0]
    return (params, enc, precompute_uv(params["attention"], enc),
            torch.stack([r["b_ih"], r["b_hh"]]))


def seeded_params(cfg, dtype, seed=SEED):
    from recnet_tpu_torch.weights import params_from_jax, random_params
    return params_from_jax(random_params(cfg, seed), DEVICE, dtype)


def seeded_features(torch, B, L, cfg, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn((B, L, cfg.encoder_size), generator=g,
                       device=DEVICE).to(dtype)


def first_divergence_margin(wd, ops, row, t, sos_token, kw):
    """Top-2 logit margin of the twin at step ``t`` of ``row``."""
    import torch
    params, enc, uv, bias2 = ops
    H = params["attention"]["W"].shape[0]
    z = torch.zeros((1, H), dtype=enc.dtype, device=enc.device)
    sos = torch.full((1, 1), sos_token, dtype=torch.int32, device=enc.device)
    _, h, _, _ = wd.whole_greedy_decode_segment_reference(
        params, enc[row:row + 1], uv[row:row + 1], bias2, z, z, sos,
        seg_len=t + 1, **kw)
    logits = h.float() @ params["out_w"].float() + params["out_b"].float()
    top = logits.topk(2, dim=-1).values[0]
    return float(top[0] - top[1])


def kernels_against_twins(torch, tc, cfg_base):
    """K1 and K2 against their twins, GRU and LSTM: f32 (CUDA-core body)
    tokens on F32_ROWS of rows and h within H_RTOL/H_ATOL on them; bf16
    (tensor-core body, the timed one) tokens on BF16_TOKENS and h and c
    within BF16_RTOL/BF16_ATOL on the rows that agree. Returns the bf16
    max |h - h_twin| (and |c - c_twin|) of K1 (T steps from <SOS>) and of
    K2 (seg_len 1 and 4)."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    T, L = tc.caption_max_len + 1, tc.encoder_output_len
    errs = {"whole_greedy_decode": 0.0, "whole_greedy_decode_segment": 0.0}
    for cell in ("GRU", "LSTM"):
        cfg = cfg_base._replace(cell_type=cell)
        for dtype in (torch.float32, torch.bfloat16):
            ops = decode_operands(seeded_params(cfg, dtype),
                                  seeded_features(torch, CHECK_B, L, cfg,
                                                  dtype, 1))
            kw = dict(emb_size=cfg.embedding_size, cell_type=cell)
            dname = "f32" if dtype == torch.float32 else "bf16"
            # K1
            got = wd.whole_greedy_decode(*ops, max_len=T - 1, **kw)
            want = wd.whole_greedy_decode_reference(*ops, max_len=T - 1, **kw)
            torch.cuda.synchronize()
            rows = (got == want).all(dim=1)
            share = rows.float().mean().item()
            tok_share = (got == want).float().mean().item()
            log("kernels", f"K1 {cell} {dname} B={CHECK_B} T={T}: rows "
                           f"equal {share:.4f}, tokens equal {tok_share:.4f}")
            if dtype == torch.float32:
                for row in torch.nonzero(~rows)[:5, 0].tolist():
                    t = int(torch.nonzero(got[row] != want[row])[0, 0])
                    margin = first_divergence_margin(wd, ops, row, t,
                                                     cfg.sos_token, kw)
                    log("kernels", f"  row {row} diverges at step {t}: "
                                   f"twin top-2 logit margin {margin:.3e}")
                check(share >= F32_ROWS, f"K1 {cell} f32 rows equal {share} "
                                         f"< {F32_ROWS}")
            else:
                check(tok_share >= BF16_TOKENS, f"K1 {cell} bf16 tokens equal "
                                                f"{tok_share} < {BF16_TOKENS}")
                bf16_agreement(torch, wd, cfg, T, L, got, want)
            # K2, two chained segments per length, and T steps from <SOS>
            # (K1's launch) for the h error
            B, H = CHECK_B, cfg.hidden_size
            for seg_len in (1, 4, T):
                z = torch.zeros((B, H), dtype=dtype, device=DEVICE)
                sos = torch.full((B, 1), cfg.sos_token, dtype=torch.int32,
                                 device=DEVICE)
                k_state, t_state = (z, z, sos), (z, z, sos)
                k_toks, t_toks = [], []
                for _ in range(1 if seg_len == T else 2):
                    k_out = wd.whole_greedy_decode_segment(
                        *ops, *k_state, seg_len=seg_len, **kw)
                    t_out = wd.whole_greedy_decode_segment_reference(
                        *ops, *t_state, seg_len=seg_len, **kw)
                    k_state, t_state = k_out[1:], t_out[1:]
                    k_toks.append(k_out[0])
                    t_toks.append(t_out[0])
                torch.cuda.synchronize()
                k_toks, t_toks = torch.cat(k_toks, 1), torch.cat(t_toks, 1)
                rows = (k_toks == t_toks).all(dim=1)
                tok_share = (k_toks == t_toks).float().mean().item()
                # h, and c for the LSTM (a GRU carries no c)
                states = [(k_out[i], t_out[i], "hc"[i - 1])
                          for i in ((1, 2) if cell == "LSTM" else (1,))]
                err = max((float((a.float() - b.float()).abs()[rows].max())
                           if bool(rows.any()) else float("nan"))
                          for a, b, _ in states)
                log("kernels", f"K2 {cell} {dname} seg_len={seg_len}: rows "
                               f"equal {rows.float().mean().item():.4f}, "
                               f"tokens equal {tok_share:.4f}, max |state - "
                               f"twin| on those rows {err:.3e} "
                               f"({'h, c' if cell == 'LSTM' else 'h'})")
                if dtype == torch.float32:
                    check(rows.float().mean().item() >= F32_ROWS,
                          f"K2 {cell} f32 seg_len={seg_len} rows disagree")
                    check(torch.allclose(k_out[1][rows], t_out[1][rows],
                                         rtol=H_RTOL, atol=H_ATOL),
                          f"K2 {cell} f32 h off the twin beyond rtol "
                          f"{H_RTOL} atol {H_ATOL}")
                    continue
                check(tok_share >= BF16_TOKENS,
                      f"K2 {cell} bf16 seg_len={seg_len}: tokens equal "
                      f"{tok_share} < {BF16_TOKENS}")
                for a, b, what in states:
                    check(torch.allclose(a[rows].float(), b[rows].float(),
                                         rtol=BF16_RTOL, atol=BF16_ATOL),
                          f"K2 {cell} bf16 seg_len={seg_len}: {what} off the "
                          f"twin beyond rtol {BF16_RTOL} atol {BF16_ATOL}")
                name = ("whole_greedy_decode" if seg_len == T
                        else "whole_greedy_decode_segment")
                errs[name] = max(errs[name], err)
    return errs


def bf16_agreement(torch, wd, cfg, T, L, got, want):
    """The bf16 token agreement of the tensor-core body (``got``) with the
    twin (``want``), beside the CUDA-core body's on the same inputs, at
    CHECK_B and again at TIME_B rows."""
    kw = dict(emb_size=cfg.embedding_size, cell_type=cfg.cell_type,
              max_len=T - 1)
    for B in (CHECK_B, TIME_B):
        ops = decode_operands(seeded_params(cfg, torch.bfloat16),
                              seeded_features(torch, B, L, cfg,
                                              torch.bfloat16, 1))
        if B != CHECK_B:
            got = wd.whole_greedy_decode(*ops, **kw)
            want = wd.whole_greedy_decode_reference(*ops, **kw)
        cores = wd.whole_greedy_decode(*ops, cuda_cores=True, **kw)
        torch.cuda.synchronize()
        share = lambda a, b: (a == b).float().mean().item()
        log("kernels", f"  K1 {cfg.cell_type} bf16 B={B}: tokens equal to "
                       f"the twin's: tensor-core body {share(got, want):.4f}, "
                       f"CUDA-core body {share(cores, want):.4f}; the two "
                       f"bodies agree on {share(got, cores):.4f}")
        check(share(got, want) >= BF16_TOKENS,
              f"K1 {cfg.cell_type} bf16 B={B} tokens equal "
              f"{share(got, want)} < {BF16_TOKENS}")


def topk_margin(out, w, b, row, k):
    """Smallest gap between neighbours among the twin's k + 1 best f32
    logits of ``row``: how close the row is to a swap."""
    import torch
    logits = out[row].float() @ w.float() + b.float()
    top = torch.sort(logits, descending=True).values[: k + 1]
    return float((top[:-1] - top[1:]).min())


def topk_against_twin(torch, cfg):
    """K3 against its twin at the flagship beam's shapes, f32 and bf16;
    returns the max |value - twin value| on the rows whose columns agree."""
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    H, V = cfg.hidden_size, cfg.vocab_size
    g = torch.Generator(device=DEVICE).manual_seed(5)
    hidden = torch.tanh(torch.randn((max(n for n, _ in TOPK_CHECKS), H),
                                    generator=g, device=DEVICE))
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = "f32" if dtype == torch.float32 else "bf16"
        params = seeded_params(cfg, dtype)
        w, b = params["out_w"], params["out_b"]
        for n, k in TOPK_CHECKS:
            out = hidden[:n].to(dtype)
            got_v, got_i = tp.outproj_topk(out, w, b, k=k)
            want_v, want_i = tp.outproj_topk_reference(out, w, b, k=k)
            torch.cuda.synchronize()
            rows = (got_i == want_i).all(dim=1)
            share = rows.float().mean().item()
            dv = float((got_v - want_v).abs()[rows].max())
            log("kernels", f"K3 {dname} N={n} H={H} V={V} k={k}: columns "
                           f"equal on {share:.4f} of rows, max |dvalue| on "
                           f"them {dv:.3e}")
            for row in torch.nonzero(~rows)[:5, 0].tolist():
                log("kernels", f"  row {row} differs: twin top-{k + 1} "
                               f"logit margin "
                               f"{topk_margin(out, w, b, row, k):.3e}")
            check(share >= F32_ROWS, f"K3 {dname} N={n} k={k}: columns "
                                     f"equal on {share} < {F32_ROWS}")
            check(torch.allclose(got_v[rows], want_v[rows], rtol=TOPK_RTOL,
                                 atol=TOPK_ATOL),
                  f"K3 {dname} N={n} k={k}: values off the twin beyond "
                  f"rtol {TOPK_RTOL} atol {TOPK_ATOL}")
            err = max(err, dv)
        # exact ties across every vocab tile: column j of out_w is the unit
        # vector e_(j mod 8), so logit j equals out[:, j % 8] exactly
        w_tie = torch.zeros((H, V), dtype=dtype, device=DEVICE)
        cols = torch.arange(V, device=DEVICE)
        w_tie[cols % 8, cols] = 1.0
        b_tie = torch.zeros(V, dtype=dtype, device=DEVICE)
        out = hidden[:1001].to(dtype)
        got = tp.outproj_topk(out, w_tie, b_tie, k=BEAM)
        want = tp.outproj_topk_reference(out, w_tie, b_tie, k=BEAM)
        torch.cuda.synchronize()
        best = out[:, :8].float().argmax(dim=1).int()   # first of the max
        exact = (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
                 and torch.equal(got[1][:, 0], best))
        log("kernels", f"K3 {dname} tie case N=1001 V={V} k={BEAM}: columns "
                       f"and values {'equal' if exact else 'DIFFER'}")
        check(exact, f"K3 {dname} tie case differs from the twin")
    return err


def k4_operands(torch, cfg, params, enc, seed):
    """The fused step's operands at the embedding rows of random tokens
    and a random h in (-1, 1)."""
    from recnet_tpu_torch.ops.attention import precompute_uv
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    a, r = params["attention"], params["rnn"][0]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B = enc.shape[0]
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=g, device=DEVICE)
    h = torch.tanh(torch.randn((B, cfg.hidden_size), generator=g,
                               device=DEVICE)).to(enc.dtype)
    return (params["embedding"][tok], h, enc, precompute_uv(a, enc), a["W"],
            a["w"], a["b"][None, :], r["w_ih"], r["w_hh"],
            fs.pack_gru_bias(r["b_ih"], r["b_hh"]))


def fused_step_against_twin(torch, tc, cfg):
    """K4 against its twin, frame_chunk 1 and 7: f32 (CUDA-core body) at B
    = CHECK_B within H_RTOL/H_ATOL; bf16 on the tensor-core route (its
    per-body count shows it) at B = CHECK_B and TIME_B, and bf16 on the
    CUDA-core body (``cuda_cores``) at CHECK_B, h within 2 bf16 ulps; at
    TIME_B the route's two kernels each against its plain stage (X, then
    h' from the same X). Returns the tensor-core route's max |h - h_twin|
    (bf16)."""
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    L, E = tc.encoder_output_len, cfg.embedding_size
    err = 0.0
    for dtype, B, cores in ((torch.float32, CHECK_B, False),
                            (torch.bfloat16, CHECK_B, False),
                            (torch.bfloat16, TIME_B, False),
                            (torch.bfloat16, CHECK_B, True)):
        dname = "f32" if dtype == torch.float32 else "bf16"
        params = seeded_params(cfg, dtype)
        enc = seeded_features(torch, B, L, cfg, dtype, 11)
        ops = k4_operands(torch, cfg, params, enc, 12)
        tiles = (params.get("layouts") or {}).get("gates")
        body = fs.step_body(dtype, cfg.hidden_size, cores)
        for fc in K4_CHUNKS:
            kw = dict(emb_size=E, frame_chunk=fc)
            n = fs.fused_gru_attn_step.body_launches[body]
            got = fs.fused_gru_attn_step(*ops, tiles=tiles, cuda_cores=cores,
                                         **kw)
            want = fs.fused_gru_attn_step_reference(*ops, **kw)
            torch.cuda.synchronize()
            d = float((got.float() - want.float()).abs().max())
            log("kernels", f"K4 {dname} {body} B={B} frame_chunk={fc}: max "
                           f"|h - h_twin| {d:.3e}")
            check(fs.fused_gru_attn_step.body_launches[body] == n + 1,
                  f"K4 {dname} B={B} did not run on the {body} body")
            if dtype == torch.float32:
                check(torch.allclose(got, want, rtol=H_RTOL, atol=H_ATOL),
                      f"K4 f32 frame_chunk={fc}: h off the twin beyond rtol "
                      f"{H_RTOL} atol {H_ATOL}")
                continue
            check(torch.allclose(got.float(), want.float(), rtol=BF16_RTOL,
                                 atol=BF16_ATOL),
                  f"K4 bf16 {body} B={B} frame_chunk={fc}: h off the twin "
                  f"beyond rtol {BF16_RTOL} atol {BF16_ATOL}")
            if body == "tensor_cores":
                err = max(err, d)
        if dtype != torch.bfloat16 or B != TIME_B:
            continue
        # each kernel of the route against its plain stage
        fc = K4_CHUNKS[-1]
        x = fs._attention_pass(*ops[:7], frame_chunk=fc)
        x_want = fs.attention_pass_reference(*ops[:7], frame_chunk=fc)
        h_new = fs._gate_cell(x, tiles, ops[9])
        h_want = fs.gate_cell_reference(x, tiles, ops[9])
        torch.cuda.synchronize()
        F = cfg.encoder_size
        ctx, ctx_want = x[:, E:E + F].float(), x_want[:, E:E + F].float()
        exact = (torch.equal(x[:, :E], x_want[:, :E])
                 and torch.equal(x[:, E + F:], x_want[:, E + F:]))
        log("kernels", f"K4 kernel A B={B} frame_chunk={fc}: emb, pad and h "
                       f"columns of X {'equal' if exact else 'DIFFER'}, max "
                       f"|ctx - plain| {float((ctx - ctx_want).abs().max()):.3e}"
                       f"; kernel B on that X: max |h - plain| "
                       f"{float((h_new.float() - h_want.float()).abs().max()):.3e}")
        check(exact, "K4 kernel A: X's emb, pad or h columns differ")
        check(torch.allclose(ctx, ctx_want, rtol=BF16_RTOL, atol=BF16_ATOL),
              "K4 kernel A: ctx off its plain stage beyond 2 bf16 ulps")
        check(torch.allclose(h_new.float(), h_want.float(), rtol=BF16_RTOL,
                             atol=BF16_ATOL),
              "K4 kernel B: h off its plain stage beyond 2 bf16 ulps")
    return err


def variants_against_k1(torch, tc, cfg_base):
    """K5: ``dual`` tokens equal K1's on every row (GRU and LSTM, f32 and
    bf16); each ``ablate`` part against its twin in f32 (GRU and LSTM), and
    ``nativeargmax`` equal to production. Returns max |token - twin token|
    per variant."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    T, L = tc.caption_max_len + 1, tc.encoder_output_len
    errs = {}
    for cell in ("GRU", "LSTM"):
        cfg = cfg_base._replace(cell_type=cell)
        for dtype in (torch.float32, torch.bfloat16):
            ops = decode_operands(seeded_params(cfg, dtype),
                                  seeded_features(torch, CHECK_B, L, cfg,
                                                  dtype, 1))
            kw = dict(emb_size=cfg.embedding_size, max_len=T - 1,
                      cell_type=cell)
            dual = wd.whole_greedy_decode(*ops, dual=True, **kw)
            full = wd.whole_greedy_decode(*ops, cuda_cores=True, **kw)
            torch.cuda.synchronize()
            rows = (dual == full).all(dim=1).float().mean().item()
            dname = "f32" if dtype == torch.float32 else "bf16"
            log("kernels", f"K5 dual {cell} {dname} B={CHECK_B}: rows equal "
                           f"to K1 on the CUDA-core body {rows:.4f}")
            check(rows == 1.0, f"K5 dual {cell} {dname} differs from K1")
            errs["dual"] = max(errs.get("dual", 0.0),
                               float((dual - full).abs().max()))
    for cell in ("GRU", "LSTM"):
        cfg = cfg_base._replace(cell_type=cell)
        ops = decode_operands(seeded_params(cfg, torch.float32),
                              seeded_features(torch, CHECK_B, L, cfg,
                                              torch.float32, 1))
        kw = dict(emb_size=cfg.embedding_size, max_len=T - 1, cell_type=cell)
        production = wd.whole_greedy_decode(*ops, **kw)
        for part in ABLATE_PARTS:
            got = wd.whole_greedy_decode(*ops, ablate=part, **kw)
            want = wd.whole_greedy_decode_reference(*ops, ablate=part, **kw)
            torch.cuda.synchronize()
            rows = (got == want).all(dim=1).float().mean().item()
            name = f"ablate={part}"
            errs[name] = max(errs.get(name, 0.0),
                             float((got - want).abs().max()))
            log("kernels", f"K5 ablate={part} {cell} f32 B={CHECK_B}: rows "
                           f"equal to the twin {rows:.4f}")
            check(rows >= F32_ROWS, f"K5 ablate={part} {cell}: rows equal "
                                    f"{rows} < {F32_ROWS}")
            if part == "nativeargmax":
                check(torch.equal(got, production),
                      f"K5 ablate=nativeargmax {cell} differs from "
                      f"production")
    return errs


# --------------------------------------------------------------------------
# 4. the main paths: HTTP serving and evaluation with the kernels
# --------------------------------------------------------------------------

def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    for fn in (wd.whole_greedy_decode, wd.whole_greedy_decode_segment,
               tp.outproj_topk, fs.fused_gru_attn_step):
        fn.n_launches = 0
    wd.whole_greedy_decode.variant_launches.clear()
    fs.fused_gru_attn_step.body_launches.clear()


def flagship_checkpoint_dir(tmp: Path, n_vocab: int) -> Path:
    """config.json (the flagship preset) and vocab.json (synthetic words)
    of a checkpoint step directory."""
    step = tmp / "flagship" / "0"
    step.mkdir(parents=True)
    shutil.copy(FLAGSHIP, step / "config.json")
    word2idx = {"<PAD>": 0, "<SOS>": 1, "<EOS>": 2}
    word2idx.update({f"word{i}": i for i in range(3, n_vocab)})
    (step / "vocab.json").write_text(json.dumps(
        {"min_count": 1, "word2idx": word2idx, "max_sentence_len": 30}))
    return step


def request_features(seed: int, n: int, encoder_size: int):
    rng = np.random.default_rng(seed)
    return [np.round(rng.standard_normal((int(f), encoder_size)), 2)
            for f in rng.integers(8, 61, n)]


def serve(captioner, model_id, requests, beams=None):
    """POST ``requests`` concurrently through the port's handler behind a
    MicroBatcher, request i with ``"beam": beams[i]`` when that is set;
    returns the captions of each request, in order."""
    from http.server import ThreadingHTTPServer
    from recnet_tpu_torch.cli.serve import make_handler
    from recnet_tpu_torch.serving import MicroBatcher

    front = MicroBatcher(captioner, flush_ms=6.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 make_handler(front, model_id))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/caption"
    beams = beams or [None] * len(requests)
    bodies = [json.dumps({"features": [f.tolist() for f in feats],
                          **({"beam": beam} if beam else {})}).encode()
              for feats, beam in zip(requests, beams)]
    out, errors = [None] * len(bodies), []

    def client(i):
        req = urllib.request.Request(
            url, data=bodies[i], headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                out[i] = json.loads(r.read())["captions"]
        except Exception as e:  # noqa: BLE001 — reported by the phase
            errors.append(f"request {i}: {e}")

    try:
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        with urllib.request.urlopen(url.replace("caption", "healthz"),
                                    timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        front.close()
        thread.join(timeout=30)
    check(not errors, f"serving failed: {errors}")
    return out, health


def logit_gaps(torch, tc, cfg, params, token, seed, steps):
    """The gap between the max logit and ``token``'s at each of the first
    ``steps`` steps of a plain-twin probe (``params`` in f32, 64 rows of
    features drawn from ``seed``): a list of (64,) gaps."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.weights import params_from_jax
    ops = decode_operands(params_from_jax(params, DEVICE, torch.float32),
                          seeded_features(torch, 64, tc.encoder_output_len,
                                          cfg, torch.float32, seed))
    p = ops[0]
    z = torch.zeros((64, cfg.hidden_size), device=DEVICE)
    state = (z, z, torch.full((64, 1), cfg.sos_token, dtype=torch.int32,
                              device=DEVICE))
    gaps = []
    for _ in range(steps):
        _, h, c, tok = wd.whole_greedy_decode_segment_reference(
            *ops, *state, emb_size=cfg.embedding_size, seg_len=1,
            cell_type=cfg.cell_type)
        logits = h @ p["out_w"] + p["out_b"]
        gaps.append(logits.max(dim=-1).values - logits[:, token])
        state = (h, c, tok)
    return gaps


def eos_biased(torch, tc, cfg, params):
    """``params`` with out_b[<EOS>] raised so that <EOS> wins about
    EOS_WIN_SHARE of steps 1-3 of a plain-twin probe (f32, 64 rows), as a
    trained model's captions end; random weights never end. Step 0 is kept
    below <EOS>: random weights give nearly every row the same first
    logits, so a lift that wins there would end every caption at once."""
    gaps = logit_gaps(torch, tc, cfg, params, cfg.eos_token, 7, 4)
    lift = min(float(torch.quantile(torch.cat(gaps[1:]), EOS_WIN_SHARE)),
               0.9 * float(gaps[0].min()))
    out = dict(params, out_b=params["out_b"].copy())
    out["out_b"][cfg.eos_token] += lift
    log("main", f"eos variant: out_b[<EOS>] raised by {lift:.4f}")
    return out


def word_share(got, want):
    """Share of word positions at which two lists of captions agree; the
    longer caption of each pair sets its positions."""
    same = total = 0
    for g, w in zip(got, want):
        g, w = g.split(), w.split()
        same += sum(a == b for a, b in zip(g, w))
        total += max(len(g), len(w))
    return same / max(total, 1)


def main_path(torch, tc, vocab, cfg, params, eos_params):
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.serving import Captioner
    kw = dict(dtype="bfloat16", device=DEVICE, use_pallas=tc.use_pallas)
    cap_k2 = Captioner(tc, vocab, params, greedy_segment=tc.greedy_segment,
                       **kw)
    cap_eos = Captioner(tc, vocab, eos_params,
                        greedy_segment=tc.greedy_segment, **kw)
    cap_k1 = Captioner(tc, vocab, params, greedy_segment=None, **kw)
    log("main", f"flagship {tc.decoder_model} H={cfg.hidden_size} "
                f"V={cfg.vocab_size} E={cfg.embedding_size} "
                f"A={cfg.attn_size} {tc.encoder_output_len}x"
                f"{cfg.encoder_size} T={tc.caption_max_len + 1} bf16 "
                f"use_pallas={tc.use_pallas} "
                f"greedy_segment={tc.greedy_segment}")
    sizes = (1, 37, 300)
    requests = [request_features(10 + i, n, cfg.encoder_size)
                for i, n in enumerate(sizes)]

    reset_counts()
    t0 = time.perf_counter()
    caps_k2, health = serve(cap_k2, tc.id, requests)
    k2_plain = wd.whole_greedy_decode_segment.n_launches
    caps_eos, health_eos = serve(cap_eos, tc.id, requests)
    k2_eos = wd.whole_greedy_decode_segment.n_launches - k2_plain
    caps_k1, _ = serve(cap_k1, tc.id, requests)
    launches = {"whole_greedy_decode": wd.whole_greedy_decode.n_launches,
                "whole_greedy_decode_segment":
                    wd.whole_greedy_decode_segment.n_launches}
    log("main", f"served {len(sizes)} requests of {sizes} videos three "
                f"times in {time.perf_counter() - t0:.2f} s; healthz "
                f"{health}; launches {launches}")
    for name, caps in (("K2", caps_k2), ("K2 eos", caps_eos),
                       ("K1", caps_k1)):
        check([len(c) for c in caps] == list(sizes),
              f"{name}: caption counts {[len(c) for c in caps]} != {sizes}")
    check(launches["whole_greedy_decode_segment"] > 0, "K2 never launched")
    check(launches["whole_greedy_decode"] > 0, "K1 never launched")
    check(caps_k1 == caps_k2, "K1 and K2 paths caption differently")
    n_seg = -(-(tc.caption_max_len + 1) // tc.greedy_segment)
    lengths = [len(s.split()) for c in caps_eos for s in c]
    log("main", f"eos variant: {k2_eos} K2 launches over "
                f"{health_eos['dispatches']} dispatches (a full decode is "
                f"{n_seg} per chunk); caption words mean "
                f"{np.mean(lengths):.2f} max {max(lengths)}")
    check(k2_eos < n_seg * health_eos["dispatches"], "eos_stop never fired")
    check(max(lengths) > 0, "the eos variant's captions are all empty")
    log("main", f"sample captions: {caps_k2[0][0][:80]!r} | "
                f"{caps_eos[1][0][:80]!r}")

    # bf16: the served K2 captions of the largest request (the tensor-core
    # body) against the twin's on the same prepared features, word by word
    from recnet_tpu_torch.decoding import tokens_to_sentences
    kw = dict(emb_size=cfg.embedding_size, max_len=tc.caption_max_len,
              sos=cfg.sos_token, cell_type=cfg.cell_type)
    videos = torch.from_numpy(cap_k2.prepare(requests[2])).to(
        DEVICE, torch.bfloat16)
    twin = wd.whole_greedy_decode_reference(
        *decode_operands(cap_k2.params, videos), **kw)
    want = tokens_to_sentences(twin.T.cpu().numpy(), vocab.idx2word,
                               cfg.eos_token)
    share = word_share(caps_k2[2], want)
    log("main", f"bf16 served captions: words equal to the twin's at "
                f"{share:.4f} of positions ({len(want)} videos)")
    check(share >= BF16_TOKENS, f"bf16 served captions: words equal to the "
                                f"twin's at {share} < {BF16_TOKENS}")

    # f32 on the card: kernel path against the plain twin, per video
    cap_f32 = Captioner(tc, vocab, eos_params, dtype="float32",
                        device=DEVICE, use_pallas=True,
                        greedy_segment=tc.greedy_segment)
    feats = requests[2]
    got = cap_f32.caption(feats)
    videos = torch.from_numpy(cap_f32.prepare(feats)).to(DEVICE,
                                                         torch.float32)
    ops = decode_operands(cap_f32.params, videos)
    twin = wd.whole_greedy_decode_reference(*ops, **kw)
    want = tokens_to_sentences(twin.T.cpu().numpy(), vocab.idx2word,
                               cfg.eos_token)
    share = float(np.mean([g == w for g, w in zip(got, want)]))
    log("main", f"f32 kernel-path captions equal to the twin's on "
                f"{share:.4f} of {len(feats)} videos")
    check(share >= F32_ROWS, f"f32 captions agree on {share} < {F32_ROWS}")
    return launches


def beam_path(torch, tc, vocab, cfg, params):
    """Beam-5 requests mixed with greedy ones through the HTTP front, from
    the bf16 flagship Captioner with use_pallas; then f32 beam captions of
    the K3 route against the plain route. Returns K3's launches in the
    served run."""
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.serving import Captioner
    cap = Captioner(tc, vocab, params, dtype="bfloat16", device=DEVICE,
                    use_pallas=tc.use_pallas,
                    greedy_segment=tc.greedy_segment)
    sizes, beams = (1, 20, 37, 9), (BEAM, None, BEAM, BEAM)
    requests = [request_features(20 + i, n, cfg.encoder_size)
                for i, n in enumerate(sizes)]
    reset_counts()
    t0 = time.perf_counter()
    caps, health = serve(cap, tc.id, requests, beams)
    launches = tp.outproj_topk.n_launches
    log("beam", f"served requests of {sizes} videos with beams {beams} in "
                f"{time.perf_counter() - t0:.2f} s; healthz {health}; "
                f"outproj_topk launches {launches}")
    check([len(c) for c in caps] == list(sizes),
          f"beam: caption counts {[len(c) for c in caps]} != {sizes}")
    check(launches > 0, "K3 never launched on the beam requests")
    check(all(isinstance(c, str) for r in caps for c in r),
          "beam: a caption is not a string")
    log("beam", f"sample beam caption: {caps[2][0][:80]!r}")

    feats = request_features(30, BEAM_CHECK_VIDEOS, cfg.encoder_size)
    got, want = (Captioner(tc, vocab, params, dtype="float32", device=DEVICE,
                           use_pallas=use_pallas).caption(feats,
                                                          beam_width=BEAM)
                 for use_pallas in (True, False))
    share = float(np.mean([g == w for g, w in zip(got, want)]))
    log("beam", f"f32 beam-{BEAM} captions, K3 route against the plain "
                f"route: equal on {share:.4f} of {len(feats)} videos")
    check(share >= F32_ROWS, f"f32 beam captions agree on {share} < "
                             f"{F32_ROWS}")
    return launches


def eval_path(torch, tc, vocab, cfg, params_np, tmp: Path):
    """``evaluation.evaluate`` with beam 5 and greedy at the flagship width
    (f32 params, as a trained checkpoint holds them, use_pallas and
    greedy_segment from the preset) on an in-memory score corpus of random
    features and reference captions. Returns each kernel's launches."""
    import types
    from recnet_tpu_torch.evaluation import evaluate
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.weights import params_from_jax
    params = params_from_jax(params_np, DEVICE, torch.float32)
    rng = np.random.default_rng(40)
    vids = [f"vid{i}" for i in range(EVAL_VIDEOS)]
    bs, L, Fdim = tc.batch_size, tc.encoder_output_len, cfg.encoder_size
    batches = []
    for start in range(0, len(vids), bs):
        chunk = vids[start:start + bs]
        batches.append((chunk + ["PAD"] * (bs - len(chunk)),
                        rng.standard_normal((bs, L, Fdim)).astype(np.float32)))
    words = [vocab.idx2word[i] for i in range(3, 40)]
    pairs = [(v, " ".join(rng.choice(words, int(rng.integers(3, 9)))))
             for v in vids for _ in range(3)]
    corpus = types.SimpleNamespace(
        score_batcher=batches, vocab=vocab,
        test_dataset=types.SimpleNamespace(video_caption_pairs=pairs))
    launches = {}
    for search in (("beam", BEAM), "greedy"):
        reset_counts()
        name = search if isinstance(search, str) else f"beam {search[1]}"
        pred = tmp / f"predictions {name}.txt"
        t0 = time.perf_counter()
        scores = evaluate(tc, corpus, params, cfg, search,
                          predictions_fpath=str(pred), n_test=EVAL_VIDEOS)
        launches[name] = {
            "outproj_topk": tp.outproj_topk.n_launches,
            "whole_greedy_decode_segment":
                wd.whole_greedy_decode_segment.n_launches}
        lines = pred.read_text().splitlines()
        log("eval", f"evaluate {name}, {len(batches)} batches of {bs}: "
                    f"{time.perf_counter() - t0:.2f} s, {len(lines)} "
                    f"predictions, launches {launches[name]}, scores "
                    f"{ {k: round(v, 4) for k, v in scores.items()} }")
        check(len(lines) == EVAL_VIDEOS and all("\t\t" in x for x in lines),
              f"evaluate {name}: predictions.txt malformed")
        check(set(tc.scores) <= set(scores)
              and all(np.isfinite(v) for v in scores.values()),
              f"evaluate {name}: scores {scores}")
    check(launches[f"beam {BEAM}"]["outproj_topk"] > 0,
          "K3 never launched in evaluate")
    check(launches["greedy"]["whole_greedy_decode_segment"] > 0,
          "K2 never launched in evaluate")
    return launches


def pallas_loop(torch, cfg, params, enc, T, step):
    """The loop of ``decoding.greedy_decode_pallas`` with ``step`` (K4's
    plain twin, or K4 on a chosen body) in place of the wrapper's default,
    on the same card tensors: tokens (T, B) of the embedding gather, the
    step, the projection and the first-max argmax (random weights: no step
    is all <PAD>, so nothing freezes)."""
    from recnet_tpu_torch.ops.attention import precompute_uv
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    a, r = params["attention"], params["rnn"][0]
    uv = precompute_uv(a, enc)
    bias3 = fs.pack_gru_bias(r["b_ih"], r["b_hh"])
    h = torch.zeros((enc.shape[0], cfg.hidden_size), dtype=enc.dtype,
                    device=enc.device)
    token = torch.full((enc.shape[0],), cfg.sos_token, dtype=torch.int32,
                       device=enc.device)
    tokens = []
    for _ in range(T):
        emb = params["embedding"][token] * cfg.embedding_scale
        h = step(emb, h, enc, uv, a["W"], a["w"], a["b"][None, :],
                 r["w_ih"], r["w_hh"], bias3, emb_size=cfg.embedding_size)
        logits = h @ params["out_w"] + params["out_b"]
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens.append(token)
    return torch.stack(tokens)


def pallas_path(torch, tc, cfg, params_np):
    """``decoding.greedy_decode_pallas`` (the K4 loop) at B = TIME_B bf16,
    with K4's launches counted (all T on the tensor-core route), its tokens
    held against the same loop through K4's twin (BF16_TOKENS), beside
    that loop on K4's CUDA-core body; then its
    f32 tokens and n_steps at B = CHECK_B against plain ``greedy_decode``'s,
    on the random weights, whose rows run all T steps. Returns K4's
    launches."""
    from recnet_tpu_torch import decoding
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    from recnet_tpu_torch.weights import params_from_jax
    T, L = tc.caption_max_len + 1, tc.encoder_output_len
    params = params_from_jax(params_np, DEVICE, torch.bfloat16)
    enc = seeded_features(torch, TIME_B, L, cfg, torch.bfloat16, 3)
    reset_counts()
    t0 = time.perf_counter()
    res = decoding.greedy_decode_pallas(params, cfg, enc, T - 1)
    torch.cuda.synchronize()
    launches = fs.fused_gru_attn_step.n_launches
    bodies = dict(fs.fused_gru_attn_step.body_launches)
    log("pallas", f"greedy_decode_pallas B={TIME_B} bf16 T={T}: "
                  f"{time.perf_counter() - t0:.2f} s, n_steps {res.n_steps}, "
                  f"K4 launches {launches} by body {bodies}")
    check(launches == T, f"K4 launched {launches} times, not T = {T}")
    check(bodies == {"tensor_cores": T},
          f"bf16 K4 did not run all {T} steps on the tensor-core route")
    check(tuple(res.tokens.shape) == (T, TIME_B)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "greedy_decode_pallas tokens malformed")
    twin = pallas_loop(torch, cfg, params, enc, T,
                       fs.fused_gru_attn_step_reference)
    cores = pallas_loop(torch, cfg, params, enc, T, functools.partial(
        fs.fused_gru_attn_step, cuda_cores=True))
    share = (res.tokens == twin).float().mean().item()
    log("pallas", f"bf16 B={TIME_B}: tokens equal to the loop through K4's "
                  f"twin {share:.4f}; the same loop on the CUDA-core body "
                  f"{(cores == twin).float().mean().item():.4f}")
    check(share >= BF16_TOKENS, f"greedy_decode_pallas bf16 tokens equal "
                                f"{share} < {BF16_TOKENS}")
    f32 = params_from_jax(params_np, DEVICE, torch.float32)
    enc = seeded_features(torch, CHECK_B, L, cfg, torch.float32, 13)
    got = decoding.greedy_decode_pallas(f32, cfg, enc, T - 1)
    want = decoding.greedy_decode(f32, cfg, enc, T - 1)
    rows = (got.tokens == want.tokens).all(dim=0)
    share = rows.float().mean().item()
    first = [int(torch.nonzero(got.tokens[:, r] != want.tokens[:, r])[0, 0])
             for r in torch.nonzero(~rows)[:5, 0].tolist()]
    log("pallas", f"f32 B={CHECK_B}: all {T} tokens equal to plain "
                  f"greedy_decode's on {share:.4f} of rows (first steps that "
                  f"differ {first}); n_steps {got.n_steps} vs "
                  f"{want.n_steps}; tokens of row 0 "
                  f"{got.tokens[:6, 0].tolist()}...")
    check(share >= F32_ROWS, f"greedy_decode_pallas f32 rows agree on "
                             f"{share} < {F32_ROWS}")
    check(got.n_steps == want.n_steps, "greedy_decode_pallas n_steps differ")
    return launches


def pad_timed(torch, tc, cfg, params):
    """``params`` (a 1-layer GRU) with a timer for <PAD>, so that rows take
    <PAD> at steps of their own and blocks exit early at different steps.
    Hidden unit 0 loses its input and recurrent weights and gets the gate
    biases z = zeta, n = nu (PAD_TIMER), so that after step t it holds
    nu (1 - zeta^(t+1)) on every row. Only the <PAD> logit reads it:
    beta * h_0 + b, with no other weight in out_w[:, <PAD>] or out_w[0].
    A row takes <PAD> once this ramp passes its own max logit, and keeps
    it as the ramp climbs on. beta and b put the ramp, in a plain-twin
    probe with the <PAD> logit held at 0, at the smallest max logit of
    steps 0-1 at step 1 and at the largest of any step at step ``full``
    (PAD_TIMER)."""
    H, T, pad = cfg.hidden_size, tc.caption_max_len + 1, cfg.pad_token
    zeta, nu, full = PAD_TIMER
    rnn = {k: v.copy() for k, v in params["rnn"][0].items()}
    gates = [0, H, 2 * H]                        # unit 0's r, z, n
    rnn["w_ih"][:, gates] = 0.0
    rnn["w_hh"][:, gates] = 0.0
    rnn["b_hh"][gates] = 0.0
    rnn["b_ih"][gates] = [0.0, np.log(zeta / (1 - zeta)), np.arctanh(nu)]
    out = dict(params, rnn=[rnn], out_w=params["out_w"].copy(),
               out_b=params["out_b"].copy())
    out["out_w"][0, :] = 0.0
    out["out_w"][:, pad] = 0.0
    out["out_b"][pad] = 0.0
    gaps = torch.stack(logit_gaps(torch, tc, cfg, out, pad, 8, T))  # (T, 64)
    ramp = lambda t: nu * (1 - zeta ** (t + 1))     # h_0 after step t
    lo, hi = float(gaps[:2].min()), float(gaps.max())
    beta = (hi - lo) / (ramp(full) - ramp(1))
    out["out_w"][0, pad] = beta
    out["out_b"][pad] = lo - beta * ramp(1)
    log("early", f"pad variant: unit 0 times <PAD>, beta {beta:.4f}, "
                 f"out_b[<PAD>] {lo - beta * ramp(1):.4f} (probe max logits "
                 f"{lo:.4f} at steps 0-1 to {hi:.4f})")
    return out


def block_stops(torch, full, what):
    """The step at which each 8-row block of the full decode ``full`` (B,
    T) is first all 0, where its early exit stops (T where it never is).
    Fails unless the blocks stop at more than one step, most of them after
    step 0 and at least EARLY_STOP_BLOCKS of them before the last step,
    and some row takes a word again after its block's stop: only then does
    a kernel that stops too early or too late differ from its twin.
    Returns (B, T): whether each column lies after its block's stop."""
    T = full.shape[1]
    zero = (full == 0).view(-1, 8, T).all(dim=1)           # (blocks, T)
    stop = torch.where(zero.any(dim=1), zero.int().argmax(dim=1), T)
    after = (torch.arange(T, device=full.device)[None, :]
             > stop.repeat_interleave(8)[:, None])         # (B, T)
    resurrect = int(((full != 0) & after).any(dim=1).sum())
    stopped = (stop < T - 1).float().mean().item()
    after0 = (stop > 0).float().mean().item()
    hist = sorted(collections.Counter(stop.tolist()).items())
    log("early", f"{what}: {len(stop)} blocks stop at steps (step, blocks) "
                 f"{hist}; {stopped:.4f} before step {T - 1}, {after0:.4f} "
                 f"after step 0; {resurrect} rows take a word after their "
                 f"block's stop")
    check(len(hist) > 1 and after0 > 0.5 and stopped >= EARLY_STOP_BLOCKS
          and resurrect > 0,
          f"{what}: the blocks' stops {hist} ({resurrect} rows take a word "
          f"after them) do not test the early exit")
    return after


def early_exit_path(torch, tc, cfg, pad_np):
    """K5's early exit on the PAD-timed weights: the kernel against its
    twin (f32, B = CHECK_B, the CUDA-core body); then ``decoding.
    greedy_decode_whole(early_exit=True)`` at B = TIME_B bf16 (the
    tensor-core body), with its launches counted, against the full K1
    decode and against its twin (BF16_TOKENS of tokens). Each full decode
    first shows that its blocks stop at different steps (``block_stops``).
    Returns (launches, the bf16 run's max |token - twin token|)."""
    from recnet_tpu_torch import decoding
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.weights import params_from_jax
    T, L = tc.caption_max_len + 1, tc.encoder_output_len
    ops = decode_operands(params_from_jax(pad_np, DEVICE, torch.float32),
                          seeded_features(torch, CHECK_B, L, cfg,
                                          torch.float32, 1))
    kw = dict(emb_size=cfg.embedding_size, max_len=T - 1,
              cell_type=cfg.cell_type, early_exit=True)
    got = wd.whole_greedy_decode(*ops, **kw)
    want = wd.whole_greedy_decode_reference(*ops, **kw)
    twin_full = wd.whole_greedy_decode_reference(
        *ops, **dict(kw, early_exit=False))
    torch.cuda.synchronize()
    block_stops(torch, twin_full, f"full twin f32 B={CHECK_B}")
    rows = (got == want).all(dim=1).float().mean().item()
    log("early", f"early_exit f32 B={CHECK_B}: rows equal to the twin "
                 f"{rows:.4f}")
    check(rows >= F32_ROWS, f"early_exit f32 rows equal {rows} < {F32_ROWS}")

    params = params_from_jax(pad_np, DEVICE, torch.bfloat16)
    enc = seeded_features(torch, TIME_B, L, cfg, torch.bfloat16, 3)
    reset_counts()
    early = decoding.greedy_decode_whole(params, cfg, enc, T - 1,
                                         early_exit=True)
    torch.cuda.synchronize()
    launches = wd.whole_greedy_decode.variant_launches["early_exit"]
    full = decoding.greedy_decode_whole(params, cfg, enc, T - 1)
    torch.cuda.synchronize()
    check(launches == 1, f"early_exit launched {launches} times, not once")
    e, f = early.tokens.T, full.tokens.T                   # (B, T)
    after = block_stops(torch, f, f"full K1 bf16 B={TIME_B}")
    quiet = ~((f != 0) & after).any(dim=1)     # tail all <PAD> after stop
    same = (e == f).all(dim=1)
    expected = torch.where(after, 0, f)
    log("early", f"early_exit bf16 B={TIME_B}: rows equal to full K1 "
                 f"{same.float().mean().item():.4f}; every row equals K1 "
                 f"with the tail after its block's stop zeroed: "
                 f"{bool(torch.equal(e, expected))}; n_steps "
                 f"{early.n_steps} vs {full.n_steps}; launches {launches}")
    check(bool(same[quiet].all()),
          "early exit differs from K1 on a row that does not resurrect")
    check(torch.equal(e, expected), "early exit differs from K1 on the "
                                    "steps its block ran")
    twin = wd.whole_greedy_decode_reference(*decode_operands(params, enc),
                                            **kw)
    torch.cuda.synchronize()
    share = (e == twin).float().mean().item()
    log("early", f"early_exit bf16 B={TIME_B}: tokens equal to the twin's "
                 f"{share:.4f}")
    check(share >= BF16_TOKENS, f"early_exit bf16 tokens equal {share} < "
                                f"{BF16_TOKENS}")
    return launches, float((e - twin).abs().max())


# --------------------------------------------------------------------------
# 5. times
# --------------------------------------------------------------------------

def timed(torch, fn, reps=3):
    """(device ms by CUDA events, wall ms) per call, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1000 / reps
    return start.elapsed_time(end) / reps, wall


def device_ms(torch, fn, names=("",), reps=10):
    """{name: device ms per call} of the work on the card whose names
    contain each of ``names`` ("" takes all of it), over ``reps`` calls of
    ``fn`` after a warm-up, by torch.profiler: the kernels' own time, where
    CUDA events around calls that the host paces read the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for ev in prof.events():
        for name in names:
            if ev.device_type == DeviceType.CUDA and name in ev.name:
                us[name] += ev.device_time
    check(all(us.values()), f"the profiler saw no device time for {names}")
    return {name: t / reps / 1000 for name, t in us.items()}


def host_ms(torch, fn, reps=50):
    """Host ms per call of ``fn``: the wall time to issue ``reps`` calls
    back to back after a warm-up and a sync, not waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1000 / reps
    torch.cuda.synchronize()
    return ms


def bound(flops, nbytes):
    """(bound ms, "operations" or "bytes"): the larger of the two times."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decode_work(cfg, L, B, row_steps, n_steps, ablate="", state=False):
    """(flops, bytes) of greedy decode steps in bf16: ``row_steps`` rows x
    steps run (B x n_steps unless blocks stop early), each input read once
    (weights, enc, uv; h and c when ``state``), tokens written once.
    ``ablate`` drops the work of the stubbed part."""
    E, F, H, A, V = (cfg.embedding_size, cfg.encoder_size, cfg.hidden_size,
                     cfg.attn_size, cfg.vocab_size)
    G, K = (3 if cfg.cell_type == "GRU" else 4) * H, E + F
    attn, proj = ablate == "attn", ablate == "proj"
    macs = ((K + H) * G + (0 if attn else H * A)
            + (0 if attn or ablate == "score1" else L * A)
            + (0 if attn or ablate == "fma" else L * F)
            + (0 if proj else H * V))
    weights = (V * E + K * G + H * G + 2 * G + (0 if attn else H * A + 2 * A)
               + (0 if proj else H * V + V))
    acts = ((0 if attn or ablate == "fma" else B * L * F)
            + (0 if attn else B * L * A) + (4 * B * H if state else 0))
    return 2 * row_steps * macs, 2 * (weights + acts) + 4 * B * n_steps


# a read-only kernel: every thread reads 16 bytes at a time through L2
# (ld.global.cg, no L1), `passes` times over the buffer: grid-stride
# (disjoint reads), or with `same` every block the whole buffer in order
READ_PROBE_SRC = r"""
#include <cuda_runtime.h>
__global__ void read_probe(const uint4* __restrict__ p, long long n,
                           int passes, int same, unsigned* sink) {
  unsigned acc = 0;
  const long long start =
      same ? threadIdx.x : blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride =
      same ? blockDim.x : (long long)gridDim.x * blockDim.x;
  for (int r = 0; r < passes; ++r) {
#pragma unroll 8
    for (long long i = start; i < n; i += stride) {
      const uint4 v = __ldcg(p + i);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x9e3779b9u) sink[0] = acc;   // keeps the loads
}
extern "C" int run_read_probe(const void* p, long long n16, int passes,
                              int same, void* sink, int blocks, int threads,
                              void* stream) {
  read_probe<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)p, n16, passes, same, (unsigned*)sink);
  return (int)cudaGetLastError();
}
"""


def read_probe_library(build):
    """READ_PROBE_SRC built with nvcc into ``build``'s directory and bound
    with ctypes."""
    import ctypes
    src = build.build_dir() / "read_probe.cu"
    lib_path = src.with_suffix(".so")
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(READ_PROBE_SRC)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.run_read_probe.argtypes = [p, ctypes.c_longlong, i, i, p, i, i, p]
    lib.run_read_probe.restype = i
    return lib


def read_rates(torch):
    """``--read-rates``: READ_PROBE_SRC (built with nvcc into build/) over a
    12 MiB buffer that stays in the 50 MB L2: disjoint reads across the
    grid, 50 passes a launch; every one of 128 blocks (K1's grid at B =
    1024) reading the whole buffer in the same order, as K1's blocks read
    the weights, with 512 threads a block (K1's) and with 1024; then the
    device-memory rate, one disjoint pass over 2 GiB. Logs GB/s of each."""
    from recnet_tpu_torch.ops.cuda import build
    card = card_line()
    lib = read_probe_library(build)
    sink = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    grid = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for what, nbytes, passes, same, blocks, threads in (
            ("L2, disjoint", L2_PROBE_BYTES, 50, 0, grid, 512),
            ("L2, every block the whole buffer", L2_PROBE_BYTES, 2, 1, 128,
             512),
            ("L2, every block the whole buffer", L2_PROBE_BYTES, 2, 1, 128,
             1024),
            ("HBM, disjoint", 2 ** 31, 1, 0, grid, 512)):
        buf = torch.ones(nbytes // 4, dtype=torch.int32, device=DEVICE)

        def run():
            err = lib.run_read_probe(buf.data_ptr(), nbytes // 16, passes,
                                     same, sink.data_ptr(), blocks, threads,
                                     stream)
            check(err == 0, f"read probe launch failed ({err})")
        ms = timed(torch, run, reps=5)[0]
        total = nbytes * passes * (blocks if same else 1)
        log("rates", f"{what} ({nbytes} bytes, {blocks} x {threads} "
                     f"threads, 16 bytes a load): {total / ms / 1e6:.1f} "
                     f"GB/s ({card})")
        del buf


def k4_work(cfg, L, B):
    """(flops, bytes) of one fused step in bf16: the products W h, the
    scores, ctx and the gates; each input read once (emb, h, enc, uv and
    the weights), h' written once."""
    E, F, H, A = (cfg.embedding_size, cfg.encoder_size, cfg.hidden_size,
                  cfg.attn_size)
    G = 3 * H
    return (2 * B * ((E + F + H) * G + H * A + L * A + L * F),
            2 * (B * E + 2 * B * H + B * L * F + B * L * A + H * A + 2 * A
                 + (E + F + H) * G + 2 * G))


def core_kernels(torch, tc, cfg, params, enc):
    """K1, K2 (seg_len 4), K3 and K4 at the timed shapes: B = enc's rows,
    K3 at B x BEAM rows of GRU output (the flagship beam's). Each as
    (kernel, plain twin, library route, (flops, bytes) of its work, timing
    reps); K3's library route is ``beam_decode``'s plain one, cuBLAS then
    the top-K; K4's is ``gru_attn_step_reference``, a composition of about
    ten PyTorch calls (cuBLAS and einsum), since no single call computes
    the step. K4 reads the parameter set's gate tiles. Imports the package
    first on sys.path, so that ``--compare`` times another tree's with
    it."""
    from recnet_tpu_torch import decoding
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    B, T, dtype = enc.shape[0], tc.caption_max_len + 1, enc.dtype
    L, H = tc.encoder_output_len, cfg.hidden_size
    ops = decode_operands(params, enc)
    kw = dict(emb_size=cfg.embedding_size, cell_type=cfg.cell_type)
    k1 = dict(max_len=T - 1, **kw)
    z = torch.zeros((B, H), dtype=dtype, device=DEVICE)
    sos = torch.full((B, 1), cfg.sos_token, dtype=torch.int32, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(6)
    hidden = torch.tanh(torch.randn((B * BEAM, H), generator=g,
                                    device=DEVICE)).to(dtype)
    w, b = params["out_w"], params["out_b"]
    padded = (params.get("layouts") or {}).get("out_w_padded")
    k3 = dict(k=BEAM, **({"padded_w": padded} if padded is not None else {}))
    N, V = B * BEAM, cfg.vocab_size
    k4 = k4_operands(torch, cfg, params, enc, 14)
    tiles = (params.get("layouts") or {}).get("gates")
    k4kw = dict(emb_size=cfg.embedding_size,
                **({"tiles": tiles} if tiles is not None else {}))
    return {
        "whole_greedy_decode": (
            lambda: wd.whole_greedy_decode(*ops, **k1),
            lambda: wd.whole_greedy_decode_reference(*ops, **k1),
            lambda: decoding.greedy_decode(params, cfg, enc, T - 1),
            decode_work(cfg, L, B, B * T, T), 3),
        "whole_greedy_decode_segment": (
            lambda: wd.whole_greedy_decode_segment(*ops, z, z, sos,
                                                   seg_len=4, **kw),
            lambda: wd.whole_greedy_decode_segment_reference(
                *ops, z, z, sos, seg_len=4, **kw),
            lambda: decoding.greedy_decode(params, cfg, enc, 3),
            decode_work(cfg, L, B, B * 4, 4, state=True), 3),
        "outproj_topk": (
            lambda: tp.outproj_topk(hidden, w, b, **k3),
            lambda: tp.outproj_topk_reference(hidden, w, b, k=BEAM),
            lambda: tp.topk_rounds(hidden @ w + b, BEAM),
            (2 * N * H * V, 2 * (N * H + H * V + V) + 8 * N * BEAM), 10),
        "fused_gru_attn_step": (
            lambda: fs.fused_gru_attn_step(*k4, **k4kw),
            lambda: fs.fused_gru_attn_step_reference(
                *k4, emb_size=cfg.embedding_size),
            lambda: fs.gru_attn_step_reference(
                *k4[:9], k4[9][0], k4[9][1], cfg.embedding_size),
            k4_work(cfg, L, B), 10),
    }


def times(torch, tc, cfg, params_np, eos_np, pad_np):
    from recnet_tpu_torch import decoding
    from recnet_tpu_torch.ops.attention import precompute_uv
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.weights import params_from_jax

    B, T, dtype = TIME_B, tc.caption_max_len + 1, torch.bfloat16
    params = params_from_jax(params_np, DEVICE, dtype)
    eos_params = params_from_jax(eos_np, DEVICE, dtype)
    pad_params = params_from_jax(pad_np, DEVICE, dtype)
    enc = seeded_features(torch, B, tc.encoder_output_len, cfg, dtype, 3)
    ops = decode_operands(params, enc)
    kw = dict(emb_size=cfg.embedding_size, cell_type=cfg.cell_type)
    card = card_line()
    L, E = tc.encoder_output_len, cfg.embedding_size
    N = B * BEAM
    entries = {}

    def entry(name, kernel, plain, library, work, reps=3):
        """Time the kernel, its plain twin and the library route (None
        where there is none) on the same inputs; bound from ``work``."""
        ms, plain_ms = (timed(torch, fn, reps)[0] for fn in (kernel, plain))
        bound_ms, bound_by = bound(*work)
        entries[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=timed(torch, library, reps)[0] if library else None)

    core = core_kernels(torch, tc, cfg, params, enc)
    for name, args in core.items():
        entry(name, *args)
    k1 = dict(max_len=T - 1, **kw)
    k1_twin = lambda: wd.whole_greedy_decode_reference(*ops, **k1)
    k1_library = lambda: decoding.greedy_decode(params, cfg, enc, T - 1)
    k1_work = decode_work(cfg, L, B, B * T, T)
    # K4 (in core_kernels): its ms and library_ms by CUDA events, as every
    # row's. A call's checks and launches take about as long on the host as
    # its kernels on the card, so the host paces repeated calls: the device
    # time by the profiler (device_ms, library_device_ms, and the two
    # kernels apart) and the host time of a call (host_ms; a launch of the
    # loop's step_launcher, checked once a decode) beside them. Its
    # CUDA-core body in the same run
    route, _, library, _, _ = core["fused_gru_attn_step"]
    k4 = k4_operands(torch, cfg, params, enc, 14)
    tiles = params["layouts"]["gates"]
    cores = lambda: fs.fused_gru_attn_step(*k4, emb_size=E, cuda_cores=True)
    step = fs.step_launcher(*k4, emb_size=E, tiles=tiles)
    e = entries["fused_gru_attn_step"]
    split = device_ms(torch, route, ("attn_pass", "gate_gemm"))
    e.update(device_ms=sum(split.values()),
             library_device_ms=device_ms(torch, library)[""],
             attn_pass_ms=split["attn_pass"], gate_gemm_ms=split["gate_gemm"],
             host_ms=host_ms(torch, route))
    # the same two kernels at B = 8: the part of their time that does not
    # shrink with the batch
    k4_8 = k4_operands(torch, cfg, params, enc[:8].contiguous(), 14)
    split8 = device_ms(torch, lambda: fs.fused_gru_attn_step(
        *k4_8, emb_size=E, tiles=tiles), ("attn_pass", "gate_gemm"))
    log("times", f"fused_gru_attn_step B={B} bf16 frame_chunk 1, by CUDA "
                 f"events: tensor-core route {e['ms']:.4f} ms, CUDA-core body "
                 f"(cuda_cores) {timed(torch, cores, 10)[0]:.4f} ms, library "
                 f"route (a composition: gru_attn_step_reference, cuBLAS + "
                 f"einsum) {e['library_ms']:.4f} ms; device time by the "
                 f"profiler: route {e['device_ms']:.4f} ms (kernel A, the "
                 f"attention pass, {e['attn_pass_ms']:.4f} ms; kernel B, the "
                 f"gate GEMM + GRU cell, {e['gate_gemm_ms']:.4f} ms), "
                 f"CUDA-core body {device_ms(torch, cores)['']:.4f} ms, "
                 f"library {e['library_device_ms']:.4f} ms; host time a "
                 f"call {e['host_ms']:.4f} ms, a step_launcher launch "
                 f"{host_ms(torch, lambda: step(k4[0], k4[1])):.4f} ms; bound "
                 f"{e['bound_ms']:.4f} ms ({e['bound_by']}); at B=8 kernel A "
                 f"{split8['attn_pass']:.4f} ms, kernel B "
                 f"{split8['gate_gemm']:.4f} ms ({card})")
    # the K5 early exit on the PAD-timed weights, dual and the CUDA-core
    # production step against K1
    pad_ops = decode_operands(pad_params, enc)
    early = dict(k1, early_exit=True)
    full_pad = wd.whole_greedy_decode(*pad_ops, **k1)
    zero = torch.ones((-(-B // 8) * 8, T), dtype=torch.bool, device=DEVICE)
    zero[:B] = full_pad == 0
    zero = zero.view(-1, 8, T).all(dim=1)
    stop = torch.where(zero.any(dim=1), zero.int().argmax(dim=1) + 1, T)
    row_steps = int((stop.clamp(max=T) * 8).sum())   # rows x steps run
    entry("whole_greedy_decode[early_exit]",
          lambda: wd.whole_greedy_decode(*pad_ops, **early),
          lambda: wd.whole_greedy_decode_reference(*pad_ops, **early),
          lambda: decoding.greedy_decode(pad_params, cfg, enc, T - 1),
          decode_work(cfg, L, B, row_steps, T))
    full_pad_ms = timed(torch, lambda: wd.whole_greedy_decode(
        *pad_ops, **k1))[0]
    entry("whole_greedy_decode[dual]",
          lambda: wd.whole_greedy_decode(*ops, dual=True, **k1), k1_twin,
          k1_library, k1_work)
    entry("whole_greedy_decode[cuda_cores]",
          lambda: wd.whole_greedy_decode(*ops, cuda_cores=True, **k1),
          k1_twin, k1_library, k1_work)
    for name, e in entries.items():
        shape = f"N={N} k={BEAM}" if name == "outproj_topk" else f"B={B}"
        library = ("none" if e["library_ms"] is None
                   else f"{e['library_ms']:.3f} ms")
        log("times", f"{name} {shape} bf16: kernel {e['ms']:.3f} ms, plain "
                     f"twin {e['plain_ms']:.3f} ms, library route {library}, "
                     f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}) "
                     f"({card})")
    log("times", f"PAD-timed weights B={B} bf16: K1 early_exit "
                 f"{entries['whole_greedy_decode[early_exit]']['ms']:.3f} ms "
                 f"({row_steps} of {B * T} row-steps), full K1 "
                 f"{full_pad_ms:.3f} ms; dual "
                 f"{entries['whole_greedy_decode[dual]']['ms']:.3f} ms and "
                 f"the CUDA-core step "
                 f"{entries['whole_greedy_decode[cuda_cores]']['ms']:.3f} ms "
                 f"against production K1 "
                 f"{entries['whole_greedy_decode']['ms']:.3f} ms ({card})")
    paths = {
        "K2 segmented (greedy_segment=4, eos_stop)": lambda: (
            decoding.greedy_decode_whole_segmented(
                params, cfg, enc, T - 1, segment=4, eos_stop=True)),
        "K2 segmented, eos-biased weights": lambda: (
            decoding.greedy_decode_whole_segmented(
                eos_params, cfg, enc, T - 1, segment=4, eos_stop=True)),
        "K1 whole": lambda: decoding.greedy_decode_whole(
            params, cfg, enc, T - 1),
        "greedy_decode_pallas (K4 loop)": lambda: (
            decoding.greedy_decode_pallas(params, cfg, enc, T - 1)),
        "K1 early_exit, PAD-timed weights": lambda: (
            decoding.greedy_decode_whole(pad_params, cfg, enc, T - 1,
                                         early_exit=True)),
        "K1 whole, PAD-timed weights": lambda: decoding.greedy_decode_whole(
            pad_params, cfg, enc, T - 1),
        "plain twin of K1": lambda: wd.whole_greedy_decode_reference(
            *decode_operands(params, enc), max_len=T - 1, **kw),
        "plain greedy_decode (early_exit)": lambda: decoding.greedy_decode(
            params, cfg, enc, T - 1, early_exit=True),
        "precompute_uv alone": lambda: precompute_uv(params["attention"],
                                                     enc),
        f"beam_decode K={BEAM}, K3 route": lambda: decoding.beam_decode(
            params, cfg, enc, BEAM, T - 1, use_pallas_topk=True),
        f"beam_decode K={BEAM}, plain route": lambda: decoding.beam_decode(
            params, cfg, enc, BEAM, T - 1, use_pallas_topk=False),
    }
    for name, fn in paths.items():
        dev_ms, wall_ms = timed(torch, fn)
        log("times", f"{name}: B={B} bf16 {dev_ms:.3f} ms by CUDA events, "
                     f"{wall_ms:.3f} ms wall; {B / dev_ms * 1000:.0f} "
                     f"captions/s (events) {B / wall_ms * 1000:.0f} "
                     f"(wall) on {card}")
    # the K4 loop: how much of a decode the card is busy (its kernels' own
    # time by the profiler, against the events around a decode)
    loop = paths["greedy_decode_pallas (K4 loop)"]
    busy = device_ms(torch, loop, reps=3)[""]
    decode_ms = timed(torch, loop)[0]
    log("times", f"greedy_decode_pallas B={B} bf16: the card busy "
                 f"{busy:.3f} ms of a {decode_ms:.3f} ms decode (idle share "
                 f"{1 - busy / decode_ms:.3f}); K4 {T} x "
                 f"{entries['fused_gru_attn_step']['device_ms']:.4f} ms of it "
                 f"({card})")
    return entries


# --------------------------------------------------------------------------
# 6. the ablation sweep of K1
# --------------------------------------------------------------------------

def ablate_sweep(torch, tc, cfg, params_np):
    """The profiling sweep of benchmarks/profile_whole_decode.py on the
    card: K1 at B = TIME_B bf16 on the CUDA-core body (the body the probes
    are variants of: its production step, each ablated part and dual),
    through the ops-level wrapper, launches counted; then each timed, the
    production step first and last, and each part's cost as full -
    variant. The production step's and each ablated part's tokens are held
    against their twins' (BF16_TOKENS of tokens equal), dual's against the
    production step's (all equal). Returns (launches by variant, {variant:
    (ms, twin ms)}, {variant: max |token - twin token|})."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.weights import params_from_jax
    T, dtype = tc.caption_max_len + 1, torch.bfloat16
    params = params_from_jax(params_np, DEVICE, dtype)
    enc = seeded_features(torch, TIME_B, tc.encoder_output_len, cfg, dtype,
                          3)
    ops = decode_operands(params, enc)
    kw = dict(emb_size=cfg.embedding_size, max_len=T - 1,
              cell_type=cfg.cell_type)
    variants = ([("cuda_cores", {"cuda_cores": True})]
                + [(f"ablate={p}", {"ablate": p}) for p in ABLATE_PARTS]
                + [("dual", {"dual": True})])
    reset_counts()
    tokens = {name: wd.whole_greedy_decode(*ops, **vkw, **kw)
              for name, vkw in variants}
    torch.cuda.synchronize()
    launches = dict(wd.whole_greedy_decode.variant_launches)
    log("ablate", f"sweep launches: {launches}")
    check(all(launches.get(name) == 1 for name, _ in variants),
          "the ablation sweep missed a variant")
    ms = {name: timed(torch, lambda vkw=vkw: wd.whole_greedy_decode(
              *ops, **vkw, **kw))[0] for name, vkw in variants}
    full = (ms["cuda_cores"] + timed(torch, lambda: wd.whole_greedy_decode(
        *ops, cuda_cores=True, **kw))[0]) / 2
    card = card_line()
    log("ablate", f"K1's CUDA-core production step B={TIME_B} bf16: "
                  f"{full:.3f} ms (mean of the first and last timing) on "
                  f"{card}")
    out, errs = {}, {}
    for name, vkw in variants:
        if name == "dual":     # the production step's tokens
            want, plain = tokens["cuda_cores"], None
        else:                  # against its twin, on the timed inputs
            twin_kw = {k: v for k, v in vkw.items() if k == "ablate"}
            want = wd.whole_greedy_decode_reference(*ops, **twin_kw, **kw)
            plain = timed(torch, lambda twin_kw=twin_kw: (
                wd.whole_greedy_decode_reference(*ops, **twin_kw, **kw)))[0]
        equal = (tokens[name] == want).float().mean().item()
        errs[name] = float((tokens[name] - want).abs().max())
        cost = full - ms[name]
        log("ablate", f"{name}: {ms[name]:.3f} ms; full - variant "
                      f"{cost:.3f} ms ({100 * cost / full:.1f}% of the step); "
                      f"tokens equal to its twin's {equal:.4f}")
        check(equal >= (1.0 if name == "dual" else BF16_TOKENS),
              f"{name} bf16 B={TIME_B}: tokens equal {equal}")
        out[name] = (ms[name], plain)
    return launches, out, errs


# --------------------------------------------------------------------------
# 8. training at the flagship width
# --------------------------------------------------------------------------

def train_config(tc):
    """The flagship preset for the [train] phase: raw (in-memory) data,
    no data bundle, short cadences on k = steps_per_dispatch boundaries."""
    k = tc.steps_per_dispatch
    return tc.replace(data_bundle=False, n_iterations=TRAIN_DISPATCHES * k,
                      log_every=k, validate_every=2 * k,
                      test_every=TRAIN_DISPATCHES * k, save_every=2 * k)


def train_corpus(tc, vocab):
    """An in-memory Corpus of ``train_splits``."""
    from recnet_tpu_torch.data import Corpus
    return Corpus(tc, vocab=vocab, splits=train_splits(tc, vocab))


def train_splits(tc, vocab):
    """In-memory splits of random features (28-60 frames of the encoder's
    width) and captions (4-20 words of the vocab), TRAIN_VIDEOS per split,
    TRAIN_CAPTIONS captions a video, from a seed: {split: (videos,
    captions)}."""
    rng = np.random.default_rng(SEED + 50)
    words = np.asarray([vocab.idx2word[i] for i in range(3, vocab.n_vocabs)])
    splits = {}
    for split, n in zip(("train", "val", "test"), TRAIN_VIDEOS):
        vids = [f"{split}{i}" for i in range(n)]
        splits[split] = (
            {v: rng.standard_normal((int(rng.integers(28, 61)),
                                     tc.encoder_output_size)
                                    ).astype(np.float32) for v in vids},
            {v: [" ".join(rng.choice(words, int(rng.integers(4, 21))))
                 for _ in range(TRAIN_CAPTIONS)] for v in vids})
    return splits


def checksums(leaves):
    """Per leaf (sum, sum of |x|) in float64."""
    return [(float(np.sum(x, dtype=np.float64)),
             float(np.sum(np.abs(x), dtype=np.float64))) for x in leaves]


def train_card_against_cpu(torch, tc, corpus):
    """(a) The same f32 train steps on the card and on the CPU from the
    same state (dropout off, so both draw nothing): losses and per-leaf
    checksums (params and Adam moments) within TRAIN_RTOL; then
    REPEAT_STEPS more card steps on the one batch, whose loss must fall.
    Returns the batch (videos, captions) as numpy arrays."""
    from recnet_tpu_torch.checkpoint import state_leaves
    from recnet_tpu_torch.training import step as S
    tc = tc.replace(embedding_dropout=0.0, decoder_dropout=0.0,
                    decoder_out_dropout=0.0, reconstructor_dropout=0.0,
                    reconstructor_decoder_dropout=0.0,
                    train_precision="float32")
    _, videos, captions = next(iter(corpus.train_batcher))
    videos = corpus.train_dataset.feature_cache()[videos] if \
        corpus.train_batcher.index_mode else videos
    runs = {}
    for device in ("cpu", DEVICE):
        state, dcfg, rcfg = S.init_train_state(SEED, tc, corpus.vocab.n_vocabs,
                                               device)
        step = S.build_train_step(tc, dcfg, rcfg)
        v = torch.from_numpy(videos).to(device)
        c = torch.from_numpy(captions).to(device)
        t0 = time.perf_counter()
        ms = [step(state, v, c) for _ in range(CARD_CPU_STEPS)]
        runs[device] = dict(
            losses=[(float(m["loss"]), float(m["grad_norm"])) for m in ms],
            sums=checksums(state_leaves(state)),
            seconds=time.perf_counter() - t0)
    cpu, card = runs["cpu"], runs[DEVICE]
    rel = lambda i: max(abs(x[i] - y[i]) / abs(y[i])
                        for x, y in zip(card["losses"], cpu["losses"]))
    loss_err, norm_err = rel(0), rel(1)
    sum_err = max(abs(a[0] - b[0]) / max(b[1], 1e-30)
                  for a, b in zip(card["sums"], cpu["sums"]))
    log("train", f"(a) {CARD_CPU_STEPS} f32 steps, B={tc.batch_size}, "
                 f"card against CPU: (loss, grad_norm) card "
                 f"{card['losses']}, cpu {cpu['losses']}; largest relative "
                 f"loss difference {loss_err:.3g} and leaf checksum "
                 f"difference {sum_err:.3g} of the leaf's sum |x| "
                 f"(tolerance {TRAIN_RTOL:g}), grad norm {norm_err:.3g} "
                 f"(tolerance {NORM_RTOL:g}; TF32 off; "
                 f"{len(card['sums'])} leaves: params and Adam states); "
                 f"CPU {cpu['seconds']:.2f} s, card {card['seconds']:.2f} s")
    check(loss_err <= TRAIN_RTOL and sum_err <= TRAIN_RTOL
          and norm_err <= NORM_RTOL,
          "card and CPU train steps disagree")
    losses = [float(step(state, v, c)["loss"]) for _ in range(REPEAT_STEPS)]
    log("train", f"(a) {REPEAT_STEPS} more card steps on the one batch: "
                 f"loss {losses[0]:.6f} -> {losses[-1]:.6f} "
                 f"({', '.join(f'{x:.5f}' for x in losses[::5])}, ...)")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          "the loss on a repeated batch did not fall")
    return videos, captions


def train_loop_path(torch, tc, corpus, tmp: Path):
    """(b) ``training.loop.train`` as the CLI calls it (k-step dispatches,
    the bf16 device feature cache, val, test through ``evaluate`` with
    greedy and beam 5, save), then a resume from the saved checkpoint.
    The launch counts are set to 0 just before the test pass and read
    just after it. Returns the test pass's launches."""
    import os
    from recnet_tpu_torch import checkpoint as ckpt
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.training import loop
    launches = {}
    test = loop._test

    def counted_test(*args, **kw):
        reset_counts()
        test(*args, **kw)
        torch.cuda.synchronize()
        launches.update(whole_greedy_decode_segment=(
            wd.whole_greedy_decode_segment.n_launches),
            outproj_topk=tp.outproj_topk.n_launches)
    loop._test = counted_test
    cwd = os.getcwd()
    try:
        os.chdir(tmp)          # the test pass writes predictions.txt here
        t0 = time.perf_counter()
        final = loop.train(tc, corpus=corpus, log_dir=str(tmp / "log"),
                           save_dir=str(tmp / "ck"), device=DEVICE)
        run_s = time.perf_counter() - t0
        last = tmp / "ck" / str(tc.n_iterations)
        t0 = time.perf_counter()
        resumed = loop.train(
            tc.replace(n_iterations=tc.n_iterations + tc.steps_per_dispatch),
            corpus=corpus, resume_from=str(last), log_dir=str(tmp / "log"),
            save_dir=str(tmp / "ck"), device=DEVICE)
        resume_s = time.perf_counter() - t0
    finally:
        loop._test = test
        os.chdir(cwd)
    records = [json.loads(x) for x in
               (tmp / "log" / "metrics.jsonl").read_text().splitlines()]
    losses = {(r["tag"], r["step"]): r["value"] for r in records
              if r["tag"].startswith("loss/")}
    log("train", f"(b) loop.train, k={tc.steps_per_dispatch}, "
                 f"{tc.n_iterations} iterations + {tc.steps_per_dispatch} "
                 f"resumed, bf16 feature cache: losses {losses}")
    check(losses and all(np.isfinite(v) for v in losses.values()),
          "a non-finite loss in the loop")
    check(any(t == tc.tx_val_loss for t, _ in losses),
          "the loop logged no val loss")
    scores = {r["tag"]: round(r["value"], 4) for r in records
              if r["tag"].startswith("score")}
    log("train", f"(b) test pass launches {launches}, scores {scores}; "
                 f"{run_s:.2f} s for the run (val, test and 2 saves "
                 f"included), {resume_s:.2f} s for the resume")
    check(launches.get("whole_greedy_decode_segment", 0) > 0,
          "K2 never launched in the loop's test pass")
    check(launches.get("outproj_topk", 0) > 0,
          "K3 never launched in the loop's test pass")
    check(len(scores) == 2 * len(tc.scores), f"test scores {scores}")
    saved, meta = ckpt.load_checkpoint(str(last), tc, corpus.vocab.n_vocabs,
                                       DEVICE)
    equal = all(np.array_equal(a, b) for a, b in zip(
        ckpt.state_leaves(saved), ckpt.state_leaves(final)))
    log("train", f"(b) checkpoint {last.name}: step {meta['step']}, its "
                 f"{meta['n_leaves']} leaves equal to the trained state: "
                 f"{equal}; the resume ran to step {resumed.step}")
    check(meta["step"] == final.step == tc.n_iterations and equal,
          "the saved checkpoint is not the trained state")
    check(resumed.step == tc.n_iterations + tc.steps_per_dispatch,
          "the resumed loop did not continue from the checkpoint")
    return launches


def train_work(tc, dcfg, rcfg, B):
    """(flops, bytes) of one train step: forward multiply-adds x 2 x 3
    (the backward takes two products per forward product); bytes: the
    batch's feature rows (bf16 cache) and captions read, every param and
    Adam moment read and written once."""
    T, L = tc.caption_max_len + 1, tc.encoder_output_len
    E, F, H, A, V = (dcfg.embedding_size, dcfg.encoder_size,
                     dcfg.hidden_size, dcfg.attn_size, dcfg.vocab_size)
    G = (3 if dcfg.cell_type == "GRU" else 4) * H
    dec = H * A + L * A + L * F + (E + F + H) * G + H * V   # a row-step
    macs = B * (T * dec + L * F * A)                         # + U v
    Hr = rcfg.hidden_size
    Gr = (3 if rcfg.cell_type == "GRU" else 4) * Hr
    if rcfg.kind == "global":
        rec_steps, rec = T, (2 * H + Hr) * Gr + Hr * Hr
    else:
        rec_steps = L
        rec = Hr * rcfg.attn_size + T * rcfg.attn_size + T * H \
            + (H + Hr) * Gr + Hr * Hr
        macs += B * T * H * rcfg.attn_size
    macs += B * rec_steps * rec
    n_dec = (V * E + (H + F) * A + 2 * A + (E + F + H) * G + 2 * G
             + H * V + V)
    n_rec = ((2 * H if rcfg.kind == "global" else H) + Hr) * Gr + 2 * Gr \
        + Hr * Hr + Hr
    if rcfg.kind == "local":
        n_rec += (Hr + H) * rcfg.attn_size + 2 * rcfg.attn_size
    moments = (3 if tc.decoder_use_amsgrad else 2) * n_dec + \
        (3 if tc.reconstructor_use_amsgrad else 2) * n_rec
    nbytes = 2 * 4 * (n_dec + n_rec + moments) + 2 * B * L * F + 4 * T * B
    return 6 * macs, nbytes


def f32_rate(torch):
    """The card's float32 matmul rate (TF32 off), FLOP/s, by CUDA events
    over an 8192^3 product."""
    n = 8192
    g = torch.Generator(device=DEVICE).manual_seed(9)
    a = torch.randn((n, n), generator=g, device=DEVICE)
    b = torch.randn((n, n), generator=g, device=DEVICE)
    ms = timed(torch, lambda: a @ b, reps=5)[0]
    return 2 * n ** 3 / (ms / 1e3)


def train_times(torch, tc, corpus):
    """(c) ms a step by CUDA events over k-step dispatches of the cached
    step (the loop's), the median of TIME_DISPATCHES, for f32 and bf16;
    the card's busy time a step by torch.profiler (kernels only) and its
    idle share; peak memory; the bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from recnet_tpu_torch.training import step as S
    k, B = tc.steps_per_dispatch, tc.batch_size
    cache = torch.from_numpy(corpus.train_dataset.feature_cache()).to(
        DEVICE, torch.bfloat16)
    from recnet_tpu_torch.data import cycle
    it = cycle(corpus.train_batcher)
    batches = [next(it) for _ in range(k)]
    rows = torch.from_numpy(np.stack([b[1] for b in batches])).to(DEVICE)
    caps = torch.from_numpy(np.stack([b[2] for b in batches])).to(DEVICE)
    card = card_line()
    peak_f32 = f32_rate(torch)
    log("train", f"(c) float32 matmul rate, TF32 off: "
                 f"{peak_f32 / 1e12:.2f} TFLOP/s (8192^3, CUDA events; "
                 f"{card})")
    out = {}
    for prec in ("float32", "bfloat16"):
        ptc = tc.replace(train_precision=prec)
        torch.cuda.reset_peak_memory_stats()
        state, dcfg, rcfg = S.init_train_state(SEED, ptc,
                                               corpus.vocab.n_vocabs, DEVICE)
        fn = S.build_train_multi_step_cached(ptc, dcfg, rcfg, k)
        run = lambda: fn(state, cache, rows, caps)
        run()                                       # warm-up
        torch.cuda.synchronize()
        per_step = []
        for _ in range(TIME_DISPATCHES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = run()
            end.record()
            torch.cuda.synchronize()
            per_step.append(start.elapsed_time(end) / k)
        check(bool(torch.isfinite(m["loss"]).all()), f"{prec}: loss {m}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA]
        busy = sum(ev.device_time for ev in kernels) / 1000 / k
        check(busy > 0, "the profiler saw no device time")
        med = float(np.median(per_step))
        flops, nbytes = train_work(ptc, dcfg, rcfg, B)
        peak = PEAK_BF16_FLOPS if prec == "bfloat16" else peak_f32
        t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        out[prec] = dict(ms=med, steps_s=1000 / med, busy_ms=busy,
                         idle=1 - busy / med, kernels=len(kernels) / k,
                         bound_ms=bound_ms, peak_gib=mem)
        log("train", f"(c) {prec}, B={B}, k={k}: "
                     f"{', '.join(f'{x:.3f}' for x in per_step)} ms a step "
                     f"by CUDA events (median {med:.3f} ms, "
                     f"{1000 / med:.2f} steps/s); the card busy "
                     f"{busy:.3f} ms a step ({len(kernels) / k:.0f} device "
                     f"activities a step; idle share {1 - busy / med:.3f}); "
                     f"peak memory {mem:.2f} GiB; bound {bound_ms:.3f} ms "
                     f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
                     f"{flops / 1e9:.1f} GFLOP at {peak / 1e12:.1f} "
                     f"TFLOP/s, {nbytes / 1e6:.0f} MB at "
                     f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) on {card}")
        del state, fn
    return out


def train_phase(torch, tc, vocab):
    """[train]: (a) card against CPU, (b) the loop with val, test, save
    and resume, (c) times."""
    ttc = train_config(tc)
    ttc.validate()
    corpus = train_corpus(ttc, vocab)
    log("train", f"flagship preset, data_bundle off, in-memory corpus: "
                 f"{len(corpus.train_dataset)} train pairs of "
                 f"{TRAIN_VIDEOS[0]} videos, {len(corpus.val_dataset)} val, "
                 f"{TRAIN_VIDEOS[2]} test videos; B={ttc.batch_size}, "
                 f"k={ttc.steps_per_dispatch}, cache "
                 f"{ttc.feature_cache_dtype}")
    train_card_against_cpu(torch, ttc, corpus)
    with tempfile.TemporaryDirectory() as tmp:
        launches = train_loop_path(torch, ttc, corpus, Path(tmp))
    train_times(torch, ttc, corpus)
    return launches


# --------------------------------------------------------------------------
# 9. the data and checkpoint side
# --------------------------------------------------------------------------

def reference_tensors(tc, n_vocab):
    """A flagship-width reference checkpoint's contents from seeded numpy,
    with the reference's own keys, its (out, in) layout and its parameter
    order (``model.parameters()``: the root-level ``attn_b`` first):
    {"dec": [(key, array)], "rec": [...], "dec_opt": (step, amsgrad,
    [{moment: array}]), "rec_opt": ...}. Weights uniform in
    +-1/sqrt(fan-in) as torch initialises them, the embedding N(0, 1);
    moments of an optimizer past step 0."""
    rng = np.random.default_rng(SEED + 70)
    H, E, F = tc.decoder_hidden_size, tc.embedding_size, \
        tc.encoder_output_size
    A, Hr = tc.decoder_attn_size, tc.reconstructor_hidden_size
    f32 = lambda x: np.asarray(x, np.float32)
    u = lambda fan, *shape: f32(rng.uniform(-fan ** -0.5, fan ** -0.5,
                                            shape))
    dec = [("attn_b", u(A, A)),
           ("embedding.weight", f32(rng.standard_normal((n_vocab, E)))),
           ("attn_W.weight", u(H, A, H)), ("attn_U.weight", u(F, A, F)),
           ("attn_w.weight", u(A, 1, A)),
           ("rnn.weight_ih_l0", u(H, 3 * H, E + F)),
           ("rnn.weight_hh_l0", u(H, 3 * H, H)),
           ("rnn.bias_ih_l0", u(H, 3 * H)), ("rnn.bias_hh_l0", u(H, 3 * H)),
           ("out.weight", u(H, n_vocab, H)), ("out.bias", u(H, n_vocab))]
    rec = [("rnn.weight_ih_l0", u(Hr, 4 * Hr, 2 * H)),
           ("rnn.weight_hh_l0", u(Hr, 4 * Hr, Hr)),
           ("rnn.bias_ih_l0", u(Hr, 4 * Hr)), ("rnn.bias_hh_l0", u(Hr, 4 * Hr)),
           ("out.weight", u(Hr, Hr, Hr)), ("out.bias", u(Hr, Hr))]

    def moments(params, amsgrad):
        out = []
        for _, p in params:
            m = {"exp_avg": f32(rng.standard_normal(p.shape) * 1e-3),
                 "exp_avg_sq": f32(rng.random(p.shape) * 1e-6)}
            if amsgrad:
                m["max_exp_avg_sq"] = m["exp_avg_sq"] + f32(
                    rng.random(p.shape) * 1e-7)
            out.append(m)
        return out
    return {"dec": dec, "rec": rec,
            "dec_opt": (1234, tc.decoder_use_amsgrad,
                        moments(dec, tc.decoder_use_amsgrad)),
            "rec_opt": (1234, tc.reconstructor_use_amsgrad,
                        moments(rec, tc.reconstructor_use_amsgrad))}


def write_reference_tar(torch, tc, ref, path):
    """torch.save ``ref`` as the reference writes its *_checkpoint.tar: the
    legacy format, pickle protocol 2, int steps, and ``'config'`` the
    ``config.TrainConfig`` class pickled by reference (a stub module
    here)."""
    import types
    groups = {"dec_opt": (tc.decoder_learning_rate, tc.decoder_weight_decay),
              "rec_opt": (tc.reconstructor_learning_rate,
                          tc.reconstructor_weight_decay)}
    out = {"iteration": 1234, "loss": 2.5}
    for mod in ("dec", "rec"):
        out[mod] = {k: torch.from_numpy(v) for k, v in ref[mod]}
        step, amsgrad, moments = ref[f"{mod}_opt"]
        lr, wd = groups[f"{mod}_opt"]
        out[f"{mod}_opt"] = {
            "state": {i: dict({"step": step}, **{
                name: torch.from_numpy(m) for name, m in entry.items()})
                for i, entry in enumerate(moments)},
            "param_groups": [{"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8,
                              "weight_decay": wd, "amsgrad": amsgrad,
                              "params": list(range(len(moments)))}]}
    stub = types.ModuleType("config")
    stub.TrainConfig = type("TrainConfig", (), {"__module__": "config"})
    sys.modules["config"] = stub
    try:
        out["config"] = stub.TrainConfig
        torch.save(out, path, pickle_protocol=2,
                   _use_new_zipfile_serialization=False)
    finally:
        del sys.modules["config"]


def read_reference_tar(torch, path):
    """torch.load a reference-format .tar (full pickle, py2-tolerant)."""
    import types
    stub = types.ModuleType("config")
    stub.TrainConfig = type("TrainConfig", (), {"__module__": "config"})
    sys.modules["config"] = stub
    try:
        return torch.load(path, map_location="cpu", weights_only=False,
                          encoding="latin1")
    finally:
        del sys.modules["config"]


def transposed_params(ref):
    """The decoder params in the port's (JAX) layout, mapped by plain
    transposition of the reference's (out, in) weights."""
    d = dict(ref["dec"])
    return {"attention": {"W": d["attn_W.weight"].T, "U": d["attn_U.weight"].T,
                          "b": d["attn_b"], "w": d["attn_w.weight"].T},
            "embedding": d["embedding.weight"],
            "rnn": [{"w_ih": d["rnn.weight_ih_l0"].T,
                     "w_hh": d["rnn.weight_hh_l0"].T,
                     "b_ih": d["rnn.bias_ih_l0"], "b_hh": d["rnn.bias_hh_l0"]}],
            "out_w": d["out.weight"].T, "out_b": d["out.bias"]}


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def run_cli(module, *args):
    """``python -m module args`` from the checkout; returns its seconds and
    last output line."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        raise SmokeFailure(f"{module} exited {proc.returncode}")
    return seconds, proc.stdout.strip().splitlines()[-1]


def data_checkpoint(torch, tc, vocab, tmp: Path):
    """(a) A reference checkpoint at the flagship width, imported by
    ``cli.import_torch``, captioned on the card (greedy through K2, beam 5
    through K3, counted from 0), against the same Captioner on params this
    phase transposes itself (f32: equal captions on every row); then
    ``cli.export_torch`` and a bit-exact comparison with the original."""
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.serving import Captioner
    t0 = time.perf_counter()
    ref = reference_tensors(tc, vocab.n_vocabs)
    tar = tmp / "1234_checkpoint.tar"
    write_reference_tar(torch, tc, ref, tar)
    vocab_json = tmp / "vocab.json"
    vocab_json.write_text(vocab.to_json())
    log("data", f"(a) reference checkpoint: decoder {tc.decoder_model} "
                f"{tc.decoder_hidden_size}, vocab {vocab.n_vocabs}, global "
                f"{tc.reconstructor_model} {tc.reconstructor_hidden_size} "
                f"reconstructor, Adam at step 1234 (AMSGrad: decoder "
                f"{tc.decoder_use_amsgrad}, reconstructor "
                f"{tc.reconstructor_use_amsgrad}); "
                f"{tar.stat().st_size / 2 ** 20:.1f} MiB written in "
                f"{time.perf_counter() - t0:.2f} s")
    import_s, said = run_cli("recnet_tpu_torch.cli.import_torch", "--ckpt",
                             str(tar), "--out", str(tmp / "imported"),
                             "--vocab", str(vocab_json))
    step_dir = tmp / "imported" / "1234"
    log("data", f"(a) cli.import_torch in {import_s:.2f} s: {said}")

    kw = dict(dtype="float32", device=DEVICE, use_pallas=True,
              greedy_segment=tc.greedy_segment)
    imported = Captioner.from_checkpoint(str(step_dir), **kw)
    check(imported.params["out_w"].device.type == torch.device(DEVICE).type,
          "the imported checkpoint does not decode on the card")
    mapped = Captioner(imported.tc, imported.vocab, transposed_params(ref),
                       **kw)
    feats = request_features(SEED + 71, DATA_VIDEOS, tc.encoder_output_size)
    reset_counts()
    t0 = time.perf_counter()
    got = {"greedy": imported.caption(feats),
           "beam": imported.caption(feats, beam_width=BEAM)}
    torch.cuda.synchronize()
    caption_s = time.perf_counter() - t0
    launches = {"whole_greedy_decode_segment":
                wd.whole_greedy_decode_segment.n_launches,
                "outproj_topk": tp.outproj_topk.n_launches}
    want = {"greedy": mapped.caption(feats),
            "beam": mapped.caption(feats, beam_width=BEAM)}
    same = {k: sum(g == w for g, w in zip(got[k], want[k])) for k in got}
    log("data", f"(a) {DATA_VIDEOS} videos captioned from the imported "
                f"checkpoint on {imported.params['out_w'].device} (f32, "
                f"use_pallas, greedy_segment {tc.greedy_segment}): greedy "
                f"and beam {BEAM} in {caption_s:.2f} s, launches "
                f"{launches}; equal to the transposed params' captions on "
                f"{same} of {DATA_VIDEOS} rows; sample "
                f"{got['greedy'][0][:60]!r} | {got['beam'][0][:60]!r}")
    check(launches["whole_greedy_decode_segment"] > 0,
          "K2 never launched on the imported checkpoint")
    check(launches["outproj_topk"] > 0,
          "K3 never launched on the imported checkpoint")
    check(all(n == DATA_VIDEOS for n in same.values()),
          "the imported checkpoint captions differently from the "
          "transposed params")

    # the export CLI's main in this process: a second interpreter would add
    # its start and torch import to the phase
    from recnet_tpu_torch.cli import export_torch
    out = tmp / "exported.tar"
    t0 = time.perf_counter()
    export_torch.main(["--ckpt", str(step_dir), "--out", str(out)])
    export_s = time.perf_counter() - t0
    back = read_reference_tar(torch, out)
    bad = []
    for mod in ("dec", "rec"):
        if [k for k in back[mod]] != [k for k, _ in ref[mod]]:
            bad.append(f"{mod} keys")
        bad += [f"{mod}.{k}" for k, v in ref[mod]
                if not bits_equal(back[mod][k].numpy(), v)]
        step, amsgrad, moments = ref[f"{mod}_opt"]
        sd = back[f"{mod}_opt"]
        group = sd["param_groups"][0]
        if (group["amsgrad"] != amsgrad
                or list(group["params"]) != list(range(len(moments)))):
            bad.append(f"{mod}_opt param_groups")
        for i, entry in enumerate(moments):
            got_e = sd["state"][i]
            if int(got_e["step"]) != step or set(got_e) != set(entry) | {
                    "step"}:
                bad.append(f"{mod}_opt[{i}] keys or step")
            bad += [f"{mod}_opt[{i}].{name}" for name, m in entry.items()
                    if not bits_equal(got_e[name].numpy(), m)]
    n_moments = sum(len(ref[f"{m}_opt"][2][0]) * len(ref[m])
                    for m in ("dec", "rec"))
    log("data", f"(a) cli.export_torch (its main, in this process) in "
                f"{export_s:.2f} s "
                f"({out.stat().st_size / 2 ** 20:.1f} MiB, legacy format: "
                f"{out.read_bytes()[:2] != b'PK'}); "
                f"{len(ref['dec']) + len(ref['rec'])} weights and "
                f"{n_moments} Adam moments against the original, bit for "
                f"bit: {'equal' if not bad else bad}; iteration "
                f"{back['iteration']}")
    check(not bad, f"the export round trip changed {bad}")
    check(back["iteration"] == 1234, "the export lost the iteration")


def data_bundle(torch, tc, vocab, tmp: Path):
    """(b) The [train] phase's corpus packed as a bundle, and the loop on
    it (data_bundle, the bf16 device feature cache, k-step dispatches, a
    test pass at each of two dispatches) against the same loop on the raw
    in-memory corpus: equal losses bit for bit; one upload of the score
    split for both test passes."""
    import importlib.util
    import os
    from recnet_tpu_torch.data import Corpus
    from recnet_tpu_torch.data import bundle as B
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.training import loop
    k = tc.steps_per_dispatch
    btc = train_config(tc).replace(
        data_bundle=True, n_iterations=2 * k, log_every=k, test_every=k,
        validate_every=2 * k, save_every=tc.save_every)
    btc.validate()
    has_h5py = importlib.util.find_spec("h5py") is not None
    log("data", f"(b) h5py {'is' if has_h5py else 'is not'} installed; the "
                f"bundle is packed from the in-memory corpus through the "
                f"writer build_bundle feeds from HDF5 "
                f"(bundle._pack_in_memory)")
    t0 = time.perf_counter()
    splits = train_splits(btc, vocab)
    raw = Corpus(btc.replace(data_bundle=False), vocab=vocab, splits=splits)
    raw_corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    path = B._pack_in_memory(btc, str(tmp / "bundles" / "flagship"), vocab,
                             splits, log=lambda m: None)
    pack_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in Path(path).iterdir())
    del splits
    t0 = time.perf_counter()
    bundled = Corpus(btc, bundle=path)
    bundle_corpus_s = time.perf_counter() - t0

    passes, launches = [], {}
    test = loop._test

    def timed_test(*args, **kw):
        reset_counts()
        t = time.perf_counter()
        test(*args, **kw)
        torch.cuda.synchronize()
        passes.append(time.perf_counter() - t)
        for name, fn in (("whole_greedy_decode_segment",
                          wd.whole_greedy_decode_segment),
                         ("outproj_topk", tp.outproj_topk)):
            launches[name] = launches.get(name, 0) + fn.n_launches
    cwd = os.getcwd()
    losses, setup = {}, {}
    try:
        os.chdir(tmp)
        for name, corpus, loss_only in (("raw", raw, True),
                                        ("bundle", bundled, False)):
            loop._test = timed_test
            loop.train(btc.replace(data_bundle=name == "bundle"),
                       corpus=corpus, loss_only=loss_only,
                       log_dir=str(tmp / name), save_dir=str(tmp / name),
                       device=DEVICE)
            setup[name] = loop.LAST_SETUP_SECONDS
            records = [json.loads(x) for x in (tmp / name / "metrics.jsonl")
                       .read_text().splitlines()]
            losses[name] = {(r["tag"], r["step"]): r["value"]
                            for r in records if r["tag"].startswith("loss/")}
    finally:
        loop._test = test
        os.chdir(cwd)
    log("data", f"(b) bundle: {size / 2 ** 20:.1f} MiB packed in "
                f"{pack_s:.2f} s (train/val features "
                f"{btc.feature_cache_dtype}); time to the first iteration: "
                f"bundled corpus {bundle_corpus_s:.3f} s + loop setup "
                f"{setup['bundle']:.3f} s, raw in-memory corpus "
                f"{raw_corpus_s:.3f} s + loop setup {setup['raw']:.3f} s")
    log("data", f"(b) loop.train, k={k}, {btc.n_iterations} iterations, "
                f"{btc.train_precision}, bf16 device cache: losses bundled "
                f"{losses['bundle']}, raw {losses['raw']}")
    check(losses["bundle"] and losses["bundle"] == losses["raw"],
          "the bundled loop's losses differ from the raw corpus's")
    check(all(np.isfinite(v) for v in losses["bundle"].values()),
          "a non-finite loss in the bundled loop")
    log("data", f"(b) {len(passes)} test passes (greedy and beam "
                f"{BEAM}, {TRAIN_VIDEOS[2]} videos) in "
                f"{', '.join(f'{s:.3f}' for s in passes)} s; score split "
                f"uploads {bundled.score_uploads}; launches {launches}")
    check(len(passes) == 2, f"{len(passes)} test passes, not 2")
    check(bundled.score_uploads == 1,
          f"the score split went to the card {bundled.score_uploads} times")
    check(launches.get("whole_greedy_decode_segment", 0) > 0
          and launches.get("outproj_topk", 0) > 0,
          "K2 or K3 never launched in the bundled loop's test passes")

    # a test pass on the bundled corpus without the device cache and from
    # it, timed the same way
    from recnet_tpu_torch.evaluation import evaluate
    from recnet_tpu_torch.training.step import init_train_state
    from recnet_tpu_torch.utils.misc import tree_fill, tree_leaves
    state, dcfg, _ = init_train_state(SEED, btc, vocab.n_vocabs, DEVICE)
    params = tree_fill(state.dec_params, iter(
        [p.detach() for p in tree_leaves(state.dec_params)]))
    times = {}
    for cache in (False, True):
        etc = btc.replace(device_feature_cache=cache)
        t0 = time.perf_counter()
        for search in btc.search_methods:
            evaluate(etc, bundled, params, dcfg, search,
                     predictions_fpath=None)
        torch.cuda.synchronize()
        times[cache] = time.perf_counter() - t0
    log("data", f"(b) a test pass (greedy and beam {BEAM}) with fresh "
                f"params: {times[False]:.3f} s uploading every batch, "
                f"{times[True]:.3f} s from the device cache")


def score_corpus():
    """Synthetic MSR-VTT-test-scale predictions: SCORE_VIDEOS videos,
    SCORE_REFS references each (5-15 words), one prediction each (6-12
    words), words drawn from a Zipf law over SCORE_WORDS words, from a
    seed."""
    rng = np.random.default_rng(SEED + 72)
    words = [f"w{i}" for i in range(SCORE_WORDS)]
    sent = lambda lo, hi: " ".join(
        words[i] for i in (rng.zipf(1.3, int(rng.integers(lo, hi + 1)))
                           - 1) % SCORE_WORDS)
    gts = {f"video{v}": [{"caption": sent(5, 15)}
                         for _ in range(SCORE_REFS)]
           for v in range(SCORE_VIDEOS)}
    res = {v: [{"caption": sent(6, 12)}] for v in gts}
    return gts, res


def data_scoring():
    """(c) CaptionScorer.evaluate() at MSR-VTT test scale with the C++
    core and on the pure-Python paths: equal scores, bit for bit."""
    from recnet_tpu_torch import native
    from recnet_tpu_torch.metrics import CaptionScorer
    built = native.HAVE_FASTMETRICS
    log("data", f"(c) the metrics' C++ core built: {built} (g++ "
                f"{' '.join(native.CXX_FLAGS)}; {native.library_path().name}"
                f", at its first use by an earlier phase's scoring)")
    check(built, f"the metrics' C++ core did not build: "
                 f"{native.BUILD_ERROR}")
    gts, res = score_corpus()
    scores, seconds = {}, {}
    t0 = time.perf_counter()
    scores["cpp"] = CaptionScorer(gts, res).evaluate()
    seconds["cpp"] = time.perf_counter() - t0
    native.HAVE_FASTMETRICS = False          # the pure-Python paths
    try:
        t0 = time.perf_counter()
        scores["python"] = CaptionScorer(gts, res).evaluate()
        seconds["python"] = time.perf_counter() - t0
    finally:
        del native.HAVE_FASTMETRICS          # read afresh: the core again
    log("data", f"(c) CaptionScorer.evaluate(), {SCORE_VIDEOS} videos x "
                f"{SCORE_REFS} references (host): C++ core "
                f"{seconds['cpp']:.2f} s, Python paths "
                f"{seconds['python']:.2f} s; scores "
                f"{ {k: round(v, 6) for k, v in scores['cpp'].items()} }, "
                f"bit-equal: {scores['cpp'] == scores['python']}")
    check(scores["cpp"] == scores["python"],
          "the C++ core's scores differ from the Python paths'")


def data_phase(torch, tc, vocab):
    """[data]: (a) a reference checkpoint imported, captioned and
    exported; (b) the bundle and the loop on it; (c) scoring."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data_checkpoint(torch, tc, vocab, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        data_bundle(torch, tc, vocab, Path(tmp))
    data_scoring()
    log("data", f"the phase took {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# 7. two trees in turns: python3 chip_smoke.py --compare <other tree>
# --------------------------------------------------------------------------

def time_kernels(root: str) -> None:
    """Time K1, K2 (seg_len 4), K3 and K4 of the package under ``root``
    and their library routes, and the K4 loop, as ``times`` does
    (``core_kernels``, bf16, B = TIME_B, on inputs from this script's
    seeds); print one JSON line. Runs in a process of its own, so that
    ``root``'s package and its kernel builds are the ones imported."""
    import importlib.util
    import torch
    sys.path.insert(0, str(Path(root).resolve()))
    from recnet_tpu_torch import decoding
    from recnet_tpu_torch.models.decoder import config_from_train
    from recnet_tpu_torch.ops.cuda import build
    from recnet_tpu_torch.weights import params_from_jax, random_params
    # the flagship preset through this tree's config, loaded by path
    spec = importlib.util.spec_from_file_location(
        "smoke_config", REPO / "recnet_tpu_torch" / "config.py")
    config = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = config
    spec.loader.exec_module(config)
    tc = config.TrainConfig.from_json(FLAGSHIP.read_text())
    cfg = config_from_train(tc, VOCAB)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    for name in ("whole_decode", "topk_proj", "fused_step"):
        build.load(name)
    built = time.perf_counter() - t0
    params = params_from_jax(random_params(cfg, SEED), DEVICE, torch.bfloat16)
    enc = seeded_features(torch, TIME_B, tc.encoder_output_len, cfg,
                          torch.bfloat16, 3)
    ms = {}
    core = core_kernels(torch, tc, cfg, params, enc)
    for name, (kernel, _, library, _, reps) in core.items():
        ms[name] = timed(torch, kernel, reps)[0]
        ms[f"{name} library"] = timed(torch, library, reps)[0]
    # K4's call is host-paced (see times): its device and host time too;
    # and its loop, greedy_decode_pallas, by events and by the card's busy
    # time
    kernel, _, library, _, _ = core["fused_gru_attn_step"]
    ms["fused_gru_attn_step device"] = device_ms(torch, kernel)[""]
    ms["fused_gru_attn_step host"] = host_ms(torch, kernel)
    ms["fused_gru_attn_step library device"] = device_ms(torch, library)[""]
    loop = lambda: decoding.greedy_decode_pallas(
        params, cfg, enc, tc.caption_max_len)
    ms["greedy_decode_pallas"] = timed(torch, loop)[0]
    ms["greedy_decode_pallas device"] = device_ms(torch, loop, reps=3)[""]
    print(json.dumps({"root": root, "build_s": built, "ms": ms}), flush=True)


def compare(other: str) -> None:
    """Time this tree and ``other`` in turns (this, other, other, this),
    each in a process of its own; print each run's JSON line."""
    card = card_line()
    for root in (str(REPO), other, other, str(REPO)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time-kernels",
             root], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SmokeFailure(f"--time-kernels {root} exited "
                               f"{proc.returncode}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        log("compare", f"{json.dumps(result)} ({card})")


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--time-kernels"]:
        time_kernels(sys.argv[2])
        return 0
    environment(torch)
    if sys.argv[1:2] == ["--compare"]:
        build_kernels()
        compare(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--read-rates"]:
        read_rates(torch)
        return 0
    build_kernels()
    from recnet_tpu_torch.checkpoint import load_config_and_vocab
    from recnet_tpu_torch.models.decoder import config_from_train
    from recnet_tpu_torch.weights import random_params

    with tempfile.TemporaryDirectory() as tmp:
        tc, vocab = load_config_and_vocab(
            str(flagship_checkpoint_dir(Path(tmp), VOCAB)))
    cfg = config_from_train(tc, vocab.n_vocabs)
    params_np = random_params(cfg, SEED)
    errs = kernels_against_twins(torch, tc, cfg)
    errs["outproj_topk"] = topk_against_twin(torch, cfg)
    errs["fused_gru_attn_step"] = fused_step_against_twin(torch, tc, cfg)
    variant_errs = variants_against_k1(torch, tc, cfg)
    eos_np = eos_biased(torch, tc, cfg, params_np)
    launches = main_path(torch, tc, vocab, cfg, params_np, eos_np)
    launches["outproj_topk"] = beam_path(torch, tc, vocab, cfg, params_np)
    with tempfile.TemporaryDirectory() as tmp:
        eval_path(torch, tc, vocab, cfg, params_np, Path(tmp))
    launches["fused_gru_attn_step"] = pallas_path(torch, tc, cfg,
                                                  params_np)
    pad_np = pad_timed(torch, tc, cfg, params_np)
    variant_launches = {}
    variant_launches["early_exit"], variant_errs["early_exit"] = (
        early_exit_path(torch, tc, cfg, pad_np))
    entries = times(torch, tc, cfg, params_np, eos_np, pad_np)
    sweep_launches, sweep_ms, sweep_errs = ablate_sweep(torch, tc, cfg,
                                                        params_np)
    variant_launches.update(sweep_launches)
    for name, err in sweep_errs.items():
        variant_errs[name] = max(variant_errs.get(name, 0.0), err)
    train_phase(torch, tc, vocab)
    data_phase(torch, tc, vocab)
    T, L = tc.caption_max_len + 1, tc.encoder_output_len
    for part in ABLATE_PARTS:
        ms, plain = sweep_ms[f"ablate={part}"]
        bound_ms, bound_by = bound(*decode_work(cfg, L, TIME_B, TIME_B * T,
                                                T, ablate=part))
        entries[f"whole_greedy_decode[ablate={part}]"] = dict(
            ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound_ms,
            bound_by=bound_by)

    pallas = "recnet_tpu/ops/pallas/"
    csrc = "recnet_tpu_torch/csrc/"
    rows = [("whole_greedy_decode", "whole_decode.cu",
             "whole_decode.py:440"),
            ("whole_greedy_decode_segment", "whole_decode.cu",
             "whole_decode.py:360"),
            ("outproj_topk", "topk_proj.cu", "topk_proj.py:77"),
            ("fused_gru_attn_step", "fused_step.cu", "fused_step.py:92")]
    rows += [(f"whole_greedy_decode[{variant}]", "whole_decode.cu",
              "whole_decode.py:497")
             for variant in ["early_exit", "dual", "cuda_cores"]
             + [f"ablate={p}" for p in ABLATE_PARTS]]
    counts = dict(launches, **{f"whole_greedy_decode[{v}]": n
                               for v, n in variant_launches.items()})
    errors = dict(errs, **{f"whole_greedy_decode[{v}]": e
                           for v, e in variant_errs.items()})
    kernels = [dict({"name": name, "route": "cuda", "source": csrc + src,
                     "replaces": pallas + tpu, "launches": counts[name],
                     "max_abs_err": errors[name]}, **entries[name])
               for name, src, tpu in rows]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
