"""Smoke run of the PyTorch/CUDA port (recnet_tpu_torch) on one Hopper card.

    python3 chip_smoke.py                        # from the repository root
    python3 chip_smoke.py --compare <other tree> # K1-K4 and [train] (c)
                                                 # of two trees
    python3 chip_smoke.py --compare-train <other tree> [rounds]
                                                 # [train] (c) alone, the
                                                 # trees in turns
    python3 chip_smoke.py --read-rates           # the card's L2 and HBM
                                                 # read rates
    python3 chip_smoke.py --gate-rows            # K4 f32's gate kernel at
                                                 # each rows a block
    python3 chip_smoke.py --embedding-backward   # the embedding backward
                                                 # and the train step with
                                                 # and without it
    python3 chip_smoke.py --gemm [check]         # the train step's TF32
                                                 # GEMM at its shapes

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
   step) against its twin, frame chunks 1 and 7: f32 on the TF32 route at
   B=256, 100, 1024 and a ragged 45 (each of its two kernels against its
   plain stage, a row's h' bit-equal across the gate kernel's rows a
   block), f32 under ``cuda_cores`` (the first design), bf16 on the
   tensor-core route at B=256 and 1024 (and each of its two kernels
   against its plain stage), bf16 under ``cuda_cores``; the K5
   variants of K1 on every body: ``dual`` bit-equal to K1's tensor-core
   tokens (bf16, B=256 and a ragged B), to K1's TF32 tokens (f32, B=256
   and the ragged B, clusters of 1, 2, 4 and 8) and to the CUDA-core step
   (f32 and bf16 under ``cuda_cores``), each ``ablate`` part against its
   twin (tensor-core body bf16; TF32 body f32 against the twin with its
   three-term products; CUDA-core body f32);
4. main paths, each with the launch counts set to 0 before it and read
   after it: greedy requests through the port's HTTP handler behind the
   MicroBatcher, from a flagship-width bf16 Captioner (use_pallas,
   greedy_segment=4), for K1 and K2, the bf16 captions held word by word
   against the twin's; beam-5 requests mixed with greedy
   ones through the same front, for K3; ``evaluation.evaluate`` with beam
   5 and greedy on an in-memory score corpus, for K3 and K2;
   ``decoding.greedy_decode_pallas`` at B=1024, for K4 (T launches, all
   on the tensor-core route in bf16, tokens held against the same loop
   through K4's twin), and at B=256 in f32 (T launches, all on the TF32
   route, rows and n_steps held against plain ``greedy_decode``);
   ``decoding.greedy_decode_whole(early_exit=True)`` on PAD-timed
   weights (blocks stop at different steps), for K5's early exit, held
   against the full K1 and, in bf16, against its twin;
5. times: each kernel at B=1024 (K3 at N=5120) beside its plain twin,
   its library route where one PyTorch route computes the same function
   (plain ``greedy_decode`` for K1/K2, the cuBLAS product and the top-K
   rounds for K3, the composed ``gru_attn_step_reference`` for K4) and
   its bound (operations at the bf16 peak or bytes at the device-memory
   rate); K4's CUDA-core body and the tensor-core route's two kernels
   apart; captions/s of the greedy and beam paths; the f32 route at B=100
   and 1024 (K1, K2, K3, and K4's TF32 route beside its first design, the
   composed route by events and device time, each launch's device time,
   and its loop's idle share);
6. ablate: the profiling sweep of K1 at B=1024 bf16 on the tensor-core
   body (its production step first and last, each ablated part, dual),
   each part's cost as full - variant (the phase split of production K1)
   and its tokens against its twin's, dual also at B=2048 beside K1 in
   turns; then the same sweep on the CUDA-core body (``cuda_cores``);
   then in f32 (the flagship's dtype) on the TF32 body at B=100 (the eval
   batch, clusters of 8) and B=1024: production first and last, each part
   and dual by events and device time, the phase split, each part's
   tokens against the twin with the body's three-term products, the
   first design's dual and parts (``cuda_cores``) beside them, and dual
   against K1 in turns at B=1024 and B=2048;
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
   profiler, the peak memory and the bound, and the device activities of
   the f32 step's two loops a step (the decoder's at most 8, the
   reconstructor's at most 4); the rollouts' kernels counted from 0 over
   (a)'s card steps; (d) the rollouts' four kernels (cell forward and
   backward for the decoder's GRU and the reconstructor's LSTM, the
   attention forward and backward) at the flagship's shapes, f32 and
   bf16, each against its plain version at ROLL_SEEDS seeds, timed beside
   it, beside ATen's fused cell where one call computes the same and
   beside the bound; the cell kernels against their first design (the
   "scalar" probe: f32 bit for bit, bf16 within 2 ulps, five seeds, on
   their whole-run route) and the forward's split (device time of the
   kernel, its first design, an empty kernel at that design's grid and
   the kernel's loads and stores without the gates); the attention
   kernels' split (each split probe against its plain part, and its
   device time beside the kernel's);
   then the two rollouts' forward + backward, the Functions against the
   plain autograd loops in turns, and their kernels' launches a step; the
   reconstructor's whole-rollout kernels (``csrc/cell_rollout.cu``, one
   launch a direction; bf16 and f32) each step against the plain loop's
   from the kernel's own state at ROLL_SEEDS seeds (f32 also chained),
   timed beside cuDNN's LSTM / GRU and the bound, the whole-rollout route
   against the per-step route in turns, their split probes (without the
   product, its MMAs, the exchange), and the bf16 reconstructor loop's
   launches (none a step, one a direction); (a) counts over its f32 steps
   and CARD_BF16_STEPS bf16 steps;
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
   paths: bit-equal scores, host seconds of each;
9. dist: multi-device at the [train] width (dropout off, DIST_ITERS
   iterations of ``training.loop.train`` with val, test and a save). The
   card is one, and NCCL refuses two ranks on one card, so NCCL across
   cards is not run here. (a) A one-rank NCCL group on a data=1 mesh
   against the loop without a mesh: equal losses, leaf checksums, K2/K3
   in the test pass, ms a step of both by CUDA events. (b) Two ranks
   (``torch.multiprocessing``) sharing the card over gloo, asked for by
   name, on a data=2 mesh: losses and leaves against (a)'s run, one digest
   on both ranks, checkpoints and predictions.txt on rank 0 alone, K2/K3
   on each rank; the two ranks first build ``topk_proj.cu`` at once into
   one directory. (c) The same ranks on a model=2 mesh (the vocabulary
   split, its collectives on the card's tensors through gloo). (d) The
   mesh Captioner, a mesh of the card alone and one listing it twice:
   DIST_VIDEOS videos, greedy (K2 segments) and beam 5 (K3), f32 captions
   equal to the plain Captioner's, bf16 words on BF16_TOKENS, the
   launches per shard.

``--compare`` times K1, K2 (seg_len 4), K3 and K4 with their library
routes, the K4 loop, the f32 route at B=100 and 1024 (K4 f32 and the
composed route also by device time), the per-step cell kernels (a step of their
launchers over a sweep of per-step operands out of L2, f32 and bf16),
[train] (c)'s f32 and bf16 k-step dispatches with the loops' split, and
the reconstructor's rollout forward + backward (the package's route and
the plain loop, f32 and bf16), for this tree and another (an unpacked
parent, say) in turns: this, other, other, this, each in a process of
its own; and holds the per-step cell kernels' outputs on the same seeded
inputs across the two trees, f32 bit for bit and bf16 within 2 ulps.
``--compare-train`` runs [train] (c)'s f32 and bf16 k-step dispatches
alone, ``rounds`` times (3 unless given) this, other, other, this, each
in a process of its own, and prints each tree's readings side by side.
``--read-rates`` times a small read kernel over an L2-resident buffer and
over device memory. ``--gate-rows`` times K4 f32's gate kernel at each
rows a block it is built for over a sweep of batches, the rule's pick
beside the fastest. ``--embedding-backward`` holds the embedding gather's
backward (``ops/cuda/embedding.py``) at the train cells' shape against
float64 ``index_put_``, its twin and itself, times it beside ATen's two
routes and its bound, reads whether ``F.embedding``'s backward syncs the
host or changes its bits, and times the f32 k-step call of the global
flagship at B 1024 with the kernel, the plain gather and ``F.embedding``
in turns.

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
DUAL_BIG_B = 2048      # dual's 16-row blocks fill one wave of 128 here
RAGGED_B = 1004        # dual's ragged check: the last 16-row block holds 12
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
TOPK_CHECKS = ((5120, 1), (5120, 3), (5120, 5), (1001, 5), (500, 5))
EVAL_B = 100           # the flagship's eval batch (tc.batch_size): f32 eval
                       # and the training loop's test pass decode it
# the TF32 body's checks: (B, cluster) at the eval batch for every cluster
# size the wrapper can pick (C = 1 first: the others are held bit-equal to
# it), one row, and TIME_B
TF32_CLUSTERS = ((EVAL_B, 1), (EVAL_B, 2), (EVAL_B, 4), (EVAL_B, 8), (1, 8),
                 (TIME_B, 1))
TOPK_RTOL = TOPK_ATOL = 1e-5   # f32 sums of exact products, another order
BEAM_CHECK_VIDEOS = 256        # f32 beam captions, kernel against plain
EVAL_VIDEOS = 128              # the in-memory score corpus
K4_CHUNKS = (1, 7)             # K4's frame_chunk values (L = 28)
K4_RAGGED_B = 45               # K4's ragged batch (partial row tiles)
# --gate-rows: the batches at which K4's f32 kernel B is timed at each of
# its rows a block, and the rounds of the choices in turns
GATE_ROWS_SWEEP_B = (1, 16, 45, 64, 100, 128, 160, 192, 240, 256, 320, 384,
                     512, 768, 900, 1000, 1024)
GATE_ROWS_ROUNDS = 3
# --embedding-backward: the train cells' teacher-forced inputs (T 31 x B
# 1024 of MSVD-like captions, ``tests/torch_embedding_cases.py``), the
# k-step call's routes in turns, the library route's repeated calls
EMB_T, EMB_B = 31, 1024
EMB_ROUNDS = 3
EMB_REPEATS = 20
EMB_STEPS = 10
EMB_CACHE_VIDEOS = 1200
# ``--gemm``: the error rule against float64 (the kernel within
# GEMM_ERR_RATIO of cuBLAS f32's error at the same shape); calls held for
# equal bits; rounds of the k-step call by each route
GEMM_B = 1024
GEMM_ERR_RATIO = 2.0
GEMM_REPEATS = 5
GEMM_ROUNDS = 2
F32_EXACT_FLOPS = 494.7e12 / 3    # three TF32 terms at the TF32 peak
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-2   # bf16 h: 2 bf16 ulps
# out_w's scale in the TF32 probes' checks (the CPU tests' fixtures')
MARGIN_OUT_W = 8.0
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
PROFILE_TRIES = 5      # device_ms: profiler sessions at most, the
PROFILE_LOSS = 0.1     # share of a kernel's events a session may miss,
PROFILE_PAUSE_S = 0.5  # the pause before a session is run again and the
PROFILE_PAD = 4        # spin kernels that open a session
# the rollouts' kernels compute in f32 on the CUDA cores (their operations
# at the f32 peak, H100 SXM data sheet); their f32 / bf16 check bounds (as
# tests/test_torch_cuda.py): rtol and, over each output's largest |value|,
# atol
PEAK_F32_FLOPS = 67e12
# the f32 decode route's bound: its products as three-term TF32 products
# at the TF32 tensor-core peak (the least time for f32-accurate products
# on the card), or its bytes at the device-memory rate; the f32 CUDA-core
# peak's time is printed beside it (H100 SXM data sheet, dense)
PEAK_TF32_FLOPS = 494.7e12
TF32_TERMS = 3
ROLL_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
ROLL_SEEDS = 5         # (d) holds each rollout kernel at this many seeds
SWEEP_L2 = 4           # (d) times a cell kernel over per-step operands of
                       # at least this many times the card's L2
CARD_BF16_STEPS = 2    # (a): bf16 card steps beside the f32 ones (the route
                       # of the whole-rollout kernels) in the counted window
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
SPLIT_STEPS = 8        # (c)'s loop split: T against T - SPLIT_STEPS steps
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
    sources = ("whole_decode", "whole_decode_probes", "whole_decode_tf32",
               "whole_decode_tf32_probes", "topk_proj", "fused_step",
               "rollout", "cell_rollout", "embedding_backward", "gemm_tf32x3")
    t0 = time.perf_counter()

    def timed_build(name):
        start = time.perf_counter()
        return build.build(name), time.perf_counter() - start

    with ThreadPoolExecutor(len(sources)) as pool:
        paths, seconds = zip(*pool.map(timed_build, sources))
    for name in sources:
        build.load(name)
    built = ", ".join(f"{p.name} {t:.1f} s" for p, t in zip(paths, seconds))
    log("build", f"nvcc {' '.join(build.NVCC_FLAGS)}: {built}; all in "
                 f"{time.perf_counter() - t0:.2f} s")
    for path in paths:
        kernel = ""
        for line in path.with_suffix(".log").read_text().splitlines():
            if "entry function" in line:
                # the mangled name: kernel (its length before it) and
                # template arguments
                for m in re.finditer(r"(?=([a-z][a-z0-9_]*?_kernel)"
                                     r"(I[A-Za-z0-9_]*?EE)?)", line):
                    size = str(len(m.group(1)))
                    if line[m.start() - len(size):m.start()] == size:
                        kernel = m.group(1) + (m.group(2) or "")
                        break
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
    """K1 and K2 against their twins, GRU and LSTM: f32 (the TF32 body)
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


def tf32_against_twins(torch, tc, cfg_base):
    """K1/K2's TF32 body against the twin at every cluster size
    (TF32_CLUSTERS), GRU and LSTM: K1 tokens on F32_ROWS of rows; K2 from
    <SOS> (two chained segments of 4, and T steps: K1's launch) tokens on
    F32_ROWS and h (and c) within H_RTOL/H_ATOL on those rows; at the eval
    batch every C's tokens, h and c bit-equal to C = 1's (the body's sums
    do not depend on C); the first design (the CUDA-core body,
    ``cuda_cores``) against the twin at the eval batch, K1 and K2. Returns
    the max |state - twin| on the agreeing rows of K1 (T steps) and of K2,
    under the kernels line's names."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    T, L, f32 = tc.caption_max_len + 1, tc.encoder_output_len, torch.float32
    errs = {"whole_greedy_decode[f32]": 0.0,
            "whole_greedy_decode_segment[f32]": 0.0}
    for cell in ("GRU", "LSTM"):
        cfg = cfg_base._replace(cell_type=cell)
        params = seeded_params(cfg, f32)
        kw = dict(emb_size=cfg.embedding_size, cell_type=cell)
        n_states = 2 if cell == "LSTM" else 1
        first = {}
        for B, C in TF32_CLUSTERS:
            ops = decode_operands(params, seeded_features(torch, B, L, cfg,
                                                          f32, 1))
            got = wd.whole_greedy_decode(*ops, max_len=T - 1, cluster=C, **kw)
            want = wd.whole_greedy_decode_reference(*ops, max_len=T - 1, **kw)
            torch.cuda.synchronize()
            share = (got == want).all(dim=1).double().mean().item()
            outs, parts = [got], [f"K1 rows equal {share:.4f}"]
            check(share >= F32_ROWS, f"K1 {cell} f32 TF32 body B={B} C={C}: "
                                     f"rows equal {share} < {F32_ROWS}")
            z = torch.zeros((B, cfg.hidden_size), dtype=f32, device=DEVICE)
            sos = torch.full((B, 1), cfg.sos_token, dtype=torch.int32,
                             device=DEVICE)
            for seg_len in (4, T):
                k_state = t_state = (z, z, sos)
                k_toks, t_toks = [], []
                for _ in range(2 if seg_len == 4 else 1):
                    k_out = wd.whole_greedy_decode_segment(
                        *ops, *k_state, seg_len=seg_len, cluster=C, **kw)
                    t_out = wd.whole_greedy_decode_segment_reference(
                        *ops, *t_state, seg_len=seg_len, **kw)
                    k_state, t_state = k_out[1:], t_out[1:]
                    k_toks.append(k_out[0])
                    t_toks.append(t_out[0])
                torch.cuda.synchronize()
                k_toks, t_toks = torch.cat(k_toks, 1), torch.cat(t_toks, 1)
                rows = (k_toks == t_toks).all(dim=1)
                share = rows.double().mean().item()
                check(share >= F32_ROWS, f"K2 {cell} f32 TF32 body B={B} "
                                         f"C={C} seg_len={seg_len}: rows "
                                         f"equal {share} < {F32_ROWS}")
                for i in range(1, 1 + n_states):
                    check(torch.allclose(k_out[i][rows], t_out[i][rows],
                                         rtol=H_RTOL, atol=H_ATOL),
                          f"K2 {cell} f32 TF32 body B={B} C={C} seg_len="
                          f"{seg_len}: {'hc'[i - 1]} off the twin beyond "
                          f"rtol {H_RTOL} atol {H_ATOL}")
                err = max(float((k_out[i] - t_out[i]).abs()[rows].max())
                          for i in range(1, 1 + n_states))
                name = ("whole_greedy_decode[f32]" if seg_len == T
                        else "whole_greedy_decode_segment[f32]")
                errs[name] = max(errs[name], err)
                outs += [k_toks, *k_out[1:1 + n_states]]
                parts.append(f"K2 seg_len={seg_len} rows equal {share:.4f}, "
                             f"max |state - twin| {err:.3e}")
            if B == EVAL_B:
                first.setdefault(B, outs)
                same = all(torch.equal(a, b) for a, b in zip(outs, first[B]))
                parts.append(f"bit-equal to C=1: {same}")
                check(same, f"{cell} f32 TF32 body B={B}: C={C} differs "
                            f"from C=1")
            log("kernels", f"TF32 body {cell} f32 B={B} cluster={C}: "
                           + "; ".join(parts))
        # the first design at the eval batch
        ops = decode_operands(params, seeded_features(torch, EVAL_B, L, cfg,
                                                      f32, 1))
        got = wd.whole_greedy_decode(*ops, max_len=T - 1, cuda_cores=True,
                                     **kw)
        want = wd.whole_greedy_decode_reference(*ops, max_len=T - 1, **kw)
        z = torch.zeros((EVAL_B, cfg.hidden_size), dtype=f32, device=DEVICE)
        sos = torch.full((EVAL_B, 1), cfg.sos_token, dtype=torch.int32,
                         device=DEVICE)
        k2 = wd.whole_greedy_decode_segment(*ops, z, z, sos, seg_len=4,
                                            cuda_cores=True, **kw)
        k2_twin = wd.whole_greedy_decode_segment_reference(
            *ops, z, z, sos, seg_len=4, **kw)
        torch.cuda.synchronize()
        rows = (got == want).all(dim=1).double().mean().item()
        rows2 = (k2[0] == k2_twin[0]).all(dim=1)
        log("kernels", f"CUDA-core body (first design) {cell} f32 B={EVAL_B}: "
                       f"K1 rows equal {rows:.4f}, K2 seg_len=4 rows equal "
                       f"{rows2.double().mean().item():.4f}")
        check(rows >= F32_ROWS and rows2.double().mean().item() >= F32_ROWS,
              f"{cell} f32 CUDA-core body off the twin")
        check(torch.allclose(k2[1][rows2], k2_twin[1][rows2], rtol=H_RTOL,
                             atol=H_ATOL),
              f"{cell} f32 CUDA-core body: h off the twin")
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
    """K3 against its twin at the flagship beam's shapes (and the eval
    batch's, N = EVAL_B x BEAM), bf16 on the split route, f32 on the split
    route (three-term TF32) and on the first design (the single pass,
    ``f32_single_pass``): columns equal on F32_ROWS of rows, values within
    TOPK_RTOL/TOPK_ATOL on them; then the tie case. Returns the max |value
    - twin value| on the rows whose columns agree: "outproj_topk" over bf16
    and the f32 single pass, "outproj_topk[f32]" of the f32 split route."""
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    H, V = cfg.hidden_size, cfg.vocab_size
    g = torch.Generator(device=DEVICE).manual_seed(5)
    hidden = torch.tanh(torch.randn((max(n for n, _ in TOPK_CHECKS), H),
                                    generator=g, device=DEVICE))
    errs = {"outproj_topk": 0.0, "outproj_topk[f32]": 0.0}
    routes = ((torch.float32, "f32", {}, "outproj_topk[f32]"),
              (torch.float32, "f32 single pass", {"f32_single_pass": True},
               "outproj_topk"),
              (torch.bfloat16, "bf16", {}, "outproj_topk"))
    for dtype, dname, opt, key in routes:
        params = seeded_params(cfg, dtype)
        w, b = params["out_w"], params["out_b"]
        for n, k in TOPK_CHECKS:
            out = hidden[:n].to(dtype)
            got_v, got_i = tp.outproj_topk(out, w, b, k=k, **opt)
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
            errs[key] = max(errs[key], dv)
        # exact ties across every vocab tile: column j of out_w is the unit
        # vector e_(j mod 8), so logit j equals out[:, j % 8] exactly
        w_tie = torch.zeros((H, V), dtype=dtype, device=DEVICE)
        cols = torch.arange(V, device=DEVICE)
        w_tie[cols % 8, cols] = 1.0
        b_tie = torch.zeros(V, dtype=dtype, device=DEVICE)
        out = hidden[:1001].to(dtype)
        got = tp.outproj_topk(out, w_tie, b_tie, k=BEAM, **opt)
        want = tp.outproj_topk_reference(out, w_tie, b_tie, k=BEAM)
        torch.cuda.synchronize()
        best = out[:, :8].float().argmax(dim=1).int()   # first of the max
        columns = (torch.equal(got[1], want[1])
                   and torch.equal(got[1][:, 0], best))
        if key == "outproj_topk[f32]":
            # three TF32 terms carry x 1 as tf32(x) + tf32(x - tf32(x)),
            # within 2^-22 of x: every tied column gets the same value, so
            # the order is the twin's; the values hold the route's bound
            values = torch.allclose(got[0], want[0], rtol=TOPK_RTOL,
                                    atol=TOPK_ATOL)
        else:
            values = torch.equal(got[0], want[0])
        log("kernels", f"K3 {dname} tie case N=1001 V={V} k={BEAM}: columns "
                       f"{'equal' if columns else 'DIFFER'}, values "
                       f"{'equal' if values else 'DIFFER'}"
                       + (f" (max |dvalue| "
                          f"{float((got[0] - want[0]).abs().max()):.3e})"
                          if key == "outproj_topk[f32]" else ""))
        check(columns and values, f"K3 {dname} tie case differs from the "
                                  f"twin")
    return errs


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
    """K4 against its twin, frame_chunk 1 and 7: f32 on the TF32 route at
    B = CHECK_B, EVAL_B, TIME_B and K4_RAGGED_B and on the CUDA-core body
    (``cuda_cores``, the first design) at CHECK_B, h within H_RTOL/H_ATOL;
    bf16 on the tensor-core route (its per-body count shows it) at B =
    CHECK_B and TIME_B, and bf16 on the CUDA-core body at CHECK_B, h
    within 2 bf16 ulps. Each route's two kernels against its plain stages
    (X, then h' from the same X): bf16 at TIME_B; f32 at every B, each
    row's h' from the gate kernel bit-equal to its h' in a batch of
    another rows a block (``k4_tf32_stages``). Returns the
    max |h - h_twin| of the tensor-core route (bf16) and of the TF32
    route (f32), keyed as the kernels line."""
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    L, E = tc.encoder_output_len, cfg.embedding_size
    errs = {"fused_gru_attn_step": 0.0, "fused_gru_attn_step[f32]": 0.0}
    for dtype, B, cores in ((torch.float32, CHECK_B, False),
                            (torch.float32, EVAL_B, False),
                            (torch.float32, TIME_B, False),
                            (torch.float32, K4_RAGGED_B, False),
                            (torch.float32, CHECK_B, True),
                            (torch.bfloat16, CHECK_B, False),
                            (torch.bfloat16, TIME_B, False),
                            (torch.bfloat16, CHECK_B, True)):
        f32 = dtype == torch.float32
        dname = "f32" if f32 else "bf16"
        params = seeded_params(cfg, dtype)
        enc = seeded_features(torch, B, L, cfg, dtype, 11)
        ops = k4_operands(torch, cfg, params, enc, 12)
        tiles = (params.get("layouts") or {}).get("gates")
        body = fs.step_body(dtype, cfg.hidden_size, cores)
        check(body == ("cuda_cores" if cores else "tf32" if f32
                       else "tensor_cores"),
              f"K4 {dname}: step_body names {body}")
        for fc in K4_CHUNKS:
            kw = dict(emb_size=E, frame_chunk=fc)
            before = dict(fs.fused_gru_attn_step.body_launches)
            got = fs.fused_gru_attn_step(*ops, tiles=tiles, cuda_cores=cores,
                                         **kw)
            want = fs.fused_gru_attn_step_reference(*ops, **kw)
            torch.cuda.synchronize()
            d = float((got.float() - want.float()).abs().max())
            log("kernels", f"K4 {dname} {body} B={B} frame_chunk={fc}: max "
                           f"|h - h_twin| {d:.3e}")
            after = dict(fs.fused_gru_attn_step.body_launches)
            check(after == dict(before, **{body: before.get(body, 0) + 1}),
                  f"K4 {dname} B={B} did not run on the {body} body alone")
            if f32:
                check(torch.allclose(got, want, rtol=H_RTOL, atol=H_ATOL),
                      f"K4 f32 {body} B={B} frame_chunk={fc}: h off the "
                      f"twin beyond rtol {H_RTOL} atol {H_ATOL}")
                if body == "tf32":
                    errs["fused_gru_attn_step[f32]"] = max(
                        errs["fused_gru_attn_step[f32]"], d)
                    k4_tf32_stages(torch, fs, ops, tiles, E, fc, B)
                continue
            check(torch.allclose(got.float(), want.float(), rtol=BF16_RTOL,
                                 atol=BF16_ATOL),
                  f"K4 bf16 {body} B={B} frame_chunk={fc}: h off the twin "
                  f"beyond rtol {BF16_RTOL} atol {BF16_ATOL}")
            if body == "tensor_cores":
                errs["fused_gru_attn_step"] = max(
                    errs["fused_gru_attn_step"], d)
        if f32 or B != TIME_B:
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
    return errs


def k4_tf32_stages(torch, fs, ops, tiles, E, fc, B):
    """The TF32 route's two kernels each against its plain stage: X's emb,
    pad and h columns exact and ctx within H_RTOL/H_ATOL of
    ``attention_pass_tf32_reference``; h' from that X within H_RTOL/H_ATOL
    of ``gate_cell_tf32_reference`` (the products as three TF32 terms),
    and each row's h' bit-equal to its h' in a batch of another
    ``gate_rows`` (``other_gate_batch``)."""
    x = fs._attention_pass_tf32(*ops[:7], frame_chunk=fc)
    x_want = fs.attention_pass_tf32_reference(*ops[:7], frame_chunk=fc)
    got = fs._gate_cell_tf32(x, tiles, ops[9])
    other = other_gate_batch(torch, fs, x)
    h_other = fs._gate_cell_tf32(other, tiles, ops[9])
    h_want = fs.gate_cell_tf32_reference(x, tiles, ops[9])
    torch.cuda.synchronize()
    F, H = ops[2].shape[2], ops[1].shape[1]
    n = min(B, other.shape[0])
    exact = (torch.equal(x[:, :E], x_want[:, :E])
             and torch.equal(x[:, E + F:], x_want[:, E + F:]))
    same = torch.equal(h_other[:n], got[:n])
    log("kernels", f"K4 f32 kernel A B={B} frame_chunk={fc}: emb, pad and h "
                   f"columns of X {'equal' if exact else 'DIFFER'}, max "
                   f"|ctx - plain| "
                   f"{float((x - x_want)[:, E:E + F].abs().max()):.3e}; "
                   f"kernel B on that X: max |h - plain| "
                   f"{float((got - h_want).abs().max()):.3e}, rows a block "
                   f"{fs.gate_rows(B)}; its first {n} rows at B="
                   f"{other.shape[0]} ({fs.gate_rows(other.shape[0])} rows "
                   f"a block) {'bit-equal' if same else 'DIFFER'}")
    check(exact, "K4 f32 kernel A: X's emb, pad or h columns differ")
    check(torch.allclose(x[:, E:E + F], x_want[:, E:E + F], rtol=H_RTOL,
                         atol=H_ATOL),
          f"K4 f32 kernel A: ctx off its plain stage beyond rtol {H_RTOL} "
          f"atol {H_ATOL}")
    check(torch.allclose(got, h_want, rtol=H_RTOL, atol=H_ATOL),
          f"K4 f32 kernel B: h off its plain stage beyond rtol {H_RTOL} "
          f"atol {H_ATOL}")
    check(same, "K4 f32 kernel B: a row's h' differs between batches of "
                "different rows a block")
    check(tuple(x.shape) == (B, fs.gate_width(E + F, H, fs.TF32_K)),
          "K4 f32 kernel A: X malformed")


def other_gate_batch(torch, fs, x):
    """X's rows in a batch that ``fs.gate_rows`` gives the other rows a
    block: its first EVAL_B rows (32 rows a block) where x takes 128 rows
    a block, else x repeated to a whole number of 128-row tiles."""
    B, big = x.shape[0], fs.GATE_ROWS_CHOICES[0]
    n = -(-B // big) * big
    other = (x[:EVAL_B] if fs.gate_rows(B) == big
             else x.repeat(n // B + 1, 1)[:n])
    check(fs.gate_rows(other.shape[0]) != fs.gate_rows(B),
          f"gate_rows gives one rows a block at B={B} and "
          f"{other.shape[0]}")
    return other.contiguous()


def margin_params(cfg, dtype, L, seed=SEED):
    """``seeded_params`` for checks of f32 kernels whose products are not
    IEEE f32's (ROADMAP Queue 3, note 3): out_w x MARGIN_OUT_W, logits with
    a clear top-2 margin; and the attention's score vector w / L. The fma
    stub sums the L scores without / L; at that scale its ctx drives the
    gates to where a change of rounding moves some GRU rows' later tokens
    (the plain twins with f32, three-term and float64 products disagree
    there), while with w / L every part's twins agree on every row.
    ``tf32_probes_against_k1`` logs that agreement."""
    from recnet_tpu_torch.weights import params_from_jax, random_params
    p = random_params(cfg, seed)
    p["out_w"] = p["out_w"] * MARGIN_OUT_W
    p["attention"]["w"] = p["attention"]["w"] / L
    return params_from_jax(p, DEVICE, dtype)


def tf32_probes_against_k1(torch, tc, cfg, note):
    """The f32 K5 probes on the TF32 body, ``cfg``'s cell: ``dual`` (16-row
    tiles) bit-equal to TF32 production K1's tokens at CHECK_B and RAGGED_B
    at every cluster size (1, 2, 4, 8); each ``ablate`` part at CHECK_B
    (``margin_params``) against the twin with the body's three-term
    products on F32_ROWS of rows, ``nativeargmax`` bit-equal to
    production."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    T, L, f32 = tc.caption_max_len + 1, tc.encoder_output_len, torch.float32
    cell = cfg.cell_type
    kw = dict(emb_size=cfg.embedding_size, max_len=T - 1, cell_type=cell)
    params = seeded_params(cfg, f32)
    for B in (CHECK_B, RAGGED_B):
        ops = decode_operands(params, seeded_features(torch, B, L, cfg, f32,
                                                      1))
        full = wd.whole_greedy_decode(*ops, **kw)
        same = {}
        for C in (1, 2, 4, 8):
            dual = wd.whole_greedy_decode(*ops, dual=True, cluster=C, **kw)
            torch.cuda.synchronize()
            same[C] = bool(torch.equal(dual, full))
            note("dual[tf32]", dual, full)
        log("kernels", f"K5 dual {cell} f32 B={B}, TF32 body: tokens "
                       f"bit-equal to TF32 K1's at cluster "
                       + ", ".join(f"{c}: {v}" for c, v in same.items()))
        check(all(same.values()), f"K5 dual {cell} f32 B={B} differs from "
                                  f"K1 on the TF32 body")
    ops = decode_operands(margin_params(cfg, f32, L),
                          seeded_features(torch, CHECK_B, L, cfg, f32, 1))
    production = wd.whole_greedy_decode(*ops, **kw)
    H = cfg.hidden_size
    z = torch.zeros((CHECK_B, H), dtype=f32, device=DEVICE)
    sos = torch.full((CHECK_B, 1), cfg.sos_token, dtype=torch.int32,
                     device=DEVICE)
    f64 = lambda a, b: (a.double() @ b.double()).float()
    for part in ABLATE_PARTS:
        got = wd.whole_greedy_decode(*ops, ablate=part, **kw)
        want, exact = (wd._decode_reference(
            *ops, z, z, sos, emb_size=cfg.embedding_size, n_steps=T,
            cell_type=cell, emb_scale=1.0, ablate=part, matmul=mm)[0]
            for mm in (wd.matmul_3xtf32_reference, f64))
        torch.cuda.synchronize()
        equal = (got == want).all(dim=1)
        rows = equal.double().mean().item()
        note(f"ablate={part}[tf32]", got, want)
        log("kernels", f"K5 ablate={part} {cell} TF32 body f32 B={CHECK_B} "
                       f"(margin_params): rows equal to the three-term twin "
                       f"{rows:.4f} (that twin's rows equal to the twin's "
                       f"with float64 products "
                       f"{(want == exact).all(dim=1).double().mean():.4f})")
        for row in torch.nonzero(~equal)[:5, 0].tolist():
            t = int(torch.nonzero(got[row] != want[row])[0, 0])
            one = (ops[0], ops[1][row:row + 1], ops[2][row:row + 1], ops[3])
            h = wd._decode_reference(
                *one, z[:1], z[:1], sos[:1], emb_size=cfg.embedding_size,
                n_steps=t + 1, cell_type=cell, emb_scale=1.0, ablate=part,
                matmul=wd.matmul_3xtf32_reference)[1]
            top = (wd.matmul_3xtf32_reference(h, ops[0]["out_w"])
                   + ops[0]["out_b"]).topk(2, dim=-1).values[0]
            log("kernels", f"  row {row} diverges at step {t}: the twin's "
                           f"top-2 logit margin {float(top[0] - top[1]):.3e}")
        check(rows >= F32_ROWS, f"K5 ablate={part} {cell} f32 TF32 body: "
                                f"rows equal {rows} < {F32_ROWS}")
        if part == "nativeargmax":
            check(torch.equal(got, production),
                  f"K5 ablate=nativeargmax {cell} f32 differs from TF32 "
                  f"production")


def variants_against_k1(torch, tc, cfg_base):
    """K5 on every body, GRU and LSTM. ``dual``: on the tensor-core body
    (bf16, 16 rows a block) its tokens equal production K1's tensor-core
    tokens on every row, at CHECK_B and at a ragged batch (RAGGED_B: half
    1 of the last block partly empty); on the TF32 body likewise in f32 at
    every cluster size (``tf32_probes_against_k1``); on the CUDA-core body
    they equal that body's production step's in f32 and in bf16
    (``cuda_cores``). ``ablate``: each part on the tensor-core body (bf16)
    against its twin on BF16_TOKENS, on the TF32 body (f32) against the
    three-term twin and on the CUDA-core body (f32, ``cuda_cores``)
    against the twin on F32_ROWS of rows; ``nativeargmax`` equal to its
    body's production step. Returns max |token - twin token| per variant,
    keyed as ``variant_launches``."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    T, L = tc.caption_max_len + 1, tc.encoder_output_len
    errs = {}

    def note(name, got, want):
        errs[name] = max(errs.get(name, 0.0), float((got - want).abs().max()))

    for cell in ("GRU", "LSTM"):
        cfg = cfg_base._replace(cell_type=cell)
        kw = dict(emb_size=cfg.embedding_size, max_len=T - 1, cell_type=cell)
        for B in (CHECK_B, RAGGED_B):     # dual on the tensor-core body
            ops = decode_operands(seeded_params(cfg, torch.bfloat16),
                                  seeded_features(torch, B, L, cfg,
                                                  torch.bfloat16, 1))
            dual = wd.whole_greedy_decode(*ops, dual=True, **kw)
            full = wd.whole_greedy_decode(*ops, **kw)
            torch.cuda.synchronize()
            rows = (dual == full).all(dim=1).float().mean().item()
            log("kernels", f"K5 dual {cell} bf16 B={B}, tensor-core body: "
                           f"rows equal to K1's tensor-core tokens "
                           f"{rows:.4f}")
            check(rows == 1.0, f"K5 dual {cell} bf16 B={B} differs from K1 "
                               f"on the tensor-core body")
            note("dual", dual, full)
        for dtype in (torch.float32, torch.bfloat16):   # the CUDA-core body
            ops = decode_operands(seeded_params(cfg, dtype),
                                  seeded_features(torch, CHECK_B, L, cfg,
                                                  dtype, 1))
            dual = wd.whole_greedy_decode(*ops, dual=True, cuda_cores=True,
                                          **kw)
            full = wd.whole_greedy_decode(*ops, cuda_cores=True, **kw)
            torch.cuda.synchronize()
            rows = (dual == full).all(dim=1).float().mean().item()
            dname = "f32" if dtype == torch.float32 else "bf16"
            log("kernels", f"K5 dual {cell} {dname} B={CHECK_B}, CUDA-core "
                           f"body: rows equal to K1 on that body {rows:.4f}")
            check(rows == 1.0, f"K5 dual {cell} {dname} differs from K1 on "
                               f"the CUDA-core body")
            note("dual[cuda_cores]", dual, full)
        tf32_probes_against_k1(torch, tc, cfg, note)
        for dtype in (torch.bfloat16, torch.float32):
            ops = decode_operands(seeded_params(cfg, dtype),
                                  seeded_features(torch, CHECK_B, L, cfg,
                                                  dtype, 1))
            f32 = dtype == torch.float32
            body = "CUDA-core body f32" if f32 else "tensor-core body bf16"
            # the probes' own body's production step (f32's CUDA-core
            # probes are asked for by cuda_cores)
            production = wd.whole_greedy_decode(*ops, cuda_cores=f32, **kw)
            for part in ABLATE_PARTS:
                got = wd.whole_greedy_decode(*ops, ablate=part,
                                             cuda_cores=f32, **kw)
                want = wd.whole_greedy_decode_reference(*ops, ablate=part,
                                                        **kw)
                torch.cuda.synchronize()
                rows = (got == want).all(dim=1).float().mean().item()
                share = (got == want).float().mean().item()
                note(f"ablate={part}" + ("[cuda_cores]" if f32 else ""),
                     got, want)
                log("kernels", f"K5 ablate={part} {cell} {body} "
                               f"B={CHECK_B}: rows equal to the twin "
                               f"{rows:.4f}, tokens {share:.4f}")
                if f32:
                    check(rows >= F32_ROWS, f"K5 ablate={part} {cell} f32: "
                                            f"rows equal {rows} < {F32_ROWS}")
                else:
                    check(share >= BF16_TOKENS,
                          f"K5 ablate={part} {cell} bf16: tokens equal "
                          f"{share} < {BF16_TOKENS}")
                if part == "nativeargmax":
                    check(torch.equal(got, production),
                          f"K5 ablate=nativeargmax {cell} ({body}) differs "
                          f"from production")
    return errs


# --------------------------------------------------------------------------
# 4. the main paths: HTTP serving and evaluation with the kernels
# --------------------------------------------------------------------------

def reset_counts():
    """Every kernel wrapper's launch count to 0."""
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    from recnet_tpu_torch.ops.cuda import rollout
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    for fn in (wd.whole_greedy_decode, wd.whole_greedy_decode_segment,
               tp.outproj_topk, fs.fused_gru_attn_step):
        fn.n_launches = 0
        # the counters by body or route (``--compare`` imports a tree that
        # may lack some)
        for name in ("variant_launches", "body_launches", "route_launches"):
            if hasattr(fn, name):
                getattr(fn, name).clear()
    rollout.reset_counts()
    try:       # ``--compare`` imports a tree that may lack it
        from recnet_tpu_torch.ops.cuda import embedding
    except ImportError:
        return
    embedding.embedding_backward.n_launches = 0
    try:
        from recnet_tpu_torch.ops.cuda import gemm
    except ImportError:
        return
    gemm.launch.n_launches = 0


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

    # f32 on the card (the TF32 body, counted from 0): K2 and K1 paths
    # against the plain twin, per video
    reset_counts()
    cap_f32 = Captioner(tc, vocab, eos_params, dtype="float32",
                        device=DEVICE, use_pallas=True,
                        greedy_segment=tc.greedy_segment)
    cap_f32_k1 = Captioner(tc, vocab, eos_params, dtype="float32",
                           device=DEVICE, use_pallas=True,
                           greedy_segment=None)
    feats = requests[2]
    got = cap_f32.caption(feats)
    got_k1 = cap_f32_k1.caption(feats)
    torch.cuda.synchronize()
    launches["whole_greedy_decode[f32]"] = (
        wd.whole_greedy_decode.body_launches["tf32"])
    launches["whole_greedy_decode_segment[f32]"] = (
        wd.whole_greedy_decode_segment.body_launches["tf32"])
    videos = torch.from_numpy(cap_f32.prepare(feats)).to(DEVICE,
                                                         torch.float32)
    ops = decode_operands(cap_f32.params, videos)
    twin = wd.whole_greedy_decode_reference(*ops, **kw)
    want = tokens_to_sentences(twin.T.cpu().numpy(), vocab.idx2word,
                               cfg.eos_token)
    share = float(np.mean([g == w for g, w in zip(got, want)]))
    share_k1 = float(np.mean([g == w for g, w in zip(got_k1, want)]))
    log("main", f"f32 kernel-path captions (TF32 body) equal to the twin's "
                f"on {share:.4f} (K2 segments) and {share_k1:.4f} (K1) of "
                f"{len(feats)} videos; TF32 body launches: K1 "
                f"{launches['whole_greedy_decode[f32]']}, K2 "
                f"{launches['whole_greedy_decode_segment[f32]']}")
    check(share >= F32_ROWS and share_k1 >= F32_ROWS,
          f"f32 captions agree on {share}, {share_k1} < {F32_ROWS}")
    check(launches["whole_greedy_decode[f32]"] > 0
          and launches["whole_greedy_decode_segment[f32]"] > 0,
          "the TF32 body never launched on the f32 serving path")
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


def eval_corpus(tc, vocab, cfg):
    """An in-memory score corpus of EVAL_VIDEOS videos of random features
    (batches of tc.batch_size, the last padded) and random reference
    captions, as ``evaluation.evaluate`` reads one."""
    import types
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
    return types.SimpleNamespace(
        score_batcher=batches, vocab=vocab,
        test_dataset=types.SimpleNamespace(video_caption_pairs=pairs))


def eval_path(torch, tc, vocab, cfg, params_np, tmp: Path):
    """``evaluation.evaluate`` with beam 5 and greedy at the flagship width
    (f32 params, as a trained checkpoint holds them, use_pallas and
    greedy_segment from the preset: the f32 route, the TF32 body and K3's
    TF32 split route) on ``eval_corpus``. Returns each kernel's launches."""
    from recnet_tpu_torch.evaluation import evaluate
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.weights import params_from_jax
    params = params_from_jax(params_np, DEVICE, torch.float32)
    corpus = eval_corpus(tc, vocab, cfg)
    bs, batches = tc.batch_size, corpus.score_batcher
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
                wd.whole_greedy_decode_segment.n_launches,
            "outproj_topk[f32]": tp.outproj_topk.route_launches["tf32_split"],
            "whole_greedy_decode_segment[f32]":
                wd.whole_greedy_decode_segment.body_launches["tf32"]}
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
    check(launches[f"beam {BEAM}"]["outproj_topk[f32]"]
          == launches[f"beam {BEAM}"]["outproj_topk"],
          "an f32 K3 launch in evaluate left the TF32 split route")
    check(launches["greedy"]["whole_greedy_decode_segment[f32]"]
          == launches["greedy"]["whole_greedy_decode_segment"],
          "an f32 K2 launch in evaluate left the TF32 body")
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
    on the random weights, whose rows run all T steps, with K4's launches
    counted (all T on the TF32 route). Returns K4's launches, keyed as the
    kernels line (bf16, and "[f32]")."""
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
    reset_counts()
    got = decoding.greedy_decode_pallas(f32, cfg, enc, T - 1)
    torch.cuda.synchronize()
    f32_launches = fs.fused_gru_attn_step.n_launches
    bodies = dict(fs.fused_gru_attn_step.body_launches)
    log("pallas", f"greedy_decode_pallas B={CHECK_B} f32 T={T}: K4 launches "
                  f"{f32_launches} by body {bodies}")
    check(f32_launches == T, f"f32 K4 launched {f32_launches} times, not "
                             f"T = {T}")
    check(bodies == {"tf32": T},
          f"f32 K4 did not run all {T} steps on the TF32 route")
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
    return {"fused_gru_attn_step": launches,
            "fused_gru_attn_step[f32]": f32_launches}


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


def profiled(torch, fn, reps=1):
    """({name: count}, {name: device us}) of the card's activities in one
    torch.profiler session of ``reps`` calls of ``fn``. The profiler on the
    card may miss a session's first device events, so the session opens
    with PROFILE_PAD spin kernels, left out of both."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    counts, times = collections.Counter(), collections.Counter()
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA \
                and "spin_kernel" not in ev.name:
            counts[ev.name] += 1
            times[ev.name] += ev.device_time
    return counts, times


def device_ms(torch, fn, names=("",), reps=10, launches=None):
    """{name: device ms per call} of the work on the card whose names
    contain each of ``names`` ("" takes all of it), over ``reps`` calls of
    ``fn`` after a warm-up, by torch.profiler: the kernels' own time, where
    CUDA events around calls that the host paces read the host. The
    profiler on the card may miss a session's first device events (so
    ``profiled`` opens each session with spin kernels), and now and then
    all of a session's events, about half or one or two. ``launches`` gives, for some of ``names``, the device kernels a
    call launches under that name (the wrappers' counts): the name's time a
    call is its mean over the events reported times that count, and the
    session stands if it misses at most PROFILE_LOSS of them. A name
    without a count (a library's kernels, "" over a loop) takes each of its
    kernels' counts from the sessions: the profiler drops events and adds
    none, so the most a session has reported of each kernel is the count,
    and it stands once two sessions have reported all of it (not always a
    whole number a call: the first backward of a leaf makes its grad, the
    next ones add to it); the name's time a call is then its events' sum
    over ``reps``. Up to
    PROFILE_TRIES sessions; fails when none stands."""
    launches = launches or {}
    fn()
    torch.cuda.synchronize()
    most = {}      # the most events of a name's kernels a session reported
    full = {}      # the sessions that reported all of them
    for attempt in range(PROFILE_TRIES):
        counts, times = profiled(torch, fn, reps)
        us, faults = {}, []
        for name in names:
            hit = {k: n for k, n in counts.items() if name in k}
            n, t = sum(hit.values()), sum(times[k] for k in hit)
            if name in launches:
                want = launches[name] * reps
                if not n or abs(n - want) > PROFILE_LOSS * want:
                    faults.append(f"{name!r}: {n} of {want} events")
                else:
                    us[name] = t / n * launches[name]
                continue
            top = dict(most.get(name, {}))
            for k, c in hit.items():
                top[k] = max(c, top.get(k, 0))
            if top != most.get(name):
                most[name], full[name] = top, 0
            if hit and hit == top:
                full[name] += 1
                if full[name] >= 2:
                    us[name] = t / reps
            else:
                faults.append(f"{name!r}: events a kernel "
                              f"{sorted(hit.values())}, the most seen "
                              f"{sorted(top.values())}")
        if len(us) == len(names):
            break
        if faults:
            log("profile", f"session {attempt + 1} of {names}, {reps} "
                           f"calls: " + "; ".join(faults))
            time.sleep(PROFILE_PAUSE_S)
    check(len(us) == len(names), f"no profiler session of {names} stood "
                                 f"in {PROFILE_TRIES}")
    return {name: t / 1000 for name, t in us.items()}


def counted_launches(torch, fn, *wrappers):
    """The launches one call of ``fn`` makes through ``wrappers`` (their
    counts; every count is reset first)."""
    reset_counts()
    fn()
    torch.cuda.synchronize()
    return sum(w.n_launches for w in wrappers)


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


def bound_f32(flops, nbytes):
    """The f32 route's (bound ms, "operations" or "bytes"): ``flops`` as
    TF32_TERMS TF32 products at PEAK_TF32_FLOPS, or ``nbytes`` at the
    device-memory rate, whichever is longer."""
    t_ops = TF32_TERMS * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decode_work(cfg, L, B, row_steps, n_steps, ablate="", state=False,
                elem=2):
    """(flops, bytes) of greedy decode steps in bf16 (``elem`` = 4: f32):
    ``row_steps`` rows x
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
    return 2 * row_steps * macs, elem * (weights + acts) + 4 * B * n_steps


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


def gate_rows_sweep(torch):
    """``--gate-rows``: kernel B of K4's TF32 route (f32, the flagship's
    width) at each rows a block it is built for, at each B of
    GATE_ROWS_SWEEP_B: the whole route run with the rows forced, the
    choices in turns over GATE_ROWS_ROUNDS rounds, kernel B's device time
    read in the route's sequence (X just written, enc streamed through L2)
    and h' held bit-equal across the choices. Logs each choice's range,
    the fastest, and the rows ``fused_step.gate_rows`` picks."""
    from recnet_tpu_torch.checkpoint import load_config_and_vocab
    from recnet_tpu_torch.models.decoder import config_from_train
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    with tempfile.TemporaryDirectory() as tmp:
        tc, vocab = load_config_and_vocab(
            str(flagship_checkpoint_dir(Path(tmp), VOCAB)))
    cfg = config_from_train(tc, vocab.n_vocabs)
    card, L, E = card_line(), tc.encoder_output_len, cfg.embedding_size
    params = seeded_params(cfg, torch.float32)
    tiles = params["layouts"]["gates"]
    names = ("attn_wh_f32", "attn_scores_f32", "attn_ctx_f32",
             "gate_gemm_f32")
    for B in GATE_ROWS_SWEEP_B:
        enc = seeded_features(torch, B, L, cfg, torch.float32, 11)
        ops = k4_operands(torch, cfg, params, enc, 12)
        named = dict(zip(fs._OPERANDS[:7], ops[:7]))
        x = torch.empty((B, fs.gate_width(E + cfg.encoder_size,
                                          cfg.hidden_size, fs.TF32_K)),
                        device=DEVICE)
        outs = {r: torch.empty_like(ops[1]) for r in fs.GATE_ROWS_CHOICES}
        runs = {r: functools.partial(
                    fs._launch_tf32, fs._ATTENTION_PASS | fs._GATE_CELL, x,
                    outs[r], **named, tiles=tiles, bias3=ops[9],
                    rows_per_block=r)
                for r in fs.GATE_ROWS_CHOICES}
        ms = collections.defaultdict(list)
        for _ in range(GATE_ROWS_ROUNDS):
            for r, run in runs.items():
                ms[r].append(device_ms(torch, run, ("gate_gemm_f32",),
                                       launches={"gate_gemm_f32": 1})
                             ["gate_gemm_f32"])
        torch.cuda.synchronize()
        first = outs[fs.GATE_ROWS_CHOICES[0]]
        check(all(torch.equal(o, first) for o in outs.values()),
              f"K4 f32 kernel B B={B}: h' differs between rows a block")
        best = min(ms, key=lambda r: min(ms[r]))
        log("gate-rows", f"B={B}: kernel B device ms by rows a block "
                         + ", ".join(f"{r}: {min(v):.4f}-{max(v):.4f}"
                                     for r, v in ms.items())
                         + f"; fastest {best}, gate_rows picks "
                         f"{fs.gate_rows(B)}; h' bit-equal ({card})")


def tests_module(name: str):
    """``tests/<name>.py`` loaded by its path: ``tests`` is no package
    here, and one installed under that name would shadow it."""
    import importlib.util
    path = Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def caption_inputs(seed, T, B, V):
    """``caption_inputs`` of ``tests/torch_embedding_cases.py``."""
    return tests_module("torch_embedding_cases").caption_inputs(seed, T, B,
                                                                 V)


def sync_fault(torch, fn):
    """None if ``fn`` runs through under ``set_sync_debug_mode("error")``,
    else the first line of the error a host synchronisation raised."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return None


def embedding_backward_times(torch, E):
    """``--embedding-backward`` (a), and the kernels line's entry of the
    default run: the kernel at the train cells' shape (N = EMB_T x EMB_B
    caption inputs, E, V = VOCAB) against float64 ``index_put_`` with
    accumulate (within 1e-5 of |value| plus the sum of the magnitudes added
    into it, the scale of an f32 sum's rounding; ATen's two routes too),
    bit for bit against its twin and against itself over five calls; by
    CUDA events and device time (each of its parts by name) beside ATen's
    ``index_put_`` with accumulate (the autograd route of ``table[tokens]``:
    a zero fill, then the sort and ``indexing_backward_kernel``) and
    ``F.embedding``'s backward (``embedding_dense_backward``), and the
    bound: the cotangent and tokens read once, the table's gradient written
    once, at the device-memory rate. The issue's other properties, read on
    both routes a gradient could take: whether a forward and backward of
    the gather syncs the host (``set_sync_debug_mode("error")``), whether
    EMB_REPEATS calls give the same bits, and whether
    ``torch.use_deterministic_algorithms`` refuses the library's backward.
    Returns the kernels-line entry, less its launches (the caller's count
    over train steps)."""
    from recnet_tpu_torch.ops.cuda import embedding
    from recnet_tpu_torch.parallel import vocab as vocab_par
    card = card_line()
    tok = caption_inputs(SEED, EMB_T, EMB_B, VOCAB).reshape(-1).to(DEVICE)
    N, V = tok.numel(), VOCAB
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    d_rows = torch.randn((N, E), device=DEVICE, generator=g)
    run = lambda: embedding.embedding_backward(tok, d_rows, V)
    aten = lambda: torch.zeros((V, E), device=DEVICE).index_put_(
        (tok,), d_rows, accumulate=True)
    dense = lambda: torch.ops.aten.embedding_dense_backward(
        d_rows, tok, V, -1, False)
    zeros = torch.zeros((V, E), dtype=torch.float64, device=DEVICE)
    want = zeros.clone().index_put_((tok,), d_rows.double(), accumulate=True)
    mag = zeros.index_put_((tok,), d_rows.double().abs(), accumulate=True)
    got = run()
    errs = {}
    for name, fn in (("kernel", lambda: got), ("aten", aten),
                     ("dense", dense)):
        err = (fn().double() - want).abs()
        errs[name] = float(err.max())
        errs[f"{name}_over_magnitude"] = float((err / (want.abs() + mag)
                                                ).nan_to_num().max())
        check(bool((err <= 1e-5 * (want.abs() + mag)).all()),
              f"embedding backward ({name}): max |err| {errs[name]:.3g} "
              f"against float64 index_put_")
    check(all(torch.equal(run(), got) for _ in range(5)),
          "embedding backward: two calls gave other bits")
    check(torch.equal(got.cpu(), embedding.embedding_backward_reference(
              tok.cpu(), d_rows.cpu(), V)),
          "embedding backward: the kernel's bits are not its twin's")
    first = dense()
    dense_repeats = sum(torch.equal(dense(), first)
                        for _ in range(EMB_REPEATS))
    table = torch.randn((V, E), device=DEVICE, generator=g)
    table.requires_grad_(True)
    rows = d_rows.reshape(EMB_T, EMB_B, E)
    gather = {"kernel": lambda: vocab_par.embed(table, tok.view(
                  EMB_T, EMB_B)),
              "dense": lambda: torch.nn.functional.embedding(
                  tok.view(EMB_T, EMB_B), table)}
    syncs = {name: sync_fault(torch, lambda: (fn() * rows).sum().backward())
             for name, fn in gather.items()}
    check(syncs["kernel"] is None, f"the embedding kernel's route syncs the "
                                   f"host: {syncs['kernel']}")
    torch.use_deterministic_algorithms(True)
    try:
        dense()
        dense_flagged = None
    except RuntimeError as e:
        dense_flagged = str(e).splitlines()[0]
    finally:
        torch.use_deterministic_algorithms(False)
    ms = timed(torch, run, reps=20)[0]
    aten_ms = timed(torch, aten, reps=3)[0]
    dense_ms = timed(torch, dense, reps=20)[0]
    parts = ("", "embedding_keys", "DeviceRadixSort", "embedding_tile_sum",
             "embedding_merge")
    dev = device_ms(torch, run, parts, reps=20)
    aten_dev = device_ms(torch, aten, ("", "indexing_backward_kernel"),
                         reps=3)
    dense_dev = device_ms(torch, dense, ("",), reps=20)
    nbytes = N * E * 4 + N * tok.element_size() + V * E * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    pad = float((tok == 0).float().mean())
    errors = ", ".join(f"{name} {errs[name]:.3g} "
                       f"({errs[f'{name}_over_magnitude']:.3g})"
                       for name in ("kernel", "aten", "dense"))
    log("embedding", f"N={N} (<PAD> share {pad:.4f}, "
                     f"{int(torch.unique(tok).numel())} rows read), E={E}, "
                     f"V={V}: kernel {ms:.4f} ms by events, device "
                     f"{dev['']:.4f} ("
                     + ", ".join(f"{p} {dev[p]:.4f}" for p in parts[1:])
                     + f"); ATen index_put_ "
                     f"accumulate {aten_ms:.4f} ms, device "
                     f"{aten_dev['']:.4f} (indexing_backward_kernel "
                     f"{aten_dev['indexing_backward_kernel']:.4f}); "
                     f"embedding_dense_backward {dense_ms:.4f} ms, device "
                     f"{dense_dev['']:.4f}; bound {bound_ms:.4f} ms "
                     f"({nbytes / 1e6:.1f} MB at "
                     f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); max |err| "
                     f"against float64 (over |value| + magnitude): "
                     f"{errors} ({card})")
    log("embedding", f"host syncs of a forward and backward of the gather "
                     f"(set_sync_debug_mode error): embed's kernel route "
                     f"{syncs['kernel'] or 'none'}; F.embedding "
                     f"{syncs['dense'] or 'none'}; embedding_dense_backward "
                     f"the same bits in {dense_repeats} of {EMB_REPEATS} "
                     f"calls; under use_deterministic_algorithms "
                     f"{dense_flagged or 'runs'} ({card})")
    return dict(name="embedding_backward", route="cuda",
                source="recnet_tpu_torch/csrc/embedding_backward.cu",
                replaces="ATen index_put_ (accumulate)", pallas=False,
                max_abs_err=errs["kernel"], ms=ms,
                device_ms=dev[""], parts_device_ms={
                    p: dev[p] for p in parts[1:]},
                library_ms=aten_ms, library_device_ms=aten_dev[""],
                indexing_backward_device_ms=aten_dev[
                    "indexing_backward_kernel"],
                dense_ms=dense_ms, dense_device_ms=dense_dev[""],
                dense_syncs=syncs["dense"], dense_repeats=dense_repeats,
                dense_deterministic_refusal=dense_flagged,
                bound_ms=bound_ms, bound_by="bytes")


def embedding_step_times(torch, tc, vocab):
    """``--embedding-backward`` (b): the f32 k-step call (EMB_STEPS steps,
    ``build_train_multi_step_cached``) of the global flagship at B =
    EMB_B on ``caption_inputs`` and seeded features in a bf16 cache, by
    three routes of the gather's backward in turns over EMB_ROUNDS rounds:
    the kernel (``vocab._kernel_gather`` as it is), the plain gather's
    ``index_put_`` (it returns False), and ``F.embedding``'s
    ``embedding_dense_backward`` (``vocab.embed`` replaced by it): ms a step
    by CUDA events over a call, the kernel's launches a step (the counts
    reset just before a call and read after it), and a profiled call of
    each route: the device ms a step of the kernel's parts, of ATen's
    ``indexing_backward_kernel`` and of ``embedding_dense_backward``'s
    ``compute_grad_weight`` and ``sum_and_scatter``."""
    from recnet_tpu_torch.models import decoder as dec_mod
    from recnet_tpu_torch.ops.cuda import embedding
    from recnet_tpu_torch.parallel import vocab as vocab_par
    from recnet_tpu_torch.training import step as S
    card = card_line()
    k, B = EMB_STEPS, EMB_B
    ttc = tc.replace(batch_size=B, steps_per_dispatch=k,
                     train_precision="float32")
    state, dcfg, rcfg = S.init_train_state(SEED, ttc, VOCAB, DEVICE)
    fn = S.build_train_multi_step_cached(ttc, dcfg, rcfg, k)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    cache = torch.randn((EMB_CACHE_VIDEOS, tc.encoder_output_len,
                         tc.encoder_output_size), device=DEVICE,
                        generator=g).to(torch.bfloat16)
    rows = torch.randint(0, EMB_CACHE_VIDEOS, (k, B), device=DEVICE,
                         generator=g)
    caps = torch.stack([caption_inputs(SEED + 2 + i, EMB_T, B, VOCAB)
                        for i in range(k)]).to(DEVICE)
    # the inputs' first row is <SOS>, the step's captions start at words
    caps = torch.cat([caps[:, 1:], torch.zeros_like(caps[:, :1])], 1)
    call = lambda: fn(state, cache, rows, caps)
    kernel_gather, embed = vocab_par._kernel_gather, vocab_par.embed
    dense = lambda table, tokens, shard=None: \
        torch.nn.functional.embedding(tokens, table)
    routes = {"kernel": (kernel_gather, embed),
              "plain": (lambda *a: False, embed),
              "dense": (kernel_gather, dense)}
    assert dec_mod.vocab_par is vocab_par     # the decoder's embed
    ms = collections.defaultdict(list)
    counted = {}
    try:
        for _ in range(EMB_ROUNDS):
            for name in ("kernel", "plain", "dense", "dense", "plain",
                         "kernel"):
                vocab_par._kernel_gather, vocab_par.embed = routes[name]
                reset_counts()
                call()
                torch.cuda.synchronize()
                counted[name] = embedding.embedding_backward.n_launches / k
                ms[name].append(timed(torch, call, reps=1)[0] / k)
        dev = {}
        for name in routes:
            vocab_par._kernel_gather, vocab_par.embed = routes[name]
            counts, times = profiled(torch, call)
            dev[name] = {
                part: sum(t for key, t in times.items() if part in key)
                / 1000 / k
                for part in ("embedding_", "DeviceRadixSort",
                             "indexing_backward_kernel",
                             "compute_grad_weight", "sum_and_scatter")}
            dev[name]["all"] = sum(times.values()) / 1000 / k
            dev[name]["activities"] = sum(counts.values()) / k
    finally:
        vocab_par._kernel_gather, vocab_par.embed = kernel_gather, embed
    check(counted == {"kernel": 1, "plain": 0, "dense": 0},
          f"embedding backward launches a step: {counted}")
    for name in routes:
        log("embedding", f"train call k={k} B={B} f32, {name} route: "
                         + ", ".join(f"{x:.3f}" for x in ms[name])
                         + f" ms a step by CUDA events (median "
                         f"{float(np.median(ms[name])):.3f}); "
                         f"{counted[name]:g} embedding launches a step; "
                         "device ms a step, profiled: "
                         + ", ".join(f"{p} {v:.4f}"
                                     for p, v in dev[name].items())
                         + f" ({card})")
    return {name: dict(ms=ms[name], launches=counted[name], **dev[name])
            for name in routes}


def embedding_phase(torch):
    """``--embedding-backward``: (a) then (b); prints the kernels line,
    the entry's launches those a step of (b)'s kernel route."""
    from recnet_tpu_torch.checkpoint import load_config_and_vocab
    with tempfile.TemporaryDirectory() as tmp:
        tc, vocab = load_config_and_vocab(
            str(flagship_checkpoint_dir(Path(tmp), VOCAB)))
    entry = embedding_backward_times(torch, tc.embedding_size)
    entry["train_step"] = embedding_step_times(torch, tc, vocab)
    entry["launches"] = entry["train_step"]["kernel"]["launches"]
    print(card_line())
    print(json.dumps({"kernels": [entry]}))


def three_tf32_products(a, b, *, bias=None, out=None, accumulate=False):
    """The three-term split on the library: a and b split as hi =
    tf32(x), lo = tf32(x - hi), then a_lo b_hi + a_hi b_lo + a_hi b_hi as
    three cuBLAS TF32 products (``allow_tf32`` on for them alone), with
    ``mm_reference``'s epilogues."""
    import torch
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    a_hi, b_hi = wd.tf32_round(a), wd.tf32_round(b)
    a_lo, b_lo = wd.tf32_round(a - a_hi), wd.tf32_round(b - b_hi)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y = (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if bias is not None:
        y = y + bias
    if out is None:
        return y
    return out.add_(y) if accumulate else out.copy_(y)


def gemm_case(torch, name, kind, M, K, N, epi, timing):
    """One product: the kernel (``gemm.launch``), cuBLAS f32
    (``mm_reference``), the split on the library (``three_tf32_products``)
    and one TF32 term (the control: a_hi b_hi, summed in float64), each
    against float64 as max |C - C64| / max |C64|; the kernel within
    GEMM_ERR_RATIO of cuBLAS f32's error, the control not; GEMM_REPEATS
    calls giving the same bits; one launch a call; ``route``, what
    ``gemm.mm`` runs at the shape (``kernel_pays``). ``timing``: the
    kernel's, cuBLAS f32's and the library split's (``library_ms``, the
    split included) ms by CUDA events, and the bound."""
    from recnet_tpu_torch.ops.cuda import gemm
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    cases = tests_module("torch_gemm_cases")
    a, b, bias, buf = cases.operands(kind, M, K, N, epi, SEED, DEVICE)
    acc = epi == "acc"
    call = lambda fn, **kw: cases.run(fn, a, b, bias, buf, epi, **kw)
    want = cases.exact(a, b, bias, buf, epi)
    err = lambda got: cases.rel_err(got, want)
    reset_counts()
    got = call(gemm.launch)
    torch.cuda.synchronize()
    check(gemm.launch.n_launches == 1,
          f"gemm {name}: {gemm.launch.n_launches} launches for one product")
    same = all(torch.equal(call(gemm.launch), got)
               for _ in range(GEMM_REPEATS - 1))
    check(same, f"gemm {name}: {GEMM_REPEATS} calls gave other bits")
    row = {"name": name, "kind": kind, "M": M, "K": K, "N": N,
           "epilogue": epi,
           "route": ("kernel" if gemm.kernel_pays(M, N, K, gemm._n_sms(
               a.device)) else "cublas"),
           "err": err(got),
           "cublas_err": err(call(gemm.mm_reference)),
           "library_err": err(call(three_tf32_products))}
    del want
    ctl = cases.exact(a, b, bias, buf, epi, wd.tf32_round, wd.tf32_round)
    want = cases.exact(a, b, bias, buf, epi)
    row["tf32_control_err"] = cases.rel_err(ctl.float(), want)
    del ctl, want
    limit = GEMM_ERR_RATIO * row["cublas_err"]
    check(row["err"] <= limit, f"gemm {name}: error {row['err']:.3e} over "
                               f"{GEMM_ERR_RATIO} x cuBLAS f32's "
                               f"{row['cublas_err']:.3e}")
    check(row["tf32_control_err"] > limit,
          f"gemm {name}: the one-term control's {row['tf32_control_err']:.3e}"
          f" passes the limit {limit:.3e}")
    if timing:
        reps = 50 if 2.0 * M * N * K < 2e10 else 5
        row["ms"] = timed(torch, lambda: call(gemm.launch), reps)[0]
        row["cublas_ms"] = timed(torch, lambda: call(gemm.mm_reference),
                                 reps)[0]
        row["library_ms"] = timed(torch,
                                  lambda: call(three_tf32_products), reps)[0]
        flops = 2.0 * M * N * K
        nbytes = 4.0 * (M * K + K * N + M * N * (2 if acc else 1))
        row["bound_ms"] = max(flops / F32_EXACT_FLOPS,
                              nbytes / HBM_BYTES_PER_S) * 1e3
        row["bound_by"] = ("operations" if flops / F32_EXACT_FLOPS
                           >= nbytes / HBM_BYTES_PER_S else "bytes")
        row["tflops"] = flops / row["ms"] / 1e9
        row["roofline"] = 100.0 * row["bound_ms"] / row["ms"]
    log("gemm", json.dumps(row))
    return row


GEMM_LIBRARY_NAMES = ("gemm", "gemv", "dot_kernel", "magma", "splitKreduce")
# cuBLAS's float32 products on the CUDA cores, by kernel name
F32_LIBRARY_NAMES = ("sgemm", "gemm_f32f32", "gemv")


def gemm_step_routes(torch, tc, kind):
    """The f32 k-step call (EMB_STEPS steps, ``build_train_multi_step_
    cached``) of the ``kind`` reconstructor's flagship at B = GEMM_B, by
    the kernel's route and by torch's products (``gemm.mm`` as
    ``mm_reference``, ``gemm.product_route`` False) in turns over
    GEMM_ROUNDS rounds: ms a step by CUDA events, the kernel's launches a
    step, and one profiled call of each: the device ms a step of the
    matrix-product kernels by name (cuBLAS's and this kernel's), and of
    all of it; ``float32_left``, the kernel route's float32 products on
    the CUDA cores (cuBLAS's sgemm, f32f32 and gemv kernels)."""
    from recnet_tpu_torch.ops.cuda import gemm
    from recnet_tpu_torch.training import step as S
    card = card_line()
    k, B = EMB_STEPS, GEMM_B
    ttc = tc.replace(batch_size=B, steps_per_dispatch=k,
                     train_precision="float32", reconstructor_type=kind)
    state, dcfg, rcfg = S.init_train_state(SEED, ttc, VOCAB, DEVICE)
    fn = S.build_train_multi_step_cached(ttc, dcfg, rcfg, k)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    cache = torch.randn((EMB_CACHE_VIDEOS, tc.encoder_output_len,
                         tc.encoder_output_size), device=DEVICE,
                        generator=g).to(torch.bfloat16)
    rows = torch.randint(0, EMB_CACHE_VIDEOS, (k, B), device=DEVICE,
                         generator=g)
    caps = torch.stack([caption_inputs(SEED + 2 + i, EMB_T, B, VOCAB)
                        for i in range(k)]).to(DEVICE)
    caps = torch.cat([caps[:, 1:], torch.zeros_like(caps[:, :1])], 1)
    call = lambda: fn(state, cache, rows, caps)
    mm, route = gemm.mm, gemm.product_route
    routes = {"kernel": (mm, route),
              "cublas": (gemm.mm_reference, lambda *x, **kw: False)}
    ms = collections.defaultdict(list)
    out = {}
    try:
        for _ in range(GEMM_ROUNDS):
            for name in ("kernel", "cublas", "cublas", "kernel"):
                gemm.mm, gemm.product_route = routes[name]
                reset_counts()
                call()
                torch.cuda.synchronize()
                out.setdefault(name, {})["launches"] = (
                    gemm.launch.n_launches / k)
                ms[name].append(timed(torch, call, reps=1)[0] / k)
        for name in routes:
            gemm.mm, gemm.product_route = routes[name]
            counts, times = profiled(torch, call)
            prods = {key: [counts[key] / k, times[key] / 1000 / k]
                     for key in counts
                     if any(x in key for x in GEMM_LIBRARY_NAMES)}
            out[name].update(
                ms=ms[name], median_ms=float(np.median(ms[name])),
                device_ms=sum(times.values()) / 1000 / k,
                activities=sum(counts.values()) / k,
                products_device_ms=sum(v[1] for v in prods.values()),
                products=prods,
                float32_left={key: v for key, v in prods.items()
                              if "gemm_tf32x3" not in key and any(
                                  x in key for x in F32_LIBRARY_NAMES)})
    finally:
        gemm.mm, gemm.product_route = mm, route
    for name, row in out.items():
        log("gemm", f"train call {kind} k={k} B={B} f32, {name} route: "
                    f"{json.dumps(row)} ({card})")
    check(out["cublas"]["launches"] == 0 and out["kernel"]["launches"] > 0,
          f"gemm launches a step: {out['kernel']['launches']} by the "
          f"kernel's route, {out['cublas']['launches']} by torch's")
    return out


def gemm_phase(torch, check_only: bool):
    """``--gemm``: every ``gemm_cases`` product (``gemm_case``), then, unless
    ``check_only``, the global and local k-step calls by both routes
    (``gemm_step_routes``); prints the kernels line."""
    from recnet_tpu_torch.checkpoint import load_config_and_vocab
    rows = []
    for case in tests_module("torch_gemm_cases").CASES:
        rows.append(gemm_case(torch, *case, timing=not check_only))
        torch.cuda.empty_cache()
    entry = {"name": "gemm_tf32x3", "route": "cuda",
             "source": "recnet_tpu_torch/csrc/gemm_tf32x3.cu",
             "replaces": None, "pallas": False, "shapes": rows}
    if not check_only:
        with tempfile.TemporaryDirectory() as tmp:
            tc, _ = load_config_and_vocab(
                str(flagship_checkpoint_dir(Path(tmp), VOCAB)))
        entry["train_step"] = {kind: gemm_step_routes(torch, tc, kind)
                               for kind in ("global", "local")}
        entry["launches"] = entry["train_step"]["global"]["kernel"][
            "launches"]
    print(card_line())
    print(json.dumps({"kernels": [entry]}))


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
    # each of K4's two kernels once a launch of the route's wrapper
    per_call = counted_launches(torch, route, fs.fused_gru_attn_step)
    k4_launches = {"attn_pass": per_call, "gate_gemm": per_call}
    split = device_ms(torch, route, ("attn_pass", "gate_gemm"),
                      launches=k4_launches)
    e.update(device_ms=sum(split.values()),
             library_device_ms=device_ms(torch, library)[""],
             attn_pass_ms=split["attn_pass"], gate_gemm_ms=split["gate_gemm"],
             host_ms=host_ms(torch, route))
    # the same two kernels at B = 8: the part of their time that does not
    # shrink with the batch
    k4_8 = k4_operands(torch, cfg, params, enc[:8].contiguous(), 14)
    split8 = device_ms(torch, lambda: fs.fused_gru_attn_step(
        *k4_8, emb_size=E, tiles=tiles), ("attn_pass", "gate_gemm"),
        launches=k4_launches)
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
    # the K5 early exit on the PAD-timed weights, dual on both bodies and
    # the CUDA-core production step against K1
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
    entry("whole_greedy_decode[dual[cuda_cores]]",
          lambda: wd.whole_greedy_decode(*ops, dual=True, cuda_cores=True,
                                         **k1), k1_twin, k1_library, k1_work)
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
                 f"{entries['whole_greedy_decode[dual]']['ms']:.3f} ms "
                 f"(tensor-core body) and "
                 f"{entries['whole_greedy_decode[dual[cuda_cores]]']['ms']:.3f}"
                 f" ms (CUDA-core body), the CUDA-core step "
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


def f32_cases(torch, tc, cfg, params, B, pad_params=None):
    """The f32 route's rows at B: {name: (route, first design, plain twin,
    library route, (flops, bytes), timing reps, {profiler name: kernels a
    call} of the route and of the first design, launches a decode)}. K1
    from <SOS> for T steps; K2 seg_len 4 from a zero state and <SOS> (the
    library route: ``greedy_decode`` of 4 steps); K3 at B x BEAM rows of GRU
    output, k = BEAM (the library route: the cuBLAS f32 product, then
    ``topk_rounds``); K4 (the TF32 route, its first design the CUDA-core
    body; the library route: the composed ``gru_attn_step_reference``;
    launches a decode: T in ``greedy_decode_pallas``, which no entry point
    calls); with
    ``pad_params`` (the PAD-timed weights) the early exit on the TF32 body,
    its work counted over the row-steps its 8-row tiles run (the library
    route: ``greedy_decode``). The first design: the CUDA-core body
    (``cuda_cores``), the single pass (``f32_single_pass``)."""
    from recnet_tpu_torch import decoding
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    T, L, H = tc.caption_max_len + 1, tc.encoder_output_len, cfg.hidden_size
    f32 = torch.float32
    enc = seeded_features(torch, B, L, cfg, f32, 3)
    ops = decode_operands(params, enc)
    kw = dict(emb_size=cfg.embedding_size, cell_type=cfg.cell_type)
    k1 = dict(max_len=T - 1, **kw)
    z = torch.zeros((B, H), dtype=f32, device=DEVICE)
    sos = torch.full((B, 1), cfg.sos_token, dtype=torch.int32, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(6)
    hidden = torch.tanh(torch.randn((B * BEAM, H), generator=g,
                                    device=DEVICE))
    w, b = params["out_w"], params["out_b"]
    # the parameter set's padded out_w (a tree without f32 layouts has none)
    padded = (params.get("layouts") or {}).get("out_w_padded")
    k3 = dict(k=BEAM, **({"padded_w": padded} if padded is not None else {}))
    N, V = B * BEAM, cfg.vocab_size
    tf32, cores = "tf32_decode_kernel", "whole_decode_kernel"
    split = {"topk_split_kernel": 1, "topk_merge_kernel": 1}
    k4 = k4_operands(torch, cfg, params, enc, 14)
    E, k4_flops, k4_bytes = cfg.embedding_size, *k4_work(cfg, L, B)
    # the parameter set's gate tiles, as the K4 loop passes them
    tiles = (params.get("layouts") or {}).get("gates")
    k4kw = dict(emb_size=E, **({"tiles": tiles} if tiles is not None else {}))
    cases = {
        "whole_greedy_decode[f32]": (
            lambda: wd.whole_greedy_decode(*ops, **k1),
            lambda: wd.whole_greedy_decode(*ops, cuda_cores=True, **k1),
            lambda: wd.whole_greedy_decode_reference(*ops, **k1),
            lambda: decoding.greedy_decode(params, cfg, enc, T - 1),
            decode_work(cfg, L, B, B * T, T, elem=4), 3,
            {tf32: 1}, {cores: 1}, 1),
        "whole_greedy_decode_segment[f32]": (
            lambda: wd.whole_greedy_decode_segment(*ops, z, z, sos,
                                                   seg_len=4, **kw),
            lambda: wd.whole_greedy_decode_segment(*ops, z, z, sos,
                                                   seg_len=4,
                                                   cuda_cores=True, **kw),
            lambda: wd.whole_greedy_decode_segment_reference(
                *ops, z, z, sos, seg_len=4, **kw),
            lambda: decoding.greedy_decode(params, cfg, enc, 3),
            decode_work(cfg, L, B, B * 4, 4, state=True, elem=4), 3,
            {tf32: 1}, {cores: 1}, -(-T // tc.greedy_segment)),
        "outproj_topk[f32]": (
            lambda: tp.outproj_topk(hidden, w, b, **k3),
            lambda: tp.outproj_topk(hidden, w, b, k=BEAM,
                                    f32_single_pass=True),
            lambda: tp.outproj_topk_reference(hidden, w, b, k=BEAM),
            lambda: tp.topk_rounds(hidden @ w + b, BEAM),
            (2 * N * H * V, 4 * (N * H + H * V + V) + 8 * N * BEAM), 10,
            split, {"topk_proj_kernel": 1}, T),
        "fused_gru_attn_step[f32]": (
            lambda: fs.fused_gru_attn_step(*k4, **k4kw),
            lambda: fs.fused_gru_attn_step(*k4, emb_size=E, cuda_cores=True),
            lambda: fs.fused_gru_attn_step_reference(*k4, emb_size=E),
            lambda: fs.gru_attn_step_reference(*k4[:9], k4[9][0], k4[9][1],
                                               E),
            (k4_flops, 2 * k4_bytes), 10,
            {"attn_wh_f32": 1, "attn_scores_f32": 1, "attn_ctx_f32": 1,
             "gate_gemm_f32": 1},
            {"fused_step_kernel": 1}, T),
    }
    if pad_params is not None:
        pad_ops = decode_operands(pad_params, enc)
        early = dict(k1, early_exit=True)
        full = wd.whole_greedy_decode(*pad_ops, **k1)
        zero = torch.ones((-(-B // 8) * 8, T), dtype=torch.bool,
                          device=DEVICE)
        zero[:B] = full == 0
        zero = zero.view(-1, 8, T).all(dim=1)
        stop = torch.where(zero.any(dim=1), zero.int().argmax(dim=1) + 1, T)
        row_steps = int((stop.clamp(max=T) * 8).sum())
        cases["whole_greedy_decode[early_exit][f32]"] = (
            lambda: wd.whole_greedy_decode(*pad_ops, **early),
            lambda: wd.whole_greedy_decode(*pad_ops, cuda_cores=True,
                                           **early),
            lambda: wd.whole_greedy_decode_reference(*pad_ops, **early),
            lambda: decoding.greedy_decode(pad_params, cfg, enc, T - 1),
            decode_work(cfg, L, B, row_steps, T, elem=4), 3, {tf32: 1},
            {cores: 1}, 1)
    return cases


def k4_f32_extras(torch, tc, cfg, params, B, library, route, parts, card):
    """K4 f32 beside ``f32_times``' row: its launches' device time
    (``parts``: kernel A's W h, scores and ctx, kernel B), kernel B's grid
    and the clusters of 8 the card holds at once, the composed library
    route's device time, a call's host time, and the K4 loop
    (``greedy_decode_pallas`` at B, f32) by events and by the card's busy
    time (its idle share)."""
    from recnet_tpu_torch import decoding
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    T = tc.caption_max_len + 1
    enc = seeded_features(torch, B, tc.encoder_output_len, cfg,
                          torch.float32, 3)
    loop = lambda: decoding.greedy_decode_pallas(params, cfg, enc, T - 1)
    loop_ms, busy = timed(torch, loop)[0], device_ms(torch, loop, reps=3)[""]
    out = dict(attn_pass_ms=(parts["attn_wh_f32"] + parts["attn_scores_f32"]
                             + parts["attn_ctx_f32"]),
               attn_wh_ms=parts["attn_wh_f32"],
               attn_scores_ms=parts["attn_scores_f32"],
               attn_ctx_ms=parts["attn_ctx_f32"],
               gate_gemm_ms=parts["gate_gemm_f32"],
               library_device_ms=device_ms(torch, library)[""],
               host_ms=host_ms(torch, route), loop_ms=loop_ms,
               loop_busy_ms=busy, loop_idle_share=1 - busy / loop_ms,
               gate_blocks=fs.gate_blocks(B, cfg.hidden_size),
               gate_clusters_at_once=fs._library()
               .recnet_fused_step_tf32_clusters(fs.gate_rows(B)))
    log("times", f"fused_gru_attn_step[f32] B={B}: kernel A (attention "
                 f"pass) {out['attn_pass_ms']:.4f} ms (W h "
                 f"{out['attn_wh_ms']:.4f}, scores "
                 f"{out['attn_scores_ms']:.4f}, ctx {out['attn_ctx_ms']:.4f}), "
                 f"kernel B (gate GEMM + GRU cell) "
                 f"{out['gate_gemm_ms']:.4f} ms device ({out['gate_blocks']} "
                 f"blocks in clusters of {fs.GATE_PARTS}, "
                 f"{out['gate_clusters_at_once']} clusters at once); library "
                 f"route device {out['library_device_ms']:.4f} ms; host "
                 f"{out['host_ms']:.4f} ms a call; the K4 loop (T={T}) "
                 f"{loop_ms:.3f} ms a decode, the card busy {busy:.3f} ms "
                 f"(idle share {out['loop_idle_share']:.3f}) ({card})")
    return out


def f32_times(torch, tc, cfg, params_np, pad_np):
    """[times] of the f32 route at the eval batch (EVAL_B) and at TIME_B:
    each of ``f32_cases`` (the early exit on ``pad_np``'s PAD-timed
    weights) on its route (the TF32 body, K3's TF32 split route, K4's TF32
    route), its first design, its plain twin and its library route
    by CUDA events; the device time of the route and of the first design by the
    profiler (held to the kernels a call); the launches a decode; the bound
    (``bound_f32``) and the f32 CUDA-core peak's time beside it. K4 also:
    each of its two kernels' device time, the library route's device time,
    a call's host time, and its loop (``greedy_decode_pallas``) by events
    and by the card's busy time. Returns the kernels line's entries at
    EVAL_B, TIME_B's under "at_<TIME_B>"."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.weights import params_from_jax
    params = params_from_jax(params_np, DEVICE, torch.float32)
    pad_params = params_from_jax(pad_np, DEVICE, torch.float32)
    card = card_line()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    T = tc.caption_max_len + 1
    entries = {}
    for B in (EVAL_B, TIME_B):
        for name, (route, first, plain, library, work, reps, names, names1,
                   per_decode) in f32_cases(torch, tc, cfg, params, B,
                                            pad_params).items():
            ms, first_ms, plain_ms, library_ms = (
                timed(torch, fn, reps)[0]
                for fn in (route, first, plain, library))
            parts = device_ms(torch, route, tuple(names), launches=names)
            dev = sum(parts.values())
            dev1 = sum(device_ms(torch, first, tuple(names1),
                                 launches=names1).values())
            bound_ms, bound_by = bound_f32(*work)
            e = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bound_by=bound_by, device_ms=dev,
                     first_design_ms=first_ms, first_design_device_ms=dev1,
                     f32_core_bound_ms=work[0] / PEAK_F32_FLOPS * 1e3,
                     launches_a_decode=per_decode,
                     shape=(f"N={B * BEAM} k={BEAM}" if "topk" in name
                            else f"B={B}"))
            if "whole" in name:
                e["cluster"] = wd.cluster_size(B, cfg.hidden_size, n_sms)
            if name == "fused_gru_attn_step[f32]":
                e.update(k4_f32_extras(torch, tc, cfg, params, B, library,
                                       route, parts, card))
            if name == "whole_greedy_decode[f32]" and B == EVAL_B:
                # K1 at each cluster size the body takes (the spread's gain)
                ops = decode_operands(params, seeded_features(
                    torch, B, tc.encoder_output_len, cfg, torch.float32, 3))
                kw = dict(emb_size=cfg.embedding_size, max_len=T - 1,
                          cell_type=cfg.cell_type)
                e["cluster_ms"] = {
                    c: timed(torch, lambda: wd.whole_greedy_decode(
                        *ops, cluster=c, **kw))[0] for c in (1, 2, 4, 8)}
                log("times", f"{name} B={B} f32 by cluster size: "
                             + ", ".join(f"C={c} {t:.4f} ms" for c, t in
                                         e["cluster_ms"].items())
                             + f" ({card})")
            log("times", f"{name} {e['shape']} f32: route {ms:.4f} ms "
                         f"(device {dev:.4f}), first design {first_ms:.4f} "
                         f"ms (device {dev1:.4f}), plain twin "
                         f"{plain_ms:.4f} ms, library route "
                         f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({bound_by}; at the f32 CUDA-core peak "
                         f"{e['f32_core_bound_ms']:.4f}), share "
                         f"{bound_ms / ms:.3f}, {per_decode} launches a "
                         f"decode" + (f", cluster {e['cluster']}"
                                      if "cluster" in e else "")
                         + f" ({card})")
            if B == EVAL_B:
                entries[name] = e
            else:
                entries[name][f"at_{B}"] = e
    return entries


# --------------------------------------------------------------------------
# 6. the ablation sweep of K1
# --------------------------------------------------------------------------

def ablate_sweep(torch, tc, cfg, params_np):
    """The profiling sweep of benchmarks/profile_whole_decode.py on the
    card, K1 at B = TIME_B bf16 through the ops-level wrapper, on each
    body: the tensor-core body (its production step, each ablated part,
    dual), then the CUDA-core body (the same set under ``cuda_cores``).
    Every variant is launched once with the counts from 0; then each
    body's set is timed, its production step first and last, and each
    part's cost printed as full - variant: on the tensor-core body, the
    phase split of the production K1. Each ablated part's tokens are held
    against its twin's (BF16_TOKENS of tokens equal), dual's against its
    body's production step's (all equal). The tensor-core dual is also
    timed at B = DUAL_BIG_B beside production K1, in turns (K1, dual, dual,
    K1), its tokens equal. Returns (launches by variant, {variant: (ms,
    twin ms)} of the ablated parts, {variant: max |token - twin token|}),
    keyed as ``variant_launches``."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.weights import params_from_jax
    T, L, dtype = tc.caption_max_len + 1, tc.encoder_output_len, torch.bfloat16
    params = params_from_jax(params_np, DEVICE, dtype)
    ops = decode_operands(params, seeded_features(torch, TIME_B, L, cfg,
                                                  dtype, 3))
    kw = dict(emb_size=cfg.embedding_size, max_len=T - 1,
              cell_type=cfg.cell_type)
    run = lambda vkw, o=ops: wd.whole_greedy_decode(*o, **vkw, **kw)
    # each body: (the suffix of its variants' names, [(name, options)]),
    # its production step first
    sweeps = {}
    for body, suffix, base, bkw in (
            ("tensor-core", "", "", {}),
            ("CUDA-core", "[cuda_cores]", "cuda_cores", {"cuda_cores": True})):
        sweeps[body] = (suffix, [(base, bkw)]
                        + [(f"ablate={p}{suffix}", dict(bkw, ablate=p))
                           for p in ABLATE_PARTS]
                        + [(f"dual{suffix}", dict(bkw, dual=True))])
    reset_counts()
    tokens = {name: run(vkw) for _, sweep in sweeps.values()
              for name, vkw in sweep}
    torch.cuda.synchronize()
    launches = dict(wd.whole_greedy_decode.variant_launches)
    log("ablate", f"sweep launches: {launches}, production K1 on the "
                  f"tensor-core body {wd.whole_greedy_decode.n_launches}")
    check(wd.whole_greedy_decode.n_launches == 1
          and all(launches.get(name) == 1 for _, sweep in sweeps.values()
                  for name, _ in sweep if name),
          "the ablation sweep missed a variant")
    twins = {p: wd.whole_greedy_decode_reference(*ops, ablate=p, **kw)
             for p in ABLATE_PARTS}
    # the CUDA-core production step (the tensor-core one is held in
    # [kernels]) against the production twin
    production = wd.whole_greedy_decode_reference(*ops, **kw)
    equal = (tokens["cuda_cores"] == production).float().mean().item()
    errs = {"cuda_cores": float((tokens["cuda_cores"] - production)
                                .abs().max())}
    log("ablate", f"cuda_cores: tokens equal to the twin's {equal:.4f}")
    check(equal >= BF16_TOKENS, f"cuda_cores bf16 B={TIME_B}: tokens equal "
                                f"{equal}")
    twin_ms = {p: timed(torch, lambda p=p: wd.whole_greedy_decode_reference(
        *ops, ablate=p, **kw))[0] for p in ABLATE_PARTS}
    card = card_line()
    out = {}
    for body, (suffix, sweep) in sweeps.items():
        ms = {name: timed(torch, lambda vkw=vkw: run(vkw))[0]
              for name, vkw in sweep}
        base, bkw = sweep[0]
        full = (ms[base] + timed(torch, lambda: run(bkw))[0]) / 2
        log("ablate", f"K1's production step on the {body} body B={TIME_B} "
                      f"bf16: {full:.3f} ms (mean of the first and last "
                      f"timing) on {card}")
        for name, vkw in sweep[1:]:
            part = vkw.get("ablate")
            want = twins[part] if part else tokens[base]
            equal = (tokens[name] == want).float().mean().item()
            errs[name] = float((tokens[name] - want).abs().max())
            cost = full - ms[name]
            log("ablate", f"{name}: {ms[name]:.3f} ms; full - variant "
                          f"{cost:.3f} ms ({100 * cost / full:.1f}% of the "
                          f"step); tokens equal to "
                          f"{'its twin' if part else 'production'}'s "
                          f"{equal:.4f}")
            check(equal >= (BF16_TOKENS if part else 1.0),
                  f"{name} bf16 B={TIME_B}: tokens equal {equal}")
            if part:
                out[name] = (ms[name], twin_ms[part])
        split = {p: full - ms[f"ablate={p}{suffix}"]
                 for p in ("emb", "attn", "proj")}
        rest = full - sum(split.values())
        log("ablate", f"phase split of the {body} body: embedding gather "
                      f"{split['emb']:.3f} ms, attention (W h, scores, enc "
                      f"reads) {split['attn']:.3f} ms, projection and argmax "
                      f"{split['proj']:.3f} ms, the rest (gates, cell, "
                      f"barriers) {rest:.3f} ms of {full:.3f} ms"
                      + (" (the parts add to more than the whole: phases "
                         "overlap)" if rest < 0 else ""))
    # dual's grid fills the card at DUAL_BIG_B; production K1 takes two
    # waves there
    big = decode_operands(params, seeded_features(torch, DUAL_BIG_B, L, cfg,
                                                  dtype, 4))
    k1, dual = run({}, big), run({"dual": True}, big)
    torch.cuda.synchronize()
    check(torch.equal(k1, dual), f"dual B={DUAL_BIG_B} differs from K1")
    turns = [timed(torch, lambda vkw=vkw: run(vkw, big))[0]
             for vkw in ({}, {"dual": True}, {"dual": True}, {})]
    log("ablate", f"B={DUAL_BIG_B} bf16, tensor-core body, in turns: K1 "
                  f"{turns[0]:.3f} ms, dual {turns[1]:.3f} ms, dual "
                  f"{turns[2]:.3f} ms, K1 {turns[3]:.3f} ms; dual tokens "
                  f"equal to K1's on every row ({card})")
    return launches, out, errs


def ablate_sweep_f32(torch, tc, cfg, params_np):
    """The sweep of ``ablate_sweep`` in f32 on the TF32 body (the
    flagship's dtype), at the eval batch (EVAL_B, clusters of 8) and at
    TIME_B, from ``margin_params`` (the same work; clear top-2 margins for
    the checks). Each batch: every variant launched once with the counts
    from 0; each part's tokens against the twin with the body's three-term
    products (F32_ROWS of rows), ``nativeargmax`` and ``dual`` against
    production's (all equal); then production timed first and last, each
    part and ``dual`` between, by CUDA events and by device time
    (torch.profiler), each part's cost as full - variant and the phase
    split; the first design's ``dual`` and parts (``cuda_cores``) once
    each, by events and device time. ``dual`` against K1 in turns (K1,
    dual, dual, K1) at TIME_B and DUAL_BIG_B, tokens equal. Returns
    (launches by variant, {kernels-line name: entry at EVAL_B with TIME_B's
    under "at_<TIME_B>"}, {variant: max |token - twin token|})."""
    from recnet_tpu_torch import decoding
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    T, L, f32 = tc.caption_max_len + 1, tc.encoder_output_len, torch.float32
    params = margin_params(cfg, f32, L)
    kw = dict(emb_size=cfg.embedding_size, max_len=T - 1,
              cell_type=cfg.cell_type)
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = card_line()
    kernel = {"tf32_decode_kernel": 1}
    first = {"whole_decode_kernel": 1}
    sweep = ([("", {})] + [(f"ablate={p}[tf32]", {"ablate": p})
                           for p in ABLATE_PARTS]
             + [("dual[tf32]", {"dual": True})])
    launches, errs, entries = collections.Counter(), {}, {}
    for B in (EVAL_B, TIME_B):
        ops = decode_operands(params, seeded_features(torch, B, L, cfg, f32,
                                                      3))
        run = lambda vkw, o=ops: wd.whole_greedy_decode(*o, **vkw, **kw)
        reset_counts()
        tokens = {name: run(vkw) for name, vkw in sweep}
        torch.cuda.synchronize()
        counted = dict(wd.whole_greedy_decode.variant_launches)
        check(wd.whole_greedy_decode.n_launches == 1
              and wd.whole_greedy_decode.body_launches["tf32"] == len(sweep)
              and all(counted.get(name) == 1 for name, _ in sweep[1:]),
              f"the f32 sweep at B={B} missed a variant: {counted}")
        launches.update(counted)
        z = torch.zeros((B, cfg.hidden_size), dtype=f32, device=DEVICE)
        sos = torch.full((B, 1), cfg.sos_token, dtype=torch.int32,
                         device=DEVICE)
        twin3 = lambda part: wd._decode_reference(
            *ops, z, z, sos, emb_size=cfg.embedding_size, n_steps=T,
            cell_type=cfg.cell_type, emb_scale=1.0, ablate=part,
            matmul=wd.matmul_3xtf32_reference)[0]
        for name, vkw in sweep[1:]:
            part = vkw.get("ablate")
            want = twin3(part) if part else tokens[""]
            rows = (tokens[name] == want).all(dim=1).double().mean().item()
            errs[name] = max(errs.get(name, 0.0),
                             float((tokens[name] - want).abs().max()))
            check(rows >= (F32_ROWS if part else 1.0),
                  f"{name} f32 B={B}: rows equal {rows}")
            if part == "nativeargmax":
                check(torch.equal(tokens[name], tokens[""]),
                      f"{name} f32 B={B} differs from production")
        ms = {"": timed(torch, lambda: run({}))[0]}
        dev = {"": device_ms(torch, lambda: run({}), tuple(kernel),
                             launches=kernel)["tf32_decode_kernel"]}
        for name, vkw in sweep[1:]:
            ms[name] = timed(torch, lambda vkw=vkw: run(vkw))[0]
            dev[name] = device_ms(torch, lambda vkw=vkw: run(vkw),
                                  tuple(kernel),
                                  launches=kernel)["tf32_decode_kernel"]
        full = (ms[""] + timed(torch, lambda: run({}))[0]) / 2
        full_dev = (dev[""] + device_ms(
            torch, lambda: run({}), tuple(kernel),
            launches=kernel)["tf32_decode_kernel"]) / 2
        C, C2 = (wd.cluster_size(B, cfg.hidden_size, n_sms, r)
                 for r in (8, 16))
        log("ablate", f"K1's production step on the TF32 body B={B} f32 "
                      f"(cluster {C}): {full:.3f} ms, device {full_dev:.3f} "
                      f"ms (means of the first and last timing) on {card}")
        library_ms = timed(torch, lambda: decoding.greedy_decode(
            params, cfg, ops[1], T - 1))[0]
        for name, vkw in sweep[1:]:
            part = vkw.get("ablate", "")
            cost, cost_dev = full - ms[name], full_dev - dev[name]
            plain_ms = timed(torch, lambda vkw=vkw: (
                wd.whole_greedy_decode_reference(*ops, **vkw, **kw)))[0]
            cores = dict(vkw, cuda_cores=True)
            first_ms = timed(torch, lambda cores=cores: run(cores))[0]
            first_dev = device_ms(torch, lambda cores=cores: run(cores),
                                  tuple(first),
                                  launches=first)["whole_decode_kernel"]
            bound_ms, bound_by = bound_f32(*decode_work(
                cfg, L, B, B * T, T, ablate=part, elem=4))
            e = dict(ms=ms[name], device_ms=dev[name], plain_ms=plain_ms,
                     library_ms=None if part else library_ms,
                     bound_ms=bound_ms, bound_by=bound_by,
                     full_minus_variant_ms=cost,
                     full_minus_variant_device_ms=cost_dev,
                     first_design_ms=first_ms,
                     first_design_device_ms=first_dev,
                     cluster=C if part else C2, shape=f"B={B}")
            log("ablate", f"{name} f32 B={B}: {ms[name]:.3f} ms (device "
                          f"{dev[name]:.3f}); full - variant {cost:.3f} ms "
                          f"(device {cost_dev:.3f}, "
                          f"{100 * cost_dev / full_dev:.1f}% of the step); "
                          f"first design (cuda_cores) {first_ms:.3f} ms "
                          f"(device {first_dev:.3f}); plain twin "
                          f"{plain_ms:.3f} ms; "
                          + (f"library route (greedy_decode) "
                             f"{library_ms:.3f} ms; " if not part else "")
                          + f"bound {bound_ms:.4f} ms ({bound_by}); cluster "
                          f"{e['cluster']}; tokens equal to "
                          f"{'the three-term twin' if part else 'K1'}'s")
            key = f"whole_greedy_decode[{name}]"
            if B == EVAL_B:
                entries[key] = e
            else:
                entries[key][f"at_{B}"] = e
        split = {p: (full - ms[f"ablate={p}[tf32]"],
                     full_dev - dev[f"ablate={p}[tf32]"])
                 for p in ("emb", "attn", "proj")}
        rest = (full - sum(v[0] for v in split.values()),
                full_dev - sum(v[1] for v in split.values()))
        log("ablate", f"phase split of the TF32 body B={B} f32 (cluster "
                      f"{C}), events (device): embedding gather "
                      f"{split['emb'][0]:.3f} ({split['emb'][1]:.3f}) ms, "
                      f"attention (W h, scores, enc reads, ctx exchange) "
                      f"{split['attn'][0]:.3f} ({split['attn'][1]:.3f}) ms, "
                      f"projection and argmax {split['proj'][0]:.3f} "
                      f"({split['proj'][1]:.3f}) ms, the rest (gates, cell, "
                      f"barriers) {rest[0]:.3f} ({rest[1]:.3f}) ms of "
                      f"{full:.3f} ({full_dev:.3f}) ms ({card})")
    # dual against K1 in turns: one wave of 16-row tiles at DUAL_BIG_B
    # where K1 needs two
    for B in (TIME_B, DUAL_BIG_B):
        ops = decode_operands(params, seeded_features(torch, B, L, cfg, f32,
                                                      4))
        run = lambda vkw, o=ops: wd.whole_greedy_decode(*o, **vkw, **kw)
        k1, dual = run({}), run({"dual": True})
        torch.cuda.synchronize()
        check(torch.equal(k1, dual), f"dual f32 B={B} differs from K1")
        turns = [timed(torch, lambda vkw=vkw: run(vkw))[0]
                 for vkw in ({}, {"dual": True}, {"dual": True}, {})]
        C, C2 = (wd.cluster_size(B, cfg.hidden_size, n_sms, r)
                 for r in (8, 16))
        log("ablate", f"B={B} f32, TF32 body, in turns: K1 {turns[0]:.3f} "
                      f"ms (cluster {C}), dual {turns[1]:.3f} ms, dual "
                      f"{turns[2]:.3f} ms (cluster {C2}), K1 "
                      f"{turns[3]:.3f} ms; dual tokens equal to K1's on "
                      f"every row ({card})")
        entries["whole_greedy_decode[dual[tf32]]"][f"turns_{B}"] = dict(
            k1_ms=(turns[0], turns[3]), dual_ms=(turns[1], turns[2]))
    return dict(launches), entries, errs


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
    The launch counts are set to 0 just before the card's steps and read
    just after them, with CARD_BF16_STEPS bf16 card steps (finite losses)
    after the f32 ones and one f32 step with an LSTM decoder (the per-step
    LSTM cells: the flagship's decoder is GRU) between them: the rollouts'
    kernels of the train step in both precisions, the embedding
    backward's (one a step in both, checked) and the TF32 GEMM's (more
    than none in the f32 steps, none in the bf16 ones: autocast keeps
    torch's products; checked). The reconstructor's
    whole-rollout kernels are counted by precision: "cell_rollout_<kind>
    [<cell>]" in the bf16 steps, and "...[f32]" in the f32 steps: the
    flagship's reconstructor width is one that ``ops.rnn.whole_rollout``
    runs whole (``whole_rollout_kernels`` checks the rule on the card).
    Returns {rollout kernel name: launches}."""
    from recnet_tpu_torch.checkpoint import state_leaves
    from recnet_tpu_torch.ops.cuda import embedding, gemm
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
        reset_counts()
        t0 = time.perf_counter()
        ms = [step(state, v, c) for _ in range(CARD_CPU_STEPS)]
        seconds = time.perf_counter() - t0
        if device == DEVICE:
            # an f32 step with an LSTM decoder: the per-step LSTM cells,
            # which the flagship's steps no longer launch (its decoder is
            # GRU, and its reconstructor's rollout runs whole)
            ltc = tc.replace(decoder_model="LSTM")
            lstate, ldcfg, lrcfg = S.init_train_state(
                SEED, ltc, corpus.vocab.n_vocabs, device)
            lstm_loss = float(S.build_train_step(ltc, ldcfg, lrcfg)(
                lstate, v, c)["loss"])
            del lstate
            torch.cuda.synchronize()
            f32_whole = {f"{k}[f32]": n for k, n in rollout_launches(
                (), tc.reconstructor_model).items()
                if k.startswith("cell_rollout")}
            f32_embedding = embedding.embedding_backward.n_launches
            f32_gemm = gemm.launch.n_launches
            btc = tc.replace(train_precision="bfloat16")
            bstate, bdcfg, brcfg = S.init_train_state(
                SEED, btc, corpus.vocab.n_vocabs, device)
            bstep = S.build_train_step(btc, bdcfg, brcfg)
            bf16 = [float(bstep(bstate, v, c)["loss"])
                    for _ in range(CARD_BF16_STEPS)]
            torch.cuda.synchronize()
            launches = rollout_launches((tc.decoder_model,
                                         tc.reconstructor_model),
                                        tc.reconstructor_model)
            for name, n in f32_whole.items():
                launches[name[:-len("[f32]")]] -= n     # the bf16 steps'
            launches.update(f32_whole)
            # the gather's backward: one a step in both precisions (the
            # table an f32 master under autocast), teacher forcing always on
            launches["embedding_backward"] = (
                embedding.embedding_backward.n_launches)
            steps = {"f32": CARD_CPU_STEPS + 1, "bf16": CARD_BF16_STEPS}
            emb = {"f32": f32_embedding,
                   "bf16": launches["embedding_backward"] - f32_embedding}
            check(tc.decoder_teacher_forcing_ratio >= 1.0 and emb == steps,
                  f"embedding backward launches {emb} in the card's "
                  f"{steps} train steps: one a step expected")
            # the f32 steps' matrix products on the TF32 GEMM, none of the
            # bf16 steps' (autocast's products stay torch's)
            launches["gemm_tf32x3"] = gemm.launch.n_launches
            products = {"f32": f32_gemm,
                        "bf16": gemm.launch.n_launches - f32_gemm}
            check(products["f32"] > 0 and products["bf16"] == 0,
                  f"TF32 GEMM launches {products} in the card's {steps} "
                  f"train steps: some in f32, none in bf16 expected")
            del bstate, bstep
            check(np.isfinite(bf16).all(), f"bf16 card steps: loss {bf16}")
            check(np.isfinite(lstm_loss), f"the LSTM decoder's f32 step: "
                                          f"loss {lstm_loss}")
        runs[device] = dict(
            losses=[(float(m["loss"]), float(m["grad_norm"])) for m in ms],
            sums=checksums(state_leaves(state)),
            seconds=seconds)
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
    log("train", f"(a) bf16 card steps from the same init: loss "
                 f"{', '.join(f'{x:.5f}' for x in bf16)}")
    log("train", f"(a) the rollouts' kernels launched in the "
                 f"{CARD_CPU_STEPS} f32 steps, an f32 step with an LSTM "
                 f"decoder (loss {lstm_loss:.5f}) and {CARD_BF16_STEPS} "
                 f"bf16 card steps (\"[f32]\": the f32 steps'): {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} never launched in the card's train steps")
    return launches


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
        counts, times = profiled(torch, run)
        n_kernels = sum(counts.values())
        busy = sum(times.values()) / 1000 / k
        check(busy > 0, "the profiler saw no device time")
        med = float(np.median(per_step))
        flops, nbytes = train_work(ptc, dcfg, rcfg, B)
        peak = PEAK_BF16_FLOPS if prec == "bfloat16" else peak_f32
        t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        out[prec] = dict(ms=med, steps_s=1000 / med, busy_ms=busy,
                         idle=1 - busy / med, kernels=n_kernels / k,
                         bound_ms=bound_ms, peak_gib=mem)
        log("train", f"(c) {prec}, B={B}, k={k}: "
                     f"{', '.join(f'{x:.3f}' for x in per_step)} ms a step "
                     f"by CUDA events (median {med:.3f} ms, "
                     f"{1000 / med:.2f} steps/s); the card busy "
                     f"{busy:.3f} ms a step ({n_kernels / k:.0f} device "
                     f"activities a step; idle share {1 - busy / med:.3f}); "
                     f"peak memory {mem:.2f} GiB; bound {bound_ms:.3f} ms "
                     f"({'operations' if t_ops >= t_bytes else 'bytes'}: "
                     f"{flops / 1e9:.1f} GFLOP at {peak / 1e12:.1f} "
                     f"TFLOP/s, {nbytes / 1e6:.0f} MB at "
                     f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) on {card}")
        del state, fn
    return out


def device_activities(torch, fn) -> collections.Counter:
    """The activities on the card (kernels, copies, fills) of one call of
    ``fn`` by name, by torch.profiler (``profiled``), after a warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    return profiled(torch, fn)[0]


def loop_activities(torch, tc, corpus):
    """The f32 train step's two loops over T, split by the profiler: the
    decoder rollout (``teacher_forced_rollout_fast``) and the global
    reconstructor, each forward + backward on one [train] batch at T and
    at T - SPLIT_STEPS steps. A loop step's activities are the difference
    over SPLIT_STEPS (what does not repeat with T cancels). Returns
    {loop: (activities a loop step, activities of the call at T, {name:
    activities a loop step})}."""
    from recnet_tpu_torch.models import decoder as dec_mod
    from recnet_tpu_torch.models import reconstructors as rec_mod
    from recnet_tpu_torch.training import step as S
    tc = tc.replace(train_precision="float32")
    state, dcfg, rcfg = S.init_train_state(SEED, tc, corpus.vocab.n_vocabs,
                                           DEVICE)
    _, videos, captions = next(iter(corpus.train_batcher))
    videos = corpus.train_dataset.feature_cache()[videos] if \
        corpus.train_batcher.index_mode else videos
    enc = torch.from_numpy(videos).to(DEVICE)
    caps = torch.from_numpy(captions).to(DEVICE)
    T = caps.shape[0]
    hid = torch.randn((T, 1, enc.shape[0], dcfg.hidden_size),
                      device=DEVICE, requires_grad=True)

    def decoder(n):
        out = dec_mod.teacher_forced_rollout_fast(state.dec_params, dcfg,
                                                  enc, caps[:n])
        (out.logits.sum() + out.hiddens.sum()).backward()

    def reconstructor(n):
        ones = torch.ones((n,), device=DEVICE)
        rec_mod.global_reconstruct(state.rec_params, rcfg, hid[:n], ones,
                                   ones.sum()).sum().backward()

    split = {}
    for name, fn in (("decoder", decoder), ("reconstructor", reconstructor)):
        full = device_activities(torch, lambda: fn(T))
        cut = device_activities(torch, lambda: fn(T - SPLIT_STEPS))
        split[name] = ((sum(full.values()) - sum(cut.values()))
                       / SPLIT_STEPS, sum(full.values()),
                       per_step(full, cut))
    return split


def per_step(full, cut):
    """{short activity name: (count at T - count at T - SPLIT_STEPS) /
    SPLIT_STEPS} over the names whose counts differ; a name is cut at its
    argument list and at 48 characters, and the counts of names that meet
    there are summed."""
    short = collections.Counter()
    for name in full | cut:
        short[name.split("(")[0][:48]] += full[name] - cut[name]
    return {k: v / SPLIT_STEPS for k, v in short.items() if v}


def train_timing(torch):
    """{"steps": (c)'s numbers by precision, "loops": the f32 split} of
    the imported package."""
    from recnet_tpu_torch.checkpoint import load_config_and_vocab
    with tempfile.TemporaryDirectory() as tmp:
        tc, vocab = load_config_and_vocab(
            str(flagship_checkpoint_dir(Path(tmp), VOCAB)))
    ttc = train_config(tc)
    corpus = train_corpus(ttc, vocab)
    return {"steps": train_times(torch, ttc, corpus),
            "loops": loop_activities(torch, ttc, corpus),
            "reconstructor_rollout": reconstructor_rollout_ms(torch, ttc)}


def reconstructor_rollout_ms(torch, tc):
    """The reconstructor's rollout, forward + backward at the flagship's
    shapes, through ``ops.rnn.rnn_rollout_pre`` (the route the package
    takes) and through the plain autograd loop, f32 and bf16 autocast:
    {prec: {"kernels": [ms], "plain": [ms], "kernels_device": ms}} (CUDA
    events in turns kernels, plain, plain, kernels; device time by the
    profiler). Uses only what every tree of the port has."""
    import functools as ft
    from recnet_tpu_torch.ops import rnn as rnn_ops
    T, B = tc.caption_max_len + 1, tc.batch_size
    H, cell = tc.reconstructor_hidden_size, tc.reconstructor_model
    G = (4 if cell == "LSTM" else 3) * H
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 70)

    def leaf(*shape):
        return (torch.randn(shape, generator=g, device=DEVICE) * 0.1
                ).requires_grad_()

    r = dict(w_hh=leaf(H, G), b_hh=leaf(G), gi=leaf(T, B, G))
    zeros = torch.zeros((B, H), device=DEVICE)
    dhs = torch.randn((T, B, H), generator=g, device=DEVICE)

    def run(fn, dtype):
        with torch.autocast("cuda", dtype=dtype, enabled=dtype is not None):
            hs = fn(cell, r, r["gi"], zeros, zeros)
        hs.backward(dhs.to(hs.dtype))

    out = {}
    for prec, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        routes = {"kernels": ft.partial(run, rnn_ops.rnn_rollout_pre, dtype),
                  "plain": ft.partial(run, rnn_ops.rnn_rollout_pre_reference,
                                      dtype)}
        ms = {"kernels": [], "plain": []}
        for route in ("kernels", "plain", "plain", "kernels"):
            ms[route].append(timed(torch, routes[route])[0])
        ms["kernels_device"] = device_ms(torch, routes["kernels"], reps=3)[""]
        out[prec] = ms
    return out


def rollout_launches(cells, whole):
    """The rollouts' wrappers' counts, by kernel entry name: the per-step
    cell kernels by cell type (``cells``), the whole-rollout ones by the
    reconstructor's (``whole``)."""
    from recnet_tpu_torch.ops.cuda import rollout as ro
    out = {}
    for name, fn in (("rollout_cell_forward", ro.cell_forward),
                     ("rollout_cell_backward", ro.cell_backward)):
        for cell in cells:
            out[f"{name}[{cell}]"] = fn.cell_launches[cell]
    out["rollout_attention_forward"] = ro.attention_forward.n_launches
    out["rollout_attention_backward"] = ro.attention_backward.n_launches
    for name, fn in (("cell_rollout_forward", ro.cell_rollout_forward),
                     ("cell_rollout_backward", ro.cell_rollout_backward)):
        out[f"{name}[{whole}]"] = fn.cell_launches[whole]
    return out


def sweep_steps(torch, nbytes):
    """Steps of a cell sweep whose per-step operands of ``nbytes`` bytes
    come to SWEEP_L2 times the card's L2 (at least a rollout's T = 31):
    each step's operands are then out of L2 when the sweep comes back to
    them, so they come from device memory as the HBM bound counts them."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(31, -(-SWEEP_L2 * l2 // nbytes))


def rollout_cases(torch, tc, dtype, seed=0, sweeps=False):
    """The rollouts' kernels at the flagship's shapes (the batch; the
    decoder's cell and attention over the encoder's frames, the
    reconstructor's cell), on inputs in ``dtype`` from ``seed``: {entry name:
    (kernel call, plain call, library call or None, (flops, bytes), a call
    of the kernel's ``*_steps`` launcher or None, its steps)}. Each call
    but the launcher's returns its outputs. With ``sweeps`` the launcher
    call is a sweep: the cells' launchers run every step of their own
    per-step operands (``sweep_steps``: the operands a step reads and
    writes lie apart, as a rollout's (T, B, .) buffers, and are out of L2
    when the sweep comes to them; the state a step reads is the one the
    step before wrote, as in a rollout); the attention's one step, whose
    enc and uv a rollout reads at every step from L2."""
    from recnet_tpu_torch.ops.cuda import rollout as ro
    B, F, E = tc.batch_size, tc.encoder_output_len, tc.encoder_output_size
    Hd, A = tc.decoder_hidden_size, tc.decoder_attn_size
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 60 + 100 * seed)
    size = torch.finfo(dtype).bits // 8

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=DEVICE)
                * scale).to(dtype)

    aten = torch.ops.aten
    cases = {}

    def cell_cases(cell, H):
        lstm, G = cell == "LSTM", (4 if cell == "LSTM" else 3) * H
        gx, gh, bias = rand(B, G, scale=1.5), rand(B, G, scale=1.5), rand(G)
        h, c, dh, dh_out, dc = (rand(B, H) for _ in range(5))
        fwd = (cell, gx, None if lstm else gh, bias, h, c if lstm else None)
        _, c_t, acts = ro.cell_forward_reference(*fwd)
        bwd = (cell, dh, dh_out, dc if lstm else None, acts, h,
               c if lstm else None, c_t if lstm else None)
        zb = torch.zeros_like(bias)
        if lstm:        # ATen's fused cell: gates = gx + 0 + (0 + b_hh)
            zero = torch.zeros_like(gx)
            lib_f = lambda: aten._thnn_fused_lstm_cell(gx, zero, c, zb, bias)
            ws = lib_f()[2]
            lib_b = lambda: aten._thnn_fused_lstm_cell_backward_impl(
                dh, dc, c, c_t, ws, False)
        else:
            lib_f = lambda: aten._thnn_fused_gru_cell(gx, gh, h, zb, bias)
            ws = lib_f()[1]
            lib_b = lambda: aten._thnn_fused_gru_cell_backward(dh, ws,
                                                               False)
        bh = B * H
        # bytes: LSTM gx, b_hh, c_prev in, acts, h', c' out; GRU gx, gh,
        # b_hh, h_prev in, acts, h' out
        io_f = (bh * (1 + 4 + 2) + B * G + G if lstm
                else bh * (1 + 4 + 1) + 2 * B * G + G)
        io_b = (bh * (3 + 4 + 2 + 1) + B * G if lstm
                else bh * (3 + 4 + 1) + 2 * B * G)
        fwd_sweep = bwd_sweep = None
        n_f = n_b = 1
        if sweeps:
            # every step of each launcher over its own (N, B, .) buffers
            n_f = sweep_steps(torch, size * io_f)
            maybe = lambda x, n, *shape: rand(n, *shape) if x else None
            fwd_step = ro.cell_forward_steps(
                cell, rand(n_f, B, G, scale=1.5),
                maybe(not lstm, n_f, B, G), bias, h, c if lstm else None,
                rand(n_f, B, H), maybe(lstm, n_f, B, H), rand(n_f, B, 4 * H))
            fwd_sweep = lambda: [fwd_step(t) for t in range(n_f)]
            n_b = sweep_steps(torch, size * io_b)
            bwd_step = ro.cell_backward_steps(
                cell, dh.clone(), rand(n_b, B, H), dc.clone() if lstm
                else None, rand(n_b, B, 4 * H), maybe(not lstm, n_b, B, H),
                maybe(lstm, n_b, B, H), maybe(lstm, n_b, B, H),
                rand(n_b, B, G), rand(n_b, B, G))
            bwd_sweep = lambda: [bwd_step(t) for t in range(n_b - 1, -1, -1)]
        cases[f"rollout_cell_forward[{cell}]"] = (
            lambda: ro.cell_forward(*fwd),
            lambda: ro.cell_forward_reference(*fwd), lib_f,
            (10 * B * G, size * io_f), fwd_sweep, n_f)
        cases[f"rollout_cell_backward[{cell}]"] = (
            lambda: ro.cell_backward(*bwd),
            lambda: ro.cell_backward_reference(*bwd), lib_b,
            (12 * B * G, size * io_b), bwd_sweep, n_b)

    for cell, H in ((tc.decoder_model, Hd),
                    (tc.reconstructor_model, tc.reconstructor_hidden_size)):
        cell_cases(cell, H)
    # the attention's operands as the decoder rollout lays them out: wh
    # and dwh beside the gate products' G columns (the GRU's h [w_hh | W])
    Gd = (4 if tc.decoder_model == "LSTM" else 3) * Hd
    gw, uv, b, w, enc = (rand(B, Gd + A), rand(B, F, A), rand(A),
                         rand(A, 1), rand(B, F, E))
    wh, dctx, dgw = gw[:, Gd:], rand(B, E), rand(B, Gd + A)
    act = torch.tanh(rand(B, F, A, scale=1.0))
    fwd_step = ro.attention_forward_steps(wh[None], uv, b, w, enc,
                                          rand(1, B, F), rand(1, B, E))
    bwd_step = ro.attention_backward_steps(dctx[None], enc, act[None], w,
                                           rand(1, B, F), dgw[None, :, Gd:])
    fwd_one = (lambda: fwd_step(0)) if sweeps else None
    bwd_one = (lambda: bwd_step(0)) if sweeps else None
    # bytes: what each kernel reads and writes (W's reads now in the
    # products that carry wh and dwh W^T)
    cases["rollout_attention_forward"] = (
        lambda: ro.attention_forward(wh, uv, b, w, enc),
        lambda: ro.attention_forward_reference(wh, uv, b, w, enc), None,
        (6 * B * F * A + 2 * B * F * E,
         size * (B * A + B * F * A + 2 * A + B * F * E + B * F + B * E)),
        fwd_one, 1)
    cases["rollout_attention_backward"] = (
        lambda: ro.attention_backward(dctx, enc, act, w,
                                      out=(None, dgw[:, Gd:])),
        lambda: ro.attention_backward_reference(dctx, enc, act, w), None,
        (2 * B * F * E + 4 * B * F * A,
         size * (B * E + B * F * E + B * F * A + A + B * F + B * A)),
        bwd_one, 1)
    return cases


def rollout_split(torch, tc):
    """(d) The attention kernels' split at the flagship's shapes, f32 and
    bf16: the device time (torch.profiler) of the kernel and of each of
    its split probes (``rollout.attention_probe``, each without one part
    of the kernel's work) on the same seeded inputs, each probe held
    against its plain part (ROLL_TOL); a part's cost is the kernel's time
    less its probe's. Returns {kernel: {prec: {"full" or probe: device
    ms}}}."""
    from recnet_tpu_torch.ops.cuda import rollout as ro
    B, F, E = tc.batch_size, tc.encoder_output_len, tc.encoder_output_size
    A = tc.decoder_attn_size
    card = card_line()
    out = {"forward": {}, "backward": {}}
    for prec in ("float32", "bfloat16"):
        dtype = getattr(torch, prec)
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 61)
        rand = lambda *shape: (torch.randn(shape, generator=g, device=DEVICE)
                               * 0.5).to(dtype)
        wh, uv, b, w, enc, dctx = (rand(B, A), rand(B, F, A), rand(A),
                                   rand(A, 1), rand(B, F, E), rand(B, E))
        act = torch.tanh(rand(B, F, A) * 2)
        runs = {"forward": (ro.attention_forward, (wh, uv, b, w, enc),
                            ro.FORWARD_PROBES),
                "backward": (ro.attention_backward, (dctx, enc, act, w),
                             ro.BACKWARD_PROBES)}
        for kind, (kernel, operands, probes) in runs.items():
            call = lambda: kernel(*operands)
            ms = {"full": device_ms(torch, call, reps=50, launches={
                "": counted_launches(torch, call, kernel)})[""]}
            for probe in probes:
                got = ro.attention_probe(kind, probe, *operands)
                want = ro.attention_probe_reference(kind, probe, *operands)
                torch.cuda.synchronize()
                tol = ROLL_TOL[prec]
                for x, y in zip(got, want):
                    x, y = x.float(), y.float()
                    check(bool(((x - y).abs() <= tol * y.abs()
                                + tol * y.abs().max()).all()),
                          f"probe {kind} {probe} {prec}: against its plain "
                          f"part {float((x - y).abs().max()):.3g}")
                ms[probe] = device_ms(torch, lambda: ro.attention_probe(
                    kind, probe, *operands), reps=50)[""]
            out[kind][prec] = ms
            log("train", f"(d) attention {kind} split, {prec}: the kernel "
                         f"{ms['full'] * 1e3:.2f} us of device time; "
                         + ", ".join(f"without {p} {ms[p] * 1e3:.2f} us "
                                     f"(the part "
                                     f"{(ms['full'] - ms[p]) * 1e3:.2f})"
                                     for p in probes) + f" on {card}")
    return out


# the cell kernels' split: each part's kernel, by the name the profiler
# gives it (the forward, its first design, the empty kernel, the copy; the
# backward and its first design)
CELL_SPLIT_KERNELS = {"kernel": "::cell_fwd_kernel<",
                      "scalar": "::cell_fwd_scalar_kernel<",
                      "empty": "::empty_kernel(",
                      "copy": "::cell_fwd_copy_kernel<",
                      "backward": "::cell_bwd_kernel<",
                      "backward scalar": "::cell_bwd_scalar_kernel<"}


def bf16_ulps(torch, got, want):
    """The largest distance between two bf16 tensors in bf16 ulps (the bit
    patterns on one integer line)."""
    def line(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        mag = bits & 0x7FFF
        return torch.where(bits >= 0x8000, -mag, mag)
    return int((line(got) - line(want)).abs().max())


def cell_split(torch, tc):
    """(d) The cell kernels at the flagship's cells (the decoder's GRU, the
    reconstructor's LSTM), f32 and bf16: the forward and the backward held
    against their first design (the "scalar" probe) at ROLL_SEEDS seeds,
    f32 bit for bit and bf16 within 2 ulps; then the device time
    (torch.profiler) of the forward, its first design, an empty kernel at
    the first design's grid (the launch's floor) and the forward's loads
    and stores without the gates ("copy"), and of the backward and its
    first design: one session in which each part runs a sweep of per-step
    operands out of L2 (``sweep_steps``) in turn, each part read by its
    kernel's name (CELL_SPLIT_KERNELS; the kernels' own names are those of
    the whole-run route, so the flagship's operands must take it). Returns
    {entry name: {prec: {part: device ms}}}."""
    from recnet_tpu_torch.ops.cuda import rollout as ro
    B = tc.batch_size
    card = card_line()
    out = {}

    def held(name, prec, seed, got, first):
        for i, (x, y) in enumerate(zip(got, first)):
            if y is not None:
                check(torch.equal(x, y) if prec == "float32"
                      else bf16_ulps(torch, x, y) <= 2,
                      f"{name} {prec} seed {seed}: output {i} against the "
                      f"first design")

    for cell, H in ((tc.decoder_model, tc.decoder_hidden_size),
                    (tc.reconstructor_model, tc.reconstructor_hidden_size)):
        lstm, G = cell == "LSTM", (4 if cell == "LSTM" else 3) * H
        fname = f"rollout_cell_forward[{cell}]"
        bname = f"rollout_cell_backward[{cell}]"
        for prec in ("float32", "bfloat16"):
            dtype = getattr(torch, prec)
            g = None

            def rand(*shape, scale=0.5):
                return (torch.randn(shape, generator=g, device=DEVICE)
                        * scale).to(dtype)

            for seed in range(ROLL_SEEDS):
                g = torch.Generator(device=DEVICE).manual_seed(
                    SEED + 62 + 100 * seed)
                gx, gh, bias = (rand(B, G, scale=1.5), rand(B, G, scale=1.5),
                                rand(G))
                h, c, dh, dh_out, dc = (rand(B, H) for _ in range(5))
                fwd = (cell, gx, None if lstm else gh, bias, h,
                       c if lstm else None)
                got = ro.cell_forward(*fwd)
                held(fname, prec, seed, got,
                     ro.cell_forward_probe("scalar", *fwd))
                bwd = (cell, dh, dh_out, dc if lstm else None, got[2], h,
                       c if lstm else None, got[1] if lstm else None)
                dgot = ro.cell_backward(*bwd)
                held(bname, prec, seed, dgot,
                     ro.cell_backward_probe("scalar", *bwd))
                torch.cuda.synchronize()
            # each step's operands and outputs of their own, n steps: a
            # forward step reads gx[t] (gh[t]) and hs[t] or cs[t] and
            # writes h_out[t], c_out[t], a_out[t]; a backward step reads
            # the carries dh and dc, dhs[t], acts[t], hs[t] or cs[t] (and
            # hs[t] as c_t) and writes dgi[t], dgh[t], dh_cell[t] or
            # dc_prev[t]; n from the forward's bytes, the fewer
            size = torch.finfo(dtype).bits // 8
            n = sweep_steps(torch, size * B * (G + 7 * H if lstm
                                               else 2 * G + 6 * H))
            gxs, ghs = rand(n, B, G, scale=1.5), rand(n, B, G, scale=1.5)
            hs, cs, dhs, acts = (rand(n, B, H), rand(n, B, H),
                                 rand(n, B, H), rand(n, B, 4 * H))
            h_out, c_out, a_out = (torch.empty_like(hs),
                                   torch.empty_like(cs),
                                   torch.empty_like(acts))
            dgi, dgh, d_state = (torch.empty_like(gxs),
                                 torch.empty_like(ghs),
                                 torch.empty_like(hs))
            fwd_t = lambda t: (cell, gxs[t], None if lstm else ghs[t], bias,
                               hs[t], cs[t] if lstm else None)
            fout_t = lambda t: (h_out[t], c_out[t] if lstm else None,
                                a_out[t])
            bwd_t = lambda t: (cell, dh, dhs[t], dc if lstm else None,
                               acts[t], hs[t], cs[t] if lstm else None,
                               hs[t] if lstm else None)
            bout_t = lambda t: (dgi[t], None if lstm else dgh[t],
                                None if lstm else d_state[t],
                                d_state[t] if lstm else None)
            parts = [lambda t: ro.cell_forward(*fwd_t(t), out=fout_t(t))]
            parts += [functools.partial(
                lambda probe, t: ro.cell_forward_probe(
                    probe, *fwd_t(t), out=fout_t(t)), p)
                for p in ro.CELL_FORWARD_PROBES]
            parts += [lambda t: ro.cell_backward(*bwd_t(t), out=bout_t(t)),
                      lambda t: ro.cell_backward_probe(
                          "scalar", *bwd_t(t), out=bout_t(t))]

            def sweeps():
                for part in parts:
                    for t in range(n):
                        part(t)

            per_call = counted_launches(torch, sweeps, ro.cell_forward)
            check(per_call == n, f"{fname} {prec}: {per_call} launches of "
                                 f"a {n}-step sweep")
            got = device_ms(torch, sweeps, tuple(CELL_SPLIT_KERNELS.values()),
                            reps=3, launches={
                                CELL_SPLIT_KERNELS["kernel"]: per_call,
                                CELL_SPLIT_KERNELS["backward"]: per_call})
            ms = {p: got[k] / n for p, k in CELL_SPLIT_KERNELS.items()}
            bms = {"kernel": ms.pop("backward"),
                   "scalar": ms.pop("backward scalar")}
            out.setdefault(fname, {})[prec] = ms
            out.setdefault(bname, {})[prec] = bms
            log("train", f"(d) cell kernels {cell} {prec}, B={B} H={H}: "
                         f"forward and backward bit-equal (f32) / within 2 "
                         f"ulps (bf16) to their first design at seeds "
                         f"0-{ROLL_SEEDS - 1}; over a sweep of {n} steps' "
                         f"operands, whole-run route, forward device "
                         + ", ".join(f"{p} {v * 1e3:.3f} us"
                                     for p, v in ms.items())
                         + f"; backward device kernel "
                         f"{bms['kernel'] * 1e3:.3f} us, scalar "
                         f"{bms['scalar'] * 1e3:.3f} us a step on {card}")
    return out


def rollout_error(torch, name, prec, kernel, plain):
    """The largest |kernel - plain| over a rollout case's outputs; fails
    above ROLL_TOL (rtol, and atol of each output's largest |value|)."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = 0.0
    for x, y in zip(got, want):
        if y is None:
            continue
        x, y = x.float(), y.float()
        d = (x - y).abs()
        tol = ROLL_TOL[prec]
        check(bool((d <= tol * y.abs() + tol * y.abs().max()).all()),
              f"{name} {prec}: kernel and plain version differ by "
              f"{float(d.max()):.3g}")
        err = max(err, float(d.max()))
    return err


def rollout_kernels(torch, tc):
    """(d) Each of the rollouts' kernels at the flagship's shapes, f32 and
    bf16: against its plain version on the same inputs (ROLL_TOL) from
    ROLL_SEEDS seeds, then a step of its ``*_steps`` launcher (the
    rollouts' route; the cells' over a sweep of per-step operands out of
    L2, ``rollout_cases``) timed by CUDA events, by the profiler's device
    time and by the host's time to launch it, beside a wrapper call, the
    plain version, the one PyTorch call of the same function where there
    is one (ATen's fused LSTM / GRU cell and their backward) and the bound
    (bytes at the HBM rate or operations at the f32 peak). Returns {entry
    name: kernels-line fields} (``max_abs_err`` over the seeds), the times
    in the preset's train precision, bf16's beside them."""
    from recnet_tpu_torch.ops.cuda import rollout as ro
    card = card_line()
    entries = {}
    for prec in ("float32", "bfloat16"):
        margins = collections.defaultdict(list)
        for seed in range(1, ROLL_SEEDS):
            for name, case in rollout_cases(torch, tc, getattr(torch, prec),
                                            seed).items():
                margins[name].append(rollout_error(torch, name, prec,
                                                   *case[:2]))
        cases = rollout_cases(torch, tc, getattr(torch, prec), sweeps=True)
        for name, (kernel, plain, library, (flops, nbytes), sweep,
                   steps) in cases.items():
            err = rollout_error(torch, name, prec, kernel, plain)
            log("train", f"(d) {name} {prec}: max |kernel - plain| at "
                         f"seeds 0-{ROLL_SEEDS - 1}: "
                         + ", ".join(f"{e:.3g}" for e in
                                     [err] + margins[name]))
            err = max([err] + margins[name])
            reps = max(100 // steps, 3)
            ms = timed(torch, sweep, reps)[0] / steps
            wrapper_ms, plain_ms = (timed(torch, fn, 100)[0]
                                    for fn in (kernel, plain))
            lib_ms = timed(torch, library, 100)[0] if library else None
            per_call = counted_launches(torch, sweep, *ro.KERNELS)
            dev = device_ms(torch, sweep, reps=max(50 // steps, 3),
                            launches={"": per_call})[""] / steps
            host = host_ms(torch, sweep, reps=reps) / steps
            t_ops = flops / PEAK_F32_FLOPS * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            entry = entries.setdefault(name, {})
            fields = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=max(t_ops, t_bytes),
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes", max_abs_err=err, device_ms=dev,
                          host_ms=host, wrapper_ms=wrapper_ms)
            if prec == tc.train_precision:
                entry.update(fields)
            else:
                entry.update({f"{prec}_{k}": v for k, v in fields.items()})
            lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.2f}"
            log("train", f"(d) {name} {prec}: max |kernel - plain| "
                         f"{err:.3g}; a step of its launcher "
                         f"({steps} a sweep) "
                         f"{ms * 1e3:.2f} us by events (device "
                         f"{dev * 1e3:.2f} us, host {host * 1e3:.2f} us), "
                         f"a wrapper call {wrapper_ms * 1e3:.2f}, plain "
                         f"{plain_ms * 1e3:.2f}, library {lib}"
                         f", bound {fields['bound_ms'] * 1e3:.2f} us "
                         f"({fields['bound_by']}: {nbytes / 1e6:.2f} MB, "
                         f"{flops / 1e6:.1f} MFLOP) on {card}")
    return entries


def rollout_times(torch, tc):
    """(d) The two rollouts, forward + backward at the flagship's shapes
    (T = caption_max_len + 1), the kernels' route (the Functions) beside
    the plain autograd loops, in turns (kernels, plain, plain, kernels),
    f32 and bf16 autocast; the wrappers' launches a step."""
    import functools as ft
    from recnet_tpu_torch.models import decoder as dec_mod
    from recnet_tpu_torch.ops import rnn as rnn_ops
    from recnet_tpu_torch.ops.cuda import rollout as ro
    T, B = tc.caption_max_len + 1, tc.batch_size
    F, E = tc.encoder_output_len, tc.encoder_output_size
    Hd, A, Hr = (tc.decoder_hidden_size, tc.decoder_attn_size,
                 tc.reconstructor_hidden_size)
    dcell, rcell = tc.decoder_model, tc.reconstructor_model
    Gd = (4 if dcell == "LSTM" else 3) * Hd
    Gr = (4 if rcell == "LSTM" else 3) * Hr
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 70)

    def leaf(*shape):
        return (torch.randn(shape, generator=g, device=DEVICE) * 0.1
                ).requires_grad_()

    d = dict(W=leaf(Hd, A), U=leaf(E, A), b=leaf(A), w=leaf(A, 1),
             w_enc=leaf(E, Gd), w_hh=leaf(Hd, Gd), b_hh=leaf(Gd),
             enc=leaf(B, F, E), gi=leaf(T, B, Gd))
    r = dict(w_hh=leaf(Hr, Gr), b_hh=leaf(Gr), gi=leaf(T, B, Gr))
    zeros = torch.zeros((B, Hr), device=DEVICE)
    dhs_d = torch.randn((T, B, Hd), generator=g, device=DEVICE)
    dhs_r = torch.randn((T, B, Hr), generator=g, device=DEVICE)

    def decoder(fn, dtype, n=T):
        with torch.autocast("cuda", dtype=dtype, enabled=dtype is not None):
            att = {k: d[k] for k in ("W", "U", "b", "w")}
            hs = fn(dcell, att, d["w_enc"], d["w_hh"], d["b_hh"], d["enc"],
                    d["enc"] @ d["U"], d["gi"][:n])
        hs.backward(dhs_d[:n].to(hs.dtype))

    def reconstructor(fn, dtype, n=T):
        with torch.autocast("cuda", dtype=dtype, enabled=dtype is not None):
            hs = fn(rcell, r, r["gi"][:n], zeros, zeros)
        hs.backward(dhs_r[:n].to(hs.dtype))

    card = card_line()
    loops = (("decoder", decoder, dec_mod.tf_attn_rollout,
              dec_mod.tf_attn_rollout_reference),
             ("reconstructor", reconstructor, rnn_ops.rnn_rollout_pre,
              rnn_ops.rnn_rollout_pre_reference))
    for name, run, kernels, plain in loops:
        for dtype in (None, torch.bfloat16):
            routes = {"kernels": ft.partial(run, kernels, dtype),
                      "plain": ft.partial(run, plain, dtype)}
            ms = {"kernels": [], "plain": []}
            for route in ("kernels", "plain", "plain", "kernels"):
                ms[route].append(timed(torch, routes[route])[0])
            log("train", f"(d) {name} rollout forward + backward, "
                         f"{'bf16 autocast' if dtype else 'f32'}, B={B}, "
                         f"T={T}: kernels {ms['kernels']} ms, plain autograd "
                         f"loop {ms['plain']} ms (events, in turns) on "
                         f"{card}")
        # a loop step's launches: T against T - SPLIT_STEPS steps; f32, and
        # bf16 for the reconstructor. The decoder's loop runs per step; the
        # reconstructor's runs its whole-rollout kernels (none a step, one a
        # direction): ops.rnn.whole_rollout holds its width in both
        for dtype in (None,) + ((torch.bfloat16,) if name == "reconstructor"
                                else ()):
            whole_route = name == "reconstructor"
            full, cut = (loop_launches(torch, ft.partial(run, kernels, dtype,
                                                         n))
                         for n in (T, T - SPLIT_STEPS))
            kern, prod = ((a - b) / SPLIT_STEPS
                          for a, b in zip(full[:2], cut[:2]))
            whole = {k: v for k, v in full[3].items()
                     if k.startswith("cell_rollout")}
            log("train", f"(d) {name} loop, "
                         f"{'bf16 autocast' if dtype else 'f32'}: {kern:g} "
                         f"kernel launches a step (the wrappers' counts) + "
                         f"{prod:g} products (cuBLAS calls); at T = {T}: "
                         f"whole-rollout launches {whole}; device "
                         f"activities a step {per_step(full[2], cut[2])}")
            if not whole_route:
                check(kern == (4 if name == "decoder" else 2)
                      and kern + prod <= (8 if name == "decoder" else 4),
                      f"the {name} loop launches {kern} kernels and {prod} "
                      f"products a step")
            else:
                check(kern == 0 and prod == 0 and whole == {
                    "cell_rollout_forward": 1, "cell_rollout_backward": 1},
                      f"the {name} loop ({dtype or 'f32'}) launches {kern} "
                      f"kernels and {prod} products a step, {whole} a "
                      f"rollout")


def whole_rollout_operands(torch, tc, dtype, seed=0, cell=None):
    """The reconstructor's cell rollout at the flagship's shapes (T =
    caption_max_len + 1, B, its hidden width), in ``dtype`` from ``seed``:
    (cell, forward operands (gi_all, w_hh, b_hh, h0, c0 or None), dhs);
    w_hh at the init's scale, 1 / sqrt(H). ``cell``: the reconstructor's
    cell type unless given (GRU at the same width is timed beside it)."""
    cell = cell or tc.reconstructor_model
    H = tc.reconstructor_hidden_size
    T, B, n = tc.caption_max_len + 1, tc.batch_size, 4 if \
        cell == "LSTM" else 3
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 80 + 100 * seed)

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=DEVICE)
                * scale).to(dtype)

    fwd = (rand(T, B, n * H, scale=1.5), rand(H, n * H, scale=H ** -0.5),
           rand(n * H), rand(B, H), rand(B, H) if cell == "LSTM" else None)
    return cell, fwd, rand(T, B, H)


def held(torch, what, prec, pairs):
    """The largest |got - want| over ``pairs``; fails above ROLL_TOL (rtol,
    and atol of each output's largest |value|)."""
    err, tol = 0.0, ROLL_TOL[prec]
    for got, want in pairs:
        if want is None:
            continue
        x, y = got.float(), want.float()
        d = (x - y).abs()
        check(bool((d <= tol * y.abs() + tol * y.abs().max()).all()),
              f"{what} {prec}: kernel and plain version differ by "
              f"{float(d.max()):.3g}")
        err = max(err, float(d.max()))
    return err


def drift(torch, pairs, prec):
    """(largest |got - want|, its largest share of ROLL_TOL's bound) over
    ``pairs``: a chained bf16 run's drift from the plain loop."""
    err, share, tol = 0.0, 0.0, ROLL_TOL[prec]
    for got, want in pairs:
        if want is None:
            continue
        x, y = got.float(), want.float()
        d = (x - y).abs()
        err = max(err, float(d.max()))
        share = max(share, float((d / (tol * y.abs() + tol * y.abs().max())
                                  ).max()))
    return err, share


def whole_rollout_check(torch, tc, prec, seed, cell=None):
    """One seed: the whole-rollout kernels against their plain versions
    (tests/test_torch_cuda.py's rule): each step from the kernel's own
    state (forward) and carries (backward) within ROLL_TOL; f32 also over
    the chained steps, bf16's chained drift returned. Returns (forward
    error, backward error, chained bf16 drift or None)."""
    from recnet_tpu_torch.ops.cuda import rollout as ro
    cell, fwd, dhs = whole_rollout_operands(torch, tc, getattr(torch, prec),
                                            seed, cell)
    lstm = cell == "LSTM"
    got = ro.cell_rollout_forward(cell, *fwd)
    each = ro.cell_rollout_forward_reference(cell, *fwd, states=got[:2])
    chained = ro.cell_rollout_forward_reference(cell, *fwd)
    torch.cuda.synchronize()
    err_f = held(torch, f"cell_rollout_forward[{cell}] seed {seed}", prec,
                 zip(got, each))
    hs, cs, acts = chained
    _, _, _, h0, c0 = fwd
    steps = (torch.empty_like(hs), torch.empty_like(hs) if lstm else None)
    got_b = ro.cell_rollout_backward(cell, dhs, acts, fwd[1], h0, hs, c0, cs,
                                     steps_out=steps)
    want_steps = (torch.empty_like(hs), torch.empty_like(hs) if lstm
                  else None)
    each_b = ro.cell_rollout_backward_reference(
        cell, dhs, acts, fwd[1], h0, hs, c0, cs, steps_out=want_steps,
        carries=steps)
    chained_b = ro.cell_rollout_backward_reference(cell, dhs, acts, fwd[1],
                                                   h0, hs, c0, cs)
    torch.cuda.synchronize()
    err_b = held(torch, f"cell_rollout_backward[{cell}] seed {seed}", prec,
                 zip(tuple(got_b) + steps, tuple(each_b) + want_steps))
    pairs = list(zip(got, chained)) + list(zip(got_b, chained_b))
    if prec == "float32":
        held(torch, f"cell_rollout[{cell}] seed {seed}, chained", prec, pairs)
        return err_f, err_b, None
    return err_f, err_b, drift(torch, pairs, prec)


def cudnn_rollout(torch, cell, T, B, H, dtype):
    """The library yardstick of the whole-rollout kernels (timed here, never
    called by the port): cuDNN's torch.nn.LSTM / GRU at hidden H over T
    steps from an input of width 1 (the same recurrence and an input product
    of width 1). Returns (forward call, backward call: the gradients of the
    input and the initial state only, as the kernel's)."""
    mod = (torch.nn.LSTM if cell == "LSTM" else torch.nn.GRU)(1, H).to(
        DEVICE, dtype)
    for p in mod.parameters():
        p.requires_grad_(False)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 90)
    x = torch.randn((T, B, 1), generator=g, device=DEVICE).to(dtype)
    h0 = torch.zeros((1, B, H), device=DEVICE, dtype=dtype)
    state = (h0, h0.clone()) if cell == "LSTM" else h0
    leaves = [t.requires_grad_() for t in
              [x] + (list(state) if cell == "LSTM" else [state])]
    out, _ = mod(leaves[0], tuple(leaves[1:]) if cell == "LSTM"
                 else leaves[1])
    dy = torch.randn_like(out)

    def forward():
        with torch.no_grad():
            return mod(x, state)

    return forward, lambda: torch.autograd.grad(out, leaves, dy,
                                                retain_graph=True)


# the whole-rollout kernels timed in (d): (cell, precision); the
# reconstructor's cell first, then GRU at the same width
WHOLE_ROLLOUT_RUNS = (("LSTM", "bfloat16"), ("LSTM", "float32"),
                      ("GRU", "bfloat16"), ("GRU", "float32"))
# a reconstructor width past what one whole-rollout launch holds on the
# H100 (the ResNet features' 2048): the route rule sends it per step
ROUTE_WIDE_H = 2048


def whole_rollout_plans(torch, tc, cell, dtype):
    """Log the whole-rollout kernels' launch shapes at the flagship's
    widths (rollout.rollout_plan: the bf16 body's shared-memory budget)."""
    from recnet_tpu_torch.ops.cuda import rollout as ro
    B, H = tc.batch_size, tc.reconstructor_hidden_size
    for forward in (True, False):
        plan, _ = ro.rollout_plan(cell, forward, dtype, B, H, DEVICE)
        log("train", f"(d) cell_rollout_{'forward' if forward else 'backward'}"
                     f"[{cell}] {dtype}: {plan['clusters']} clusters of "
                     f"{plan['cluster']} (the card holds "
                     f"{plan['capacity']}), {plan['units']} units a block, "
                     f"{plan['rows']} product rows x k slice "
                     f"{plan['k_slice']}, {plan['pass_rows']} batch rows a "
                     f"pass, {plan['stages']} stages; shared memory "
                     f"{plan['smem']} of {plan['smem_limit']} bytes a block")


def whole_rollout_kernels(torch, tc):
    """(d) The whole-rollout kernels at the flagship's shapes, each run of
    WHOLE_ROLLOUT_RUNS: held against their plain versions at ROLL_SEEDS
    seeds (``whole_rollout_check``); a wrapper call timed by CUDA events
    and by the profiler's device time beside the plain version, cuDNN's
    (``cudnn_rollout``) and the bound (operations at the bf16 peak or, in
    f32, as TF32_TERMS TF32 products at PEAK_TF32_FLOPS, with the f32
    CUDA-core peak's time beside it; or bytes at the HBM rate); then, for
    the reconstructor's cell, forward + backward of the whole-rollout route
    against the per-step route (``ops.rnn.steps_forward`` /
    ``steps_backward``) in turns, in both precisions: the measurement
    behind the route rule ``ops.rnn.whole_rollout``, checked here to run
    the flagship's width whole and ROUTE_WIDE_H per step. Returns {entry name: kernels-line
    fields}: the reconstructor's cell in bf16 ("cell_rollout_<kind>[LSTM]")
    and in f32 ("...[LSTM][f32]"), each with GRU's fields in its precision
    beside them, prefixed "gru_"."""
    from recnet_tpu_torch.ops import rnn as rnn_ops
    from recnet_tpu_torch.ops.cuda import rollout as ro
    card = card_line()
    T, B = tc.caption_max_len + 1, tc.batch_size
    H, main_cell = tc.reconstructor_hidden_size, tc.reconstructor_model
    entries = {}
    for cell, prec in WHOLE_ROLLOUT_RUNS:
        dtype = getattr(torch, prec)
        G = (4 if cell == "LSTM" else 3) * H
        size = torch.finfo(dtype).bits // 8
        whole_rollout_plans(torch, tc, cell, dtype)
        checks = [whole_rollout_check(torch, tc, prec, seed, cell)
                  for seed in range(ROLL_SEEDS)]
        drifts = [c[2] for c in checks if c[2] is not None]
        log("train", f"(d) cell_rollout[{cell}] {prec}: max |kernel - plain|"
                     f" each step from the kernel's own state, forward "
                     + ", ".join(f"{c[0]:.3g}" for c in checks)
                     + "; backward " + ", ".join(f"{c[1]:.3g}" for c in checks)
                     + f" (seeds 0-{ROLL_SEEDS - 1})"
                     + ("; chained over T, f32 within ROLL_TOL" if not drifts
                        else "; the chained bf16 steps' drift from the plain "
                        "loop: " + ", ".join(f"{d:.3g} ({r:.3f} of the bound)"
                                             for d, r in drifts)))
        _, fwd, dhs = whole_rollout_operands(torch, tc, dtype, cell=cell)
        hs, cs, acts = ro.cell_rollout_forward_reference(cell, *fwd)
        w, h0, c0 = fwd[1], fwd[3], fwd[4]
        bwd = (cell, dhs, acts, w, h0, hs, c0, cs)
        lib_f, lib_b = cudnn_rollout(torch, cell, T, B, H, dtype)
        flops = 2 * B * H * G * T
        f32 = prec == "float32"
        # bytes: each input read once, each output written once
        bh, tbh = B * H, T * B * H
        carried = 2 if cell == "LSTM" else 1       # h (and c) states
        io = {"forward": size * (T * B * G + H * G + G + carried * bh
                                 + carried * tbh + 4 * tbh),
              "backward": size * (tbh + 4 * tbh + H * G + carried * tbh
                                  + carried * bh + T * B * G
                                  * (1 if cell == "LSTM" else 2)
                                  + carried * bh)}
        runs = {"forward": (lambda: ro.cell_rollout_forward(cell, *fwd),
                            lambda: ro.cell_rollout_forward_reference(cell,
                                                                      *fwd),
                            lib_f),
                "backward": (lambda: ro.cell_rollout_backward(*bwd),
                             lambda: ro.cell_rollout_backward_reference(*bwd),
                             lib_b)}
        for kind, (kernel, plain, library) in runs.items():
            ms, plain_ms, lib_ms = (timed(torch, fn, reps)[0] for fn, reps in
                                    ((kernel, 20), (plain, 3), (library, 20)))
            # the kernel's events held to its wrapper's count
            name = "::cell_rollout"
            dev = device_ms(torch, kernel, (name,), reps=10, launches={
                name: counted_launches(torch, kernel, *ro.KERNELS)})[name]
            lib_dev = device_ms(torch, library, reps=10)[""]
            i = 0 if kind == "forward" else 1
            bound_ms, bound_by = (bound_f32 if f32 else bound)(flops,
                                                               io[kind])
            fields = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=max(c[i] for c in checks),
                          device_ms=dev, library_device_ms=lib_dev,
                          precision=prec)
            if f32:
                fields["f32_core_bound_ms"] = flops / PEAK_F32_FLOPS * 1e3
            name = (f"cell_rollout_{kind}[{main_cell}]"
                    + ("[f32]" if f32 else ""))
            entry = entries.setdefault(name, {})
            if cell == main_cell:
                entry.update(fields)
            else:
                del fields["precision"]
                entry.update({f"{cell.lower()}_{k}": v
                              for k, v in fields.items()})
            log("train", f"(d) cell_rollout_{kind}[{cell}] {prec}, B={B}, "
                         f"H={H}, T={T}: one launch {ms:.4f} ms by events "
                         f"(device {dev:.4f}), plain loop {plain_ms:.4f}, "
                         f"cuDNN {lib_ms:.4f} (device {lib_dev:.4f}), bound "
                         f"{bound_ms:.4f} ms ({bound_by}: "
                         f"{flops / 1e9:.1f} GFLOP"
                         + (f" as {TF32_TERMS} TF32 terms; "
                            f"{fields['f32_core_bound_ms']:.4f} ms on the "
                            f"CUDA cores" if f32 else "")
                         + f", {io[kind] / 1e6:.1f} MB); device "
                         f"{dev / lib_dev:.2f}x cuDNN's, "
                         f"{dev / bound_ms:.1f}x the bound on {card}")
        if cell != main_cell:
            continue
        # the route rule's measurement: whole rollout against per-step, in
        # turns (whole, steps, steps, whole), forward + backward
        routes = {
            "whole": (ro.cell_rollout_forward, ro.cell_rollout_backward),
            "steps": (rnn_ops.steps_forward, rnn_ops.steps_backward)}
        ms = {"whole": [], "steps": []}
        for route in ("whole", "steps", "steps", "whole"):
            f, b = routes[route]
            ms[route].append(timed(torch, lambda: (f(cell, *fwd),
                                                   b(*bwd)))[0])
        rule = {h: rnn_ops.whole_rollout(cell, dtype, B, h,
                                         torch.device(DEVICE))
                for h in (H, ROUTE_WIDE_H)}
        log("train", f"(d) the reconstructor's cell rollout {prec}, forward "
                     f"+ backward, by events in turns: one launch a "
                     f"direction {ms['whole']} ms, per step {ms['steps']} ms"
                     f" on {card}; the route rule (ops.rnn.whole_rollout) "
                     f"runs whole at H = {H}: {rule[H]}, at H = "
                     f"{ROUTE_WIDE_H}: {rule[ROUTE_WIDE_H]}")
        check(rule == {H: True, ROUTE_WIDE_H: False},
              f"the route rule at B={B}, {prec}: {rule} (whole?)")
    return entries


def whole_rollout_split(torch, tc):
    """(d) The whole-rollout kernels' split at the flagship's shapes, bf16
    and f32: the device time (torch.profiler) of each kernel and of its
    split probes (``rollout.cell_rollout_probe``: without the product (the
    staging, its waits for readiness and the MMAs), without the MMAs,
    without the exchange (the waits for other blocks and the cluster's
    sum)) on the same inputs; the product probe held against the plain
    version with w_hh = 0 (ROLL_TOL, each step from the probe's own
    state), the others finite. A part's cost is the kernel's time less its
    probe's, printed a launch and a step. Returns {kind: {prec: {"full" or
    probe: device ms}}}."""
    from recnet_tpu_torch.ops.cuda import rollout as ro
    card = card_line()
    T = tc.caption_max_len + 1
    out = {"forward": {}, "backward": {}}
    for prec in ("bfloat16", "float32"):
        cell, fwd, dhs = whole_rollout_operands(torch, tc,
                                                getattr(torch, prec), 1)
        hs, cs, acts = ro.cell_rollout_forward_reference(cell, *fwd)
        w, h0, c0 = fwd[1], fwd[3], fwd[4]
        zero = torch.zeros_like(w)
        zfwd = (fwd[0], zero) + fwd[2:]
        operands = {"forward": (cell,) + tuple(fwd),
                    "backward": (cell, dhs, acts, w, h0, hs, c0, cs)}
        kernels = {"forward": ro.cell_rollout_forward,
                   "backward": ro.cell_rollout_backward}
        for kind in ("forward", "backward"):
            ops = operands[kind]
            ms = {"full": device_ms(torch, lambda: kernels[kind](*ops),
                                    reps=10)[""]}
            for probe in ro.ROLLOUT_PROBES:
                got = ro.cell_rollout_probe(kind, probe, *ops)
                torch.cuda.synchronize()
                if probe == "exchange":
                    check(all(bool(torch.isfinite(x.float()).all())
                              for x in got if x is not None),
                          f"{kind} {probe} probe {prec}: not finite")
                elif kind == "forward":
                    held(torch, f"{kind} {probe} probe", prec, zip(
                        got, ro.cell_rollout_forward_reference(
                            cell, *zfwd, states=got[:2])))
                else:
                    held(torch, f"{kind} {probe} probe", prec, zip(
                        got, ro.cell_rollout_backward_reference(
                            cell, dhs, acts, zero, h0, hs, c0, cs)))
                ms[probe] = device_ms(torch, lambda: ro.cell_rollout_probe(
                    kind, probe, *ops), reps=10)[""]
            out[kind][prec] = ms
            log("train", f"(d) cell_rollout_{kind}[{cell}] split, {prec}: "
                         f"the kernel {ms['full']:.4f} ms of device time "
                         f"({ms['full'] / T * 1e3:.2f} us a step); "
                         + ", ".join(f"without {p} {ms[p]:.4f} ms (the part"
                                     f" {ms['full'] - ms[p]:.4f}, "
                                     f"{(ms['full'] - ms[p]) / T * 1e3:.2f} "
                                     f"us a step)"
                                     for p in ro.ROLLOUT_PROBES)
                         + f" on {card}")
    return out


ROLLOUT_PRODUCTS = ("aten::mm", "aten::addmm", "aten::addmm_", "aten::bmm")


def loop_launches(torch, run):
    """(the rollout wrappers' launches, product calls (ROLLOUT_PRODUCTS, by
    the profiler's host events), device activities by name, {wrapper name:
    launches}) of one call of ``run``, after a warm-up."""
    from recnet_tpu_torch.ops.cuda import rollout as ro
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    products = sum(ev.device_type == DeviceType.CPU
                   and ev.name in ROLLOUT_PRODUCTS for ev in events)
    device = collections.Counter(ev.name for ev in events
                                 if ev.device_type == DeviceType.CUDA)
    return (sum(fn.n_launches for fn in ro.KERNELS), products, device,
            {fn.__name__: fn.n_launches for fn in ro.KERNELS})


def train_phase(torch, tc, vocab):
    """[train]: (a) card against CPU, (b) the loop with val, test, save
    and resume, (c) times. Returns the kernels-line entries of the train
    step's kernels (the rollouts', the embedding backward's, the TF32
    GEMM's), each with its launches in (a)'s card steps."""
    ttc = train_config(tc)
    ttc.validate()
    corpus = train_corpus(ttc, vocab)
    log("train", f"flagship preset, data_bundle off, in-memory corpus: "
                 f"{len(corpus.train_dataset)} train pairs of "
                 f"{TRAIN_VIDEOS[0]} videos, {len(corpus.val_dataset)} val, "
                 f"{TRAIN_VIDEOS[2]} test videos; B={ttc.batch_size}, "
                 f"k={ttc.steps_per_dispatch}, cache "
                 f"{ttc.feature_cache_dtype}")
    launches = train_card_against_cpu(torch, ttc, corpus)
    with tempfile.TemporaryDirectory() as tmp:
        train_loop_path(torch, ttc, corpus, Path(tmp))
    train_times(torch, ttc, corpus)
    split = loop_activities(torch, ttc, corpus)
    log("train", f"(c) device activities of the f32 step's loops (T = "
                 f"{ttc.caption_max_len + 1} against "
                 f"{ttc.caption_max_len + 1 - SPLIT_STEPS} steps): "
                 + "; ".join(f"{k} {v[0]:g} a step, {v[1]} a call ({v[2]})"
                             for k, v in split.items()))
    entries = rollout_kernels(torch, ttc)
    for name, by_prec in cell_split(torch, ttc).items():
        for prec, ms in by_prec.items():
            pre = "" if prec == ttc.train_precision else f"{prec}_"
            entries[name].update({f"{pre}{part}_device_ms": v
                                  for part, v in ms.items()
                                  if part != "kernel"})
    entries.update(whole_rollout_kernels(torch, ttc))
    rollout_split(torch, ttc)
    whole_rollout_split(torch, ttc)
    rollout_times(torch, ttc)
    entries["embedding_backward"] = embedding_backward_times(
        torch, ttc.embedding_size)
    entries["gemm_tf32x3"] = dict(
        name="gemm_tf32x3", route="cuda",
        source="recnet_tpu_torch/csrc/gemm_tf32x3.cu", replaces=None,
        pallas=False)
    for name, entry in entries.items():
        entry["launches"] = launches[name]
    return entries


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
# 10. multi-device: a process group, the mesh and mesh serving
# --------------------------------------------------------------------------

DIST_ITERS = 20                # two k = 10 dispatches a loop
DIST_VIDEOS = 300              # the mesh Captioner's requests
DIST_LOSS_RTOL = 1e-5
DIST_LEAF_RTOL, DIST_LEAF_ATOL = 1e-4, 1e-6
DIST_SUM_TOL = 1e-6            # (a): leaf checksums, of the leaf's sum |x|


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def on_a_free_port(start, tries: int = 3):
    """``start(port)`` on a port free a moment ago; another process can
    take it before the rendezvous binds it (EADDRINUSE), and then a new
    port is tried."""
    for attempt in range(tries):
        try:
            return start(free_port())
        except Exception as e:  # noqa: BLE001 -- only EADDRINUSE retries
            if "EADDRINUSE" not in str(e) or attempt == tries - 1:
                raise
            log("dist", f"the rendezvous port was taken; attempt "
                        f"{attempt + 2} of {tries}")


def dist_config(tc):
    """The flagship preset for [dist]: raw (in-memory) data, dropout off,
    DIST_ITERS iterations logged every dispatch, val, test and a save at
    the end."""
    k = tc.steps_per_dispatch
    return tc.replace(data_bundle=False, n_iterations=DIST_ITERS,
                      log_every=k, validate_every=DIST_ITERS,
                      test_every=DIST_ITERS, save_every=DIST_ITERS,
                      embedding_dropout=0.0, decoder_dropout=0.0,
                      decoder_out_dropout=0.0, reconstructor_dropout=0.0,
                      reconstructor_decoder_dropout=0.0)


def dist_loop(torch, tc, vocab, out: Path, use_mesh: bool = True):
    """``training.loop.train`` on a fresh [train] corpus (its batchers'
    shuffles start from the seed), run in ``out`` (its logs, checkpoints
    and predictions.txt land there), K2 and K3 counted from 0 just before
    its test pass and read just after. Returns (state, result): the
    launches, the seconds and the logged losses."""
    import os
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.training import loop
    out.mkdir(parents=True, exist_ok=True)
    launches = {}
    test = loop._test

    def counted_test(*args, **kw):
        reset_counts()
        test(*args, **kw)
        torch.cuda.synchronize()
        launches.update(K2=wd.whole_greedy_decode_segment.n_launches,
                        K3=tp.outproj_topk.n_launches)
    loop._test = counted_test
    cwd = os.getcwd()
    try:
        os.chdir(out)
        t0 = time.perf_counter()
        state = loop.train(tc, corpus=train_corpus(tc, vocab),
                           use_mesh=use_mesh,
                           log_dir=str(out / "log"),
                           save_dir=str(out / "ck"), device=DEVICE)
        seconds = time.perf_counter() - t0
    finally:
        loop._test = test
        os.chdir(cwd)
    metrics = out / "log" / "metrics.jsonl"
    losses = {}
    if metrics.exists():
        for line in metrics.read_text().splitlines():
            r = json.loads(line)
            if r["tag"].startswith("loss/"):
                losses[f"{r['tag']}@{r['step']}"] = r["value"]
    return state, dict(launches=launches, seconds=seconds, losses=losses)


def dist_step_ms(torch, tc, vocab):
    """ms a step by CUDA events over k-step dispatches of the loop's cached
    step, without a mesh and on ``tc.mesh_shape`` over the process group
    (the rank's rows of the same batches; the all-reduce of the gradients
    and loss terms, the vocabulary collectives), in turns (plain, mesh,
    mesh, plain, plain, mesh)."""
    from recnet_tpu_torch.data import cycle
    from recnet_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                shard_state)
    from recnet_tpu_torch.training import step as S
    k = tc.steps_per_dispatch
    corpus = train_corpus(tc, vocab)
    cache = torch.from_numpy(corpus.train_dataset.feature_cache()).to(
        DEVICE, torch.bfloat16)
    it = cycle(corpus.train_batcher)
    batches = [next(it) for _ in range(k)]
    rows = np.stack([b[1] for b in batches])                 # (k, B)
    caps = np.stack([b[2] for b in batches])                 # (k, T, B)
    mesh = make_mesh(tc.mesh_shape)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        state, dcfg, rcfg = S.init_train_state(SEED, tc,
                                               corpus.vocab.n_vocabs, DEVICE)
        if m is not None:
            state = shard_state(state, m)
            rows_, caps_ = (batch_sharding(m, 1).part(rows),
                            batch_sharding(m, 2).part(caps))
        else:
            rows_, caps_ = rows, caps
        fn = S.build_train_multi_step_cached(tc, dcfg, rcfg, k, m)
        runs[name] = functools.partial(
            fn, state, cache, torch.from_numpy(rows_.copy()).to(DEVICE),
            torch.from_numpy(caps_.copy()).to(DEVICE))
        runs[name]()                                  # warm-up
    ms = {"plain": [], "mesh": []}
    for name in ("plain", "mesh", "mesh", "plain", "plain", "mesh"):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        runs[name]()
        end.record()
        torch.cuda.synchronize()
        ms[name].append(start.elapsed_time(end) / k)
    return ms


def dist_one_rank(torch, tc, vocab, tmp: Path, card: str):
    """(a) A one-rank NCCL group on cuda:0 (``initialize`` takes a count of
    1 for a single-process run, so the group is made directly): the loop
    on the data=1 mesh against the loop without a mesh. Returns the
    mesh-less run's final leaves and result."""
    from recnet_tpu_torch.checkpoint import state_leaves
    from recnet_tpu_torch.parallel import distributed as dist
    on_a_free_port(lambda port: torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0))
    try:
        check(dist.device() == torch.device("cuda", 0),
              f"the rank's device is {dist.device()}")
        plain, rp = dist_loop(torch, tc, vocab, tmp / "plain",
                              use_mesh=False)
        meshed, rm = dist_loop(torch, tc, vocab, tmp / "mesh")
        ms = dist_step_ms(torch, tc, vocab)
    finally:
        dist.shutdown()
    leaves = state_leaves(plain)
    sum_err = max(abs(a[0] - b[0]) / max(b[1], 1e-30) for a, b in zip(
        checksums(state_leaves(meshed)), checksums(leaves)))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log("dist", f"(a) one rank, NCCL, cuda:0, data=1 mesh against no mesh, "
                f"{tc.n_iterations} iterations, B={tc.batch_size}: losses "
                f"equal {rm['losses'] == rp['losses']} ({rm['losses']}); "
                f"largest leaf checksum difference {sum_err:.3g} of the "
                f"leaf's sum |x| (tolerance {DIST_SUM_TOL:g}, "
                f"{len(leaves)} leaves); test pass launches {rm['launches']}"
                f"; loop {rp['seconds']:.2f} s plain, {rm['seconds']:.2f} s "
                f"mesh; ms a step by CUDA events over k="
                f"{tc.steps_per_dispatch} dispatches, in turns: plain "
                f"{', '.join(f'{x:.3f}' for x in ms['plain'])} (median "
                f"{med['plain']:.3f}), mesh "
                f"{', '.join(f'{x:.3f}' for x in ms['mesh'])} (median "
                f"{med['mesh']:.3f}, with the all-reduce) on {card}")
    check(rp["losses"] and rm["losses"] == rp["losses"],
          "(a) the mesh loop's losses differ from the plain loop's")
    check(sum_err <= DIST_SUM_TOL, "(a) the mesh loop's leaves differ")
    check(rm["launches"].get("K2", 0) > 0 and rm["launches"].get("K3", 0)
          > 0, f"(a) K2/K3 not launched in the test pass: {rm['launches']}")
    return leaves, rp


def dist_build_race(torch, tmp: Path):
    """Both ranks build ``topk_proj.cu`` at once into one directory that
    holds the other two libraries already: each nvcc writes a temporary
    named by its pid and renames it over the library; both load it."""
    from recnet_tpu_torch.ops.cuda import build
    build.BUILD_DIR = tmp / "build_race"
    torch.distributed.barrier()
    t0 = time.perf_counter()
    path = build.build("topk_proj")
    for name in ("whole_decode", "topk_proj", "fused_step"):
        build.load(name)
    return dict(library=path.name, seconds=time.perf_counter() - t0)


def dist_rank(rank: int, port: int, tmp: str):
    """One of two ranks sharing cuda:0 over gloo (asked for by name): the
    build race, then (b) the loop on a data=2 mesh and (c) on a model=2
    mesh; writes its results to <tmp>/rank<rank>.json."""
    import torch
    from recnet_tpu_torch.checkpoint import (load_config_and_vocab,
                                             state_leaves)
    from recnet_tpu_torch.parallel import distributed as dist
    from recnet_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    dist.initialize(coordinator_address=f"localhost:{port}",
                    num_processes=2, process_id=rank, local_device_ids=[0],
                    cpu_collectives="gloo")
    try:
        result = {"race": dist_build_race(torch, tmp),
                  "backend": torch.distributed.get_backend(),
                  "device": str(dist.device())}
        with tempfile.TemporaryDirectory() as t:
            tc, vocab = load_config_and_vocab(
                str(flagship_checkpoint_dir(Path(t), VOCAB)))
        tc = dist_config(tc)
        for name, shape in (("b", (("data", 2),)), ("c", (("model", 2),))):
            stc = tc.replace(mesh_shape=shape)
            state, r = dist_loop(torch, stc, vocab,
                                 tmp / name / f"rank{rank}")
            leaves = state_leaves(state, make_mesh(shape), vocab.n_vocabs)
            r["digest"] = sum(float(np.abs(x).sum(dtype=np.float64))
                              for x in leaves)
            r["shard_rows"] = int(state.dec_params["embedding"].shape[0])
            del state, leaves
            r["ms"] = dist_step_ms(torch, stc, vocab)
            result[name] = r
        (tmp / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.shutdown()


def dist_two_ranks(torch, tc, want_leaves, want, tmp: Path, card: str):
    """(b) and (c): two ranks spawned on the card, held against (a)'s
    mesh-less run."""
    import torch.multiprocessing as mp
    from recnet_tpu_torch.ops.cuda import build
    race = tmp / "build_race"
    race.mkdir()
    for name in ("whole_decode", "fused_step"):
        shutil.copy(build.library_path(name), race)
    t0 = time.perf_counter()
    on_a_free_port(lambda port: mp.spawn(dist_rank, args=(port, str(tmp)),
                                         nprocs=2, join=True))
    seconds = time.perf_counter() - t0
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(2)]
    libs = sorted(p.name for p in race.iterdir())
    kernels = [x for x in libs if x.endswith(".so") and x.split("-")[0]
               in ("whole_decode", "topk_proj", "fused_step")]
    log("dist", f"(b, c) two ranks on cuda:0 over {ranks[0]['backend']} "
                f"({ranks[0]['device']}, {ranks[1]['device']}), "
                f"{seconds:.1f} s with the spawn; both built "
                f"{ranks[0]['race']['library']} at once "
                f"({ranks[0]['race']['seconds']:.1f} s, "
                f"{ranks[1]['race']['seconds']:.1f} s): the directory holds "
                f"{libs} on {card}")
    check(len(kernels) == 3 and not any(".tmp." in x for x in libs),
          f"the build race left {libs}")
    for name, what in (("b", "data=2"), ("c", "model=2")):
        r0, r1 = ranks[0][name], ranks[1][name]
        loss_err = max(abs(r0["losses"].get(k, np.inf) - v) / abs(v)
                       for k, v in want["losses"].items())
        step_dir = tmp / name / "rank0" / "ck" / str(tc.n_iterations)
        with np.load(step_dir / "state.npz") as data:
            got = [data[f"leaf_{i}"] for i in range(len(data.files))]
        # the largest |diff| / (atol + rtol |x|): at most 1 passes
        worst = max(float(np.max(np.abs(a - b) / (
            DIST_LEAF_ATOL + DIST_LEAF_RTOL * np.abs(b))))
            for a, b in zip(got, want_leaves))
        diff = max(float(np.max(np.abs(a - b)))
                   for a, b in zip(got, want_leaves))
        med = {k: float(np.median(v)) for k, v in r0["ms"].items()}
        rank1 = tmp / name / "rank1"
        quiet = not any((rank1 / x).exists()
                        for x in ("ck", "log", "predictions.txt"))
        wrote = (tmp / name / "rank0" / "predictions.txt").exists()
        log("dist", f"({name}) {what} mesh, 2 ranks on cuda:0 over gloo: "
                    f"loop {r0['seconds']:.2f} s / {r1['seconds']:.2f} s; "
                    f"largest relative loss difference from (a) "
                    f"{loss_err:.3g} (tolerance {DIST_LOSS_RTOL:g}); the "
                    f"checkpoint's {len(got)} leaves against (a)'s: largest "
                    f"|diff| {diff:.3g}, largest |diff| / (atol "
                    f"{DIST_LEAF_ATOL:g} + rtol {DIST_LEAF_RTOL:g} |x|) "
                    f"{worst:.3g} (at most 1); ms a step on rank 0 by CUDA "
                    f"events, in turns, both ranks stepping on the card: "
                    f"no mesh (B={tc.batch_size} a rank) "
                    f"{', '.join(f'{x:.3f}' for x in r0['ms']['plain'])} "
                    f"(median {med['plain']:.3f}), {what} "
                    f"{', '.join(f'{x:.3f}' for x in r0['ms']['mesh'])} "
                    f"(median {med['mesh']:.3f}); digests "
                    f"{r0['digest']:.6f} / {r1['digest']:.6f}; embedding "
                    f"rows a rank {r0['shard_rows']}; test pass launches "
                    f"{r0['launches']} / {r1['launches']}; rank 0 wrote "
                    f"checkpoint {step_dir.name} and predictions.txt: "
                    f"{wrote}, rank 1 wrote nothing: {quiet} on {card}")
        check(len(got) == len(want_leaves) and worst <= 1,
              f"({name}) leaves differ from the one-rank run")
        check(loss_err <= DIST_LOSS_RTOL, f"({name}) losses differ")
        check(r0["digest"] == r1["digest"], f"({name}) the ranks disagree")
        check(quiet and wrote, f"({name}) side effects off rank 0")
        for r in (r0, r1):
            check(r["launches"].get("K2", 0) > 0
                  and r["launches"].get("K3", 0) > 0,
                  f"({name}) a rank's test pass launched no K2/K3: "
                  f"{r['launches']}")


def dist_captioner(torch, tc, vocab, cfg, params_np, card: str):
    """(d) The mesh Captioner on a mesh of cuda:0 alone and on one listing
    it twice, against the plain Captioner: greedy through K2 segments and
    beam 5 through K3, f32 and bf16; the launches per shard."""
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.parallel.mesh import make_mesh
    from recnet_tpu_torch.serving import Captioner
    feats = request_features(SEED + 60, DIST_VIDEOS, cfg.encoder_size)
    for dtype in ("float32", "bfloat16"):
        kw = dict(dtype=dtype, use_pallas=True,
                  greedy_segment=tc.greedy_segment, device=DEVICE)
        plain = Captioner(tc, vocab, params_np, **kw)
        entry = f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE
        meshes = {n: Captioner(tc, vocab, params_np, mesh=make_mesh(
            (("data", n),), [entry] * n), **kw) for n in (1, 2)}
        for beam in (None, BEAM):
            counter = (tp.outproj_topk if beam
                       else wd.whole_greedy_decode_segment)
            what = (f"beam {beam} (K3)" if beam else
                    f"greedy (K2, segments of {tc.greedy_segment})")
            want = plain.caption(feats, beam_width=beam)
            parts, launches = [], {}
            for n, cap in meshes.items():
                reset_counts()
                t0 = time.perf_counter()
                got = cap.caption(feats, beam_width=beam)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches[n] = counter.n_launches
                videos = sum(a == b for a, b in zip(got, want)) / len(want)
                words = word_share(got, want)
                parts.append(f"{n} shard{'s' if n > 1 else ''}: "
                             f"{launches[n]} launches "
                             f"({launches[n] // n} a shard), videos equal "
                             f"{videos:.4f}, words {words:.4f}, "
                             f"{seconds:.3f} s")
                if dtype == "float32":
                    check(videos == 1.0, f"(d) f32 {n}-shard captions "
                                         "differ from the plain Captioner's")
                else:
                    check(words >= BF16_TOKENS, f"(d) bf16 {n}-shard words "
                                                f"{words} < {BF16_TOKENS}")
            log("dist", f"(d) mesh Captioner, {DIST_VIDEOS} videos, {dtype}, "
                        f"{what}: {'; '.join(parts)} on {card}")
            check(launches[1] > 0 and launches[2] == 2 * launches[1],
                  f"(d) launches a shard {launches}")
        del plain, meshes


def dist_phase(torch, tc, vocab, cfg, params_np):
    """[dist]: (a) one rank over NCCL, (b, c) two ranks on the card over
    gloo, (d) the mesh Captioner."""
    t0 = time.perf_counter()
    card = card_line()
    dtc = dist_config(tc)
    log("dist", f"flagship preset, dropout off, the [train] in-memory "
                f"corpus; B={dtc.batch_size}, k={dtc.steps_per_dispatch}, "
                f"{dtc.n_iterations} iterations; one card: NCCL across cards "
                f"is not run here")
    with tempfile.TemporaryDirectory() as tmp:
        leaves, want = dist_one_rank(torch, dtc, vocab, Path(tmp) / "a",
                                     card)
        (Path(tmp) / "bc").mkdir()
        dist_two_ranks(torch, dtc, leaves, want, Path(tmp) / "bc", card)
    del leaves
    dist_captioner(torch, tc, vocab, cfg, params_np, card)
    log("dist", f"the phase took {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# 7. two trees in turns: python3 chip_smoke.py --compare <other tree>
# --------------------------------------------------------------------------

def time_kernels(root: str, outputs: str) -> None:
    """Time K1, K2 (seg_len 4), K3 and K4 of the package under ``root``
    and their library routes, and the K4 loop, as ``times`` does
    (``core_kernels``, bf16, B = TIME_B, on inputs from this script's
    seeds); the per-step cell kernels (``cell_step_times``) and the
    whole-rollout kernels (``whole_rollout_times``); then
    [train] (c)'s k-step dispatches, f32 and bf16, and the loops' split
    (``train_timing``); print one JSON line. The per-step cell kernels'
    outputs on seed 0's inputs go to the file ``outputs``. Runs in a
    process of its own, so that ``root``'s package and its kernel builds
    are the ones imported."""
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
    for name in ("whole_decode", "whole_decode_tf32", "topk_proj",
                 "fused_step"):
        if (build.CSRC / f"{name}.cu").is_file():   # the tree's sources
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
    # the bf16 route's outputs on these inputs, held bit for bit across the
    # trees
    decoded = {f"decode bf16 {name}": [x.cpu() for x in (
        out if isinstance(out, tuple) else (out,))]
        for name, out in (("whole_greedy_decode", core[
            "whole_greedy_decode"][0]()), ("whole_greedy_decode_segment",
                                           core["whole_greedy_decode_segment"]
                                           [0]()), ("outproj_topk", core[
                                               "outproj_topk"][0]()))}
    del params, enc, core
    ms.update(f32_route_times(torch, tc, cfg))
    ms.update(cell_step_times(torch, tc, outputs, decoded))
    ms.update(whole_rollout_times(torch, tc))
    print(json.dumps({"root": root, "build_s": built, "ms": ms,
                      "train": train_timing(torch)}), flush=True)


def f32_route_times(torch, tc, cfg):
    """{"<name> B=<B>": ms by CUDA events} of the imported package's f32
    route through its production wrappers (whatever body each tree takes
    for f32: the first designs in a tree without the TF32 body) and the
    library routes, at EVAL_B and TIME_B (``f32_cases``' shapes); then
    ``evaluation.evaluate`` of the f32 flagship over ``eval_corpus``'s
    batches of EVAL_B, greedy and beam 5: the wall seconds of a run after
    one warm-up, and the decode of one batch by CUDA events."""
    from recnet_tpu_torch.checkpoint import load_config_and_vocab
    from recnet_tpu_torch.evaluation import decode_batch, evaluate
    from recnet_tpu_torch.weights import params_from_jax, random_params
    params = params_from_jax(random_params(cfg, SEED), DEVICE, torch.float32)
    out = {}
    for B in (EVAL_B, TIME_B):
        for name, case in f32_cases(torch, tc, cfg, params, B).items():
            route, _, _, library, _, reps = case[:6]
            out[f"{name} B={B}"] = timed(torch, route, reps)[0]
            out[f"{name} library B={B}"] = timed(torch, library, reps)[0]
            if name == "fused_gru_attn_step[f32]":   # host-paced: the card's
                out[f"{name} device B={B}"] = device_ms(torch, route)[""]
                out[f"{name} library device B={B}"] = device_ms(
                    torch, library)[""]
    with tempfile.TemporaryDirectory() as tmp:
        _, vocab = load_config_and_vocab(
            str(flagship_checkpoint_dir(Path(tmp), VOCAB)))
    corpus = eval_corpus(tc, vocab, cfg)
    videos = corpus.score_batcher[0][1]
    with tempfile.TemporaryDirectory() as tmp:
        for search in ("greedy", ("beam", BEAM)):
            name = search if isinstance(search, str) else f"beam {BEAM}"
            run = lambda: evaluate(tc, corpus, params, cfg, search,
                                   predictions_fpath=str(Path(tmp) / "p"),
                                   n_test=EVAL_VIDEOS)
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            out[f"evaluate f32 {name} s"] = time.perf_counter() - t0
            out[f"decode_batch f32 {name} B={EVAL_B}"] = timed(
                torch, lambda: decode_batch(
                    params, cfg, videos, search, tc.caption_max_len,
                    use_pallas=tc.use_pallas,
                    greedy_segment=tc.greedy_segment))[0]
    return out


def cell_step_times(torch, tc, outputs, decoded=None):
    """{"<entry name> <prec>": ms a step of its ``*_steps`` launcher by
    CUDA events, and with " device": device ms} of the imported package's
    per-step cell kernels at the flagship's shapes, over a sweep of
    per-step operands out of L2 (``rollout_cases``: the launchers'
    signatures are the same in every tree that has them), f32 and bf16.
    Each kernel's outputs from a wrapper call on the same inputs go to the
    file ``outputs`` (torch.save of {"<entry name> <prec>": [tensors]}),
    with ``decoded`` (other outputs to hold across trees) beside them."""
    from recnet_tpu_torch.ops.cuda import rollout as ro
    out, saved = {}, {}
    for prec in ("float32", "bfloat16"):
        for name, case in rollout_cases(torch, tc, getattr(torch, prec),
                                        sweeps=True).items():
            if name.startswith("rollout_cell"):
                sweep, steps = case[4], case[5]
                out[f"{name} {prec}"] = timed(
                    torch, sweep, max(100 // steps, 3))[0] / steps
                per_call = counted_launches(torch, sweep, *ro.KERNELS)
                out[f"{name} {prec} device"] = device_ms(
                    torch, sweep, reps=max(50 // steps, 3),
                    launches={"": per_call})[""] / steps
                saved[f"{name} {prec}"] = [None if x is None else x.cpu()
                                           for x in case[0]()]
    saved.update(decoded or {})
    torch.save(saved, outputs)
    return out


def whole_rollout_times(torch, tc):
    """{"cell_rollout_<kind>[<cell>] <bf16 or f32>": ms by events, and
    with " device": device ms} of the imported package's whole-rollout
    wrappers at the flagship's shapes, LSTM and GRU, bf16 and f32, on this
    script's inputs (the wrappers' signatures are the same in every tree
    that has them)."""
    from recnet_tpu_torch.ops.cuda import rollout as ro
    out = {}
    runs = [(cell, dtype) for cell in ("LSTM", "GRU")
            for dtype in (torch.bfloat16, torch.float32)]
    for cell, dtype in runs:
        prec = "bf16" if dtype == torch.bfloat16 else "f32"
        _, fwd, dhs = whole_rollout_operands(torch, tc, dtype, cell=cell)
        hs, cs, acts = ro.cell_rollout_forward_reference(cell, *fwd)
        bwd = (cell, dhs, acts, fwd[1], fwd[3], hs, fwd[4], cs)
        for kind, fn in (
                ("forward", lambda: ro.cell_rollout_forward(cell, *fwd)),
                ("backward", lambda: ro.cell_rollout_backward(*bwd))):
            name = f"cell_rollout_{kind}[{cell}] {prec}"
            out[name] = timed(torch, fn, 20)[0]
            kernel = "::cell_rollout"       # held to the wrapper's count
            out[f"{name} device"] = device_ms(
                torch, fn, (kernel,), reps=10, launches={
                    kernel: counted_launches(torch, fn, *ro.KERNELS)})[kernel]
    return out


def compare(other: str) -> None:
    """Time this tree and ``other`` in turns (this, other, other, this),
    each in a process of its own; print each run's JSON line. Then hold
    the per-step cell kernels' outputs of the two trees on the same inputs
    against each other: f32 bit for bit, bf16 within 2 ulps."""
    import torch
    card = card_line()
    tmp = Path(tempfile.mkdtemp(prefix="compare-"))
    runs = []
    for i, root in enumerate((str(REPO), other, other, str(REPO))):
        runs.append(tmp / f"cells-{i}.pt")
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--time-kernels",
             root, str(runs[-1])], capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SmokeFailure(f"--time-kernels {root} exited "
                               f"{proc.returncode}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        log("compare", f"{json.dumps(result)} ({card})")
    mine, theirs = torch.load(runs[0]), torch.load(runs[1])
    shutil.rmtree(tmp)
    for name, got in mine.items():
        check(name in theirs, f"{other} has no {name}")
        for i, (x, y) in enumerate(zip(got, theirs[name])):
            if x is None or y is None:
                check(x is y, f"{name} output {i}: None in one tree only")
            elif name.endswith("float32") or name.startswith("decode bf16"):
                check(torch.equal(x, y), f"{name} output {i}: not bit-equal "
                                         f"to {other}'s")
            else:
                check(bf16_ulps(torch, x, y) <= 2,
                      f"{name} output {i}: over 2 ulps from {other}'s")
    log("compare", f"the per-step cell kernels' outputs: f32 bit-equal and "
                   f"bf16 within 2 ulps to {other}'s on the same inputs; the "
                   f"bf16 decode kernels' (K1, K2, K3) bit-equal "
                   f"({', '.join(mine)})")


def time_train(root: str) -> None:
    """[train] (c)'s k-step dispatches (``train_times``, f32 and bf16) of
    the package under ``root``; print one JSON line. Runs in a process of
    its own, so that ``root``'s package and its kernel builds are the ones
    imported."""
    import torch
    sys.path.insert(0, str(Path(root).resolve()))
    from recnet_tpu_torch.checkpoint import load_config_and_vocab
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        tc, vocab = load_config_and_vocab(
            str(flagship_checkpoint_dir(Path(tmp), VOCAB)))
    ttc = train_config(tc)
    steps = train_times(torch, ttc, train_corpus(ttc, vocab))
    print(json.dumps({"root": root, "steps": steps}), flush=True)


def compare_train(other: str, rounds: int) -> None:
    """[train] (c) of this tree and ``other`` in turns, ``rounds`` times
    (this, other, other, this), each in a process of its own; print each
    run's JSON line, then each tree's ms a step, busy ms, idle share and
    activities a step by precision, in the order run."""
    card = card_line()
    seen = {str(REPO): [], other: []}
    for _ in range(rounds):
        for root in (str(REPO), other, other, str(REPO)):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--time-train", root], capture_output=True, text=True,
                timeout=600)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                raise SmokeFailure(f"--time-train {root} exited "
                                   f"{proc.returncode}")
            result = json.loads(proc.stdout.strip().splitlines()[-1])
            log("compare", f"{json.dumps(result)} ({card})")
            seen[root].append(result["steps"])
    for root, runs in seen.items():
        for prec in ("float32", "bfloat16"):
            log("compare", f"{root} {prec}: " + "; ".join(
                f"{key} " + ", ".join(f"{r[prec][key]:.3f}" for r in runs)
                for key in ("ms", "busy_ms", "idle", "kernels"))
                + f" ({card})")


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--time-kernels"]:
        time_kernels(sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--time-train"]:
        time_train(sys.argv[2])
        return 0
    environment(torch)
    if sys.argv[1:2] == ["--compare"]:
        build_kernels()
        compare(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--compare-train"]:
        build_kernels()
        compare_train(sys.argv[2], int(sys.argv[3]) if sys.argv[3:] else 3)
        return 0
    if sys.argv[1:2] == ["--read-rates"]:
        read_rates(torch)
        return 0
    if sys.argv[1:2] == ["--gate-rows"]:
        build_kernels()
        gate_rows_sweep(torch)
        return 0
    if sys.argv[1:2] == ["--embedding-backward"]:
        build_kernels()
        embedding_phase(torch)
        return 0
    if sys.argv[1:2] == ["--gemm"]:
        check_only = sys.argv[2:3] == ["check"]
        if check_only:       # the GEMM alone
            from recnet_tpu_torch.ops.cuda import build
            build.load("gemm_tf32x3")
        else:
            build_kernels()
        gemm_phase(torch, check_only)
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
    errs.update(tf32_against_twins(torch, tc, cfg))
    errs.update(topk_against_twin(torch, cfg))
    errs.update(fused_step_against_twin(torch, tc, cfg))
    variant_errs = variants_against_k1(torch, tc, cfg)
    eos_np = eos_biased(torch, tc, cfg, params_np)
    launches = main_path(torch, tc, vocab, cfg, params_np, eos_np)
    launches["outproj_topk"] = beam_path(torch, tc, vocab, cfg, params_np)
    with tempfile.TemporaryDirectory() as tmp:
        eval_launches = eval_path(torch, tc, vocab, cfg, params_np,
                                  Path(tmp))
    launches["outproj_topk[f32]"] = eval_launches[f"beam {BEAM}"][
        "outproj_topk[f32]"]
    launches["whole_greedy_decode_segment[f32]"] += eval_launches["greedy"][
        "whole_greedy_decode_segment[f32]"]
    launches.update(pallas_path(torch, tc, cfg, params_np))
    pad_np = pad_timed(torch, tc, cfg, params_np)
    variant_launches = {}
    variant_launches["early_exit"], variant_errs["early_exit"] = (
        early_exit_path(torch, tc, cfg, pad_np))
    entries = times(torch, tc, cfg, params_np, eos_np, pad_np)
    entries.update(f32_times(torch, tc, cfg, params_np, pad_np))
    sweep_launches, sweep_ms, sweep_errs = ablate_sweep(torch, tc, cfg,
                                                        params_np)
    f32_launches, f32_entries, f32_errs = ablate_sweep_f32(torch, tc, cfg,
                                                           params_np)
    variant_launches.update(sweep_launches)
    variant_launches.update(f32_launches)
    entries.update(f32_entries)
    for name, err in list(sweep_errs.items()) + list(f32_errs.items()):
        variant_errs[name] = max(variant_errs.get(name, 0.0), err)
    rollout_entries = train_phase(torch, tc, vocab)
    embedding_entry = rollout_entries.pop("embedding_backward")
    gemm_entry = rollout_entries.pop("gemm_tf32x3")
    data_phase(torch, tc, vocab)
    dist_phase(torch, tc, vocab, cfg, eos_np)
    T, L = tc.caption_max_len + 1, tc.encoder_output_len
    for part in ABLATE_PARTS:
        bound_ms, bound_by = bound(*decode_work(cfg, L, TIME_B, TIME_B * T,
                                                T, ablate=part))
        for suffix in ("", "[cuda_cores]"):
            ms, plain = sweep_ms[f"ablate={part}{suffix}"]
            entries[f"whole_greedy_decode[ablate={part}{suffix}]"] = dict(
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bound_ms,
                bound_by=bound_by)

    pallas = "recnet_tpu/ops/pallas/"
    csrc = "recnet_tpu_torch/csrc/"
    rows = [("whole_greedy_decode", "whole_decode.cu",
             "whole_decode.py:440"),
            ("whole_greedy_decode_segment", "whole_decode.cu",
             "whole_decode.py:360"),
            ("outproj_topk", "topk_proj.cu", "topk_proj.py:77"),
            ("fused_gru_attn_step", "fused_step.cu", "fused_step.py:92"),
            # the f32 route: the TF32 body and K3's TF32 split route
            ("whole_greedy_decode[f32]", "whole_decode_tf32.cu",
             "whole_decode.py:440"),
            ("whole_greedy_decode_segment[f32]", "whole_decode_tf32.cu",
             "whole_decode.py:360"),
            ("outproj_topk[f32]", "topk_proj.cu", "topk_proj.py:77"),
            ("fused_gru_attn_step[f32]", "fused_step.cu", "fused_step.py:92")]
    # the K5 variants, each under its variant_launches key: the
    # tensor-core probes are built from whole_decode_probes.cu, the TF32
    # body's (f32) from whole_decode_tf32_probes.cu, the rest (the early
    # exit, and the CUDA-core body's variants) from whole_decode.cu
    variants = (["early_exit", "dual", "dual[cuda_cores]", "cuda_cores",
                 "dual[tf32]"]
                + [f"ablate={p}{suffix}"
                   for suffix in ("", "[cuda_cores]", "[tf32]")
                   for p in ABLATE_PARTS])
    source = lambda v: ("whole_decode_tf32_probes.cu" if "[tf32]" in v
                        else "whole_decode.cu" if v == "early_exit"
                        or "cuda_cores" in v else "whole_decode_probes.cu")
    rows += [(f"whole_greedy_decode[{v}]", source(v), "whole_decode.py:497")
             for v in variants]
    counts = dict(launches, **{f"whole_greedy_decode[{v}]": n
                               for v, n in variant_launches.items()})
    errors = dict(errs, **{f"whole_greedy_decode[{v}]": e
                           for v, e in variant_errs.items()})
    kernels = [dict({"name": name, "route": "cuda", "source": csrc + src,
                     "replaces": pallas + tpu, "launches": counts[name],
                     "max_abs_err": errors[name]}, **entries[name])
               for name, src, tpu in rows]
    # the training rollouts' kernels: no Pallas kernel on their path (XLA
    # fuses it in the JAX package); "replaces" names the JAX function each
    # serves
    serves = {"cell_forward": "recnet_tpu/ops/rnn.py:153",
              "cell_backward": "recnet_tpu/ops/rnn.py:181",
              "attention_forward": "recnet_tpu/models/decoder.py:261",
              "attention_backward": "recnet_tpu/models/decoder.py:283",
              # the custom VJP's forward and backward, by cell type
              "cell_rollout_forward[LSTM]": "recnet_tpu/ops/rnn.py:215",
              "cell_rollout_backward[LSTM]": "recnet_tpu/ops/rnn.py:225",
              "cell_rollout_forward[GRU]": "recnet_tpu/ops/rnn.py:256",
              "cell_rollout_backward[GRU]": "recnet_tpu/ops/rnn.py:265"}
    for name, entry in rollout_entries.items():
        whole = name.startswith("cell_rollout")
        kind = (name.split("]")[0] + "]" if whole
                else name[len("rollout_"):].split("[")[0])
        kernels.append(dict({"name": name, "route": "cuda",
                             "source": csrc + ("cell_rollout.cu" if whole
                                               else "rollout.cu"),
                             "replaces": serves[kind], "pallas": False},
                            **entry))
    kernels.append(embedding_entry)
    kernels.append(gemm_entry)
    for k in kernels:     # the body each decode row ran on
        if k["name"].startswith(("whole_greedy_decode", "fused_gru_attn")):
            k["body"] = ("cuda_cores" if "cuda_cores" in k["name"]
                         else "tf32" if "[f32]" in k["name"]
                         or "[tf32]" in k["name"] else "tensor_cores")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
