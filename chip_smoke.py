"""Smoke run of the PyTorch/CUDA port (recnet_tpu_torch) on one Hopper card.

    python3 chip_smoke.py          # from the repository root

Phases, one line or more each; any failure exits non-zero before a result:

1. environment: torch, CUDA, the card, TF32 off;
2. build: nvcc builds the port's CUDA kernels from this checkout, one
   process per source, all at once;
3. kernels: K1 (whole decode) and K2 (decode segment) against their plain
   PyTorch twins at the flagship width, GRU and LSTM, f32 and bf16; K3
   (projection + top-k) against its twin at the flagship beam's shapes;
   K4 (fused attention + GRU step) against its twin, f32 and bf16, frame
   chunks 1 and 7; the K5 variants of K1: ``dual`` bit-equal to K1, each
   ``ablate`` part against its twin;
4. main paths, each with the launch counts set to 0 before it and read
   after it: greedy requests through the port's HTTP handler behind the
   MicroBatcher, from a flagship-width bf16 Captioner (use_pallas,
   greedy_segment=4), for K1 and K2; beam-5 requests mixed with greedy
   ones through the same front, for K3; ``evaluation.evaluate`` with beam
   5 and greedy on an in-memory score corpus, for K3 and K2;
   ``decoding.greedy_decode_pallas`` at B=1024, for K4 (T launches);
   ``decoding.greedy_decode_whole(early_exit=True)`` on PAD-timed
   weights (blocks stop at different steps), for K5's early exit;
5. times: captions/s at B=1024 for the kernel and plain greedy paths
   (K1, K2, the K4 loop), K3 and its twin at N=5120, K4 and its twin per
   step, the early exit and dual against K1, and beam captions/s for the
   K3 and plain routes;
6. ablate: the profiling sweep of K1 at B=1024 bf16 (production, each
   ablated part, dual), each part's cost as full - variant and its tokens
   against its twin's.

The weights are random, drawn from a numpy seed. The last three lines are
the card's name and power limit, one JSON line listing every kernel, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import json
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
BF16_ROWS = 0.90       # sanity bound on the bf16 token agreement
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
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{path.stem}: {line.strip()}")


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
                check(tok_share >= BF16_ROWS,
                      f"K1 {cell} bf16 tokens equal {tok_share} < {BF16_ROWS}")
            # K2, two chained segments per length, and T steps from <SOS>
            # (K1's launch) for the h error
            B, H = CHECK_B, cfg.hidden_size
            for seg_len in (1, 4, T):
                z = torch.zeros((B, H), dtype=dtype, device=DEVICE)
                sos = torch.full((B, 1), cfg.sos_token, dtype=torch.int32,
                                 device=DEVICE)
                k_state, t_state = (z, z, sos), (z, z, sos)
                for _ in range(1 if seg_len == T else 2):
                    k_out = wd.whole_greedy_decode_segment(
                        *ops, *k_state, seg_len=seg_len, **kw)
                    t_out = wd.whole_greedy_decode_segment_reference(
                        *ops, *t_state, seg_len=seg_len, **kw)
                    k_state, t_state = k_out[1:], t_out[1:]
                torch.cuda.synchronize()
                rows = (k_out[0] == t_out[0]).all(dim=1)
                dh = (k_out[1].float() - t_out[1].float()).abs()[rows]
                err = float(dh.max()) if len(dh) else float("nan")
                log("kernels", f"K2 {cell} {dname} seg_len={seg_len}: rows "
                               f"equal {rows.float().mean().item():.4f}, max "
                               f"|h - h_twin| on them {err:.3e}")
                if dtype == torch.float32:
                    check(rows.float().mean().item() >= F32_ROWS,
                          f"K2 {cell} f32 seg_len={seg_len} rows disagree")
                    check(torch.allclose(k_out[1][rows], t_out[1][rows],
                                         rtol=H_RTOL, atol=H_ATOL),
                          f"K2 {cell} f32 h off the twin beyond rtol "
                          f"{H_RTOL} atol {H_ATOL}")
                    name = ("whole_greedy_decode" if seg_len == T
                            else "whole_greedy_decode_segment")
                    errs[name] = max(errs[name], err)
    return errs


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
    """K4 against its twin at B = CHECK_B, f32 and bf16, frame_chunk 1 and
    7; returns the max |h - h_twin| in f32."""
    from recnet_tpu_torch.ops.cuda import fused_step as fs
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = "f32" if dtype == torch.float32 else "bf16"
        enc = seeded_features(torch, CHECK_B, tc.encoder_output_len, cfg,
                              dtype, 11)
        ops = k4_operands(torch, cfg, seeded_params(cfg, dtype), enc, 12)
        for fc in K4_CHUNKS:
            kw = dict(emb_size=cfg.embedding_size, frame_chunk=fc)
            got = fs.fused_gru_attn_step(*ops, **kw)
            want = fs.fused_gru_attn_step_reference(*ops, **kw)
            torch.cuda.synchronize()
            d = float((got.float() - want.float()).abs().max())
            log("kernels", f"K4 {dname} B={CHECK_B} frame_chunk={fc}: max "
                           f"|h - h_twin| {d:.3e}")
            if dtype == torch.float32:
                check(torch.allclose(got, want, rtol=H_RTOL, atol=H_ATOL),
                      f"K4 f32 frame_chunk={fc}: h off the twin beyond rtol "
                      f"{H_RTOL} atol {H_ATOL}")
                err = max(err, d)
            else:
                check(torch.allclose(got.float(), want.float(),
                                     rtol=BF16_RTOL, atol=BF16_ATOL),
                      f"K4 bf16 frame_chunk={fc}: h off the twin beyond "
                      f"rtol {BF16_RTOL} atol {BF16_ATOL}")
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
            full = wd.whole_greedy_decode(*ops, **kw)
            torch.cuda.synchronize()
            rows = (dual == full).all(dim=1).float().mean().item()
            dname = "f32" if dtype == torch.float32 else "bf16"
            log("kernels", f"K5 dual {cell} {dname} B={CHECK_B}: rows equal "
                           f"to K1 {rows:.4f}")
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

    # f32 on the card: kernel path against the plain twin, per video
    from recnet_tpu_torch.decoding import tokens_to_sentences
    cap_f32 = Captioner(tc, vocab, eos_params, dtype="float32",
                        device=DEVICE, use_pallas=True,
                        greedy_segment=tc.greedy_segment)
    feats = requests[2]
    got = cap_f32.caption(feats)
    videos = torch.from_numpy(cap_f32.prepare(feats)).to(DEVICE,
                                                         torch.float32)
    ops = decode_operands(cap_f32.params, videos)
    twin = wd.whole_greedy_decode_reference(
        *ops, emb_size=cfg.embedding_size, max_len=tc.caption_max_len,
        sos=cfg.sos_token, cell_type=cfg.cell_type)
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


def pallas_path(torch, tc, cfg, params_np):
    """``decoding.greedy_decode_pallas`` (the K4 loop) at B = TIME_B bf16,
    with K4's launches counted; then its f32 tokens and n_steps at B =
    CHECK_B against plain ``greedy_decode``'s, on the random weights, whose
    rows run all T steps. Returns K4's launches."""
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
    log("pallas", f"greedy_decode_pallas B={TIME_B} bf16 T={T}: "
                  f"{time.perf_counter() - t0:.2f} s, n_steps {res.n_steps}, "
                  f"K4 launches {launches}")
    check(launches == T, f"K4 launched {launches} times, not T = {T}")
    check(tuple(res.tokens.shape) == (T, TIME_B)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "greedy_decode_pallas tokens malformed")
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
    twin (f32, B = CHECK_B); then ``decoding.greedy_decode_whole(
    early_exit=True)`` at B = TIME_B bf16, with its launches counted,
    against the full K1 decode. Each run first checks that its blocks stop
    at different steps (``block_stops``). Returns (launches, max |token -
    twin token|)."""
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
    err = float((got - want).abs().max())
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
    return launches, err


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
    z = torch.zeros((B, cfg.hidden_size), dtype=dtype, device=DEVICE)
    sos = torch.full((B, 1), cfg.sos_token, dtype=torch.int32, device=DEVICE)
    card = card_line()
    kernel_ms = {
        "whole_greedy_decode": (
            timed(torch, lambda: wd.whole_greedy_decode(
                *ops, max_len=T - 1, **kw))[0],
            timed(torch, lambda: wd.whole_greedy_decode_reference(
                *ops, max_len=T - 1, **kw))[0]),
        "whole_greedy_decode_segment": (
            timed(torch, lambda: wd.whole_greedy_decode_segment(
                *ops, z, z, sos, seg_len=4, **kw))[0],
            timed(torch, lambda: wd.whole_greedy_decode_segment_reference(
                *ops, z, z, sos, seg_len=4, **kw))[0]),
    }
    # K3 at the flagship beam's shapes: B x beam rows of GRU output
    from recnet_tpu_torch.ops.cuda import topk_proj as tp
    g = torch.Generator(device=DEVICE).manual_seed(6)
    hidden = torch.tanh(torch.randn((B * BEAM, cfg.hidden_size),
                                    generator=g, device=DEVICE)).to(dtype)
    w, b = params["out_w"], params["out_b"]
    kernel_ms["outproj_topk"] = (
        timed(torch, lambda: tp.outproj_topk(hidden, w, b, k=BEAM), reps=10)[0],
        timed(torch, lambda: tp.outproj_topk_reference(hidden, w, b, k=BEAM),
              reps=10)[0])
    # K4 per step; the K5 early exit on the PAD-timed weights and dual
    k4 = k4_operands(torch, cfg, params, enc, 14)
    k4kw = dict(emb_size=cfg.embedding_size)
    kernel_ms["fused_gru_attn_step"] = (
        timed(torch, lambda: fs.fused_gru_attn_step(*k4, **k4kw),
              reps=10)[0],
        timed(torch, lambda: fs.fused_gru_attn_step_reference(*k4, **k4kw),
              reps=10)[0])
    pad_ops = decode_operands(pad_params, enc)
    early = dict(max_len=T - 1, early_exit=True, **kw)
    kernel_ms["whole_greedy_decode[early_exit]"] = (
        timed(torch, lambda: wd.whole_greedy_decode(*pad_ops, **early))[0],
        timed(torch, lambda: wd.whole_greedy_decode_reference(
            *pad_ops, **early))[0])
    full_pad_ms = timed(torch, lambda: wd.whole_greedy_decode(
        *pad_ops, max_len=T - 1, **kw))[0]
    kernel_ms["whole_greedy_decode[dual]"] = (
        timed(torch, lambda: wd.whole_greedy_decode(
            *ops, max_len=T - 1, dual=True, **kw))[0],
        kernel_ms["whole_greedy_decode"][1])   # the twin of dual is K1's
    for name, (ms, plain) in kernel_ms.items():
        shape = f"N={B * BEAM} k={BEAM}" if name == "outproj_topk" else f"B={B}"
        log("times", f"{name} {shape} bf16: kernel {ms:.3f} ms, plain twin "
                     f"{plain:.3f} ms ({card})")
    log("times", f"PAD-timed weights B={B} bf16: K1 early_exit "
                 f"{kernel_ms['whole_greedy_decode[early_exit]'][0]:.3f} ms, "
                 f"full K1 {full_pad_ms:.3f} ms; dual "
                 f"{kernel_ms['whole_greedy_decode[dual]'][0]:.3f} ms against "
                 f"production K1 {kernel_ms['whole_greedy_decode'][0]:.3f} ms "
                 f"({card})")
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
    return kernel_ms


# --------------------------------------------------------------------------
# 6. the ablation sweep of K1
# --------------------------------------------------------------------------

def ablate_sweep(torch, tc, cfg, params_np):
    """The profiling sweep of benchmarks/profile_whole_decode.py on the
    card: K1 at B = TIME_B bf16, production, each ablated part and dual,
    through the ops-level wrapper, launches counted; then each timed, the
    production kernel first and last, and each part's cost as full -
    variant. Each ablated part's tokens are held against its twin's
    (BF16_ROWS of tokens equal), dual's against production's (all equal).
    Returns (launches by variant, {variant: (ms, twin ms)}, {variant: max
    |token - twin token|})."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.weights import params_from_jax
    T, dtype = tc.caption_max_len + 1, torch.bfloat16
    params = params_from_jax(params_np, DEVICE, dtype)
    enc = seeded_features(torch, TIME_B, tc.encoder_output_len, cfg, dtype,
                          3)
    ops = decode_operands(params, enc)
    kw = dict(emb_size=cfg.embedding_size, max_len=T - 1,
              cell_type=cfg.cell_type)
    variants = [("", {})] + [(f"ablate={p}", {"ablate": p})
                             for p in ABLATE_PARTS] + [("dual", {"dual": True})]
    reset_counts()
    tokens = {name: wd.whole_greedy_decode(*ops, **vkw, **kw)
              for name, vkw in variants}
    torch.cuda.synchronize()
    launches = dict(wd.whole_greedy_decode.variant_launches)
    log("ablate", f"sweep launches: production "
                  f"{wd.whole_greedy_decode.n_launches}, variants {launches}")
    check(wd.whole_greedy_decode.n_launches == 1
          and all(launches.get(name) == 1 for name, _ in variants[1:]),
          "the ablation sweep missed a variant")
    ms = {name: timed(torch, lambda vkw=vkw: wd.whole_greedy_decode(
              *ops, **vkw, **kw))[0] for name, vkw in variants}
    full = (ms[""] + timed(torch, lambda: wd.whole_greedy_decode(
        *ops, **kw))[0]) / 2
    card = card_line()
    log("ablate", f"K1 production B={TIME_B} bf16: {full:.3f} ms (mean of "
                  f"the first and last timing) on {card}")
    out, errs = {}, {}
    for name, vkw in variants[1:]:
        cost = full - ms[name]
        if "ablate" in vkw:    # against its twin, on the inputs it was timed on
            want = wd.whole_greedy_decode_reference(*ops, **vkw, **kw)
            plain = timed(torch, lambda vkw=vkw: (
                wd.whole_greedy_decode_reference(*ops, **vkw, **kw)))[0]
        else:                  # dual: the production tokens
            want, plain = tokens[""], None
        equal = (tokens[name] == want).float().mean().item()
        errs[name] = float((tokens[name] - want).abs().max())
        log("ablate", f"{name}: {ms[name]:.3f} ms; full - variant "
                      f"{cost:.3f} ms ({100 * cost / full:.1f}% of K1); "
                      f"tokens equal to its twin's {equal:.4f}")
        check(equal >= (1.0 if name == "dual" else BF16_ROWS),
              f"{name} bf16 B={TIME_B}: tokens equal {equal}")
        out[name] = (ms[name], plain)
    return launches, out, errs


def main() -> int:
    import torch

    environment(torch)
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
    kernel_ms = times(torch, tc, cfg, params_np, eos_np, pad_np)
    sweep_launches, sweep_ms, sweep_errs = ablate_sweep(torch, tc, cfg,
                                                        params_np)
    variant_launches.update(sweep_launches)
    for name, err in sweep_errs.items():
        variant_errs[name] = max(variant_errs[name], err)

    pallas = "recnet_tpu/ops/pallas/"
    csrc = "recnet_tpu_torch/csrc/"
    rows = [("whole_greedy_decode", "whole_decode.cu",
             "whole_decode.py:440"),
            ("whole_greedy_decode_segment", "whole_decode.cu",
             "whole_decode.py:360"),
            ("outproj_topk", "topk_proj.cu", "topk_proj.py:77"),
            ("fused_gru_attn_step", "fused_step.cu", "fused_step.py:92")]
    kernels = [{"name": name, "route": "cuda", "source": csrc + src,
                "replaces": pallas + tpu, "launches": launches[name],
                "max_abs_err": errs[name], "ms": kernel_ms[name][0],
                "plain_ms": kernel_ms[name][1]}
               for name, src, tpu in rows]
    for variant in ["early_exit", "dual"] + [f"ablate={p}"
                                             for p in ABLATE_PARTS]:
        name = f"whole_greedy_decode[{variant}]"
        ms, plain = kernel_ms.get(name) or sweep_ms[variant]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "whole_decode.cu",
            "replaces": pallas + "whole_decode.py:497",
            "launches": variant_launches[variant],
            "max_abs_err": variant_errs[variant], "ms": ms,
            "plain_ms": plain})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
