"""Smoke run of the PyTorch/CUDA port (recnet_tpu_torch) on one Hopper card.

    python3 chip_smoke.py          # from the repository root

Phases, one line or more each; any failure exits non-zero before a result:

1. environment: torch, CUDA, the card, TF32 off;
2. build: nvcc builds the port's CUDA kernels from this checkout;
3. kernels: K1 (whole decode) and K2 (decode segment) against their plain
   PyTorch twins at the flagship width, GRU and LSTM, f32 and bf16;
4. main path: the port's HTTP handler behind the MicroBatcher serves
   captions from a flagship-width bf16 Captioner (use_pallas,
   greedy_segment=4), with the kernels' launch counts read around it;
5. times: captions/s at B=1024 for the kernel and plain decode paths.

The weights are random, drawn from a numpy seed. The last three lines are
the card's name and power limit, a JSON line per kernel, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
    from recnet_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    path = build.build("whole_decode")
    build.load("whole_decode")
    log("build", f"nvcc {' '.join(build.NVCC_FLAGS)}: {path.name} in "
                 f"{time.perf_counter() - t0:.2f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())


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


# --------------------------------------------------------------------------
# 4. the main path: HTTP serving with the kernels
# --------------------------------------------------------------------------

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


def serve(captioner, model_id, requests):
    """POST ``requests`` concurrently through the port's handler behind a
    MicroBatcher; returns the captions of each request, in order."""
    from http.server import ThreadingHTTPServer
    from recnet_tpu_torch.cli.serve import make_handler
    from recnet_tpu_torch.serving import MicroBatcher

    front = MicroBatcher(captioner, flush_ms=6.0)
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 make_handler(front, model_id))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/caption"
    bodies = [json.dumps({"features": [f.tolist() for f in feats]}).encode()
              for feats in requests]
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


def eos_biased(torch, tc, cfg, params):
    """``params`` with out_b[<EOS>] raised so that <EOS> wins about
    EOS_WIN_SHARE of steps 1-3 of a plain-twin probe (f32, 64 rows), as a
    trained model's captions end; random weights never end. Step 0 is kept
    below <EOS>: random weights give nearly every row the same first
    logits, so a lift that wins there would end every caption at once."""
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    ops = decode_operands(seeded_params(cfg, torch.float32),
                          seeded_features(torch, 64, tc.encoder_output_len,
                                          cfg, torch.float32, 7))
    p = ops[0]
    H, gaps = cfg.hidden_size, []
    z = torch.zeros((64, H), device=DEVICE)
    state = (z, z, torch.full((64, 1), cfg.sos_token, dtype=torch.int32,
                              device=DEVICE))
    for _ in range(4):
        _, h, c, tok = wd.whole_greedy_decode_segment_reference(
            *ops, *state, emb_size=cfg.embedding_size, seg_len=1,
            cell_type=cfg.cell_type)
        logits = h @ p["out_w"] + p["out_b"]
        gaps.append(logits.max(dim=-1).values - logits[:, cfg.eos_token])
        state = (h, c, tok)
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

    wd.whole_greedy_decode.n_launches = 0
    wd.whole_greedy_decode_segment.n_launches = 0
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


def times(torch, tc, cfg, params_np, eos_np):
    from recnet_tpu_torch import decoding
    from recnet_tpu_torch.ops.attention import precompute_uv
    from recnet_tpu_torch.ops.cuda import whole_decode as wd
    from recnet_tpu_torch.weights import params_from_jax

    B, T, dtype = TIME_B, tc.caption_max_len + 1, torch.bfloat16
    params = params_from_jax(params_np, DEVICE, dtype)
    eos_params = params_from_jax(eos_np, DEVICE, dtype)
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
    for name, (ms, plain) in kernel_ms.items():
        log("times", f"{name} B={B} bf16: kernel {ms:.3f} ms, plain twin "
                     f"{plain:.3f} ms ({card})")
    paths = {
        "K2 segmented (greedy_segment=4, eos_stop)": lambda: (
            decoding.greedy_decode_whole_segmented(
                params, cfg, enc, T - 1, segment=4, eos_stop=True)),
        "K2 segmented, eos-biased weights": lambda: (
            decoding.greedy_decode_whole_segmented(
                eos_params, cfg, enc, T - 1, segment=4, eos_stop=True)),
        "K1 whole": lambda: decoding.greedy_decode_whole(
            params, cfg, enc, T - 1),
        "plain twin of K1": lambda: wd.whole_greedy_decode_reference(
            *decode_operands(params, enc), max_len=T - 1, **kw),
        "plain greedy_decode (early_exit)": lambda: decoding.greedy_decode(
            params, cfg, enc, T - 1, early_exit=True),
        "precompute_uv alone": lambda: precompute_uv(params["attention"],
                                                     enc),
    }
    for name, fn in paths.items():
        dev_ms, wall_ms = timed(torch, fn)
        log("times", f"{name}: B={B} bf16 {dev_ms:.3f} ms by CUDA events, "
                     f"{wall_ms:.3f} ms wall; {B / dev_ms * 1000:.0f} "
                     f"captions/s (events) {B / wall_ms * 1000:.0f} "
                     f"(wall) on {card}")
    return kernel_ms


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
    eos_np = eos_biased(torch, tc, cfg, params_np)
    launches = main_path(torch, tc, vocab, cfg, params_np, eos_np)
    kernel_ms = times(torch, tc, cfg, params_np, eos_np)

    replaces = {
        "whole_greedy_decode": "recnet_tpu/ops/pallas/whole_decode.py:440",
        "whole_greedy_decode_segment":
            "recnet_tpu/ops/pallas/whole_decode.py:360",
    }
    kernels = [{"name": name, "route": "cuda",
                "source": "recnet_tpu_torch/csrc/whole_decode.cu",
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": kernel_ms[name][0],
                "plain_ms": kernel_ms[name][1]}
               for name in replaces]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
