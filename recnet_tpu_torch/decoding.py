"""Greedy and beam decoding: the plain loops and the loops around the
decode kernels.

Port of ``recnet_tpu.decoding`` (reference eval.py:19-120):

* ``greedy_decode``: the argmax chain in plain PyTorch, freezing once every
  token is <PAD> and reporting ``n_steps``; ``early_exit`` stops there;
* ``greedy_decode_pallas``: the loop around kernel K4, one fused
  attention + GRU step per launch, the projection and argmax in torch;
* ``greedy_decode_whole``: the whole loop in one launch of kernel K1
  (``early_exit``: its K5 variant that stops a block once its tokens are 0);
* ``greedy_decode_whole_segmented``: K2 segments chained with a stop check
  between them (all <PAD>, or with ``eos_stop`` every row has seen <EOS>);
* ``beam_decode``: batched beam search with the reference's scoring, its
  per-beam top-K either plain or through kernel K3 (``use_pallas_topk``);
* ``sample_decode``: temperature / top-k sampling with greedy's freeze,
  its draws from a ``torch.Generator``.

Each stop and freeze reads a batch-wide value (all <PAD>, every row past
its <EOS>, the latest first <EOS>). ``across`` reduces such a value over
the shards of a batch that is decoded in pieces on several devices
(``serving.Captioner`` on a mesh), so that every piece stops where the
whole batch does; by default the batch is whole and the value is kept.

The segmented greedy decode and the beam search mark their phases with
spans (``utils.profiling``, off unless turned on): ``decode.greedy`` /
``decode.beam`` around the call, ``decode.prepare``, each
``decode.segment`` or ``decode.beam_step`` (``decode.beam_cell``,
``decode.beam_topk``, ``decode.beam_select``), and with ``waits`` each host
read of device data (``decode.stop_check``, ``decode.n_steps``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as nnf

from recnet_tpu_torch.models import decoder as dec_mod
from recnet_tpu_torch.ops import attention as attn_ops
from recnet_tpu_torch.ops import rnn as rnn_ops
from recnet_tpu_torch.ops.cuda import fused_step, topk_proj
from recnet_tpu_torch.ops.cuda import whole_decode as wd
from recnet_tpu_torch.utils.profiling import span


def whole_batch(x: torch.Tensor, op) -> torch.Tensor:
    """The default ``across``: the batch is whole on this device, so a
    value reduced over it with ``op`` (``torch.all``, ``torch.amax``) is
    already the batch-wide one."""
    return x


class GreedyResult(NamedTuple):
    tokens: torch.Tensor   # (T, B) int32, valid through n_steps
    n_steps: int


def kernels_supported(cfg: dec_mod.DecoderConfig, kind: str) -> bool:
    """Whether a hand-written decode kernel serves this config; the
    counterpart of ``recnet_tpu.decoding.pallas_supported``.

    ``"greedy_whole"`` (K1/K2): a GRU or LSTM with one layer.
    ``"beam_topk"`` (K3): any cell and depth; the kernel sees only the
    decoder output and the vocab projection.

    It decides by config only, so routing is the same on the CPU and on the
    card; the wrappers alone choose between the kernel (CUDA tensors) and
    its plain twin (CPU tensors)."""
    if kind == "greedy_whole":
        return cfg.cell_type in ("GRU", "LSTM") and cfg.n_layers == 1
    if kind == "beam_topk":
        return True
    raise ValueError(f"no ported kernel of kind {kind!r}")


def _make_step_logits(params: Dict, cfg: dec_mod.DecoderConfig,
                      encoder_outputs: torch.Tensor, uv: torch.Tensor):
    """fn(token, state) -> (logits, new_state), on the hoisted decode tables
    when the decoder has one layer."""
    if cfg.n_layers == 1:
        pre_table, encW, b_ih = dec_mod.hoisted_decode_tables(
            params, cfg, encoder_outputs)

        def step_logits(token, state):
            h, new_state = dec_mod.decoder_step_hoisted(
                params, cfg, token, state, uv, pre_table, encW, b_ih)
            return h @ params["out_w"] + params["out_b"], new_state
        return step_logits

    def step_logits(token, state):
        return dec_mod.decoder_step(params, cfg, token, state,
                                    encoder_outputs, uv)
    return step_logits


@torch.no_grad()
def greedy_decode(params: Dict, cfg: dec_mod.DecoderConfig,
                  encoder_outputs: torch.Tensor, max_len: int,
                  early_exit: bool = False,
                  across=whole_batch) -> GreedyResult:
    """Greedy argmax chain. Once every token of a step is <PAD> the state
    freezes and later steps emit <PAD>; ``n_steps`` counts the steps up to
    and including that one. ``early_exit`` stops the loop there instead,
    with the same output; it reads the stop flag on the host (a device
    sync per step)."""
    B, dev = encoder_outputs.shape[0], encoder_outputs.device
    T = max_len + 1
    uv = attn_ops.precompute_uv(params["attention"], encoder_outputs)
    step_logits = _make_step_logits(params, cfg, encoder_outputs, uv)
    state = dec_mod.zero_state(cfg, B, encoder_outputs.dtype, dev)
    token = torch.full((B,), cfg.sos_token, dtype=torch.int32, device=dev)
    tokens = torch.full((T, B), cfg.pad_token, dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_steps = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(T):
        if early_exit and bool(done):            # host sync
            break
        logits, new_state = step_logits(token, state)
        out = torch.argmax(logits, dim=-1).to(torch.int32)
        out = torch.where(done, cfg.pad_token, out).to(torch.int32)
        n_steps = torch.where(done, n_steps, t + 1).to(torch.int32)
        state = tuple(torch.where(done, o, n)
                      for n, o in zip(new_state, state))
        done = done | across((out == cfg.pad_token).all(), torch.all)
        tokens[t] = out
        token = out
    return GreedyResult(tokens, int(n_steps))


def _bias2(params: Dict) -> torch.Tensor:
    r = params["rnn"][0]
    return torch.stack([r["b_ih"], r["b_hh"]])


def _steps_to_first_all_pad(tokens: torch.Tensor, pad: int,
                            across=whole_batch) -> int:
    """n_steps of the reference's whole-batch break: the first step whose
    tokens are all <PAD>, counted inclusively; T when there is none."""
    all_pad = across((tokens == pad).all(dim=1), torch.all)
    hits = torch.nonzero(all_pad)
    return int(hits[0, 0]) + 1 if len(hits) else tokens.shape[0]


@torch.no_grad()
def greedy_decode_pallas(params: Dict, cfg: dec_mod.DecoderConfig,
                         encoder_outputs: torch.Tensor,
                         max_len: int) -> GreedyResult:
    """Greedy decode with kernel K4 (``fused_gru_attn_step``) doing the
    recurrent step: per step the embedding gather in torch, K4, then the
    vocab projection and ``torch.argmax`` (the first maximum, as
    ``jnp.argmax``) in torch, as JAX leaves them to XLA. Once every token of
    a step is <PAD>, h, the output and ``n_steps`` freeze. A fixed T-step
    loop with no host sync but the final ``n_steps``. The 1-layer GRU only;
    the name is the JAX counterpart's. K4's tensor-core route reads the
    parameter set's gate tiles (``params["layouts"]["gates"]``); its
    operands are checked once, at the first step (``step_launcher``)."""
    if cfg.cell_type != "GRU" or cfg.n_layers != 1:
        raise ValueError("K4 takes the 1-layer GRU decoder, not "
                         f"{cfg.n_layers} layer(s) of {cfg.cell_type}")
    B, dev = encoder_outputs.shape[0], encoder_outputs.device
    T = max_len + 1
    a, r = params["attention"], params["rnn"][0]
    uv = attn_ops.precompute_uv(a, encoder_outputs)
    bias3 = fused_step.pack_gru_bias(r["b_ih"], r["b_hh"])
    attn_b2 = a["b"][None, :]
    tiles = (params.get("layouts") or {}).get("gates")
    h = torch.zeros((B, cfg.hidden_size), dtype=encoder_outputs.dtype,
                    device=dev)
    token = torch.full((B,), cfg.sos_token, dtype=torch.int32, device=dev)
    tokens = torch.full((T, B), cfg.pad_token, dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_steps = torch.zeros((), dtype=torch.int32, device=dev)
    step = None
    for t in range(T):
        emb = params["embedding"][token] * cfg.embedding_scale
        if step is None:   # K4's operands checked once a decode
            step = fused_step.step_launcher(
                emb, h, encoder_outputs, uv, a["W"], a["w"], attn_b2,
                r["w_ih"], r["w_hh"], bias3, emb_size=cfg.embedding_size,
                tiles=tiles)
        h_new = step(emb, h)
        logits = h_new @ params["out_w"] + params["out_b"]
        out = torch.argmax(logits, dim=-1).to(torch.int32)
        out = torch.where(done, cfg.pad_token, out).to(torch.int32)
        n_steps = torch.where(done, n_steps, t + 1).to(torch.int32)
        h = torch.where(done, h, h_new)
        done = done | (out == cfg.pad_token).all()
        tokens[t] = out
        token = out
    return GreedyResult(tokens, int(n_steps))


@torch.no_grad()
def greedy_decode_whole(params: Dict, cfg: dec_mod.DecoderConfig,
                        encoder_outputs: torch.Tensor, max_len: int,
                        early_exit: bool = False,
                        across=whole_batch) -> GreedyResult:
    """Greedy decode with the whole loop in one launch of K1. Rows evolve
    independently, so the tokens equal ``greedy_decode``'s on the executed
    prefix; n_steps comes from the first all-<PAD> step.

    ``early_exit`` takes K5's variant: a block of 8 rows stops once all
    its tokens are 0, and its later tokens read 0. It equals the full
    decode unless a row emits a non-zero token after its whole block went
    to 0 (JAX's per-tile caveat, with a tile of 8 rows)."""
    if not kernels_supported(cfg, "greedy_whole"):
        raise ValueError("K1 takes a 1-layer GRU or LSTM decoder")
    uv = attn_ops.precompute_uv(params["attention"], encoder_outputs)
    tokens = wd.whole_greedy_decode(
        params, encoder_outputs, uv, _bias2(params),
        emb_size=cfg.embedding_size, max_len=max_len, sos=cfg.sos_token,
        cell_type=cfg.cell_type, emb_scale=cfg.embedding_scale,
        early_exit=early_exit).T
    return GreedyResult(tokens, _steps_to_first_all_pad(
        tokens, cfg.pad_token, across))


@torch.no_grad()
def greedy_decode_whole_segmented(params: Dict, cfg: dec_mod.DecoderConfig,
                                  encoder_outputs: torch.Tensor,
                                  max_len: int, segment: int = 8,
                                  eos_stop: bool = False,
                                  across=whole_batch) -> GreedyResult:
    """K2 segments of ``segment`` steps, carrying (h, c, token), until every
    current token is <PAD> or, with ``eos_stop``, every row has emitted an
    <EOS>. Tokens past the stop are <PAD>; with ``eos_stop`` the sentences
    (cut at the first <EOS>) equal the full decode's. The stop check between
    segments reads a flag on the host (one device sync per segment)."""
    if not kernels_supported(cfg, "greedy_whole"):
        raise ValueError("K2 takes a 1-layer GRU or LSTM decoder")
    B, dev = encoder_outputs.shape[0], encoder_outputs.device
    dtype = encoder_outputs.dtype
    T = max_len + 1
    n_seg = -(-T // segment)
    H = cfg.hidden_size
    with span("decode.greedy"):
        with span("decode.prepare"):
            uv = attn_ops.precompute_uv(params["attention"], encoder_outputs)
            bias2 = _bias2(params)
            h = torch.zeros((B, H), dtype=dtype, device=dev)
            c = torch.zeros((B, H), dtype=dtype, device=dev)
            tok = torch.full((B, 1), cfg.sos_token, dtype=torch.int32,
                             device=dev)
            seen_eos = torch.zeros((B, 1), dtype=torch.bool, device=dev)
            toks = torch.full((B, n_seg * segment), cfg.pad_token,
                              dtype=torch.int32, device=dev)
        for s in range(n_seg):
            stop = across((tok == cfg.pad_token).all(), torch.all)
            if eos_stop:
                stop = stop | across(seen_eos.all(), torch.all)
            with span("decode.stop_check", waits=True):
                stopped = bool(stop)                 # host sync
            if stopped:
                break
            with span("decode.segment"):
                tseg, h, c, tok = wd.whole_greedy_decode_segment(
                    params, encoder_outputs, uv, bias2, h, c, tok,
                    emb_size=cfg.embedding_size, seg_len=segment,
                    cell_type=cfg.cell_type, emb_scale=cfg.embedding_scale)
                toks[:, s * segment:(s + 1) * segment] = tseg
                seen_eos |= (tseg == cfg.eos_token).any(dim=1, keepdim=True)
        tokens = toks[:, :T].T
        with span("decode.n_steps", waits=True):
            n_steps = _steps_to_first_all_pad(tokens, cfg.pad_token, across)
    return GreedyResult(tokens, n_steps)


class BeamResult(NamedTuple):
    tokens: torch.Tensor   # (B, T) int32, the top beam, valid through n_steps
    n_steps: int
    scores: torch.Tensor   # (B, K) final cumulative scores


# log_sigmoid's saturation point: -log(f32 tiny), where exp(-x) leaves the
# f32 normal range (recnet_tpu.decoding.beam_decode)
_LOGSIG_SAT = float(-np.log(np.finfo(np.float32).tiny))


@torch.no_grad()
def beam_decode(params: Dict, cfg: dec_mod.DecoderConfig,
                encoder_outputs: torch.Tensor, beam_width: int,
                max_len: int, use_pallas_topk: bool = False,
                early_exit: bool = False,
                length_cutoff_margin: Optional[int] = None,
                across=whole_batch) -> BeamResult:
    """Batched beam search of width K (reference eval.py:36-120).

    Port of ``recnet_tpu.decoding.beam_decode`` with its quirks:

    * candidates score ``log(sigmoid(logit))``, not log-softmax;
    * the cumulative score is re-divided every step by ``len ** 0.7``, len
      being the position of the beam's LAST <EOS> plus one, else t + 1;
    * one live beam at t = 0 (the other slots start at -inf);
    * each beam keeps its own top-K of the raw logits, then a stable top-K
      over the K*K candidates (``lax.top_k`` order) picks the new beams;
    * logits are clamped at log_sigmoid's saturation point, -log(f32 tiny):
      the plain route clamps before it ranks, so saturated logits tie and
      rank by word; the kernel route (``use_pallas_topk``, kernel K3) ranks
      the raw logits and clamps the values it returns;
    * a sticky first-<EOS> register per beam, and once every token of a
      step is <PAD> the output-bearing state freezes and ``n_steps`` stops.

    ``early_exit`` stops the loop at that all-<PAD> step; the output is
    the same. ``length_cutoff_margin`` (implies ``early_exit``) also stops
    once every beam has a first <EOS> and the step is ``margin`` past the
    latest one, an approximation for serving. Both read a stop flag on the
    host each step. ``cum_prob`` is carried in the encoder dtype, as JAX
    does. A 1-layer decoder runs on the hoisted decode tables (a GRU
    without a cell state); deeper ones through ``_multilayer_rnn``."""
    early_exit = early_exit or (length_cutoff_margin is not None)
    B, F, _ = encoder_outputs.shape
    K = beam_width
    T = max_len + 1
    dtype, dev = encoder_outputs.dtype, encoder_outputs.device
    a = params["attention"]
    hoist = cfg.n_layers == 1
    is_gru = cfg.cell_type == "GRU" and hoist

    def compute_scores(query):
        wh = query @ a["W"]                                       # (B, K, A)
        return (torch.tanh(wh[:, :, None, :] + uv[:, None] + a["b"])
                * a["w"][:, 0]).sum(-1)                           # (B, K, F)

    def beam_decoder_step(tokens, h, c):
        """One decoder step for all B*K beams against the shared encoder;
        returns (out (B*K, H), h, c) with h, c shaped like the inputs."""
        query = h if hoist else h[:, :, -1]
        scores = compute_scores(query)
        if hoist:
            gi = (pre_table[tokens]
                  + torch.einsum("bkf,bfg->bkg", scores, encW) / F
                  + b_ih).reshape(B * K, -1)
            if is_gru:
                nh = rnn_ops.gru_cell_pre(params["rnn"][0], gi,
                                          h.reshape(B * K, -1))
                return nh, nh.reshape(B, K, -1), c
            nh, nc = rnn_ops.lstm_cell_pre(
                params["rnn"][0], gi,
                (h.reshape(B * K, -1), c.reshape(B * K, -1)))
            return nh, nh.reshape(B, K, -1), nc.reshape(B, K, -1)
        emb = params["embedding"][tokens] * cfg.embedding_scale   # (B, K, E)
        ctx = torch.einsum("bkf,bfe->bke", scores, encoder_outputs) / F
        x = torch.cat([emb, ctx], dim=-1).reshape(B * K, -1)
        flat = lambda s: s.reshape(B * K, cfg.n_layers, -1).movedim(1, 0)
        out, (nh, nc) = dec_mod._multilayer_rnn(
            cfg, params["rnn"], x, (flat(h), flat(c)))
        unflat = lambda s: s.movedim(0, 1).reshape(B, K, cfg.n_layers, -1)
        return out, unflat(nh), unflat(nc)

    def per_beam_topk(out):
        """Top-K of ``out @ out_w + out_b`` per row: (values, words)."""
        if use_pallas_topk:
            vals, idxs = topk_proj.outproj_topk(
                out, params["out_w"], params["out_b"], k=K,
                padded_w=(params.get("layouts") or {}).get("out_w_padded"))
            return torch.minimum(vals.to(dtype), sat), idxs
        return topk_proj.topk_rounds(
            torch.minimum(out @ params["out_w"] + params["out_b"], sat), K)

    def gather_beams(x, src):
        """Rows of (B, K, ...) x regathered by source beam src (B, K)."""
        index = src.reshape((B, K) + (1,) * (x.dim() - 2)).expand(x.shape)
        return torch.gather(x, 1, index)

    L, H = cfg.n_layers, cfg.hidden_size
    state_shape = (B, K, H) if hoist else (B, K, L, H)
    with span("decode.beam"):
        with span("decode.prepare"):
            uv = attn_ops.precompute_uv(a, encoder_outputs)  # shared by beams
            if hoist:
                pre_table, encW, b_ih = dec_mod.hoisted_decode_tables(
                    params, cfg, encoder_outputs)
            sat = torch.tensor(_LOGSIG_SAT, dtype=dtype, device=dev)
            h = torch.zeros(state_shape, dtype=dtype, device=dev)
            c = (torch.zeros((1, 1, 1), dtype=dtype, device=dev) if is_gru
                 else torch.zeros(state_shape, dtype=dtype, device=dev))
            tokens = torch.full((B, K), cfg.sos_token, dtype=torch.int32,
                                device=dev)
            cum_prob = torch.full((B, K), float("-inf"), dtype=dtype,
                                  device=dev)
            cum_prob[:, 0] = 0.0                 # one live beam at t = 0
            last_eos = torch.full((B, K), -1, dtype=torch.int32, device=dev)
            first_eos = torch.full((B, K), -1, dtype=torch.int32, device=dev)
            history = torch.full((B, K, T), cfg.pad_token, dtype=torch.int32,
                                 device=dev)
            done = torch.zeros((), dtype=torch.bool, device=dev)
            n_steps = torch.zeros((), dtype=torch.int32, device=dev)

        for t in range(T):
            if early_exit:
                stop = done
                if length_cutoff_margin is not None:
                    stop = stop | (
                        across((first_eos >= 0).all(), torch.all)
                        & (t >= across(first_eos.max(), torch.amax) + 1
                           + length_cutoff_margin))
                with span("decode.stop_check", waits=True):
                    stopped = bool(stop)         # host sync
                if stopped:
                    break
            with span("decode.beam_step"):
                with span("decode.beam_cell"):
                    out, nh, nc = beam_decoder_step(tokens, h, c)
                with span("decode.beam_topk"):
                    pb_val, pb_idx = per_beam_topk(out)          # (B*K, K)
                with span("decode.beam_select"):
                    # length-penalised cumulative score (eval.py:51-63)
                    seq_len = torch.where(last_eos >= 0, last_eos + 1,
                                          t + 1).to(dtype)
                    penalized = cum_prob / seq_len ** 0.7
                    cand = (penalized.reshape(B * K, 1)
                            + nnf.logsigmoid(pb_val)).reshape(B, K * K)
                    # a stable descending sort keeps lax.top_k's order
                    # among equals
                    top_val, top_i = torch.sort(cand, dim=1, descending=True,
                                                stable=True)
                    top_val, top_i = top_val[:, :K], top_i[:, :K]
                    src = torch.div(top_i, K, rounding_mode="floor")
                    word = torch.gather(pb_idx.reshape(B, K * K), 1, top_i)

                    h = gather_beams(nh, src)
                    c = c if is_gru else gather_beams(nc, src)
                    new_hist = gather_beams(history, src)
                    new_hist[:, :, t] = word
                    new_last_eos = torch.where(
                        word == cfg.eos_token, t,
                        torch.gather(last_eos, 1, src))
                    inherited = torch.gather(first_eos, 1, src)
                    new_first_eos = torch.where(
                        inherited >= 0, inherited,
                        torch.where(word == cfg.eos_token, t, -1)
                    ).to(torch.int32)

                    # freeze the output-bearing state once done (the
                    # reference's break)
                    keep = lambda n, o: torch.where(done, o, n)
                    tokens = keep(word, tokens)
                    cum_prob = keep(top_val, cum_prob)
                    last_eos = keep(new_last_eos, last_eos)
                    first_eos = keep(new_first_eos, first_eos)
                    history = keep(new_hist, history)
                    n_steps = torch.where(done, n_steps, t + 1)
                    done = done | across((word == cfg.pad_token).all(),
                                         torch.all)
        with span("decode.n_steps", waits=True):
            n = int(n_steps)
    return BeamResult(history[:, 0, :], n, cum_prob)


@torch.no_grad()
def sample_decode(params: Dict, cfg: dec_mod.DecoderConfig,
                  encoder_outputs: torch.Tensor, max_len: int,
                  generator: torch.Generator, temperature: float = 1.0,
                  top_k: int = 0) -> GreedyResult:
    """Stochastic decoding over the softmax of logits / temperature (the
    temperature floored at 1e-6); ``top_k`` > 0 keeps the logits at or
    above the k-th largest. One draw a step (the Gumbel-max trick, as
    ``jax.random.categorical``) from ``generator``, which lies on the
    features' device. Greedy's freeze once every token is <PAD>. A new
    capability of the JAX package (the reference has greedy and beam
    only); the draws differ from JAX's."""
    B, dev = encoder_outputs.shape[0], encoder_outputs.device
    T = max_len + 1
    uv = attn_ops.precompute_uv(params["attention"], encoder_outputs)
    step_logits = _make_step_logits(params, cfg, encoder_outputs, uv)
    state = dec_mod.zero_state(cfg, B, encoder_outputs.dtype, dev)
    token = torch.full((B,), cfg.sos_token, dtype=torch.int32, device=dev)
    tokens = torch.full((T, B), cfg.pad_token, dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_steps = torch.zeros((), dtype=torch.int32, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    for t in range(T):
        logits, new_state = step_logits(token, state)
        logits = logits.float() / max(temperature, 1e-6)
        if top_k > 0:
            kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
            logits = torch.where(logits < kth, -torch.inf, logits)
        u = torch.rand(logits.shape, generator=generator, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
        out = torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
        out = torch.where(done, cfg.pad_token, out).to(torch.int32)
        n_steps = torch.where(done, n_steps, t + 1).to(torch.int32)
        state = tuple(torch.where(done, o, n)
                      for n, o in zip(new_state, state))
        done = done | (out == cfg.pad_token).all()
        tokens[t] = out
        token = out
    return GreedyResult(tokens, int(n_steps))


def tokens_to_sentences(idxs, idx2word, eos_token: int) -> List[str]:
    """(T, B) token ids -> one sentence per row, cut at the first <EOS>
    (reference utils.py:11-20). A copy of the JAX package's numpy helper,
    whose module imports jax."""
    arr = np.asarray(idxs).T
    sentences = []
    for row in arr:
        words = []
        for idx in row:
            if int(idx) == eos_token:
                break
            words.append(idx2word[int(idx)])
        sentences.append(" ".join(words))
    return sentences
