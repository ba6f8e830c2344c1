"""Greedy decoding: the plain loop and the loops around the decode kernels.

Port of the greedy half of ``recnet_tpu.decoding`` (reference eval.py:19-33):

* ``greedy_decode``: the argmax chain in plain PyTorch, freezing once every
  token is <PAD> and reporting ``n_steps``; ``early_exit`` stops there;
* ``greedy_decode_whole``: the whole loop in one launch of kernel K1;
* ``greedy_decode_whole_segmented``: K2 segments chained with a stop check
  between them (all <PAD>, or with ``eos_stop`` every row has seen <EOS>).

Beam search and sampling are not ported yet (ROADMAP Queue 1, item 6).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from recnet_tpu_torch.models import decoder as dec_mod
from recnet_tpu_torch.ops import attention as attn_ops
from recnet_tpu_torch.ops.cuda import whole_decode as wd


class GreedyResult(NamedTuple):
    tokens: torch.Tensor   # (T, B) int32, valid through n_steps
    n_steps: int


def kernels_supported(cfg: dec_mod.DecoderConfig, kind: str) -> bool:
    """Whether a hand-written decode kernel serves this config; the
    counterpart of ``recnet_tpu.decoding.pallas_supported``.

    ``"greedy_whole"`` (K1/K2): a GRU or LSTM with one layer. It decides by
    config only, so routing is the same on the CPU and on the card; the
    wrappers alone choose between the kernel (CUDA tensors) and its plain
    twin (CPU tensors)."""
    if kind == "greedy_whole":
        return cfg.cell_type in ("GRU", "LSTM") and cfg.n_layers == 1
    raise ValueError(f"no ported kernel of kind {kind!r}; the beam top-K "
                     "kernel is ROADMAP Queue 2, K3")


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
                  early_exit: bool = False) -> GreedyResult:
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
        done = done | (out == cfg.pad_token).all()
        tokens[t] = out
        token = out
    return GreedyResult(tokens, int(n_steps))


def _bias2(params: Dict) -> torch.Tensor:
    r = params["rnn"][0]
    return torch.stack([r["b_ih"], r["b_hh"]])


def _steps_to_first_all_pad(tokens: torch.Tensor, pad: int) -> int:
    """n_steps of the reference's whole-batch break: the first step whose
    tokens are all <PAD>, counted inclusively; T when there is none."""
    all_pad = (tokens == pad).all(dim=1)
    hits = torch.nonzero(all_pad)
    return int(hits[0, 0]) + 1 if len(hits) else tokens.shape[0]


@torch.no_grad()
def greedy_decode_whole(params: Dict, cfg: dec_mod.DecoderConfig,
                        encoder_outputs: torch.Tensor,
                        max_len: int) -> GreedyResult:
    """Greedy decode with the whole loop in one launch of K1. Rows evolve
    independently, so the tokens equal ``greedy_decode``'s on the executed
    prefix; n_steps comes from the first all-<PAD> step."""
    if not kernels_supported(cfg, "greedy_whole"):
        raise ValueError("K1 takes a 1-layer GRU or LSTM decoder")
    uv = attn_ops.precompute_uv(params["attention"], encoder_outputs)
    tokens = wd.whole_greedy_decode(
        params, encoder_outputs, uv, _bias2(params),
        emb_size=cfg.embedding_size, max_len=max_len, sos=cfg.sos_token,
        cell_type=cfg.cell_type, emb_scale=cfg.embedding_scale).T
    return GreedyResult(tokens,
                        _steps_to_first_all_pad(tokens, cfg.pad_token))


@torch.no_grad()
def greedy_decode_whole_segmented(params: Dict, cfg: dec_mod.DecoderConfig,
                                  encoder_outputs: torch.Tensor,
                                  max_len: int, segment: int = 8,
                                  eos_stop: bool = False) -> GreedyResult:
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
    uv = attn_ops.precompute_uv(params["attention"], encoder_outputs)
    bias2 = _bias2(params)
    h = torch.zeros((B, H), dtype=dtype, device=dev)
    c = torch.zeros((B, H), dtype=dtype, device=dev)
    tok = torch.full((B, 1), cfg.sos_token, dtype=torch.int32, device=dev)
    seen_eos = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    toks = torch.full((B, n_seg * segment), cfg.pad_token,
                      dtype=torch.int32, device=dev)
    for s in range(n_seg):
        stop = (tok == cfg.pad_token).all()
        if eos_stop:
            stop = stop | seen_eos.all()
        if bool(stop):                           # host sync
            break
        tseg, h, c, tok = wd.whole_greedy_decode_segment(
            params, encoder_outputs, uv, bias2, h, c, tok,
            emb_size=cfg.embedding_size, seg_len=segment,
            cell_type=cfg.cell_type, emb_scale=cfg.embedding_scale)
        toks[:, s * segment:(s + 1) * segment] = tseg
        seen_eos |= (tseg == cfg.eos_token).any(dim=1, keepdim=True)
    tokens = toks[:, :T].T
    return GreedyResult(tokens,
                        _steps_to_first_all_pad(tokens, cfg.pad_token))


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
