"""Attention RNN caption decoder.

Port of ``recnet_tpu.models.decoder``: embedding * scale + dropout,
*unnormalised* additive attention over the encoder features (scores
mean-pool the values), an LSTM/GRU stack with inter-layer dropout, and the
vocab projection + dropout. The training side: ``init_decoder_params``, the
train path of ``decoder_step`` and the two teacher-forced rollouts
(``teacher_forced_rollout``, one teacher-forcing decision per iteration,
and ``teacher_forced_rollout_fast`` for ratio 1.0, with the embedding
gather, the embedding-side gate term (one layer) and the vocab projection
hoisted out of the loop). Dropout masks come from a ``torch.Generator``;
autograd gives the gradients, at one layer through ``tf_attn_rollout``,
the JAX package's custom VJP as a ``torch.autograd.Function`` on the
per-step kernels of ``ops/cuda/rollout.py``.

On a mesh the training side takes the step's ``parallel.mesh.Shard``: the
batch rows are this rank's, the embedding, ``out_w`` and ``out_b`` may be
its vocabulary shards (``parallel.vocab`` does the lookup, the projection
and the argmax), and each dropout mask is drawn at the global shape from
the step's shared generator and cut to the rank's rows and columns, so
that every rank keeps the mask a single-device run draws.

Parameters are a nested dict in the JAX layout:
``embedding (V, E)``, ``attention{W (H,A), U (F,A), b (A,), w (A,1)}``,
``rnn[i]{w_ih (in, nG*H), w_hh (H, nG*H), b_ih, b_hh}``, ``out_w (H, V)``,
``out_b (V,)``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from recnet_tpu_torch.ops import attention as attn_ops
from recnet_tpu_torch.ops import rnn as rnn_ops
from recnet_tpu_torch.ops.cuda import gemm, rollout
from recnet_tpu_torch.parallel import vocab as vocab_par

State = Tuple[torch.Tensor, torch.Tensor]


class DecoderConfig(NamedTuple):
    """Static hyperparameters; the same fields as the JAX DecoderConfig."""
    cell_type: str = "GRU"            # ["LSTM", "GRU"]
    n_layers: int = 1
    vocab_size: int = 4188
    embedding_size: int = 468
    embedding_scale: float = 1.0
    encoder_size: int = 1536
    hidden_size: int = 512
    attn_size: int = 128
    embedding_dropout: float = 0.5
    dropout: float = 0.5              # inter-layer RNN dropout
    out_dropout: float = 0.5
    sos_token: int = 1
    pad_token: int = 0
    eos_token: int = 2


def config_from_train(tc, vocab_size: int) -> DecoderConfig:
    """Build a DecoderConfig from a recnet_tpu TrainConfig."""
    return DecoderConfig(
        cell_type=tc.decoder_model,
        n_layers=tc.decoder_n_layers,
        vocab_size=vocab_size,
        embedding_size=tc.embedding_size,
        embedding_scale=tc.embedding_scale,
        encoder_size=tc.encoder_output_size,
        hidden_size=tc.decoder_hidden_size,
        attn_size=tc.decoder_attn_size,
        embedding_dropout=tc.embedding_dropout,
        dropout=tc.decoder_dropout,
        out_dropout=tc.decoder_out_dropout,
        sos_token=tc.init_word2idx_dict["<SOS>"],
        pad_token=tc.init_word2idx_dict["<PAD>"],
        eos_token=tc.init_word2idx_dict["<EOS>"],
    )


def init_decoder_params(generator: torch.Generator, cfg: DecoderConfig,
                        dtype=torch.float32) -> Dict:
    """The JAX initialiser's distributions, drawn from ``generator`` on its
    device: embedding N(0, 1), attention and RNN as their modules' inits,
    out_w and out_b U(-1/sqrt(H), 1/sqrt(H))."""
    dev = generator.device
    bound = 1.0 / cfg.hidden_size ** 0.5
    emb = torch.empty((cfg.vocab_size, cfg.embedding_size), dtype=dtype,
                      device=dev).normal_(generator=generator)
    attention = attn_ops.init_attention_params(
        generator, cfg.hidden_size, cfg.encoder_size, cfg.attn_size, dtype)
    rnn = [rnn_ops.init_rnn_params(
        generator, cfg.cell_type,
        cfg.embedding_size + cfg.encoder_size if li == 0
        else cfg.hidden_size, cfg.hidden_size, dtype)
        for li in range(cfg.n_layers)]

    def u(*shape):
        return torch.empty(shape, dtype=dtype, device=dev).uniform_(
            -bound, bound, generator=generator)
    return {"embedding": emb, "attention": attention, "rnn": rnn,
            "out_w": u(cfg.hidden_size, cfg.vocab_size),
            "out_b": u(cfg.vocab_size)}


def zero_state(cfg: DecoderConfig, batch_size: int, dtype=torch.float32,
               device="cpu") -> State:
    """(h, c), each (L, B, H), zero."""
    z = torch.zeros((cfg.n_layers, batch_size, cfg.hidden_size),
                    dtype=dtype, device=device)
    return z, z


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator],
             train: bool, shard=None, batch_dim: int = 0,
             vocab_dim: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). Identity unless training with a
    generator and rate > 0. With a ``shard`` the mask is drawn at the
    global shape (the whole batch along ``batch_dim``, the whole vocabulary
    along ``vocab_dim``) and cut to this rank's part."""
    if not train or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape, part = list(x.shape), [slice(None)] * x.dim()
    if shard is not None:
        start, stop, shape[batch_dim] = shard.rows
        part[batch_dim] = slice(start, stop)
        if vocab_dim is not None:
            start, stop, shape[vocab_dim] = shard.cols
            part[vocab_dim] = slice(start, stop)
    mask = torch.rand(shape, generator=generator,
                      device=x.device)[tuple(part)] < keep
    return torch.where(mask, x / keep, 0.0)


def _multilayer_rnn(cfg, params_layers, x: torch.Tensor, state: State,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False, shard=None):
    """Stacked cells with dropout between layers (nn.RNN's ``dropout``);
    ``cfg`` needs ``cell_type`` and ``dropout`` (the decoder's and the
    reconstructors' configs have both)."""
    h, c = state
    new_h, new_c = [], []
    inp = x
    for li, p in enumerate(params_layers):
        hi, ci = rnn_ops.rnn_step(cfg.cell_type, p, inp, (h[li], c[li]))
        new_h.append(hi)
        new_c.append(ci)
        inp = hi
        if li + 1 < len(params_layers):
            inp = _dropout(inp, cfg.dropout, generator, train, shard)
    return inp, (torch.stack(new_h), torch.stack(new_c))


def decoder_step(params: Dict, cfg: DecoderConfig, token: torch.Tensor,
                 state: State, encoder_outputs: torch.Tensor,
                 uv: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 train: bool = False,
                 shard=None) -> Tuple[torch.Tensor, State]:
    """One decode step; ``train`` with a ``generator`` applies the
    embedding, inter-layer and output dropout.

    token (B,) int; state (h, c) each (L, B, H); encoder_outputs (B, F, enc);
    uv (B, F, A). Returns (logits (B, V), new_state); on a 'model' axis
    (``shard``) the logits are the rank's vocabulary columns.
    """
    emb = vocab_par.embed(params["embedding"], token, shard) \
        * cfg.embedding_scale
    emb = _dropout(emb, cfg.embedding_dropout, generator, train, shard)
    context = attn_ops.attend_mean(params["attention"], state[0][-1],
                                   encoder_outputs, uv)
    x = torch.cat([emb, context], dim=-1)
    output, new_state = _multilayer_rnn(cfg, params["rnn"], x, state,
                                        generator, train, shard)
    logits = vocab_par.project(output, params["out_w"], params["out_b"],
                               shard)
    return _dropout(logits, cfg.out_dropout, generator, train, shard,
                    vocab_dim=1), new_state


class DecoderRollout(NamedTuple):
    logits: torch.Tensor          # (T, B, V)
    hiddens: torch.Tensor         # (T, L, B, H): every layer's h per step
    greedy_tokens: torch.Tensor   # (T, B) int32 argmax chain


def teacher_forced_rollout(params: Dict, cfg: DecoderConfig,
                           encoder_outputs: torch.Tensor,
                           targets: torch.Tensor, use_teacher_forcing: bool,
                           generator: Optional[torch.Generator] = None,
                           train: bool = False,
                           shard=None) -> DecoderRollout:
    """The T-step rollout (reference train.py:41-67). targets (T, B) int.
    ``use_teacher_forcing`` is one decision for the whole batch and
    sequence (the reference draws one Bernoulli per iteration,
    train.py:37-38): feed the targets, or else each step's argmax (over
    the whole vocabulary on a 'model' axis)."""
    T, B = targets.shape
    uv = attn_ops.precompute_uv(params["attention"], encoder_outputs)
    state = zero_state(cfg, B, encoder_outputs.dtype, encoder_outputs.device)
    token = torch.full((B,), cfg.sos_token, dtype=torch.int32,
                       device=encoder_outputs.device)
    logits, hiddens, greedy = [], [], []
    for t in range(T):
        step_logits, state = decoder_step(params, cfg, token, state,
                                          encoder_outputs, uv, generator,
                                          train, shard)
        out = vocab_par.argmax(step_logits, shard)
        token = targets[t] if use_teacher_forcing else out
        logits.append(step_logits)
        hiddens.append(state[0])
        greedy.append(out)
    return DecoderRollout(torch.stack(logits), torch.stack(hiddens),
                          torch.stack(greedy))


def teacher_forced_rollout_fast(params: Dict, cfg: DecoderConfig,
                                encoder_outputs: torch.Tensor,
                                targets: torch.Tensor,
                                generator: Optional[torch.Generator] = None,
                                train: bool = False,
                                shard=None) -> DecoderRollout:
    """``teacher_forced_rollout`` for teacher forcing always on: every
    step's input token is known up front, so the embedding gather (and, at
    one layer, its gate term emb @ w_ih[:E] + b_ih) and the vocab
    projection run once for all T steps; the loop keeps the attention, the
    context's gate term and the cell. Equal to the generic rollout in eval
    mode; the dropout masks are drawn in another order."""
    T, B = targets.shape
    dev = encoder_outputs.device
    uv = attn_ops.precompute_uv(params["attention"], encoder_outputs)
    inputs = torch.cat([torch.full((1, B), cfg.sos_token,
                                   dtype=targets.dtype, device=dev),
                        targets[:-1]])
    emb_all = vocab_par.embed(params["embedding"], inputs, shard) \
        * cfg.embedding_scale                                    # (T, B, E)
    emb_all = _dropout(emb_all, cfg.embedding_dropout, generator, train,
                       shard, batch_dim=1)
    att = params["attention"]
    if cfg.n_layers == 1:
        r0, E = params["rnn"][0], cfg.embedding_size
        gi_emb = gemm.matmul(emb_all, r0["w_ih"][:E], r0["b_ih"])  # (T, B, G)
        hs = tf_attn_rollout(cfg.cell_type, att, r0["w_ih"][E:], r0["w_hh"],
                             r0["b_hh"], encoder_outputs, uv, gi_emb)
        hiddens = hs[:, None]                                   # (T, 1, B, H)
    else:
        state = zero_state(cfg, B, encoder_outputs.dtype, dev)
        hs = []
        for t in range(T):
            context = attn_ops.attend_mean(att, state[0][-1],
                                           encoder_outputs, uv)
            _, state = _multilayer_rnn(
                cfg, params["rnn"], torch.cat([emb_all[t], context], -1),
                state, generator, train, shard)
            hs.append(state[0])
        hiddens = torch.stack(hs)
    logits = vocab_par.project(hiddens[:, -1], params["out_w"],
                               params["out_b"], shard)           # (T, B, V)
    logits = _dropout(logits, cfg.out_dropout, generator, train, shard,
                      batch_dim=1, vocab_dim=2)
    return DecoderRollout(logits, hiddens, vocab_par.argmax(logits, shard))


def tf_attn_rollout_reference(cell_type: str, att: Dict,
                              w_enc: torch.Tensor, w_hh: torch.Tensor,
                              b_hh: torch.Tensor, enc: torch.Tensor,
                              uv: torch.Tensor,
                              gi_emb: torch.Tensor) -> torch.Tensor:
    """``tf_attn_rollout`` as a plain loop over T (autograd records every
    op of every step)."""
    T, B, _ = gi_emb.shape
    F = enc.shape[1]
    r0 = {"w_hh": w_hh, "b_hh": b_hh}
    h, c = rnn_ops.zero_state(B, w_hh.shape[0], enc.dtype, enc.device)
    hs = []
    for t in range(T):
        scores = attn_ops.attention_scores(att, h, uv)
        ctx = torch.einsum("bf,bfe->be", scores, enc) / F
        h, c = rnn_ops.rnn_step_pre(cell_type, r0, gi_emb[t] + ctx @ w_enc,
                                    (h, c))
        hs.append(h)
    return torch.stack(hs)


class _TfAttnRollout(torch.autograd.Function):
    """``tf_attn_rollout``: the teacher-forced one-layer recurrence,
    attention + cell, forward and backward (``_tf_rollout_fwd`` /
    ``_tf_rollout_bwd`` of ``recnet_tpu/models/decoder.py``).

    The attention's W shares its products with w_hh: one (H, G + A)
    weight ``[w_hh | W]``, so that ``h [w_hh | W]`` gives a step's gh and
    wh = h W in one product, and ``[dgh | dwh] [w_hh | W]^T`` gives
    dh_prev's two terms in one. Forward, a step: that product (GRU into
    the step's (B, G + A) row of a buffer; LSTM added in place to a copy
    of gi_emb laid out with A zero columns, which take wh), the attention
    kernel from wh (scores and ctx into the rollout's buffers), ``gi +=
    ctx w_enc`` in place, the cell kernel. It keeps hs, cs (LSTM), the
    activations, every step's wh, the scores and the contexts. Backward:
    ``ACT = tanh(wh + uv + b)`` once for all T (the loop's attention kernel
    reads it, and so do the contractions for d_uv, db and dw after the
    loop, as in the JAX backward's U2); a step is the cell's backward
    kernel (dgh into a (T, B, G + A) buffer beside dwh), ``dctx = dgi
    w_enc^T``, the attention's backward kernel (dwh beside dgh), and
    ``dh_prev = dh_cell + [dgh | dwh] [w_hh | W]^T``. The weight gradients,
    d_uv and ``d(enc) = sum_t scores (x) dctx / F`` (the saved scores) are
    stacked contractions after the loop (d(enc) only when enc needs a
    gradient: the train step's videos do not). U's gradient is None: it
    reaches U through ``precompute_uv``'s autograd from d_uv (the JAX
    backward returns zeros for it). Every product is ``gemm.mm``: in f32
    on the card the three-term TF32 kernel, into or onto the buffers' rows
    (``out=``, ``accumulate``); under autocast and on the CPU torch's."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, cell_type, W, U, b, w, w_enc, w_hh, b_hh, enc, uv,
                gi_emb):
        ctx.cell_type = cell_type
        ctx.dtypes = [x.dtype for x in (W, U, b, w, w_enc, w_hh, b_hh, enc,
                                        uv, gi_emb)]
        dt = rnn_ops.compute_dtype(gi_emb)
        b, w, w_enc, b_hh, enc, uv = rnn_ops.cast_operands(
            dt, b, w, w_enc, b_hh, enc, uv)
        w_cat = torch.cat([w_hh, W], 1).to(dt)          # (H, G + A)
        lstm = cell_type == "LSTM"
        T, B, G = gi_emb.shape
        H, F, E, A = w_hh.shape[0], enc.shape[1], enc.shape[2], W.shape[1]
        if lstm:       # gains h [w_hh | W], then ctx w_enc
            gw = torch.cat([gi_emb.to(dt),
                            gi_emb.new_zeros((T, B, A), dtype=dt)], -1)
            gi = gw[..., :G]
        else:          # gi gains ctx w_enc; gw's rows are h [w_hh | W]
            gi = gi_emb.to(dt, copy=True).contiguous()
            gw = gi.new_empty((T, B, G + A))
        hs = gi.new_empty((T, B, H))
        cs = torch.empty_like(hs) if lstm else None
        acts = gi.new_empty((T, B, 4 * H))
        scores = gi.new_empty((T, B, F))
        ctxs = gi.new_empty((T, B, E))
        h0 = gi.new_zeros((B, H))
        attend = rollout.attention_forward_steps(gw[..., G:], uv, b, w, enc,
                                                 scores, ctxs)
        cell = rollout.cell_forward_steps(cell_type, gi, None if lstm else
                                          gw[..., :G], b_hh, h0,
                                          h0 if lstm else None, hs, cs, acts)
        h_prev, ctx_t = (h0,) + hs.unbind(0)[:-1], ctxs.unbind(0)
        for t in range(T):
            gemm.mm(h_prev[t], w_cat, out=gw[t], accumulate=lstm)
            attend(t)
            gemm.mm(ctx_t[t], w_enc, out=gi[t], accumulate=True)
            cell(t)
        if not lstm:
            cs = hs.new_empty((0,))
        ctx.save_for_backward(w_cat, b, w, w_enc, enc, uv, hs, cs, acts,
                              gw, scores, ctxs)
        return hs

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dhs):
        (w_cat, b, w, w_enc, enc, uv, hs, cs, acts, gw, scores,
         ctxs) = ctx.saved_tensors
        lstm = ctx.cell_type == "LSTM"
        dhs = dhs.to(hs.dtype).contiguous()
        T, B, H = hs.shape
        F, E, A = enc.shape[1], enc.shape[2], uv.shape[2]
        G = w_cat.shape[1] - A
        z0 = hs.new_zeros((1, B, H))
        h_prev = torch.cat([z0, hs[:-1]])
        c_prev = torch.cat([z0, cs[:-1]]) if lstm else None
        act = (gw[..., G:][:, :, None, :] + uv).add_(b).tanh_()  # (T,B,F,A)
        dgw = hs.new_empty((T, B, G + A))       # [dgh | dwh] a step
        dgh, dwh = dgw[..., :G], dgw[..., G:]
        dgi = dgh if lstm else hs.new_empty((T, B, G))
        dctx = hs.new_empty((T, B, E))
        dsc = hs.new_empty((T, B, F))
        dh = torch.zeros_like(hs[0])
        dc = torch.zeros_like(hs[0]) if lstm else None
        cell = rollout.cell_backward_steps(ctx.cell_type, dh, dhs, dc, acts,
                                           h_prev, c_prev, cs if lstm else
                                           None, dgi, None if lstm else dgh)
        attend = rollout.attention_backward_steps(dctx, enc, act, w, dsc,
                                                  dwh)
        w_cat_t, w_enc_t = w_cat.t(), w_enc.t()
        dgi_t, dgw_t, dctx_t = dgi.unbind(0), dgw.unbind(0), dctx.unbind(0)
        for t in reversed(range(T)):
            cell(t)                             # GRU: dh = dh z
            gemm.mm(dgi_t[t], w_enc_t, out=dctx_t[t])
            attend(t)
            gemm.mm(dgw_t[t], w_cat_t, out=dh, accumulate=not lstm)
        dpre = act.square().neg_().add_(1).mul_(dsc[..., None]).mul_(
            w.reshape(-1))                                      # (T, B, F, A)
        d_uv = dpre.sum(0)
        rows = T * B
        hp = h_prev.reshape(rows, H).t()
        grads = (
            gemm.mm(hp, dwh.reshape(rows, A)),                         # W
            None,                                                      # U
            d_uv.sum((0, 1)),                                          # b
            torch.einsum("tbfa,tbf->a", act, dsc)[:, None],            # w
            gemm.mm(ctxs.reshape(rows, E).t(), dgi.reshape(rows, G)),  # w_enc
            gemm.mm(hp, dgh.reshape(rows, G)),                         # w_hh
            dgh.sum((0, 1)),                                           # b_hh
            (torch.einsum("tbf,tbe->bfe", scores, dctx) / F            # enc
             if ctx.needs_input_grad[8] else None),
            d_uv,                                                      # uv
            dgi)                                                       # gi_emb
        return (None,) + tuple(None if g is None else g.to(d)
                               for g, d in zip(grads, ctx.dtypes))


def tf_attn_rollout(cell_type: str, att: Dict, w_enc: torch.Tensor,
                    w_hh: torch.Tensor, b_hh: torch.Tensor, enc: torch.Tensor,
                    uv: torch.Tensor, gi_emb: torch.Tensor) -> torch.Tensor:
    """The teacher-forced decoder recurrence at one layer (the JAX
    package's ``_tf_attn_rollout``), from h = c = 0: per step the
    attention over ``enc`` (B, F, E) with ``uv`` (B, F, A), ``gi =
    gi_emb[t] + ctx @ w_enc`` and the cell. gi_emb (T, B, G) = emb @
    w_ih[:E] + b_ih; w_enc = w_ih[E:]. Returns the hidden states (T, B,
    H). Runs ``_TfAttnRollout``: its kernels on the card."""
    return _TfAttnRollout.apply(cell_type, att["W"], att["U"], att["b"],
                                att["w"], w_enc, w_hh, b_hh, enc, uv, gi_emb)


def hoisted_decode_tables(params: Dict, cfg: DecoderConfig,
                          encoder_outputs: torch.Tensor):
    """Loop-invariant input-side products of the decode loop.

    x @ w_ih + b_ih = (emb*scale @ w_ih[:E])[token]
                      + sum_f score_f (enc_f @ w_ih[E:]) / F + b_ih

    Returns (pre_table (V, G), encW (B, F, G), b_ih (G,)). One layer only.
    """
    if cfg.n_layers != 1:
        raise ValueError("hoisted_decode_tables needs a 1-layer decoder")
    E = cfg.embedding_size
    w_ih = params["rnn"][0]["w_ih"]
    pre_table = (params["embedding"] * cfg.embedding_scale) @ w_ih[:E]
    encW = torch.einsum("bfe,eg->bfg", encoder_outputs, w_ih[E:])
    return pre_table, encW, params["rnn"][0]["b_ih"]


def decoder_step_hoisted(params: Dict, cfg: DecoderConfig,
                         token: torch.Tensor, state: State, uv: torch.Tensor,
                         pre_table: torch.Tensor, encW: torch.Tensor,
                         b_ih: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """``decoder_step`` (eval, 1 layer) on ``hoisted_decode_tables``.

    Returns (output h (B, H), new_state); the projection is the caller's."""
    scores = attn_ops.attention_scores(params["attention"], state[0][-1], uv)
    gi = (pre_table[token]
          + torch.einsum("bf,bfg->bg", scores, encW) / encW.shape[1] + b_ih)
    h, c = rnn_ops.rnn_step_pre(cfg.cell_type, params["rnn"][0], gi,
                                (state[0][0], state[1][0]))
    return h, (h[None], c[None])


class Decoder(nn.Module):
    """Holds the decoder's parameters (JAX layout) as frozen nn.Parameters.

    ``params()`` returns the nested dict the functions of this module take,
    with the kernels' weight copies (``"layouts"``) it was given;
    ``forward`` is one ``decoder_step``."""

    def __init__(self, cfg: DecoderConfig, params: Dict):
        super().__init__()
        self.cfg = cfg
        frozen = lambda t: nn.Parameter(t, requires_grad=False)
        self.embedding = frozen(params["embedding"])
        self.attention = nn.ParameterDict(
            {k: frozen(v) for k, v in params["attention"].items()})
        self.rnn = nn.ModuleList(
            nn.ParameterDict({k: frozen(v) for k, v in layer.items()})
            for layer in params["rnn"])
        self.out_w = frozen(params["out_w"])
        self.out_b = frozen(params["out_b"])
        self.layouts = params.get("layouts")

    def params(self) -> Dict:
        params = {
            "embedding": self.embedding,
            "attention": dict(self.attention),
            "rnn": [dict(layer) for layer in self.rnn],
            "out_w": self.out_w,
            "out_b": self.out_b,
        }
        if self.layouts:
            params["layouts"] = self.layouts
        return params

    def forward(self, token, state, encoder_outputs, uv):
        return decoder_step(self.params(), self.cfg, token, state,
                            encoder_outputs, uv)
