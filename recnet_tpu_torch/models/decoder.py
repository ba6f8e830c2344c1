"""Attention RNN caption decoder, eval mode.

Port of ``recnet_tpu.models.decoder``: embedding * scale, *unnormalised*
additive attention over the encoder features (scores mean-pool the values),
an LSTM/GRU stack, and the vocab projection. Dropout and the teacher-forced
training rollouts are not ported yet (ROADMAP Queue 1, item 8).

Parameters are a nested dict in the JAX layout:
``embedding (V, E)``, ``attention{W (H,A), U (F,A), b (A,), w (A,1)}``,
``rnn[i]{w_ih (in, nG*H), w_hh (H, nG*H), b_ih, b_hh}``, ``out_w (H, V)``,
``out_b (V,)``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

from recnet_tpu_torch.ops import attention as attn_ops
from recnet_tpu_torch.ops import rnn as rnn_ops

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


def zero_state(cfg: DecoderConfig, batch_size: int, dtype=torch.float32,
               device="cpu") -> State:
    """(h, c), each (L, B, H), zero."""
    z = torch.zeros((cfg.n_layers, batch_size, cfg.hidden_size),
                    dtype=dtype, device=device)
    return z, z


def _multilayer_rnn(cfg: DecoderConfig, params_layers, x: torch.Tensor,
                    state: State):
    """Stacked cells (eval mode: no inter-layer dropout)."""
    h, c = state
    new_h, new_c = [], []
    inp = x
    for li, p in enumerate(params_layers):
        hi, ci = rnn_ops.rnn_step(cfg.cell_type, p, inp, (h[li], c[li]))
        new_h.append(hi)
        new_c.append(ci)
        inp = hi
    return inp, (torch.stack(new_h), torch.stack(new_c))


def decoder_step(params: Dict, cfg: DecoderConfig, token: torch.Tensor,
                 state: State, encoder_outputs: torch.Tensor,
                 uv: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """One eval-mode decode step.

    token (B,) int; state (h, c) each (L, B, H); encoder_outputs (B, F, enc);
    uv (B, F, A). Returns (logits (B, V), new_state).
    """
    emb = params["embedding"][token] * cfg.embedding_scale
    context = attn_ops.attend_mean(params["attention"], state[0][-1],
                                   encoder_outputs, uv)
    x = torch.cat([emb, context], dim=-1)
    output, new_state = _multilayer_rnn(cfg, params["rnn"], x, state)
    return output @ params["out_w"] + params["out_b"], new_state


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

    ``params()`` returns the nested dict the functions of this module take;
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

    def params(self) -> Dict:
        return {
            "embedding": self.embedding,
            "attention": dict(self.attention),
            "rnn": [dict(layer) for layer in self.rnn],
            "out_w": self.out_w,
            "out_b": self.out_b,
        }

    def forward(self, token, state, encoder_outputs, uv):
        return decoder_step(self.params(), self.cfg, token, state,
                            encoder_outputs, uv)
