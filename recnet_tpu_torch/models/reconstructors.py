"""Global and local feature reconstructors.

Port of ``recnet_tpu.models.reconstructors`` (reference:
models/global_reconstructor.py, models/local_reconstructor.py and
train.py:78-131). Both regenerate the encoder features from the decoder's
hidden states, RecNet's reconstruction loss. The quirks kept:

* global: the mean-pool of the decoder hiddens over (time, layers) is
  rescaled by caption_max_len / T_eff (global_reconstructor.py:31-37) and
  computed once (it does not change across steps); its dropout is drawn
  fresh at every step; the loss is divided by T_eff (train.py:101-102);
* local: *unnormalised* additive attention over the decoder hiddens, a
  masked mean over the executed steps (``attend_mean`` with ``mask`` and
  ``denom=t_eff``); the loss is not divided by the step count
  (train.py:127-130).

T_eff, the reference's number of executed decoder steps, is a tensor
computed from the caption mask, so shapes stay fixed. Losses reduce in
the dtype of the encoder outputs they are given, the outputs cast to it,
as the JAX package's (bfloat16 in a bf16 train step).

On a mesh (the step's ``parallel.mesh.Shard``) the hiddens are this rank's
rows; the caller's step mask and T_eff are the whole batch's, each loss is
this rank's share of the mean over the global batch, and each dropout mask
is cut from the global one (``decoder._dropout``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from recnet_tpu_torch.models.decoder import _dropout, _multilayer_rnn
from recnet_tpu_torch.ops import attention as attn_ops
from recnet_tpu_torch.ops import rnn as rnn_ops
from recnet_tpu_torch.ops.cuda import gemm


class ReconstructorConfig(NamedTuple):
    kind: str = "global"              # ["global", "local"]
    cell_type: str = "LSTM"
    n_layers: int = 1
    decoder_hidden_size: int = 512
    hidden_size: int = 1536
    attn_size: int = 128              # local only
    dropout: float = 0.5              # inter-layer RNN dropout
    decoder_dropout: float = 0.5      # on the pooled/attended decoder input
    caption_max_len: int = 30         # global rescale factor
    encoder_output_len: int = 28      # local step count


def init_reconstructor_params(generator: torch.Generator,
                              cfg: ReconstructorConfig,
                              dtype=torch.float32) -> Dict:
    """The JAX initialiser's distributions, drawn from ``generator``: RNN
    layers and attention (local) as their modules', out_w and out_b
    U(-1/sqrt(hidden), 1/sqrt(hidden)). The first layer takes
    [h_t, mean-pool] (2 x decoder hidden) in the global variant and the
    attended hidden in the local one."""
    dev = generator.device
    bound = 1.0 / cfg.hidden_size ** 0.5
    in0 = cfg.decoder_hidden_size * (2 if cfg.kind == "global" else 1)
    rnn = [rnn_ops.init_rnn_params(generator, cfg.cell_type,
                                   in0 if li == 0 else cfg.hidden_size,
                                   cfg.hidden_size, dtype)
           for li in range(cfg.n_layers)]

    def u(*shape):
        return torch.empty(shape, dtype=dtype, device=dev).uniform_(
            -bound, bound, generator=generator)
    params = {"rnn": rnn, "out_w": u(cfg.hidden_size, cfg.hidden_size),
              "out_b": u(cfg.hidden_size)}
    if cfg.kind == "local":
        params["attention"] = attn_ops.init_attention_params(
            generator, cfg.hidden_size, cfg.decoder_hidden_size,
            cfg.attn_size, dtype)
    return params


def _zero_state(cfg: ReconstructorConfig, batch: int, like: torch.Tensor):
    z = torch.zeros((cfg.n_layers, batch, cfg.hidden_size), dtype=like.dtype,
                    device=like.device)
    return z, z


def _batch_mean(x: torch.Tensor, shard) -> torch.Tensor:
    """The mean over the global batch of which ``x`` holds this rank's
    rows: the local mean times the rank's share of the rows."""
    if shard is None:
        return x.mean()
    start, stop, total = shard.rows
    return x.mean() * ((stop - start) / total)


def global_reconstruct(params: Dict, cfg: ReconstructorConfig,
                       decoder_hiddens: torch.Tensor, step_mask: torch.Tensor,
                       t_eff: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       train: bool = False, shard=None) -> torch.Tensor:
    """decoder_hiddens (T, L, B, Hdec); step_mask (T,) 1.0 for executed
    steps; t_eff = sum(step_mask). Returns outputs (T, B, hidden)."""
    T, L, B, Hd = decoder_hiddens.shape
    masked = decoder_hiddens * step_mask[:, None, None, None]
    mean_pooled = masked.sum(dim=(0, 1)) / (t_eff * L)           # (B, Hd)
    mean_pooled = mean_pooled / t_eff * cfg.caption_max_len
    # a fresh dropout mask at every step (global_reconstructor.py:38)
    mp_all = _dropout(mean_pooled.expand(T, B, Hd), cfg.decoder_dropout,
                      generator, train, shard, batch_dim=1)
    if cfg.n_layers == 1:
        # every step's input is known before the loop: the input-side gate
        # product and the output projection run once for all T steps
        p0 = params["rnn"][0]
        gi_all = gemm.matmul(torch.cat([decoder_hiddens[:, 0], mp_all], -1),
                             p0["w_ih"], p0["b_ih"])             # (T, B, G)
        z = mp_all.new_zeros((B, cfg.hidden_size))
        outs = rnn_ops.rnn_rollout_pre(cfg.cell_type, p0, gi_all, z, z)
        return gemm.matmul(outs, params["out_w"], params["out_b"])
    state, outs = _zero_state(cfg, B, mp_all), []
    for t in range(T):
        # input = [decoder_hiddens[t][0], mean-pool]
        # (global_reconstructor.py:40 takes the first layer)
        x = torch.cat([decoder_hiddens[t, 0], mp_all[t]], -1)
        out, state = _multilayer_rnn(cfg, params["rnn"], x, state,
                                     generator, train, shard)
        outs.append(out)
    return gemm.matmul(torch.stack(outs), params["out_w"], params["out_b"])


def global_recon_loss(params: Dict, cfg: ReconstructorConfig,
                      decoder_hiddens: torch.Tensor,
                      encoder_outputs: torch.Tensor, step_mask: torch.Tensor,
                      t_eff: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      train: bool = False, shard=None) -> torch.Tensor:
    """MSE(mean_t outputs, mean_f enc) / T_eff (train.py:92-102)."""
    outputs = global_reconstruct(params, cfg, decoder_hiddens, step_mask,
                                 t_eff, generator, train, shard
                                 ).to(encoder_outputs.dtype)
    out_mean = (outputs * step_mask[:, None, None]).sum(0) / t_eff
    enc_mean = encoder_outputs.mean(dim=1)
    return _batch_mean((out_mean - enc_mean).square(), shard) / t_eff


def local_reconstruct(params: Dict, cfg: ReconstructorConfig,
                      decoder_hiddens: torch.Tensor, step_mask: torch.Tensor,
                      t_eff: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      train: bool = False, shard=None) -> torch.Tensor:
    """encoder_output_len steps of attention over the decoder hiddens
    (T, 1, B, Hdec): the reference feeds the layer axis as a length-1
    sequence (local_reconstructor.py:49-52), so one decoder layer only.
    Returns outputs (F, B, hidden)."""
    T, L, B, Hd = decoder_hiddens.shape
    if L != 1:
        raise ValueError("the local reconstructor needs decoder_n_layers == 1")
    hs = decoder_hiddens[:, 0].transpose(0, 1)                   # (B, T, Hd)
    att = params["attention"]
    uv = attn_ops.precompute_uv(att, hs)                         # (B, T, A)
    mask_bt = step_mask[None, :].expand(B, T)
    state, outs = _zero_state(cfg, B, hs), []
    for _ in range(cfg.encoder_output_len):
        x = attn_ops.attend_mean(att, state[0][-1], hs, uv, mask=mask_bt,
                                 denom=t_eff)
        x = _dropout(x, cfg.decoder_dropout, generator, train, shard)
        out, state = _multilayer_rnn(cfg, params["rnn"], x, state,
                                     generator, train, shard)
        outs.append(out)
    # the output projection runs once for all steps
    return gemm.matmul(torch.stack(outs), params["out_w"], params["out_b"])


def local_recon_loss(params: Dict, cfg: ReconstructorConfig,
                     decoder_hiddens: torch.Tensor,
                     encoder_outputs: torch.Tensor, step_mask: torch.Tensor,
                     t_eff: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     train: bool = False, shard=None) -> torch.Tensor:
    """MSE(outputs^T, enc), not divided by the steps (train.py:127-130)."""
    outputs = local_reconstruct(params, cfg, decoder_hiddens, step_mask,
                                t_eff, generator, train, shard
                                ).to(encoder_outputs.dtype)
    return _batch_mean(
        (outputs.transpose(0, 1) - encoder_outputs).square(), shard)


def recon_loss(params: Dict, cfg: ReconstructorConfig,
               decoder_hiddens: torch.Tensor, encoder_outputs: torch.Tensor,
               step_mask: torch.Tensor, t_eff: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               train: bool = False, shard=None) -> torch.Tensor:
    if cfg.kind == "global":
        return global_recon_loss(params, cfg, decoder_hiddens,
                                 encoder_outputs, step_mask, t_eff,
                                 generator, train, shard)
    if cfg.kind == "local":
        return local_recon_loss(params, cfg, decoder_hiddens,
                                encoder_outputs, step_mask, t_eff,
                                generator, train, shard)
    raise ValueError(f"Unknown reconstructor kind: {cfg.kind}")


def config_from_train(tc) -> ReconstructorConfig:
    return ReconstructorConfig(
        kind=tc.reconstructor_type,
        cell_type=tc.reconstructor_model,
        n_layers=tc.reconstructor_n_layers,
        decoder_hidden_size=tc.decoder_hidden_size,
        hidden_size=tc.reconstructor_hidden_size,
        attn_size=tc.reconstructor_attn_size,
        dropout=tc.reconstructor_dropout,
        decoder_dropout=tc.reconstructor_decoder_dropout,
        caption_max_len=tc.caption_max_len,
        encoder_output_len=tc.encoder_output_len,
    )
