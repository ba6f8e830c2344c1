"""RecNet in plain PyTorch: the decoder, both reconstructors and the joint
loss, on parameter trees in the JAX layout (input-major weights).

The semantics are those of the RecNet reference implementation
(hobincar/reconstruction-network-for-video-captioning: ``models/``,
``train.py``) as the program carries them:

* attention is unnormalised: scores ``w . tanh(W h + U v + b)`` weigh the
  values, which are mean-pooled (divided by their count, or by T_eff in the
  local reconstructor, whose scores are masked to the executed steps);
* cells keep PyTorch's gate order (LSTM i, f, g, o; GRU r, z, n with
  ``n = tanh(i_n + r (W_hn h + b_hn))``);
* the decoder loss sums each step's masked-mean cross entropy and divides
  by the token count; regularisers are sums of leaf norms;
* the global reconstructor feeds [h_t, mean-pool] (the pool divided by
  T_eff twice and scaled by caption_max_len) and compares the mean of its
  outputs with the mean feature, over T_eff; the local one attends over
  the decoder's hidden states for encoder_output_len steps and compares
  frame by frame.

Every product goes through a ``Products``: float32 with TF32 off, or the
control's TF32 (each operand rounded to TF32's 10-bit mantissa, the sums
in float32). Dropout draws ``torch.rand`` of the masked tensor's shape from
the step's generator, in the order the step applies it (embedding, logits,
then the reconstructor's inputs).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

SOS, PAD = 1, 0


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, nearest even."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """a @ b on TF32-rounded operands, and the backward's two products on
    TF32-rounded operands as well. b is (K, N), or (B, K, N) beside a (B,
    M, K)."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        if rb.dim() == 2:
            return (rg @ rb.t(),
                    ra.reshape(-1, ra.shape[-1]).t()
                    @ rg.reshape(-1, rg.shape[-1]))
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg


class Products:
    """The reference's matrix products in ``precision``: "float32" (TF32
    off) or "tf32" (the control)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"no reference precision {precision!r}")
        self.precision = precision

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N)."""
        if self.precision == "tf32":
            return _TF32Product.apply(x, w)
        return x @ w

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (B, M, K) @ b (B, K, N)."""
        if self.precision == "tf32":
            return _TF32Product.apply(a, b)
        return a @ b


@contextlib.contextmanager
def tf32_off():
    """cuBLAS and cuDNN products in full float32 while the reference runs
    (the settings are put back after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def dropout(x: torch.Tensor, rate: float,
            g: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a uniform draw of x's shape from ``g``;
    identity without a generator."""
    if g is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=g, device=x.device)
    return torch.where(u < keep, x / keep, 0.0)


def cell(kind: str, r: Dict, gi: torch.Tensor, h: torch.Tensor,
         c: torch.Tensor, prod: Products):
    """One LSTM or GRU step from the input gates ``gi = x w_ih + b_ih``."""
    gh = prod.mm(h, r["w_hh"]) + r["b_hh"]
    if kind == "GRU":
        i_r, i_z, i_n = gi.chunk(3, -1)
        h_r, h_z, h_n = gh.chunk(3, -1)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + torch.sigmoid(i_r + h_r) * h_n)
        return (1.0 - z) * n + z * h, c
    i, f, g, o = (gi + gh).chunk(4, -1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def attend(att: Dict, h: torch.Tensor, values: torch.Tensor,
           uv: torch.Tensor, prod: Products,
           mask: Optional[torch.Tensor] = None, denom=None):
    """The unnormalised attention: sum_t score_t v_t / (T or ``denom``)."""
    act = torch.tanh(prod.mm(h, att["W"])[:, None, :] + uv + att["b"])
    scores = prod.mm(act, att["w"])[..., 0]                    # (B, T)
    if mask is not None:
        scores = scores * mask
    ctx = prod.bmm(scores[:, None, :], values)[:, 0]
    return ctx / (values.shape[1] if denom is None else denom)


def decoder_rollout(P: Dict, c: Dict, enc: torch.Tensor,
                    inputs: torch.Tensor, prod: Products,
                    g: Optional[torch.Generator] = None):
    """Teacher-forced decoder over ``inputs`` (T, B) (step t reads
    inputs[t]): (logits (T, B, V), hidden states (T, B, H)); with a
    generator, the embedding's and the logits' dropout."""
    T, B = inputs.shape
    att, r = P["attention"], P["rnn"][0]
    H = r["w_hh"].shape[0]
    uv = prod.mm(enc, att["U"])                                # (B, F, A)
    emb = P["embedding"][inputs] * c["embedding_scale"]        # (T, B, E)
    emb = dropout(emb, c["embedding_dropout"], g)
    h = enc.new_zeros((B, H))
    cs = h
    hs = []
    for t in range(T):
        ctx = attend(att, h, enc, uv, prod)
        gi = prod.mm(torch.cat([emb[t], ctx], -1), r["w_ih"]) + r["b_ih"]
        h, cs = cell(c["decoder_model"], r, gi, h, cs, prod)
        hs.append(h)
    hs = torch.stack(hs)
    logits = prod.mm(hs, P["out_w"]) + P["out_b"]
    return dropout(logits, c["decoder_out_dropout"], g), hs


def caption_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """sum_t mean_b(CE over the step's tokens) / the token count."""
    mask = (targets > PAD).float()
    nll = (torch.logsumexp(logits, -1)
           - logits.gather(-1, targets[..., None])[..., 0])
    per_step = (nll * mask).sum(1) / mask.sum(1).clamp(min=1.0)
    return per_step.sum() / mask.sum().clamp(min=1.0)


def norm_sum(tree) -> torch.Tensor:
    """sum of every leaf's 2-norm."""
    if isinstance(tree, dict):
        return sum(norm_sum(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(norm_sum(v) for v in tree)
    return tree.square().sum().sqrt()


def global_recon_loss(R: Dict, c: Dict, hs: torch.Tensor,
                      enc: torch.Tensor, step_mask: torch.Tensor,
                      t_eff: torch.Tensor, prod: Products,
                      g: Optional[torch.Generator]) -> torch.Tensor:
    T, B, Hd = hs.shape
    r = R["rnn"][0]
    Hr = r["w_hh"].shape[0]
    pooled = ((hs * step_mask[:, None, None]).sum(0) / t_eff / t_eff
              * c["caption_max_len"])
    mp = dropout(pooled.expand(T, B, Hd),
                 c["reconstructor_decoder_dropout"], g)
    gi_all = prod.mm(torch.cat([hs, mp], -1), r["w_ih"]) + r["b_ih"]
    h = hs.new_zeros((B, Hr))
    cs, outs = h, []
    for t in range(T):
        h, cs = cell(c["reconstructor_model"], r, gi_all[t], h, cs, prod)
        outs.append(h)
    out = prod.mm(torch.stack(outs), R["out_w"]) + R["out_b"]
    out_mean = (out * step_mask[:, None, None]).sum(0) / t_eff
    return (out_mean - enc.mean(1)).square().mean() / t_eff


def local_recon_loss(R: Dict, c: Dict, hs: torch.Tensor,
                     enc: torch.Tensor, step_mask: torch.Tensor,
                     t_eff: torch.Tensor, prod: Products,
                     g: Optional[torch.Generator]) -> torch.Tensor:
    T, B, Hd = hs.shape
    att, r = R["attention"], R["rnn"][0]
    Hr = r["w_hh"].shape[0]
    values = hs.transpose(0, 1)                                # (B, T, Hd)
    uv = prod.mm(values, att["U"])
    mask = step_mask[None, :].expand(B, T)
    h = hs.new_zeros((B, Hr))
    cs, outs = h, []
    for _ in range(c["encoder_output_len"]):
        x = attend(att, h, values, uv, prod, mask=mask, denom=t_eff)
        x = dropout(x, c["reconstructor_decoder_dropout"], g)
        gi = prod.mm(x, r["w_ih"]) + r["b_ih"]
        h, cs = cell(c["reconstructor_model"], r, gi, h, cs, prod)
        outs.append(h)
    out = prod.mm(torch.stack(outs), R["out_w"]) + R["out_b"]  # (F, B, Hr)
    return (out.transpose(0, 1) - enc).square().mean()


def joint_loss(P: Dict, R: Dict, c: Dict, enc: torch.Tensor,
               captions: torch.Tensor, prod: Products,
               g: Optional[torch.Generator] = None) -> torch.Tensor:
    """The train step's loss on features (B, F, E) and captions (T, B),
    teacher forcing on."""
    T, B = captions.shape
    inputs = torch.cat([torch.full((1, B), SOS, dtype=captions.dtype,
                                   device=captions.device), captions[:-1]])
    logits, hs = decoder_rollout(P, c, enc, inputs, prod, g)
    dec_loss = (caption_loss(logits, captions)
                + c["decoder_lambda_reg"] * norm_sum(P))
    step_mask = ((captions > PAD).float().sum(1) > 0).float()
    t_eff = step_mask.sum().clamp(min=1.0)
    recon = (local_recon_loss if c["reconstructor_type"] == "local"
             else global_recon_loss)
    rec_loss = (recon(R, c, hs, enc, step_mask, t_eff, prod, g)
                + c["reconstructor_lambda_reg"] * norm_sum(R))
    return dec_loss + c["lambda_recon"] * rec_loss
