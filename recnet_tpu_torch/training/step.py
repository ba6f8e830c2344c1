"""The train and val steps: the reference's train.py:241-273 in eager
PyTorch.

Port of ``recnet_tpu.training.step``. One train step is the decoder
rollout, the reconstructor rollout, the joint loss, autograd, the clip of
the decoder's gradients and the two Adam updates:

  total = [sum_t mean-CE_t / sum tokens + 0.001 * sum ||theta_dec||]
        + lambda_recon * [recon_mse + 0.01 * sum ||theta_rec||]

The state (``TrainState``) holds float32 master parameters as nested dicts
of leaf tensors in the JAX layout and a ``torch.optim.Adam`` per model; a
step updates it in place and returns its metrics as 0-d tensors on the
device, so that nothing waits for the card inside a step or a k-step
dispatch. Teacher forcing is one draw per iteration (train.py:37-38) from a
host generator seeded by ``tc.seed + 1`` and the step; the dropout masks
come from a device generator seeded from that one, so a resumed run draws
what an unbroken run would. ``train_precision="bfloat16"`` runs the
rollouts under ``torch.autocast`` over the float32 masters; the losses and
the regularisers stay in float32.

On a mesh (``parallel.mesh``, one process per device) a train step takes
this rank's rows of the batch. The loss is the rank's share of the global
one (the token counts and the step mask are the whole batch's; the
regularisers, which every data rank computes alike, are added on the rank
with the first rows); after the backward pass one all-reduce sums the
gradients and the loss terms over 'data'. The clip's norm is global over
'model' and both Adam updates run elementwise on the rank's shards. The
val step decodes the whole batch on every rank. Averaging per-rank means,
as ``DistributedDataParallel`` does, would weigh the ranks' tokens
unequally whenever their token counts differ.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.models import decoder as dec_mod
from recnet_tpu_torch.models import reconstructors as rec_mod
from recnet_tpu_torch.ops.losses import l2_norm_sum, step_mean_ce
from recnet_tpu_torch.parallel import mesh as mesh_lib
from recnet_tpu_torch.training.optim import (clip_by_global_norm,
                                             load_adam_state, make_adam)
from recnet_tpu_torch.utils.misc import tree_fill, tree_leaves


@dataclasses.dataclass
class TrainState:
    step: int
    dec_params: Dict
    dec_opt: torch.optim.Adam
    rec_params: Optional[Dict] = None
    rec_opt: Optional[torch.optim.Adam] = None


def check_device(device) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and
    there is none (there is no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is "
                           "not available; pass device='cpu' to train on "
                           "the CPU")
    return device


def make_train_state(tc: TrainConfig, step: int, dec_params: Dict,
                     rec_params: Optional[Dict] = None, dec_adam=None,
                     rec_adam=None, device="cuda") -> TrainState:
    """A TrainState from parameter trees of arrays or tensors (JAX layout)
    and, optionally, each model's Adam state as the JAX
    ``TorchAdamState`` fields (count, mu, nu, nu_max), every moment a tree
    like the params (nu_max None without AMSGrad); fresh moments when
    None. Copies everything onto ``device`` as float32 leaf tensors."""
    device = check_device(device)

    def leaves(tree):
        return tree_fill(tree, (
            torch.tensor(x.detach().cpu().numpy() if torch.is_tensor(x)
                         else x, dtype=torch.float32, device=device
                         ).requires_grad_(True)
            for x in tree_leaves(tree)))

    def opt(params, adam, lr, wd, amsgrad):
        o = make_adam(params, lr, wd, amsgrad)
        if adam is not None:
            count, mu, nu, nu_max = adam
            load_adam_state(o, int(count), tree_leaves(mu), tree_leaves(nu),
                            tree_leaves(nu_max) if amsgrad else None)
        return o

    dec = leaves(dec_params)
    state = TrainState(int(step), dec, opt(
        dec, dec_adam, tc.decoder_learning_rate, tc.decoder_weight_decay,
        tc.decoder_use_amsgrad))
    if tc.use_recon:
        state.rec_params = leaves(rec_params)
        state.rec_opt = opt(state.rec_params, rec_adam,
                            tc.reconstructor_learning_rate,
                            tc.reconstructor_weight_decay,
                            tc.reconstructor_use_amsgrad)
    return state


def init_train_state(seed: int, tc: TrainConfig, vocab_size: int,
                     device="cuda") -> Tuple[TrainState,
                                             dec_mod.DecoderConfig,
                                             Optional[
                                                 rec_mod.ReconstructorConfig]]:
    """Fresh parameters drawn on the host from ``seed`` (so every device
    starts from the same numbers) and zero Adam moments, on ``device``."""
    dcfg = dec_mod.config_from_train(tc, vocab_size)
    rcfg = rec_mod.config_from_train(tc) if tc.use_recon else None
    g = torch.Generator().manual_seed(seed)
    dec = dec_mod.init_decoder_params(g, dcfg)
    rec = rec_mod.init_reconstructor_params(g, rcfg) if rcfg else None
    return make_train_state(tc, 0, dec, rec, device=device), dcfg, rcfg


def _forward(dec_params, rec_params, dcfg, rcfg, tc_pad, lambda_recon,
             dec_lambda_reg, rec_lambda_reg, videos, captions, use_tf: bool,
             generator: Optional[torch.Generator], train: bool,
             always_tf: bool = False, compute_dtype=None, shard=None,
             dec_specs=None):
    """Joint forward; returns (total, aux).

    ``always_tf`` takes the rollout with the vocab projection hoisted out
    of the loop (teacher forcing always on). ``compute_dtype`` (bf16) runs
    the rollouts under autocast on the videos cast to it, as the JAX
    package casts them (``recnet_tpu/training/step.py:92-98``; it casts
    the parameters too); the regularisers read the float32 masters and the
    cross entropy reduces in float32, the reconstruction loss in
    ``compute_dtype`` with the step mask and T_eff in it, as JAX's.
    ``shard`` (``parallel.mesh.Shard``) is this rank's place on a mesh;
    ``dec_specs`` the decoder leaves' specs there."""
    if shard is None or shard.owns_replicated:
        dec_reg = dec_lambda_reg * l2_norm_sum(dec_params, shard, dec_specs)
        rec_reg = (rec_lambda_reg * l2_norm_sum(rec_params)
                   if rec_params is not None else None)
    else:
        dec_reg = rec_reg = torch.zeros((), device=videos.device)
    mask = captions > tc_pad                                      # (T, B)
    if compute_dtype is not None:           # cast once, as the JAX step
        videos = videos.to(compute_dtype)
    with torch.autocast(videos.device.type, dtype=compute_dtype,
                        enabled=compute_dtype is not None):
        if always_tf:
            rollout = dec_mod.teacher_forced_rollout_fast(
                dec_params, dcfg, videos, captions, generator, train, shard)
        else:
            rollout = dec_mod.teacher_forced_rollout(
                dec_params, dcfg, videos, captions, use_tf, generator, train,
                shard)
        ce, n_tok = step_mean_ce(rollout.logits, captions, mask, shard)
        dec_loss = ce + dec_reg
        aux = {"n_tokens": n_tok, "greedy_tokens": rollout.greedy_tokens,
               "dec_loss": dec_loss}
        if rec_params is None:
            aux["rec_loss"] = torch.zeros((), device=videos.device)
            return dec_loss, aux
        # the reconstruction loss in the compute dtype, as JAX's: on the
        # videos as cast, the step mask and T_eff in that dtype
        step_mask = (mesh_lib.data_sum(mask.float().sum(dim=1), shard)
                     > 0).to(videos.dtype)                          # (T,)
        t_eff = step_mask.sum().clamp(min=1.0)
        rec = rec_mod.recon_loss(rec_params, rcfg, rollout.hiddens, videos,
                                 step_mask, t_eff, generator, train, shard)
    rec_loss = rec + rec_reg
    aux["rec_loss"] = rec_loss
    return dec_loss + lambda_recon * rec_loss, aux


def _step_draws(seed: int, step: int, ratio: float, device
                ) -> Tuple[bool, torch.Generator]:
    """(teacher forcing on?, the dropout generator) of iteration ``step``:
    one host generator seeded by (seed, step) draws the Bernoulli and the
    dropout generator's seed."""
    host = torch.Generator().manual_seed(seed * 2 ** 32 + step)
    use_tf = bool(torch.rand((), generator=host) <= ratio)
    dropout = torch.Generator(device=device).manual_seed(
        int(torch.randint(2 ** 62, (), generator=host)))
    return use_tf, dropout


def _make_step_fn(tc: TrainConfig, dcfg: dec_mod.DecoderConfig,
                  rcfg: Optional[rec_mod.ReconstructorConfig], mesh=None):
    if tc.train_precision not in ("float32", "bfloat16"):
        raise ValueError(
            f"Unknown train_precision {tc.train_precision!r}; "
            "expected 'float32' or 'bfloat16'")
    compute_dtype = (torch.bfloat16 if tc.train_precision == "bfloat16"
                     else None)
    pad = tc.init_word2idx_dict["<PAD>"]
    ratio = tc.decoder_teacher_forcing_ratio
    # ratio >= 1.0: the Bernoulli (random.random() <= ratio) is always
    # true, so the fast rollout applies unconditionally
    always_tf = ratio >= 1.0

    def step_fn(state: TrainState, videos, captions) -> Dict:
        shard = mesh_lib.step_shard(mesh, videos.shape[0], dcfg.vocab_size)
        specs = mesh_lib.param_specs(state.dec_params, ".dec_params", mesh)
        use_tf, generator = _step_draws(tc.seed + 1, state.step, ratio,
                                        videos.device)
        opts = [state.dec_opt] + ([state.rec_opt] if tc.use_recon else [])
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        total, aux = _forward(
            state.dec_params, state.rec_params if tc.use_recon else None,
            dcfg, rcfg, pad, tc.lambda_recon, tc.decoder_lambda_reg,
            tc.reconstructor_lambda_reg, videos, captions, use_tf, generator,
            train=True, always_tf=always_tf, compute_dtype=compute_dtype,
            shard=shard, dec_specs=specs)
        total.backward()
        losses = [total.detach(), aux["dec_loss"].detach(),
                  aux["rec_loss"].detach()]
        if shard is not None and shard.data_group is not None:
            # the ranks' shares: one sum of every gradient and loss term
            losses = mesh_lib.all_reduce_grads(
                [p for opt in opts for p in opt.param_groups[0]["params"]],
                losses, shard.data_group)
        gnorm = (clip_by_global_norm(state.dec_params, tc.gradient_clip,
                                     shard, specs)
                 if tc.use_gradient_clip
                 else torch.zeros((), device=videos.device))
        for opt in opts:
            opt.step()
        state.step += 1
        return {"loss": losses[0], "dec_loss": losses[1],
                "rec_loss": losses[2], "grad_norm": gnorm,
                "n_tokens": aux["n_tokens"]}

    return step_fn


def gather_f32(cache: torch.Tensor, vid_rows: torch.Tensor) -> torch.Tensor:
    """The batch's rows of a device feature cache, widened to float32 when
    the cache is stored half-width (``feature_cache_dtype``)."""
    videos = cache.index_select(0, vid_rows.to(cache.device).long())
    return videos if videos.dtype == torch.float32 else videos.float()


def build_train_step(tc: TrainConfig, dcfg: dec_mod.DecoderConfig,
                     rcfg: Optional[rec_mod.ReconstructorConfig], mesh=None):
    """fn(state, videos (B, F, E), captions (T, B)) -> metrics; updates
    ``state`` in place. On a process group's ``mesh`` the videos and
    captions are this rank's rows and the metrics the global ones."""
    return _make_step_fn(tc, dcfg, rcfg, mesh)


def build_train_multi_step(tc: TrainConfig, dcfg: dec_mod.DecoderConfig,
                           rcfg: Optional[rec_mod.ReconstructorConfig],
                           k: int, mesh=None):
    """k train steps per call over stacked batches: fn(state, videos
    (k, B, F, E), captions (k, T, B)) -> metrics with a leading (k,) axis.
    Equal to k calls of :func:`build_train_step` (the draws depend on the
    step only); nothing inside waits for the card."""
    step_fn = _make_step_fn(tc, dcfg, rcfg, mesh)

    def multi_fn(state: TrainState, videos, captions) -> Dict:
        ms = [step_fn(state, videos[i], captions[i]) for i in range(k)]
        return {key: torch.stack([m[key] for m in ms]) for key in ms[0]}

    return multi_fn


def build_train_step_cached(tc: TrainConfig, dcfg: dec_mod.DecoderConfig,
                            rcfg: Optional[rec_mod.ReconstructorConfig],
                            mesh=None):
    """The device-feature-cache variant (config.device_feature_cache):
    fn(state, cache (V, F, E), vid_rows (B,), captions) -> metrics. The
    train features stay on the card; each step gathers its rows (on a
    mesh: the whole cache on every rank, the rank's rows of indices)."""
    step_fn = _make_step_fn(tc, dcfg, rcfg, mesh)
    return lambda state, cache, vid_rows, captions: step_fn(
        state, gather_f32(cache, vid_rows), captions)


def build_train_multi_step_cached(tc: TrainConfig,
                                  dcfg: dec_mod.DecoderConfig,
                                  rcfg: Optional[rec_mod.ReconstructorConfig],
                                  k: int, mesh=None):
    """k cached steps per call: fn(state, cache, vid_rows (k, B), captions
    (k, T, B))."""
    multi_fn = build_train_multi_step(tc, dcfg, rcfg, k, mesh)

    def fn(state: TrainState, cache, vid_rows, captions) -> Dict:
        B = vid_rows.shape[1]
        videos = gather_f32(cache, vid_rows.reshape(-1))
        return multi_fn(state, videos.reshape(k, B, *cache.shape[1:]),
                        captions)
    return fn


def build_val_step(tc: TrainConfig, dcfg: dec_mod.DecoderConfig,
                   rcfg: Optional[rec_mod.ReconstructorConfig], mesh=None):
    """Eval-mode forward with teacher forcing off (the reference's
    forward_decoder at ratio 0, train.py:327-328): the decoder feeds its
    own argmax. fn(dec_params, rec_params, videos, captions) -> losses and
    the greedy token chain (T, B). On a mesh every rank takes the whole
    batch (the losses are then the global ones), its vocabulary shards
    summed over 'model'."""
    pad = tc.init_word2idx_dict["<PAD>"]

    @torch.no_grad()
    def val_fn(dec_params, rec_params, videos, captions) -> Dict:
        total, aux = _forward(
            dec_params, rec_params if tc.use_recon else None, dcfg, rcfg,
            pad, tc.lambda_recon, tc.decoder_lambda_reg,
            tc.reconstructor_lambda_reg, videos, captions, use_tf=False,
            generator=None, train=False,
            shard=mesh_lib.step_shard(mesh, videos.shape[0],
                                      dcfg.vocab_size, split_batch=False),
            dec_specs=mesh_lib.param_specs(dec_params, ".dec_params", mesh))
        return {"loss": total, "dec_loss": aux["dec_loss"],
                "rec_loss": aux["rec_loss"],
                "greedy_tokens": aux["greedy_tokens"]}

    return val_fn


def build_val_step_cached(tc: TrainConfig, dcfg: dec_mod.DecoderConfig,
                          rcfg: Optional[rec_mod.ReconstructorConfig],
                          mesh=None):
    """:func:`build_val_step` on a device feature cache: fn(dec_params,
    rec_params, cache, vid_rows (B,), captions)."""
    val_fn = build_val_step(tc, dcfg, rcfg, mesh)
    return lambda dp, rp, cache, vid_rows, captions: val_fn(
        dp, rp, gather_f32(cache, vid_rows), captions)
