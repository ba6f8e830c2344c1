"""The port's reference-checkpoint interop (recnet_tpu_torch/interop.py,
cli/import_torch.py, cli/export_torch.py) against the JAX package's
(recnet_tpu/interop.py) on the same reference checkpoints: the mirror of
tests/test_interop.py function for function, with the cross-package cases
(a checkpoint imported by both packages gives equal leaves; the two
exporters' .tars hold equal tensors) and the optimizer-order trap (the
reference indexes Adam's moments in torch's enumeration order, the port in
the JAX flatten order) pinned for decoder and reconstructor, AMSGrad on
and off.

The reference-shaped modules and the checkpoint writer are
tests/test_interop.py's."""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

import jax

from recnet_tpu import checkpoint as j_ckpt
from recnet_tpu import interop as j_interop
from recnet_tpu.training.step import init_train_state as j_init_train_state
from recnet_tpu_torch import checkpoint as t_ckpt
from recnet_tpu_torch import interop
from recnet_tpu_torch.cli import export_torch as t_export_cli
from recnet_tpu_torch.cli import import_torch as t_import_cli
from recnet_tpu_torch.data.vocab import Vocab
from recnet_tpu_torch.models.decoder import decoder_step
from recnet_tpu_torch.ops.attention import precompute_uv
from recnet_tpu_torch.utils.misc import tree_leaves

from tests.test_interop import (RefDecoder, RefGlobalRecon, RefLocalRecon,
                                _save_reference_checkpoint,
                                _surrogate_recon_step, _trained_decoder)


def _leaves_equal(got, want, what=""):
    got, want = list(got), list(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=f"{what} leaf {i}")


def _recon(kind, cell, seed, amsgrad=False):
    torch.manual_seed(seed)
    rec = RefGlobalRecon(cell) if kind == "global" else RefLocalRecon(cell)
    opt = torch.optim.Adam(rec.parameters(), lr=1e-6, weight_decay=1e-5,
                           amsgrad=amsgrad)
    _surrogate_recon_step(rec, opt)
    return rec, opt


def _vocab_file(tmp_path, n_vocabs=30):
    vocab = Vocab({"<PAD>": 0, "<SOS>": 1, "<EOS>": 2}, min_count=1)
    vocab.build([" ".join(f"w{i}" for i in range(n_vocabs - 3))],
                lambda s: s.split())
    assert vocab.n_vocabs == n_vocabs
    path = os.path.join(str(tmp_path), "vocab.json")
    with open(path, "w") as f:
        f.write(vocab.to_json())
    return path


# --------------------------------------------------------------------------
# Weight mapping
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cell,n_layers", [("GRU", 1), ("LSTM", 1),
                                           ("GRU", 2)])
def test_decoder_forward_parity(cell, n_layers):
    """The imported params equal the JAX package's leaf for leaf, and the
    port's decoder_step on them gives the reference module's logits."""
    dec, _ = _trained_decoder(cell, n_layers=n_layers)
    params, dcfg = interop.decoder_from_state_dict(dec.state_dict())
    jparams, jdcfg = j_interop.decoder_from_state_dict(dec.state_dict())
    assert tuple(dcfg) == tuple(jdcfg)
    assert dcfg.cell_type == cell and dcfg.n_layers == n_layers
    _leaves_equal(tree_leaves(params), jax.tree_util.tree_leaves(jparams),
                  "decoder")

    rng = np.random.default_rng(0)
    B, F, H = 3, 4, 16
    enc = torch.from_numpy(rng.standard_normal((B, F, 12)).astype(np.float32))
    token = torch.from_numpy(rng.integers(0, 30, (B,)))
    p = jax.tree_util.tree_map(torch.from_numpy, params)
    zeros = torch.zeros(n_layers, B, H)
    got, _ = decoder_step(p, dcfg, token, (zeros, zeros), enc,
                          precompute_uv(p["attention"], enc))
    want, _ = dec.step(token, (zeros, zeros) if cell == "LSTM" else zeros,
                       enc)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_transposed_reference_weights_load_contiguous():
    """Weights mapped by plain transposition are strided views; the params
    the decoders take from them are contiguous (the CUDA kernels refuse
    other strides) and equal the import's."""
    from recnet_tpu_torch.weights import params_from_jax
    dec, _ = _trained_decoder("GRU")
    sd = {k: v.numpy() for k, v in dec.state_dict().items()}
    views = {"attention": {"W": sd["attn_W.weight"].T,
                           "U": sd["attn_U.weight"].T, "b": sd["attn_b"],
                           "w": sd["attn_w.weight"].T},
             "embedding": sd["embedding.weight"],
             "rnn": [{"w_ih": sd["rnn.weight_ih_l0"].T,
                      "w_hh": sd["rnn.weight_hh_l0"].T,
                      "b_ih": sd["rnn.bias_ih_l0"],
                      "b_hh": sd["rnn.bias_hh_l0"]}],
             "out_w": sd["out.weight"].T, "out_b": sd["out.bias"]}
    got = tree_leaves(params_from_jax(views, "cpu", torch.float32))
    assert all(t.is_contiguous() for t in got)
    imported, _ = interop.decoder_from_state_dict(dec.state_dict())
    _leaves_equal(got, tree_leaves(imported), "transposed")


@pytest.mark.parametrize("kind,cell", [("global", "LSTM"), ("local", "GRU")])
def test_reconstructor_mapping(kind, cell):
    torch.manual_seed(2)
    rec = RefGlobalRecon(cell) if kind == "global" else RefLocalRecon(cell)
    params, rcfg = interop.reconstructor_from_state_dict(rec.state_dict())
    jparams, jrcfg = j_interop.reconstructor_from_state_dict(
        rec.state_dict())
    assert tuple(rcfg) == tuple(jrcfg)
    assert rcfg.kind == kind and rcfg.cell_type == cell
    assert rcfg.hidden_size == 10 and rcfg.decoder_hidden_size == 16
    _leaves_equal(tree_leaves(params), jax.tree_util.tree_leaves(jparams),
                  "reconstructor")
    sd = rec.state_dict()
    np.testing.assert_array_equal(params["rnn"][0]["w_ih"],
                                  sd["rnn.weight_ih_l0"].numpy().T)
    np.testing.assert_array_equal(params["out_w"],
                                  sd["out.weight"].numpy().T)


# --------------------------------------------------------------------------
# Optimizer state resume
# --------------------------------------------------------------------------

@pytest.mark.parametrize("amsgrad", [True, False])
def test_adam_state_resume_matches_torch(tmp_path, amsgrad):
    """Identical synthetic gradients stepped through torch Adam on the
    reference module and through the imported TrainState's Adam (moments
    in the JAX flatten order) give identical parameters: moment placement,
    transposes and the step count, decoder and reconstructor."""
    dec, dopt = _trained_decoder("GRU", amsgrad=amsgrad, wd=1e-2)
    rec, ropt = _recon("local", "GRU", 7, amsgrad=not amsgrad)
    path = _save_reference_checkpoint(tmp_path, dec, dopt, rec, ropt)
    state, _, _, _ = interop.train_state_from_reference(
        interop.load_reference_checkpoint(path))
    models = [(dec, dopt, state.dec_params, state.dec_opt,
               interop.decoder_from_state_dict),
              (rec, ropt, state.rec_params, state.rec_opt,
               interop.reconstructor_from_state_dict)]
    for step in range(3):
        for module, opt, params, port_opt, mapping in models:
            for p in module.parameters():
                p.grad = 0.1 * p.detach() + 0.01
            opt.step()
            for p in tree_leaves(params):
                p.grad = 0.1 * p.detach() + 0.01
            port_opt.step()
            got, _ = mapping(module.state_dict())
            _leaves_equal(tree_leaves(params), tree_leaves(got),
                          f"step {step}")


# --------------------------------------------------------------------------
# Whole-checkpoint import + CLI round trip
# --------------------------------------------------------------------------

@pytest.fixture
def still_clock(monkeypatch):
    """Hold the wall clock at one second. A new ``TrainConfig`` of either
    package stamps ``timestamp`` with the current second, so two configs
    built a moment apart differ whenever a second boundary falls between
    them; with the clock held, they are compared on what they were built
    from."""
    now = time.gmtime()
    monkeypatch.setattr(time, "gmtime", lambda secs=None: now)


@pytest.mark.parametrize("kind", ["global", "local", None])
def test_train_state_from_reference(tmp_path, kind, still_clock):
    """A reference checkpoint imported by both packages: equal configs and
    equal leaves (params, Adam counts and moments) in flatten order."""
    dec, dopt = _trained_decoder("GRU")
    rec = ropt = None
    if kind is not None:
        rec, ropt = _recon(kind, "LSTM", 3)
    path = _save_reference_checkpoint(tmp_path, dec, dopt, rec, ropt)

    ckpt = interop.load_reference_checkpoint(path)
    state, dcfg, rcfg, tc = interop.train_state_from_reference(ckpt)
    jstate, _, jrcfg, jtc = j_interop.train_state_from_reference(
        j_interop.load_reference_checkpoint(path))
    assert state.step == 40000
    assert dcfg.cell_type == "GRU"
    assert tc.decoder_use_amsgrad is True
    assert tc.to_json() == jtc.to_json()
    if kind is None:
        assert state.rec_params is None and rcfg is None
        assert tc.use_recon is False
    else:
        assert rcfg.kind == kind and tuple(rcfg) == tuple(jrcfg)
        assert tc.use_recon and tc.reconstructor_type == kind
        assert tc.reconstructor_learning_rate == pytest.approx(1e-6)
    _leaves_equal(t_ckpt.state_leaves(state),
                  jax.tree_util.tree_leaves(jstate), "state")


def test_import_cli_round_trip(tmp_path):
    """The import CLI writes a step directory that the port's and the JAX
    package's checkpoint readers both load, with the weights bit-exact."""
    dec, dopt = _trained_decoder("GRU")
    rec, ropt = _recon("global", "LSTM", 4)
    path = _save_reference_checkpoint(tmp_path, dec, dopt, rec, ropt,
                                      iteration=1234)
    out_dir = os.path.join(str(tmp_path), "imported")
    t_import_cli.main(["--ckpt", path, "--out", out_dir,
                       "--vocab", _vocab_file(tmp_path)])
    step_dir = os.path.join(out_dir, "1234")
    assert os.path.isdir(step_dir)

    tc, vocab = t_ckpt.load_config_and_vocab(step_dir)
    assert vocab.n_vocabs == 30
    state, meta = t_ckpt.load_checkpoint(step_dir, tc, vocab.n_vocabs, "cpu")
    assert state.step == 1234 and meta["imported_from"] == path
    np.testing.assert_array_equal(
        state.dec_params["embedding"].detach().numpy(),
        dec.state_dict()["embedding.weight"].numpy())

    jtc, jvocab = j_ckpt.load_config_and_vocab(step_dir)
    example, _, _ = j_init_train_state(jax.random.PRNGKey(0), jtc,
                                       jvocab.n_vocabs)
    jstate, _ = j_ckpt.load_checkpoint(step_dir, example)
    _leaves_equal(t_ckpt.state_leaves(state),
                  jax.tree_util.tree_leaves(jstate), "reloaded")


def test_import_refuses_orbax(tmp_path):
    dec, dopt = _trained_decoder("GRU")
    path = _save_reference_checkpoint(tmp_path, dec, dopt)
    with pytest.raises(SystemExit):
        t_import_cli.main(["--ckpt", path, "--out", str(tmp_path / "o"),
                           "--vocab", _vocab_file(tmp_path),
                           "--backend", "orbax"])
    assert not os.path.exists(tmp_path / "o")


# --------------------------------------------------------------------------
# Export: the port's state -> reference torch format
# --------------------------------------------------------------------------

def _assert_opt_sd_equal(got, want, what):
    g, w = got["param_groups"][0], want["param_groups"][0]
    for key in ("lr", "weight_decay", "amsgrad", "eps", "betas"):
        assert tuple(np.atleast_1d(g[key])) == tuple(np.atleast_1d(w[key])), \
            f"{what} {key}"
    assert list(g["params"]) == list(w["params"])
    assert sorted(got["state"]) == sorted(want["state"])
    for i, w_e in want["state"].items():
        g_e = got["state"][i]
        assert int(g_e["step"]) == int(w_e["step"])
        assert sorted(k for k in g_e if k != "step") == \
            sorted(k for k in w_e if k != "step"), f"{what}[{i}]"
        for name in w_e:
            if name != "step":
                np.testing.assert_array_equal(
                    g_e[name].numpy(), w_e[name].numpy(),
                    err_msg=f"{what}[{i}].{name}")


@pytest.mark.parametrize("kind,amsgrad", [("global", True), ("local", False),
                                          ("local", True)])
def test_export_import_roundtrip_bitexact(tmp_path, kind, amsgrad):
    """export(import(x)) reproduces every tensor of a reference checkpoint
    bitwise: weights both ways, and every Adam moment (AMSGrad's too)
    permuted back to torch's order, for decoder and reconstructor; and
    the JAX package's exporter writes the same tensors."""
    dec, dopt = _trained_decoder("LSTM", amsgrad=amsgrad, wd=1e-2)
    rec, ropt = _recon(kind, "GRU", 5, amsgrad=amsgrad)
    path = _save_reference_checkpoint(tmp_path, dec, dopt, rec, ropt)

    ckpt = interop.load_reference_checkpoint(path)
    state, _, _, tc = interop.train_state_from_reference(ckpt)
    out = os.path.join(str(tmp_path), "exported.tar")
    interop.export_reference_checkpoint(out, state, tc, loss=1.23)
    jstate, _, _, jtc = j_interop.train_state_from_reference(ckpt)
    jout = os.path.join(str(tmp_path), "jax_exported.tar")
    j_interop.export_reference_checkpoint(jout, jstate, jtc, loss=1.23)

    back = interop.load_reference_checkpoint(out)
    jback = interop.load_reference_checkpoint(jout)
    assert back["iteration"] == 40000 and back["loss"] == pytest.approx(1.23)
    for mod in ("dec", "rec"):
        assert list(back[mod]) == list(ckpt[mod])
        for k, want in ckpt[mod].items():
            np.testing.assert_array_equal(back[mod][k].numpy(),
                                          want.numpy(), err_msg=f"{mod}.{k}")
            np.testing.assert_array_equal(jback[mod][k].numpy(),
                                          want.numpy(), err_msg=f"{mod}.{k}")
    for mod in ("dec_opt", "rec_opt"):
        _assert_opt_sd_equal(back[mod], ckpt[mod], mod)
        _assert_opt_sd_equal(back[mod], jback[mod], mod)


@pytest.mark.parametrize("amsgrad", [True, False])
def test_exported_checkpoint_resumes_in_torch(tmp_path, amsgrad):
    """torch.optim.Adam.load_state_dict on the port's export, and the same
    gradients, step a fresh reference module exactly as the port's own
    state continues: the reference could go on training from it."""
    dec, dopt = _trained_decoder("GRU", amsgrad=amsgrad, wd=1e-2)
    path = _save_reference_checkpoint(tmp_path, dec, dopt)
    state, _, _, tc = interop.train_state_from_reference(
        interop.load_reference_checkpoint(path))
    out = os.path.join(str(tmp_path), "exported.tar")
    interop.export_reference_checkpoint(out, state, tc)

    back = interop.load_reference_checkpoint(out)
    dec2 = RefDecoder("GRU")
    dec2.load_state_dict(back["dec"])
    opt2 = torch.optim.Adam(dec2.parameters(), lr=tc.decoder_learning_rate,
                            weight_decay=tc.decoder_weight_decay,
                            amsgrad=amsgrad)
    opt2.load_state_dict(back["dec_opt"])
    for step in range(3):
        for p in dec2.parameters():
            p.grad = 0.1 * p.detach() + 0.01
        opt2.step()
        for p in tree_leaves(state.dec_params):
            p.grad = 0.1 * p.detach() + 0.01
        state.dec_opt.step()
        got, _ = interop.decoder_from_state_dict(dec2.state_dict())
        _leaves_equal(tree_leaves(state.dec_params), tree_leaves(got),
                      f"step {step}")


@pytest.mark.parametrize("kind", ["global", "local"])
def test_export_cli_from_native_checkpoint(tmp_path, kind):
    """A port checkpoint (trained a step, so the moments are not zero)
    exports through the CLI into the legacy torch format with the
    reference's key set; the JAX package's export CLI, reading the same
    directory, writes the same tensors; re-import closes the loop."""
    from recnet_tpu.cli import export_torch as j_export_cli
    from recnet_tpu_torch.config import TrainConfig
    from recnet_tpu_torch.training.step import init_train_state
    from tests.fixtures import tiny_train_config

    tc = TrainConfig.from_json(tiny_train_config(
        str(tmp_path), use_recon=True, reconstructor_type=kind,
        decoder_use_amsgrad=kind == "local").to_json())
    vocab = Vocab({"<PAD>": 0, "<SOS>": 1, "<EOS>": 2}, min_count=1)
    vocab.build(["a b c d e"], lambda s: s.split())
    state, _, _ = init_train_state(0, tc, vocab.n_vocabs, "cpu")
    for params, opt in ((state.dec_params, state.dec_opt),
                        (state.rec_params, state.rec_opt)):
        for p in tree_leaves(params):
            p.grad = 0.1 * p.detach() + 0.01
        opt.step()
    state.step = 55
    step_dir = t_ckpt.save_checkpoint(str(tmp_path / "native"), 55, state,
                                      tc, vocab)

    out = os.path.join(str(tmp_path), "55_checkpoint.tar")
    t_export_cli.main(["--ckpt", step_dir, "--out", out])
    jout = os.path.join(str(tmp_path), "jax_55_checkpoint.tar")
    j_export_cli.main(["--ckpt", step_dir, "--out", jout])

    with open(out, "rb") as f:        # legacy, not zipfile: torch 1.0 / py2
        assert f.read(2) != b"PK"
    back = interop.load_reference_checkpoint(out)
    jback = interop.load_reference_checkpoint(jout)
    assert sorted(back) == ["config", "dec", "dec_opt", "iteration", "loss",
                            "rec", "rec_opt"]
    assert back["iteration"] == 55 and isinstance(back["config"], type)
    for mod in ("dec", "rec"):
        assert list(back[mod]) == list(jback[mod])
        for k in back[mod]:
            np.testing.assert_array_equal(back[mod][k].numpy(),
                                          jback[mod][k].numpy())
    for mod in ("dec_opt", "rec_opt"):
        _assert_opt_sd_equal(back[mod], jback[mod], mod)
    state2, dcfg2, rcfg2, _ = interop.train_state_from_reference(back)
    assert rcfg2.kind == kind and dcfg2.vocab_size == vocab.n_vocabs
    _leaves_equal(t_ckpt.state_leaves(state2), t_ckpt.state_leaves(state),
                  "re-imported")


def test_vocab_mismatch_is_an_error(tmp_path):
    dec, dopt = _trained_decoder("GRU")
    path = _save_reference_checkpoint(tmp_path, dec, dopt)
    with pytest.raises(SystemExit):
        t_import_cli.main(["--ckpt", path, "--out",
                           os.path.join(str(tmp_path), "o"),
                           "--vocab", _vocab_file(tmp_path, n_vocabs=6)])
