"""The run configuration: a copy of ``recnet_tpu/config.py``'s
``TrainConfig``, so that the port reads a checkpoint's ``config.json``
without importing the JAX package.

The dataclass is copied whole, every field, default, derived id and the
``validate`` checks, so ``from_json`` takes every key a JAX checkpoint
holds and ``replace`` works as there. The split and eval pointers
(``SplitConfig``, ``EvalConfig``) are not copied: the port has no split
or training CLI.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


def _asdict(obj) -> Dict[str, Any]:
    return dataclasses.asdict(obj)


@dataclass(frozen=True)
class TrainConfig:
    """All training hyperparameters (reference: config.py:27-157)."""

    model: str = "RecNet"
    corpus: str = "MSVD"            # ["MSVD", "MSR-VTT"]
    encoder_model: str = "InceptionV4"
    decoder_model: str = "GRU"      # ["LSTM", "GRU"]  (reference: config.py:31)
    reconstructor_model: str = "LSTM"  # ["LSTM", "GRU"] (reference: config.py:32)

    # Data (reference: config.py:36-53)
    data_root: str = "data"
    min_count: int = 5
    frame_sampling_method: str = "uniform"  # ["uniform", "random", "uniform_jitter"]
    caption_max_len: int = 30
    batch_size: int = 100
    shuffle: bool = True
    num_workers: int = 4
    build_train_data_loader: bool = True
    build_val_data_loader: bool = True
    build_test_data_loader: bool = True
    build_score_data_loader: bool = True

    # Word embedding (reference: config.py:55-59)
    init_word2idx: Tuple[Tuple[str, int], ...] = (("<PAD>", 0), ("<SOS>", 1), ("<EOS>", 2))
    embedding_size: int = 468
    embedding_dropout: float = 0.5
    embedding_scale: float = 1.0

    # Encoder features (reference: config.py:61-63)
    encoder_output_size: int = 1536
    encoder_output_len: int = 28

    # Decoder (reference: config.py:65-71)
    decoder_n_layers: int = 1
    decoder_hidden_size: int = 512
    decoder_attn_size: int = 128
    decoder_dropout: float = 0.5        # no-op for 1-layer RNN, kept for parity
    decoder_out_dropout: float = 0.5
    decoder_teacher_forcing_ratio: float = 1.0

    # Reconstructor (reference: config.py:73-82)
    use_recon: bool = True
    reconstructor_type: str = "local"   # ["global", "local"]; reference
    # default is "local" (config.py:76) — matched so the default config
    # trains the same model variant as the reference's default run.
    reconstructor_n_layers: int = 1
    reconstructor_hidden_size: int = 1536
    reconstructor_decoder_dropout: float = 0.5
    reconstructor_dropout: float = 0.5
    reconstructor_attn_size: int = 128

    # Train (reference: config.py:84-93)
    n_iterations: int = 100000
    decoder_learning_rate: float = 1e-5
    reconstructor_learning_rate: float = 1e-6
    decoder_weight_decay: float = 1e-5
    reconstructor_weight_decay: float = 1e-5
    decoder_use_amsgrad: bool = True
    reconstructor_use_amsgrad: bool = False
    use_gradient_clip: bool = True
    gradient_clip: float = 50.0
    # Mixed-precision training (new capability, no reference counterpart):
    # "float32" = the reference's recipe (default, required for parity);
    # "bfloat16" = bf16 forward/backward compute with f32 master weights,
    # optimizer state and loss reductions (ops/losses.py reduces in f32).
    train_precision: str = "float32"    # ["float32", "bfloat16"]

    # Regularizer lambdas (reference: train.py:151,188,225)
    decoder_lambda_reg: float = 0.001
    reconstructor_lambda_reg: float = 0.01
    lambda_recon: float = 1.0

    # Test (reference: config.py:95-97)
    search_methods: Tuple[Any, ...] = ("greedy", ("beam", 5))
    scores: Tuple[str, ...] = (
        "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "CIDEr", "METEOR", "ROUGE_L")
    # METEOR formulation: "2007" (default) or "1.5" (the jar's English
    # parameterization; see metrics/meteor.py and BASELINE.md for deltas)
    meteor_version: str = "2007"

    # Log cadence (reference: config.py:99-103)
    log_every: int = 500
    validate_every: int = 5000
    test_every: int = 10000
    save_every: int = 100000
    timestamp: str = field(default_factory=lambda: time.strftime("%y%m%d-%H:%M:%S", time.gmtime()))

    # Runtime knobs (new; TPU-native additions, no reference counterpart)
    seed: int = 0
    dtype: str = "float32"            # compute dtype for activations
    param_dtype: str = "float32"
    mesh_shape: Tuple[Tuple[str, int], ...] = (("data", 1),)  # e.g. (("data",4),("model",2))
    prefetch_depth: int = 2
    # train steps per device dispatch (one jitted lax.scan over k batches;
    # training/step.py build_train_multi_step). 1 = the reference's
    # step-per-dispatch. k>1 removes per-step host dispatch overhead; every
    # log/validate/test/save cadence must be a multiple of k.
    steps_per_dispatch: int = 1
    use_pallas: bool = False          # fused Pallas decoder step (falls back to XLA)
    # With use_pallas: run the greedy whole-decode kernel in N-step segments
    # chained by an XLA while_loop that stops once every row has emitted its
    # first <EOS> (or at an all-<PAD> boundary) — device-level early exit,
    # sentence-EXACT (decoding.greedy_decode_whole_segmented; measured 2.32x
    # at B=2048/segment=4 on a trained model). Applies to the periodic
    # test-eval greedy pass and cli.eval --greedy. 0 = single fixed-length
    # kernel (bit-exact dead-tail tokens, runs all max_len+1 steps).
    greedy_segment: int = 0
    # Keep all (deterministically sampled) train video features resident in
    # HBM and send only (B,) row indices per step; the jitted step gathers
    # features on device (training/step.py build_train_step_cached).
    # Removes the per-step host->device feature upload — the training-loop
    # bandwidth bottleneck on remote/tunneled links (MSVD-scale cache is
    # ~206 MB). Requires frame_sampling_method="uniform" (bit-identical to
    # the uncached path then; stochastic sampling would be frozen by a
    # cache, so it is rejected).
    device_feature_cache: bool = False
    # Storage dtype for the HBM feature caches ("float32" | "bfloat16" |
    # "float16"). Half-width storage halves the cache upload + residency
    # (the warm-start dominant cost on tunneled links: ~1 GiB at MSR-VTT
    # scale) at the price of rounding the features once on the way in; the
    # jitted steps gather rows and cast back to f32, so all compute/state
    # stays f32. Default "float32" keeps the bit-identical-to-uncached
    # contract (tests/test_train_step.py).
    feature_cache_dtype: str = "float32"
    # Preprocessed-corpus bundle (data/bundle.py): pack features (frame
    # pipeline applied), tokenized caption matrices, row maps and the vocab
    # into one versioned on-disk artifact keyed on config+input-file hashes;
    # subsequent starts mmap it and reach iteration 1 in seconds instead of
    # re-running the reference's load-everything prep (dataset/MSVD.py:234-240)
    # — bit-identical batches either way (tests/test_bundle.py). Requires
    # frame_sampling_method="uniform" (deterministic).
    data_bundle: bool = False
    data_bundle_root: str = ""        # default: {data_root}/{corpus}/bundles

    # ---- derived (reference: config.py:105-134) ----

    @property
    def n_val(self) -> int:
        return 100 if self.corpus == "MSVD" else 497

    @property
    def n_test(self) -> int:
        return 670 if self.corpus == "MSVD" else 2990

    @property
    def init_word2idx_dict(self) -> Dict[str, int]:
        return dict(self.init_word2idx)

    @property
    def total_video_fpath(self) -> str:
        return f"{self.data_root}/{self.corpus}/features/{self.encoder_model}.hdf5"

    @property
    def total_caption_fpath(self) -> str:
        if self.corpus == "MSR-VTT":
            return f"{self.data_root}/{self.corpus}/metadata/videodatainfo.json"
        return f"{self.data_root}/{self.corpus}/metadata/MSR Video Description Corpus.csv"

    def video_fpath(self, split: str) -> str:
        return f"{self.data_root}/{self.corpus}/features/{self.encoder_model}_{split}.hdf5"

    def caption_fpath(self, split: str) -> str:
        ext = "json" if self.corpus == "MSR-VTT" else "csv"
        return f"{self.data_root}/{self.corpus}/metadata/{split}.{ext}"

    @property
    def corpus_id(self) -> str:
        return "{} tc-{} mc-{} sp-{}".format(
            self.corpus, self.caption_max_len, self.min_count, self.frame_sampling_method)

    @property
    def encoder_id(self) -> str:
        return "ENC {} sm-{}".format(self.encoder_model, self.encoder_output_len)

    @property
    def decoder_id(self) -> str:
        return "DEC {}-{} at-{} dr-{}-{} tf-{} lr-{}-wd-{} op-{}".format(
            self.decoder_model, self.decoder_n_layers, self.decoder_attn_size,
            self.decoder_dropout, self.decoder_out_dropout,
            self.decoder_teacher_forcing_ratio, self.decoder_learning_rate,
            self.decoder_weight_decay,
            ["adam", "amsgrad"][int(self.decoder_use_amsgrad)])

    @property
    def reconstructor_id(self) -> str:
        rid = "REC-{} {} lr-{}-wd-{} op-{}".format(
            self.reconstructor_type, self.reconstructor_model,
            self.reconstructor_learning_rate, self.reconstructor_weight_decay,
            ["adam", "amsgrad"][int(self.reconstructor_use_amsgrad)])
        if self.reconstructor_type == "local":
            rid = "{} at-{}".format(rid, self.reconstructor_attn_size)
        return rid

    @property
    def embedding_id(self) -> str:
        return "EMB {} dr-{} sc-{}".format(
            self.embedding_size, self.embedding_dropout, self.embedding_scale)

    @property
    def hyperparams_id(self) -> str:
        hid = "bs-{}".format(self.batch_size)
        if self.use_gradient_clip:
            hid = "{} | cp-{}".format(hid, self.gradient_clip)
        return hid

    @property
    def id(self) -> str:
        parts = [self.model, self.corpus_id, self.encoder_id, self.decoder_id]
        if self.use_recon:
            parts.append(self.reconstructor_id)
        parts += [self.embedding_id, self.hyperparams_id, self.timestamp]
        return " | ".join(parts)

    @property
    def log_dpath(self) -> str:
        return "logs/{}".format(self.id)

    @property
    def save_dpath(self) -> str:
        return "checkpoints/{}".format(self.id)

    # TensorBoard tag schema (reference: config.py:136-157)
    tx_train_loss: str = "loss/train/total"
    tx_train_loss_decoder: str = "loss/train/decoder"
    tx_train_loss_reconstructor: str = "loss/train/reconstructor"
    tx_val_loss: str = "loss/val/total"
    tx_val_loss_decoder: str = "loss/val/decoder"
    tx_val_loss_reconstructor: str = "loss/val/reconstructor"
    tx_predicted_captions: str = "Ground Truths (GT) v.s. Predicted Captions (PD)"
    tx_lambda_decoder: str = "lambda/decoder_regularizer"
    tx_lambda_reconstructor: str = "lambda/reconstructor_regularizer"
    tx_lambda: str = "lambda/reconstructor"

    def tx_score(self, search_method_id: str, score: str) -> str:
        return "score with {} search/{}".format(search_method_id, score)

    @staticmethod
    def search_method_id(search_method) -> str:
        if isinstance(search_method, str):
            return search_method
        if isinstance(search_method, (tuple, list)):
            return "-".join(str(s) for s in search_method)
        raise NotImplementedError(f"Unknown search method: {search_method}")

    # ---- serialization ----

    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        d = dict(d)
        for key in ("init_word2idx", "mesh_shape"):
            if key in d and d[key] is not None:
                d[key] = tuple(tuple(x) for x in d[key])
        for key in ("search_methods",):
            if key in d and d[key] is not None:
                d[key] = tuple(tuple(x) if isinstance(x, list) else x for x in d[key])
        if "scores" in d and d["scores"] is not None:
            d["scores"] = tuple(d["scores"])
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def validate(self, debug: bool = False) -> "TrainConfig":
        """Fail loudly on incompatible knob combinations.

        One shared predicate for the train loop, the CLIs and the preset
        configs (examples/*_flagship.json) — every rule the runtime layers
        enforce piecemeal, checked up front so a bad config dies at load
        time instead of minutes into setup. Returns self for chaining.
        """
        if self.train_precision not in ("float32", "bfloat16"):
            raise ValueError(
                f"Unknown train_precision {self.train_precision!r}; "
                "expected 'float32' or 'bfloat16'")
        if self.feature_cache_dtype not in ("float32", "bfloat16",
                                            "float16"):
            raise ValueError(
                f"Unknown feature_cache_dtype {self.feature_cache_dtype!r};"
                " expected 'float32', 'bfloat16' or 'float16'")
        k = int(self.steps_per_dispatch)
        if k < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got "
                f"{self.steps_per_dispatch} (1 = one jitted step per "
                "dispatch; >1 chains k steps in one dispatch)")
        if k > 1:
            if debug:
                raise ValueError("debug mode needs steps_per_dispatch=1 "
                                 "(it runs every block every iteration)")
            for name, every in (("log_every", self.log_every),
                                ("validate_every", self.validate_every),
                                ("test_every", self.test_every),
                                ("save_every", self.save_every),
                                ("n_iterations", self.n_iterations)):
                if every % k != 0:
                    raise ValueError(
                        f"{name}={every} must be a multiple of "
                        f"steps_per_dispatch={k}")
        if self.frame_sampling_method != "uniform":
            if self.device_feature_cache:
                raise ValueError(
                    "device_feature_cache requires frame_sampling_method="
                    "'uniform' (stochastic sampling would be frozen by the "
                    f"cache); got {self.frame_sampling_method!r}")
            if self.data_bundle:
                raise ValueError(
                    "data bundles require frame_sampling_method='uniform' "
                    "(stochastic sampling would be frozen by the packed "
                    f"features); got {self.frame_sampling_method!r}")
        if self.greedy_segment < 0:
            raise ValueError(
                f"greedy_segment must be >= 0, got {self.greedy_segment}")
        if self.greedy_segment and not self.use_pallas:
            raise ValueError(
                "greedy_segment > 0 requires use_pallas=True (the segmented"
                " early exit is a mode of the Pallas whole-decode kernel)")
        if self.feature_cache_dtype != "float32" \
                and not self.device_feature_cache:
            # the knob only shapes the device caches — without them it
            # would silently do nothing (ADVICE r4)
            import warnings
            warnings.warn(
                f"feature_cache_dtype={self.feature_cache_dtype!r} has no "
                "effect because device_feature_cache is off; enable the "
                "cache or drop the knob", stacklevel=2)
        return self
