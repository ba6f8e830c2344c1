"""Traffic of kind "train": the program's k-step training call on the
loop's device feature cache, closed loop, one call after another.

Set-up builds one train state (the configuration's decoder and
reconstructor, seeded weights, fresh Adam moments) and the step
(``training.step.build_train_multi_step_cached``, as the loop builds it),
puts the train split's features into the cache in the configuration's
cache dtype, and makes a pool of calls' rows and captions on the card. Its
first call runs steps 1 to k on the pool's first call; optimizer hooks read
the first step's moment and the parameters after step 3 there. A second
call warms the rest. The window keeps calling on the pool's calls in turn.
After it, the reference follows steps 1 to 3 from the same seeded weights
and batches.

The configuration's ``train_precision`` has to be float32, the
reference's. Traffic keys: batch_size, steps_per_call, videos (the
cache's rows), caption_words ({words: weight}), pool_calls, trace_calls.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from h100_bench import seeded
from h100_bench.reference import train as ref_train
from h100_bench.reference.recnet import Products, tf32_off

CHECK_STEPS = 3        # the steps the reference follows
_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 vocab: int):
        if config["train_precision"] != "float32":
            raise ValueError("the train generator checks float32 training "
                             "against its float32 reference only")
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.vocab = torch.device(device), vocab
        self.k, self.B = traffic["steps_per_call"], traffic["batch_size"]
        if CHECK_STEPS > self.k:
            raise ValueError("the checked steps lie in the first call")
        self.train_seed = seed % 2 ** 31
        self.calls = 0
        self.losses = []
        self.window_work = self.trace_work = {}

    def setup(self, parts) -> None:
        with parts("imports"):
            from recnet_tpu_torch.config import TrainConfig
            from recnet_tpu_torch.models import decoder as dec_mod
            from recnet_tpu_torch.models import reconstructors as rec_mod
            from recnet_tpu_torch.training import step as step_mod
        c, dev = self.config, self.device
        tc = TrainConfig.from_dict(c).replace(
            batch_size=self.B, steps_per_dispatch=self.k,
            seed=self.train_seed)
        if not tc.device_feature_cache:
            raise ValueError("the train generator feeds the device feature "
                             "cache (device_feature_cache)")
        with parts("weights"):
            dec = seeded.decoder_params(c, self.vocab, self.seed, dev)
            rec = seeded.reconstructor_params(c, self.seed, dev)
            self.state = step_mod.make_train_state(
                tc, 0, seeded.to_numpy(dec), seeded.to_numpy(rec),
                device=dev)
            del dec, rec
        with parts("feature_cache"):
            self.cache = self._cache()
            rows, caps = seeded.train_batches(c, self.vocab, self.traffic,
                                              self.seed,
                                              self.traffic["pool_calls"])
            self.rows = torch.from_numpy(rows).to(dev)
            self.caps = torch.from_numpy(caps).to(dev)
        dcfg = dec_mod.config_from_train(tc, self.vocab)
        rcfg = rec_mod.config_from_train(tc)
        self.fn = step_mod.build_train_multi_step_cached(tc, dcfg, rcfg,
                                                         self.k)
        with parts("warm_up"):
            self.program = self._first_call()
            self._call(1)
            self._sync()

    def _cache(self) -> torch.Tensor:
        """The train split's features as the loop's device cache holds
        them."""
        return seeded.features(
            self.config, self.traffic["videos"], self.seed, "videos",
            self.device,
            _CACHE_DTYPES[self.config.get("feature_cache_dtype", "float32")])

    def _leaves(self) -> Dict[str, torch.Tensor]:
        st = self.state
        return {**{f"dec/{k}": v for k, v in
                   seeded.flatten(st.dec_params).items()},
                **{f"rec/{k}": v for k, v in
                   seeded.flatten(st.rec_params).items()}}

    def _first_call(self) -> Dict:
        """The first call, with hooks on both optimizers that read step 1's
        first moment and the change after step CHECK_STEPS."""
        leaves = self._leaves()
        path = {id(p): k for k, p in leaves.items()}
        start = {k: p.detach().clone() for k, p in leaves.items()}
        beta1 = ref_train.BETAS[0]
        grad, change, seen = {}, {}, {}

        def hook(opt, args, kwargs):
            seen[id(opt)] = n = seen.get(id(opt), 0) + 1
            for p in opt.param_groups[0]["params"]:
                k = path[id(p)]
                if n == 1:
                    grad[k] = (opt.state[p]["exp_avg"].double().norm()
                               / (1 - beta1))
                if n == CHECK_STEPS:
                    change[k] = (p.detach() - start[k]).double().norm()

        opts = [self.state.dec_opt, self.state.rec_opt]
        handles = [o.register_step_post_hook(hook) for o in opts]
        try:
            m = self._call(0)
            self._sync()
        finally:
            for h in handles:
                h.remove()
        if any(seen.get(id(o), 0) < CHECK_STEPS for o in opts):
            raise RuntimeError("an optimizer took fewer steps than checked")
        return {"loss": [float(x) for x in
                         m["loss"][: CHECK_STEPS].cpu()],
                "grad": {k: float(v) for k, v in grad.items()},
                "change": {k: float(v) for k, v in change.items()}}

    def _call(self, i: int):
        j = i % self.rows.shape[0]
        m = self.fn(self.state, self.cache, self.rows[j], self.caps[j])
        self.losses.append(m["loss"])
        return m

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> Dict[str, float]:
        self.losses = []
        self._sync()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self._call(2 + n)
            n += 1
        self._sync()
        elapsed = time.perf_counter() - t0
        self.calls = n
        self.window_work = dict(self._work(), elapsed_s=elapsed)
        return {"train_samples_per_s": n * self.k * self.B / elapsed}

    def traced_calls(self) -> None:
        self.losses = []
        n = self.traffic["trace_calls"]
        for i in range(n):
            self._call(2 + i)
        self._sync()
        self.calls = n
        self.trace_work = self._work()

    def attempted(self) -> int:
        return self.calls * self.k * self.B

    def failed(self) -> int:
        bad = sum(int(not bool(torch.isfinite(m).all())) for m in self.losses)
        return bad * self.k * self.B

    def _work(self) -> Dict[str, int]:
        return {"train_steps": self.calls * self.k, "train_batch": self.B}

    def counts(self) -> Dict[str, Dict]:
        """The work of the untimed window and of the traced calls."""
        return {"window": self.window_work, "trace": self.trace_work}

    def free_program(self) -> None:
        self.state = self.fn = self.cache = None
        self.losses = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, precision: str, half: bool = False) -> Dict:
        c, dev = self.config, self.device
        with torch.no_grad():
            dec = seeded.decoder_params(c, self.vocab, self.seed, dev)
            rec = seeded.reconstructor_params(c, self.seed, dev)
            cache = self._cache()
        batches = [(cache[self.rows[0, s]].float(), self.caps[0, s])
                   for s in range(CHECK_STEPS)]
        with tf32_off():
            return ref_train.first_steps(
                c, dec, rec, batches, self.train_seed + 1,
                Products(precision), half=half)

    def numbers(self) -> Dict[str, float]:
        """The program's first steps against the reference's."""
        from h100_bench import oracle
        self.reference = self._reference("float32")
        return oracle.train_numbers(self.program, self.reference)

    def control_numbers(self) -> Dict[str, Dict[str, float]]:
        """The control (the reference in TF32) and the planted faults, each
        in the program's place, against the float32 reference."""
        from h100_bench import oracle
        ref = self.reference
        unchanged = {"loss": ref["loss"],
                     "grad": {k: 0.0 for k in ref["grad"]},
                     "change": {k: 0.0 for k in ref["change"]}}
        return {
            "control_tf32": oracle.train_numbers(self._reference("tf32"),
                                                 ref),
            "fault_half_batch": oracle.train_numbers(
                self._reference("float32", half=True), ref),
            "fault_state_unchanged": oracle.train_numbers(unchanged, ref),
        }
