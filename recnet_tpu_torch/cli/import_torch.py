"""CLI: import a reference PyTorch checkpoint as a port checkpoint.

    python -m recnet_tpu_torch.cli.import_torch \
        --ckpt /path/to/100000_checkpoint.tar --out checkpoints/imported \
        [--vocab vocab.json | --caption_fpath "MSR Video Description Corpus.csv"]

The port's counterpart of ``recnet_tpu.cli.import_torch``. The reference
checkpoint (reference: train.py:397-420) stores no vocab and no config
values (see recnet_tpu_torch/interop.py); the vocab is either a vocab.json
saved by either package, or rebuilt deterministically from the full
caption file as the reference's own eval does (reference: eval.py:185).
The step directory written is a normal npz checkpoint: ``cli.eval``,
``cli.caption``, ``cli.serve`` and ``cli.train --resume`` of either package
load it. A host tool: it converts files and touches no device.
"""

from __future__ import annotations

import argparse
import sys

from recnet_tpu_torch import checkpoint as ckpt_mod
from recnet_tpu_torch import interop
from recnet_tpu_torch.config import TrainConfig
from recnet_tpu_torch.data.vocab import Vocab


def main(argv=None):
    a = argparse.ArgumentParser(description=__doc__)
    a.add_argument("--ckpt", required=True,
                   help="reference *_checkpoint.tar (torch.save format)")
    a.add_argument("--out", required=True,
                   help="output checkpoint dir (step subdir is created)")
    a.add_argument("--vocab", default=None,
                   help="vocab.json saved by this framework")
    a.add_argument("--caption_fpath", default=None,
                   help="full caption CSV to rebuild the vocab from "
                        "(the reference eval.py:185 route)")
    a.add_argument("--data_root", default=None,
                   help="data root recorded in the imported config")
    a.add_argument("--backend", default="npz", choices=["npz", "orbax"],
                   help="npz only: orbax checkpoints are the JAX "
                        "package's")
    a.add_argument("--embedding_scale", type=float, default=None,
                   help="override (not recoverable from weights; ref default 1)")
    a.add_argument("--caption_max_len", type=int, default=None,
                   help="override (not recoverable from weights; ref default 30)")
    a.add_argument("--min_count", type=int, default=None,
                   help="vocab min word count of the ORIGINAL training run "
                        "(only used with --caption_fpath; ref default 5)")
    a.add_argument("--corpus", default=None, choices=["MSVD", "MSR-VTT"],
                   help="corpus the checkpoint was trained on (selects the "
                        "--caption_fpath parser: MSVD CSV vs MSR-VTT "
                        "videodatainfo JSON; default MSVD)")
    a.add_argument("--encoder_output_len", type=int, default=None,
                   help="frame count of the original run (not recoverable "
                        "from weights; ref default 28)")
    args = a.parse_args(argv)
    if args.backend == "orbax":
        a.error("--backend orbax: the port writes and reads npz "
                "checkpoints only (orbax is the JAX package's)")

    base = TrainConfig()
    overrides = {}
    if args.data_root:
        overrides["data_root"] = args.data_root
    if args.embedding_scale is not None:
        overrides["embedding_scale"] = args.embedding_scale
    if args.caption_max_len is not None:
        overrides["caption_max_len"] = args.caption_max_len
    if args.min_count is not None:
        overrides["min_count"] = args.min_count
    if args.corpus is not None:
        overrides["corpus"] = args.corpus
    if args.encoder_output_len is not None:
        overrides["encoder_output_len"] = args.encoder_output_len
    if overrides:
        base = base.replace(**overrides)

    ckpt = interop.load_reference_checkpoint(args.ckpt)
    state, dcfg, rcfg, tc = interop.train_state_from_reference(ckpt, base)

    if args.vocab:
        with open(args.vocab) as f:
            vocab = Vocab.from_json(f.read())
    elif args.caption_fpath:
        from recnet_tpu_torch.data.corpus import build_vocab_from_captions
        vocab = build_vocab_from_captions(tc, args.caption_fpath)
    else:
        a.error("one of --vocab / --caption_fpath is required "
                "(the reference checkpoint stores no vocab)")

    if vocab.n_vocabs != dcfg.vocab_size:
        print(f"ERROR: vocab has {vocab.n_vocabs} words but the checkpoint's "
              f"embedding has {dcfg.vocab_size} rows — wrong vocab source "
              f"(the vocab must be rebuilt with the same min_count/corpus "
              f"as the original training run)", file=sys.stderr)
        sys.exit(1)

    step = int(ckpt.get("iteration", 0))
    step_dir = ckpt_mod.save_checkpoint(
        args.out, step, state, tc, vocab,
        extra={"imported_from": args.ckpt,
               "reference_loss": float(ckpt["loss"])
               if "loss" in ckpt else None})
    kind = rcfg.kind if rcfg is not None else "none"
    print(f"imported {args.ckpt} -> {step_dir} "
          f"(decoder={dcfg.cell_type} h{dcfg.hidden_size} "
          f"vocab={dcfg.vocab_size}, reconstructor={kind}, step={step})")


if __name__ == "__main__":
    main()
