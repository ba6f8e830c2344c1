"""CLI: export a port (npz) checkpoint to the reference's torch format.

    python -m recnet_tpu_torch.cli.export_torch \
        --ckpt checkpoints/<run-id>/<step> --out 100000_checkpoint.tar

The port's counterpart of ``recnet_tpu.cli.export_torch``. The output is a
reference-style ``*_checkpoint.tar`` (reference: train.py:395-418) that the
reference's own ``eval.py`` loads next to its ``config.py``: weights and
the torch-Adam moments, so the reference could continue training from it.
The checkpoint's structure comes from its config.json
(``checkpoint.load_checkpoint``). A host tool: it converts files and
touches no device.
"""

from __future__ import annotations

import argparse

from recnet_tpu_torch import checkpoint as ckpt_mod
from recnet_tpu_torch import interop


def main(argv=None):
    a = argparse.ArgumentParser(description=__doc__)
    a.add_argument("--ckpt", type=str, required=True,
                   help="checkpoint step directory (npz)")
    a.add_argument("--out", type=str, required=True,
                   help="output .tar path (reference torch format)")
    a.add_argument("--loss", type=float, default=None,
                   help="loss value to record (reference stores the last "
                        "train loss; defaults to the checkpoint's metadata "
                        "value when present, else 0.0)")
    args = a.parse_args(argv)

    tc, vocab = ckpt_mod.load_config_and_vocab(args.ckpt)
    state, meta = ckpt_mod.load_checkpoint(args.ckpt, tc, vocab.n_vocabs,
                                           device="cpu")
    loss = args.loss
    if loss is None:
        for key in ("loss", "reference_loss"):
            if isinstance(meta.get(key), (int, float)):
                loss = float(meta[key])
                break

    interop.export_reference_checkpoint(args.out, state, tc, loss=loss)
    kind = tc.reconstructor_type if tc.use_recon else "none"
    print(f"exported {args.ckpt} -> {args.out} "
          f"(decoder={tc.decoder_model} vocab={vocab.n_vocabs}, "
          f"reconstructor={kind}, step={state.step})")


if __name__ == "__main__":
    main()
