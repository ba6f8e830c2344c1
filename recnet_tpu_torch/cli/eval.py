"""CLI: python -m recnet_tpu_torch.cli.eval --ckpt <dir>/<step> [--beam 5]

Port of ``recnet_tpu.cli.eval`` (reference eval.py:172-208): read a JAX
npz checkpoint, decode the test split with beam search (or ``--greedy``) on
``--device``, write predictions.txt and print the scores. The vocab comes
from the checkpoint itself.
"""

from __future__ import annotations

import argparse

from recnet_tpu_torch import checkpoint as ckpt
from recnet_tpu_torch.data import Corpus
from recnet_tpu_torch.evaluation import evaluate
from recnet_tpu_torch.models.decoder import config_from_train
from recnet_tpu_torch.weights import params_from_jax


def main(argv=None):
    a = argparse.ArgumentParser()
    a.add_argument("--ckpt", type=str, required=True,
                   help="checkpoint step directory")
    a.add_argument("--beam", type=int, default=5)
    a.add_argument("--greedy", action="store_true")
    a.add_argument("--data_root", type=str, default=None,
                   help="override the data root stored in the checkpoint")
    a.add_argument("--use_pallas", action="store_true", default=None,
                   help="decode with the hand-written kernels: whole-decode "
                        "for greedy, projection + top-K for beam (default: "
                        "whatever the checkpoint trained with)")
    a.add_argument("--greedy_segment", type=int, default=None,
                   help="with the kernels and --greedy: decode in N-step "
                        "segments and stop once every row has its first "
                        "<EOS>, sentence-exact (default: the checkpoint's "
                        "setting)")
    a.add_argument("--device", type=str, default="cuda",
                   help="torch device to decode on (default cuda)")
    args = a.parse_args(argv)

    tc, vocab = ckpt.load_config_and_vocab(args.ckpt)
    if args.data_root:
        tc = tc.replace(data_root=args.data_root)
    if args.use_pallas is not None:
        tc = tc.replace(use_pallas=args.use_pallas)
    if args.greedy_segment is not None:
        tc = tc.replace(greedy_segment=args.greedy_segment)
    # only the score loader and the test captions are needed; a bundle key
    # would stat every split's files, which an eval host may not carry
    tc = tc.replace(build_train_data_loader=False,
                    build_val_data_loader=False,
                    build_test_data_loader=True,
                    build_score_data_loader=True,
                    data_bundle=False)

    params = params_from_jax(
        ckpt.load_decoder_params(args.ckpt, tc, vocab.n_vocabs), args.device)
    corpus = Corpus(tc, vocab=vocab)
    search = "greedy" if args.greedy else ("beam", args.beam)
    scores = evaluate(tc, corpus, params,
                      config_from_train(tc, vocab.n_vocabs), search)
    print(scores)
    return scores


if __name__ == "__main__":
    main()
