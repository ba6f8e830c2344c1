"""Caption scoring: a copy of ``recnet_tpu.metrics`` (BLEU-1..4, METEOR,
ROUGE-L, CIDEr, the PTB tokenizer and the Porter stemmer) on its
pure-Python paths only.

The JAX package routes BLEU's and ROUGE's statistics and CIDEr's core
through its optional C++ module (``recnet_tpu/native/fastmetrics.cpp``)
when that is built; its tests pin those paths bit-equal to the Python ones,
so the scores here equal the JAX package's either way. Porting the C++ core
is open work (ROADMAP).
"""

from recnet_tpu_torch.metrics.score import (CaptionScorer, gts_from_pairs,
                                            res_from_dict)

__all__ = ["CaptionScorer", "gts_from_pairs", "res_from_dict"]
