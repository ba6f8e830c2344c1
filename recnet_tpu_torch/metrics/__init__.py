"""Caption scoring: a copy of ``recnet_tpu.metrics`` (BLEU-1..4, METEOR,
ROUGE-L, CIDEr, the PTB tokenizer, the Porter stemmer and the COCO-format
caption adapter).

BLEU's and ROUGE's statistics and CIDEr's core take the port's C++ module
(``recnet_tpu_torch.native``, built with g++ at first use) when it builds,
and their pure-Python paths otherwise; the two are bit-equal, so the
scores here equal the JAX package's either way.
"""

from recnet_tpu_torch.metrics.bleu import Bleu
from recnet_tpu_torch.metrics.cider import Cider
from recnet_tpu_torch.metrics.coco import COCOCaptions
from recnet_tpu_torch.metrics.rouge import Rouge
from recnet_tpu_torch.metrics.score import (CaptionScorer, gts_from_pairs,
                                            res_from_dict)

__all__ = ["Bleu", "COCOCaptions", "CaptionScorer", "Cider", "Rouge",
           "gts_from_pairs", "res_from_dict"]
