"""Caption scoring orchestrator — COCOEvalCap equivalent, JVM-free.

Mirrors reference coco_caption/pycocoevalcap/eval.py:9-75: tokenize ground
truths and results with the PTB tokenizer, run BLEU-1..4 / METEOR / ROUGE_L /
CIDEr, collect corpus-level and per-image scores. SPICE is omitted exactly as
the reference disables it (eval.py:44).

Adapters mirror coco_caption/pycocotools/msvd.py (gts from video-caption
pairs) and utils.py load_res (predictions dict).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from recnet_tpu_torch.metrics.tokenizer import PTBTokenizer
from recnet_tpu_torch.metrics.bleu import Bleu
from recnet_tpu_torch.metrics.cider import Cider
from recnet_tpu_torch.metrics.meteor import Meteor
from recnet_tpu_torch.metrics.rouge import Rouge


def gts_from_pairs(video_caption_pairs: Sequence[Tuple[str, str]]
                   ) -> Dict[str, List[dict]]:
    """(vid, caption) pairs → {vid: [{'caption': str}]}
    (reference: pycocotools/msvd.py:4-13; also accepts (vid, video, caption)
    triples for drop-in compatibility)."""
    img_to_anns: Dict[str, List[dict]] = defaultdict(list)
    for pair in video_caption_pairs:
        vid, caption = pair[0], pair[-1]
        img_to_anns[vid].append({"caption": caption})
    return dict(img_to_anns)


def res_from_dict(pd_vid_caption_dict: Dict[str, List[str]]
                  ) -> Dict[str, List[dict]]:
    """{vid: [caption,...]} → {vid: [{'caption': str}]}
    (reference: pycocotools/utils.py:5-10)."""
    return {vid: [{"caption": c} for c in caps]
            for vid, caps in pd_vid_caption_dict.items()}


_meteor_warned = False


def _warn_meteor_once(version: str = "2007"):
    """One-time notice: METEOR here is pure Python, not the meteor-1.5 jar —
    values are not comparable to jar-based published numbers
    (metrics/meteor.py docstring for details)."""
    global _meteor_warned
    if not _meteor_warned:
        _meteor_warned = True
        import sys
        print(f"[recnet_tpu_torch] note: METEOR is a pure-Python scorer "
              f"(version={version}; no WordNet/paraphrase modules); do not "
              f"compare it against meteor-1.5.jar-based published numbers.",
              file=sys.stderr)


class CaptionScorer:
    """evaluate() → dict {metric: corpus score}; imgToEval per-image detail."""

    def __init__(self, gts: Dict[str, List[dict]],
                 res: Dict[str, List[dict]],
                 image_ids: Sequence[str] | None = None,
                 meteor_version: str = "2007"):
        self.gts_raw = gts
        self.res_raw = res
        self.meteor_version = meteor_version
        self.params = {"image_id": list(image_ids) if image_ids is not None
                       else list(gts.keys())}
        self.eval: Dict[str, float] = {}
        self.imgToEval: Dict[str, dict] = {}
        self.evalImgs: List[dict] = []

    def evaluate(self) -> Dict[str, float]:
        ids = self.params["image_id"]
        gts = {i: self.gts_raw[i] for i in ids}
        res = {i: self.res_raw[i] for i in ids}

        tok = PTBTokenizer()
        gts = tok.tokenize(gts)
        res = tok.tokenize(res)

        _warn_meteor_once(self.meteor_version)
        scorers = [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Meteor(version=self.meteor_version), "METEOR"),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ]
        for scorer, method in scorers:
            score, scores = scorer.compute_score(gts, res)
            if isinstance(method, list):
                for sc, scs, m in zip(score, scores, method):
                    self._set(sc, m)
                    self._set_imgs(scs, gts.keys(), m)
            else:
                self._set(score, method)
                self._set_imgs(scores, gts.keys(), method)
        self.evalImgs = list(self.imgToEval.values())
        return self.eval

    def _set(self, score, method):
        self.eval[method] = float(score)

    def _set_imgs(self, scores, img_ids, method):
        for iid, sc in zip(img_ids, scores):
            self.imgToEval.setdefault(iid, {"image_id": iid})[method] = float(sc)
