"""COCO caption-annotation adapter — the caption-eval subset of the COCO API
(a copy of ``recnet_tpu/metrics/coco.py``).

The reference vendors the stock pycocotools/coco.py (368 LoC) but its RecNet
path only ever uses imgToAnns/getImgIds adapters (SURVEY §2: coco.py is
consumed only by the demo notebook). This module provides the same
caption-scoring surface for real COCO-format JSON files — load annotations,
build imgToAnns, attach result files — so CaptionScorer can score COCO-format
datasets directly (reference: coco_caption/pycocotools/coco.py, msvd.py,
utils.py).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Union


class COCOCaptions:
    """Minimal COCO caption dataset: {"images": [...], "annotations": [...]}.

    Supports the methods COCOEvalCap-style scoring relies on:
    imgToAnns, getImgIds, loadRes.
    """

    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[dict] = None):
        if annotation_file is not None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset or {"images": [], "annotations": []}
        self.imgs: Dict = {}
        self.anns: Dict = {}
        self.imgToAnns: Dict[Union[int, str], List[dict]] = defaultdict(list)
        self._create_index()

    def _create_index(self) -> None:
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for ann in self.dataset.get("annotations", []):
            self.anns[ann.get("id", len(self.anns))] = ann
            self.imgToAnns[ann["image_id"]].append(ann)
        # images without annotations still count as ids
        for img_id in self.imgs:
            self.imgToAnns.setdefault(img_id, [])

    def getImgIds(self) -> List:
        return list(self.imgToAnns.keys())

    def loadRes(self, res: Union[str, Sequence[dict]]) -> "COCOCaptions":
        """Attach results: [{"image_id": ..., "caption": ...}] or a JSON
        path thereof. Returns a COCOCaptions over the predictions."""
        if isinstance(res, str):
            with open(res) as f:
                res = json.load(f)
        anns = [{"id": i, "image_id": r["image_id"], "caption": r["caption"]}
                for i, r in enumerate(res)]
        return COCOCaptions(dataset={"images": list(self.dataset.get(
            "images", [])), "annotations": anns})

    def to_gts(self) -> Dict:
        """{img_id: [{'caption': str}]} for CaptionScorer."""
        return {iid: [{"caption": a["caption"]} for a in anns]
                for iid, anns in self.imgToAnns.items()}
