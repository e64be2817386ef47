"""COCO-format dataset (json annotations → roidb), a copy of
``tllod_tpu/data/coco.py``.

Counterpart of the reference's ``lib/datasets/coco.py`` (which wraps the
vendored pycocotools). Training needs only boxes and classes, parsed here
from the COCO json directly: category ids (sparse, 1-90 in the real set) map
to contiguous class indices in id order, crowd annotations are left out of
the roidb and kept for evaluation, and each xywh box becomes a 0-based
inclusive xyxy box clipped to the image. :meth:`COCODetection.
evaluate_detections` runs the bbox COCO protocol of
:mod:`tllod_torch.data.coco_eval` (no ``pycocotools``) and writes the
standard ``detections_<name>_results.json``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from tllod_torch.data.voc import write_atomic


class COCODetection:
    """Minimal COCO-format reader exposing the same surface the loaders and
    eval driver need (``image_index``, ``classes``, ``gt_roidb``)."""

    def __init__(self, name: str, image_dir: str, annotation_file: str):
        self.name = name
        self.image_dir = image_dir
        with open(annotation_file) as f:
            data = json.load(f)
        cats = sorted(data["categories"], key=lambda c: c["id"])
        self.classes = ("__background__",) + tuple(c["name"] for c in cats)
        self.num_classes = len(self.classes)
        self._cat_to_ind = {c["id"]: i + 1 for i, c in enumerate(cats)}
        self._images = {im["id"]: im for im in data["images"]}
        self._anns: Dict[int, List[dict]] = {}
        self._eval_anns: Dict[int, List[dict]] = {}   # crowds kept for eval
        for ann in data["annotations"]:
            self._eval_anns.setdefault(ann["image_id"], []).append(ann)
            if ann.get("iscrowd", 0):
                continue
            self._anns.setdefault(ann["image_id"], []).append(ann)
        self.image_ids = sorted(self._images)
        self.image_index = [os.path.splitext(
            self._images[i]["file_name"])[0] for i in self.image_ids]
        self.image_ext = ".jpg"

    def image_path(self, index_or_id) -> str:
        if isinstance(index_or_id, int):
            return os.path.join(self.image_dir,
                                self._images[index_or_id]["file_name"])
        for iid in self.image_ids:
            if os.path.splitext(self._images[iid]["file_name"])[0] \
                    == index_or_id:
                return os.path.join(self.image_dir,
                                    self._images[iid]["file_name"])
        raise KeyError(index_or_id)

    def gt_roidb(self) -> List[dict]:
        roidb = []
        for iid in self.image_ids:
            im = self._images[iid]
            anns = self._anns.get(iid, [])
            boxes = np.zeros((len(anns), 4), np.float32)
            classes = np.zeros((len(anns),), np.int32)
            for k, ann in enumerate(anns):
                x, y, w, h = ann["bbox"]
                # xywh → 0-based inclusive xyxy, clipped (reference
                # coco.py's _load_coco_annotation box sanitization)
                boxes[k] = [max(0, x), max(0, y),
                            min(im["width"] - 1, x + max(0, w - 1)),
                            min(im["height"] - 1, y + max(0, h - 1))]
                classes[k] = self._cat_to_ind[ann["category_id"]]
            keep = (boxes[:, 2] >= boxes[:, 0]) & (boxes[:, 3] >= boxes[:, 1])
            roidb.append({
                "boxes": boxes[keep], "gt_classes": classes[keep],
                "gt_ishard": np.zeros(int(keep.sum()), np.int32),
                "flipped": False,
                "width": im["width"], "height": im["height"],
                "image": os.path.join(self.image_dir, im["file_name"]),
                "img_id": os.path.splitext(im["file_name"])[0],
            })
        return roidb

    # -- COCO-protocol evaluation (reference lib/datasets/coco.py:266-325 +
    # lib/pycocotools/cocoeval.py, bbox-only) --

    def evaluate_detections(self, all_boxes: List[List], output_dir: str
                            ) -> Dict[str, float]:
        """all_boxes[class][image] = (n, 5) [x1 y1 x2 y2 score] raw coords →
        the 12 COCO stats (AP@[.5:.95] headline). Also writes the standard
        detections_<name>_results.json (reference coco.py:299-315)."""
        import json as _json

        from tllod_torch.data.coco_eval import (evaluate_coco,
                                              print_coco_stats)

        ind_to_cat = {v: k for k, v in self._cat_to_ind.items()}
        gts, dts, results = {}, {}, []
        for iid in self.image_ids:
            for ann in self._eval_anns.get(iid, []):
                x, y, w, h = ann["bbox"]
                cat = ann["category_id"]
                gts.setdefault((iid, cat), []).append({
                    "bbox": [x, y, w, h],
                    "area": float(ann.get("area", w * h)),
                    "iscrowd": int(ann.get("iscrowd", 0))})
        for c in range(1, self.num_classes):
            cat = ind_to_cat[c]
            for i, iid in enumerate(self.image_ids):
                dets = np.asarray(all_boxes[c][i]
                                  if i < len(all_boxes[c]) else [])
                if dets.size == 0:
                    continue
                for x1, y1, x2, y2, score in dets:
                    # xyxy (0-based inclusive) → xywh (coco.py:304-310)
                    bbox = [float(x1), float(y1),
                            float(x2 - x1 + 1), float(y2 - y1 + 1)]
                    dts.setdefault((iid, cat), []).append(
                        {"bbox": bbox, "score": float(score)})
                    results.append({"image_id": int(iid), "category_id": cat,
                                    "bbox": [round(v, 2) for v in bbox],
                                    "score": float(score)})
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            res_file = os.path.join(
                output_dir, f"detections_{self.name}_results.json")
            write_atomic(res_file, _json.dumps(results).encode())
        out = evaluate_coco(gts, dts, sorted(ind_to_cat.values()),
                            self.image_ids)
        print_coco_stats(out["stats"])
        return out["stats"]
