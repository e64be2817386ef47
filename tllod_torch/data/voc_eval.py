"""Pascal VOC detection evaluation, pure numpy (copy of
``tllod_tpu/data/voc_eval.py``).

Reimplements ``lib/datasets/voc_eval.py``: per-class PR curve with greedy
one-to-one gt matching at IoU>thresh, difficult-gt exclusion, and both AP
metrics — the VOC07 11-point interpolation (used by all the published
Cityscapes→Foggy numbers, selected at ``lib/datasets/cityscape.py:323``) and
the area-under-PR variant.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence, Tuple

import numpy as np

from tllod_torch.data.voc import write_atomic


def parse_rec(filename: str) -> List[dict]:
    """Parse one VOC xml annotation (reference ``voc_eval.py:15-33``)."""
    tree = ET.parse(filename)
    objects = []
    for obj in tree.findall("object"):
        bbox = obj.find("bndbox")
        diff = obj.find("difficult")
        objects.append({
            "name": obj.find("name").text,
            "difficult": 0 if diff is None else int(diff.text),
            "bbox": [int(float(bbox.find("xmin").text)),
                     int(float(bbox.find("ymin").text)),
                     int(float(bbox.find("xmax").text)),
                     int(float(bbox.find("ymax").text))],
        })
    return objects


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a PR curve (reference ``voc_eval.py:36-67``)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_class_detections(
        class_recs: Dict[str, dict],
        image_ids: Sequence[str],
        confidence: np.ndarray,
        boxes: np.ndarray, *,
        ovthresh: float = 0.5,
        use_07_metric: bool = False) -> Tuple[np.ndarray, np.ndarray, float]:
    """Core matcher (reference ``voc_eval.py:152-211``): detections sorted by
    confidence, greedy match to the best un-matched, non-difficult gt.

    class_recs: image_id → {"bbox": (n,4), "difficult": (n,) bool,
    "det": [False]*n (mutated)}. Boxes are 1-based inclusive VOC coords.
    """
    npos = sum(int((~r["difficult"]).sum()) for r in class_recs.values())
    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    if nd > 0:
        order = np.argsort(-confidence)
        boxes = boxes[order]
        image_ids = [image_ids[i] for i in order]
        for d in range(nd):
            r = class_recs[image_ids[d]]
            bb = boxes[d]
            ovmax, jmax = -np.inf, -1
            gt = r["bbox"].astype(float)
            if gt.size > 0:
                ixmin = np.maximum(gt[:, 0], bb[0])
                iymin = np.maximum(gt[:, 1], bb[1])
                ixmax = np.minimum(gt[:, 2], bb[2])
                iymax = np.minimum(gt[:, 3], bb[3])
                iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
                ih = np.maximum(iymax - iymin + 1.0, 0.0)
                inter = iw * ih
                uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                       + (gt[:, 2] - gt[:, 0] + 1.0)
                       * (gt[:, 3] - gt[:, 1] + 1.0) - inter)
                overlaps = inter / uni
                ovmax = overlaps.max()
                jmax = int(overlaps.argmax())
            if ovmax > ovthresh:
                if not r["difficult"][jmax]:
                    if not r["det"][jmax]:
                        tp[d] = 1.0
                        r["det"][jmax] = True
                    else:
                        fp[d] = 1.0
            else:
                fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def voc_eval(detpath: str, annopath: str, imagesetfile: str, classname: str,
             cachedir: str, ovthresh: float = 0.5,
             use_07_metric: bool = False):
    """File-based API matching the reference ``voc_eval`` signature
    (``voc_eval.py:70-104``): results files + xml annotations → (rec, prec,
    ap). Annotations are pickle-cached per image-set file, written whole
    or not at all."""
    os.makedirs(cachedir, exist_ok=True)
    cachefile = os.path.join(
        cachedir, "%s_annots.pkl" % os.path.basename(imagesetfile))
    with open(imagesetfile) as f:
        imagenames = [x.strip() for x in f if x.strip()]

    if os.path.isfile(cachefile):
        with open(cachefile, "rb") as f:
            recs = pickle.load(f)
    else:
        recs = {name: parse_rec(annopath.format(name))
                for name in imagenames}
        write_atomic(cachefile, pickle.dumps(recs))

    class_recs = {}
    for name in imagenames:
        objs = [o for o in recs[name] if o["name"] == classname]
        class_recs[name] = {
            "bbox": np.array([o["bbox"] for o in objs]).reshape(-1, 4),
            "difficult": np.array([o["difficult"] for o in objs],
                                  dtype=bool),
            "det": [False] * len(objs),
        }

    with open(detpath.format(classname)) as f:
        lines = [x.strip().split(" ") for x in f if x.strip()]
    image_ids = [x[0] for x in lines]
    confidence = np.array([float(x[1]) for x in lines])
    boxes = np.array([[float(z) for z in x[2:]] for x in lines]
                     ).reshape(-1, 4)
    return eval_class_detections(class_recs, image_ids, confidence, boxes,
                                 ovthresh=ovthresh,
                                 use_07_metric=use_07_metric)
