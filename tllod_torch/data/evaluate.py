"""Detection evaluation driver (copy of ``tllod_tpu/data/evaluate.py``):
all_boxes → VOC results files → per-class AP/mAP (reference ``imdb.evaluate_detections`` →
``_write_voc_results_file`` → ``_do_python_eval``,
``lib/datasets/cityscape.py:290-377``)."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from tllod_torch.data.voc import VOCDetection
from tllod_torch.data.voc_eval import eval_class_detections, voc_eval


def write_voc_results(dataset: VOCDetection, all_boxes: List[List],
                      out_dir: str, comp_id: str = "comp4") -> str:
    """Write one results file per class: ``image_id score x1 y1 x2 y2`` with
    1-based coordinates (reference ``cityscape.py:290-306`` adds +1)."""
    os.makedirs(out_dir, exist_ok=True)
    template = os.path.join(out_dir,
                            f"{comp_id}_det_{dataset.split}_{{:s}}.txt")
    for cls_ind, cls in enumerate(dataset.classes):
        if cls == "__background__":
            continue
        with open(template.format(cls), "w") as f:
            for im_ind, index in enumerate(dataset.image_index):
                dets = all_boxes[cls_ind][im_ind]
                if len(dets) == 0:
                    continue
                for k in range(dets.shape[0]):
                    f.write(f"{index} {dets[k, -1]:.3f} "
                            f"{dets[k, 0] + 1:.1f} {dets[k, 1] + 1:.1f} "
                            f"{dets[k, 2] + 1:.1f} {dets[k, 3] + 1:.1f}\n")
    return template


def evaluate_detections(dataset: VOCDetection, all_boxes: List[List],
                        out_dir: str, *, use_07_metric: bool = True,
                        ovthresh: float = 0.5, use_salt: bool = False,
                        cleanup: bool = False) -> Dict[str, float]:
    """Per-class AP + mAP. The VOC07 11-point metric is the default, matching
    every published table (reference ``cityscape.py:323`` uses 07 metric for
    year < 2010).

    ``use_salt`` appends a uuid to the comp id so concurrent runs don't
    clobber each other's results files, and ``cleanup`` deletes them after
    scoring — the rbg-variant imdb's behavior
    (``lib/datasets/pascal_voc_rbg.py:48-54,189-192,283-293``).
    """
    comp_id = "comp4"
    if use_salt:
        import uuid
        comp_id += "_" + str(uuid.uuid4())
    template = write_voc_results(dataset, all_boxes, out_dir, comp_id=comp_id)
    cachedir = os.path.join(out_dir, "annotations_cache")
    aps: Dict[str, float] = {}
    for cls in dataset.classes:
        if cls == "__background__":
            continue
        _, _, ap = voc_eval(template, dataset.annopath_template,
                            dataset.imageset_file, cls, cachedir,
                            ovthresh=ovthresh, use_07_metric=use_07_metric)
        aps[cls] = ap
        if cleanup:
            os.remove(template.format(cls))
    aps["mAP"] = float(np.mean([v for k, v in aps.items() if k != "mAP"]))
    return aps


def evaluate_detections_roidb(dataset, roidb: Sequence[dict],
                              all_boxes: List[List], *,
                              ovthresh: float = 0.5,
                              use_07_metric: bool = True
                              ) -> Dict[str, float]:
    """In-memory VOC-style AP for datasets without an on-disk VOC devkit
    layout (imagenet, vg, DG-union names): class_recs come straight from
    the roidb (the pattern of reference ``lib/datasets/vg_eval.py:40-51``),
    ``gt_ishard`` plays the difficult flag like ``voc_eval``."""
    aps: Dict[str, float] = {}
    img_ids = [str(e.get("img_id", i)) for i, e in enumerate(roidb)]
    for c in range(1, dataset.num_classes):
        class_recs = {}
        for iid, entry in zip(img_ids, roidb):
            sel = np.asarray(entry["gt_classes"]) == c
            bbox = np.asarray(entry["boxes"])[sel]
            hard = np.asarray(entry.get(
                "gt_ishard", np.zeros(len(entry["gt_classes"]))))[sel]
            class_recs[iid] = {"bbox": bbox,
                               "difficult": hard.astype(bool),
                               "det": [False] * len(bbox)}
        det_ids, confs, boxes = [], [], []
        for iid, dets in zip(img_ids, all_boxes[c]):
            dets = np.asarray(dets)
            for k in range(len(dets)):
                det_ids.append(iid)
                confs.append(dets[k, 4])
                boxes.append(dets[k, :4])
        _, _, ap = eval_class_detections(
            class_recs, det_ids, np.asarray(confs, float),
            np.asarray(boxes, float).reshape(-1, 4),
            ovthresh=ovthresh, use_07_metric=use_07_metric)
        aps[dataset.classes[c]] = ap
    aps["mAP"] = float(np.mean([v for k, v in aps.items() if k != "mAP"]))
    return aps


def print_eval(aps: Dict[str, float]) -> None:
    for k, v in aps.items():
        if k != "mAP":
            print(f"AP for {k} = {v:.4f}")
    print(f"Mean AP = {aps['mAP']:.4f}")
