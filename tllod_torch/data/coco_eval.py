"""COCO detection evaluation protocol (bbox AP@[.5:.95]) in pure numpy
(copy of ``tllod_tpu/data/coco_eval.py``).

Reimplements the bbox path of the reference's vendored pycocotools
(``lib/pycocotools/cocoeval.py:1-452``) without the C
extension — detection needs no RLE masks, so this is the complete protocol
for this framework: 10 IoU thresholds × 4 area ranges × {1,10,100} maxDets,
101-point interpolated precision, crowd-aware greedy matching.

Matching semantics preserved exactly (``cocoeval.py evaluateImg``):
  * detections in score order, each takes the best-IoU unmatched gt;
  * crowd gts may be matched repeatedly, and IoU against a crowd gt divides
    by the detection's own area (``maskApi.c iou`` with iscrowd);
  * once a detection holds a non-ignored match, ignored gts can't steal it;
  * detections matched to ignored gts — or unmatched and outside the area
    range — are ignored (neither TP nor FP).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {"all": (0.0, 1e10), "small": (0.0, 32.0 ** 2),
             "medium": (32.0 ** 2, 96.0 ** 2), "large": (96.0 ** 2, 1e10)}
MAX_DETS = (1, 10, 100)


def iou_xywh(dts: np.ndarray, gts: np.ndarray,
             iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU for xywh boxes, vectorized; crowd gt → inter / det area
    (``maskApi.c bbIou`` semantics)."""
    D, G = len(dts), len(gts)
    if D == 0 or G == 0:
        return np.zeros((D, G))
    dts = np.asarray(dts, float)
    gts = np.asarray(gts, float)
    iw = (np.minimum(dts[:, None, 0] + dts[:, None, 2],
                     gts[None, :, 0] + gts[None, :, 2])
          - np.maximum(dts[:, None, 0], gts[None, :, 0]))
    ih = (np.minimum(dts[:, None, 1] + dts[:, None, 3],
                     gts[None, :, 1] + gts[None, :, 3])
          - np.maximum(dts[:, None, 1], gts[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    darea = (dts[:, 2] * dts[:, 3])[:, None]
    garea = (gts[:, 2] * gts[:, 3])[None, :]
    union = np.where(np.asarray(iscrowd, bool)[None, :], darea,
                     darea + garea - inter)
    out = np.zeros((D, G))
    np.divide(inter, union, out=out, where=union > 0)
    out[(iw <= 0) | (ih <= 0)] = 0.0
    return out


def evaluate_img(gt: List[dict], dt: List[dict], area_rng, max_det: int,
                 ious: np.ndarray = None):
    """Per (image, category) matching → dict of match/ignore arrays
    (``cocoeval.py:evaluateImg``).

    When ``ious`` is given, ``dt`` must already be score-sorted and ``ious``
    aligned to (sorted dt × original gt order) — the caller computes IoUs
    ONCE per (image, category) and reuses them across the 4 area ranges and
    3 maxDet caps, like pycocotools ``computeIoU``/``evaluateImg``.
    """
    if not gt and not dt:
        return None
    for g in gt:
        # crowds are always ignore regions (cocoeval.py _prepare)
        g["_ignore"] = 1 if (g.get("ignore") or g.get("iscrowd")
                             or g["area"] < area_rng[0]
                             or g["area"] > area_rng[1]) else 0
    gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
    gt = [gt[i] for i in gtind]
    if ious is None:
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:max_det]]
        iscrowd = np.array([int(g.get("iscrowd", 0)) for g in gt])
        ious = iou_xywh(
            np.array([d["bbox"] for d in dt], float).reshape(-1, 4),
            np.array([g["bbox"] for g in gt], float).reshape(-1, 4), iscrowd)
    else:
        dt = dt[:max_det]
        ious = ious[:len(dt)][:, gtind] if ious.size else ious
    iscrowd = np.array([int(g.get("iscrowd", 0)) for g in gt])

    T, G, D = len(IOU_THRS), len(gt), len(dt)
    gtm = np.zeros((T, G))
    dtm = np.zeros((T, D))
    gt_ig = np.array([g["_ignore"] for g in gt])
    dt_ig = np.zeros((T, D))
    for tind, t in enumerate(IOU_THRS):
        for dind in range(D):
            iou = min(t, 1 - 1e-10)
            m = -1
            for gind in range(G):
                # gt already matched at this thresh, and not a crowd
                if gtm[tind, gind] > 0 and not iscrowd[gind]:
                    continue
                # dt holds a real match; later gts are all ignored → stop
                if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                    break
                if ious[dind, gind] < iou:
                    continue
                iou = ious[dind, gind]
                m = gind
            if m == -1:
                continue
            dt_ig[tind, dind] = gt_ig[m]
            dtm[tind, dind] = 1
            gtm[tind, m] = 1
    # unmatched dets outside the area range are ignored
    a = np.array([d["bbox"][2] * d["bbox"][3] < area_rng[0]
                  or d["bbox"][2] * d["bbox"][3] > area_rng[1]
                  for d in dt]).reshape(1, -1) if D else np.zeros((1, 0))
    dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0, np.repeat(a, T, 0)))
    return {"dt_matches": dtm, "dt_ignore": dt_ig, "gt_ignore": gt_ig,
            "dt_scores": np.array([d["score"] for d in dt])}


def evaluate_coco(gts_by_img: Dict, dts_by_img: Dict,
                  cat_ids: Sequence[int], img_ids: Sequence) -> Dict:
    """Full protocol → the 12 COCO stats plus the precision tensor.

    gts_by_img[(img, cat)] → [{bbox xywh, area, iscrowd, ignore}, ...];
    dts_by_img[(img, cat)] → [{bbox xywh, score}, ...].
    """
    T, R = len(IOU_THRS), len(REC_THRS)
    K, A, M = len(cat_ids), len(AREA_RNGS), len(MAX_DETS)
    precision = -np.ones((T, R, K, A, M))
    recall = -np.ones((T, K, A, M))
    area_items = list(AREA_RNGS.items())

    max_cap = max(MAX_DETS)
    for k, cat in enumerate(cat_ids):
        # score-sort detections and compute IoUs ONCE per (img, cat); the
        # 4 area × 3 maxDet combinations below reuse them (pycocotools
        # computeIoU caching)
        per_img = {}
        for img in img_ids:
            gt = gts_by_img.get((img, cat), [])
            dt = dts_by_img.get((img, cat), [])
            order = np.argsort([-d["score"] for d in dt], kind="mergesort")
            dt = [dt[i] for i in order[:max_cap]]
            iscrowd = np.array([int(g.get("iscrowd", 0)) for g in gt])
            ious = iou_xywh(
                np.array([d["bbox"] for d in dt], float).reshape(-1, 4),
                np.array([g["bbox"] for g in gt], float).reshape(-1, 4),
                iscrowd)
            per_img[img] = (gt, dt, ious)
        for a, (_, rng) in enumerate(area_items):
            for m, max_det in enumerate(MAX_DETS):
                evals = [evaluate_img(
                    [dict(g) for g in per_img[img][0]],
                    list(per_img[img][1]), rng, max_det,
                    ious=per_img[img][2]) for img in img_ids]
                evals = [e for e in evals if e is not None]
                if not evals:
                    continue
                scores = np.concatenate([e["dt_scores"] for e in evals])
                order = np.argsort(-scores, kind="mergesort")
                dtm = np.concatenate([e["dt_matches"] for e in evals],
                                     axis=1)[:, order]
                dt_ig = np.concatenate([e["dt_ignore"] for e in evals],
                                       axis=1)[:, order]
                npig = int(np.sum(np.concatenate(
                    [e["gt_ignore"] for e in evals]) == 0))
                if npig == 0:
                    continue
                tps = np.logical_and(dtm, np.logical_not(dt_ig))
                fps = np.logical_and(np.logical_not(dtm),
                                     np.logical_not(dt_ig))
                tp_sum = np.cumsum(tps, axis=1).astype(float)
                fp_sum = np.cumsum(fps, axis=1).astype(float)
                for t in range(T):
                    tp, fp = tp_sum[t], fp_sum[t]
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall[t, k, a, m] = rc[-1] if len(rc) else 0.0
                    q = np.zeros((R,))
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[t, :, k, a, m] = q

    def _summarize(ap=True, iou=None, area="all", max_det=100):
        aind = [i for i, (nm, _) in enumerate(area_items) if nm == area][0]
        mind = MAX_DETS.index(max_det)
        if ap:
            s = precision[:, :, :, aind, mind]
            if iou is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
        else:
            s = recall[:, :, aind, mind]
            if iou is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    stats = {
        "AP": _summarize(True),
        "AP50": _summarize(True, iou=0.5),
        "AP75": _summarize(True, iou=0.75),
        "AP_small": _summarize(True, area="small"),
        "AP_medium": _summarize(True, area="medium"),
        "AP_large": _summarize(True, area="large"),
        "AR_1": _summarize(False, max_det=1),
        "AR_10": _summarize(False, max_det=10),
        "AR_100": _summarize(False),
        "AR_small": _summarize(False, area="small"),
        "AR_medium": _summarize(False, area="medium"),
        "AR_large": _summarize(False, area="large"),
    }
    return {"stats": stats, "precision": precision, "recall": recall}


def print_coco_stats(stats: Dict[str, float]) -> None:
    rows = [
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | "
         "maxDets=100 ]", "AP"),
        ("Average Precision  (AP) @[ IoU=0.50      | area=   all | "
         "maxDets=100 ]", "AP50"),
        ("Average Precision  (AP) @[ IoU=0.75      | area=   all | "
         "maxDets=100 ]", "AP75"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | "
         "maxDets=100 ]", "AP_small"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | "
         "maxDets=100 ]", "AP_medium"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | "
         "maxDets=100 ]", "AP_large"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | "
         "maxDets=  1 ]", "AR_1"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | "
         "maxDets= 10 ]", "AR_10"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | "
         "maxDets=100 ]", "AR_100"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | "
         "maxDets=100 ]", "AR_small"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | "
         "maxDets=100 ]", "AR_medium"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | "
         "maxDets=100 ]", "AR_large"),
    ]
    for label, key in rows:
        print(f" {label} = {stats[key]:.3f}")
