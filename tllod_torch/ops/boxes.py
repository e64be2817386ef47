"""Box math: encode, decode, clip and IoU (``tllod_tpu/ops/boxes.py``).

All keep the reference's legacy "+1" box convention (width = x2 - x1 + 1),
which the published mAP numbers depend on, and take any leading batch dims.

``pred_cx = dx * width + ctr_x`` is one fused multiply-add with a single
rounding, as XLA contracts this expression in the JAX package; it is computed
in float64 and rounded once to float32 (the product of two float32 values is
exact in float64), so decoded boxes match the JAX ones bit for bit wherever
``exp`` agrees.
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to ``a``'s float32 type."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def bbox_transform(ex_rois: torch.Tensor, gt_rois: torch.Tensor
                   ) -> torch.Tensor:
    """Encode gt boxes relative to example boxes → (dx, dy, dw, dh);
    (..., N, 4) × (..., N, 4) → (..., N, 4) (``boxes.py:18``)."""
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h

    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h

    dx = (gt_cx - ex_cx) / ex_w
    dy = (gt_cy - ex_cy) / ex_h
    dw = torch.log(gt_w / ex_w)
    dh = torch.log(gt_h / ex_h)
    return torch.stack((dx, dy, dw, dh), dim=-1)


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor,
                  mask_zero_area: bool = False) -> torch.Tensor:
    """Pairwise IoU, (..., N, 4) × (..., K, 4) → (..., N, K) (``boxes.py:
    83``). With ``mask_zero_area`` an all-zero query box (a padded gt slot)
    gives 0 and an all-zero candidate box (a padded RoI slot) gives -1."""
    bx = boxes[..., 2] - boxes[..., 0] + 1.0
    by = boxes[..., 3] - boxes[..., 1] + 1.0
    qx = query_boxes[..., 2] - query_boxes[..., 0] + 1.0
    qy = query_boxes[..., 3] - query_boxes[..., 1] + 1.0
    areas = (bx * by)[..., :, None]
    query_areas = (qx * qy)[..., None, :]

    def pair(i):
        return boxes[..., i][..., :, None], query_boxes[..., i][..., None, :]

    iw = (torch.minimum(*pair(2)) - torch.maximum(*pair(0)) + 1.0).clamp(min=0)
    ih = (torch.minimum(*pair(3)) - torch.maximum(*pair(1)) + 1.0).clamp(min=0)
    inter = iw * ih
    overlaps = inter / (areas + query_areas - inter)

    if mask_zero_area:
        query_zero = ((qx == 1.0) & (qy == 1.0))[..., None, :]
        box_zero = ((bx == 1.0) & (by == 1.0))[..., :, None]
        overlaps = torch.where(query_zero, 0.0, overlaps)
        overlaps = torch.where(box_zero, -1.0, overlaps)
    return overlaps


def bbox_transform_inv(boxes: torch.Tensor, deltas: torch.Tensor
                       ) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas on anchor/RoI boxes.

    ``boxes`` is (..., N, 4); ``deltas`` is (..., N, 4*K) with K sets of
    deltas interleaved every 4 columns. Returns (..., N, 4*K) xyxy boxes.
    """
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    d = deltas.reshape(deltas.shape[:-1] + (deltas.shape[-1] // 4, 4))
    dx, dy, dw, dh = d.unbind(-1)

    pred_cx = fma(dx, widths[..., None], ctr_x[..., None])
    pred_cy = fma(dy, heights[..., None], ctr_y[..., None])
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack((pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h), dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, im_h, im_w) -> torch.Tensor:
    """Clamp xyxy boxes (..., M, 4K) into [0, W-1] × [0, H-1].

    ``im_h``/``im_w`` are numbers or tensors of the leading batch shape
    ``boxes.shape[:-2]`` (one size per image).
    """
    k = boxes.shape[-1] // 4
    b = boxes.reshape(boxes.shape[:-1] + (k, 4))

    def hi(v):
        v = torch.as_tensor(v, dtype=boxes.dtype, device=boxes.device) - 1.0
        return v.reshape(v.shape + (1, 1))

    hi_x, hi_y = hi(im_w), hi(im_h)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(b[..., 0], zero), hi_x)
    y1 = torch.minimum(torch.maximum(b[..., 1], zero), hi_y)
    x2 = torch.minimum(torch.maximum(b[..., 2], zero), hi_x)
    y2 = torch.minimum(torch.maximum(b[..., 3], zero), hi_y)
    return torch.stack((x1, y1, x2, y2), dim=-1).reshape(boxes.shape)
