"""Box math for inference: decode and clip (``tllod_tpu/ops/boxes.py:41-80``).

Both keep the reference's legacy "+1" box convention (width = x2 - x1 + 1),
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
