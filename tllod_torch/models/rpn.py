"""Region Proposal Network head and proposal layer
(``tllod_tpu/models/rpn.py:42-148``; reference ``lib/model/rpn/rpn.py``,
``proposal_layer.py:49-161``).

  * :class:`RPNHead`: 3×3 conv (512) + ReLU, then 1×1 convs for 2A scores
    and 4A deltas.
  * :func:`rpn_probs`: the pairwise (bg, fg) softmax over the 2A channel
    layout, background channels ``[:A]`` and foreground ``[A:]``.
  * :func:`proposal_layer`: decode → clip → top-k → NMS → fixed (B, postN, 5)
    zero-padded RoIs, all images in one NMS launch.

The pre-NMS top-k is a stable descending sort cut to k: ``lax.top_k`` breaks
ties toward the lower index and ``torch.topk`` promises no order, while a
stable sort keeps equal scores in index order, so bucket-padded regions,
where many anchors score the same, select the same boxes as JAX.
PA-ATF's random proposal sampling (``sample_rng``) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.ops.boxes import bbox_transform_inv, clip_boxes
from tllod_torch.ops.nms import nms_fixed_batched


class RPNHead(nn.Module):
    """NCHW in, NCHW (2A scores, 4A deltas) out."""

    def __init__(self, in_channels: int, num_anchors: int, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, 512, 3, padding=1, device=device)
        self.cls_score = nn.Conv2d(512, 2 * num_anchors, 1, device=device)
        self.bbox_pred = nn.Conv2d(512, 4 * num_anchors, 1, device=device)

    def forward(self, base_feat: torch.Tensor):
        x = F.relu(self.conv(base_feat))
        return self.cls_score(x), self.bbox_pred(x)


def rpn_probs(cls_score: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cls_score (B, H, W, 2A) → (fg_prob (B, H, W, A),
    logits (B, H, W, A, 2)), the softmax written as ``jax.nn.softmax``."""
    a = cls_score.shape[-1] // 2
    logits = torch.stack((cls_score[..., :a], cls_score[..., a:]), dim=-1)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    fg = e[..., 1] / (e[..., 0] + e[..., 1])
    return fg, logits


def proposal_layer(fg_prob: torch.Tensor, bbox_deltas: torch.Tensor,
                   im_info: torch.Tensor, anchors: torch.Tensor, *,
                   pre_nms_top_n: int, post_nms_top_n: int,
                   nms_thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchors + deltas → clipped, NMS-ed, fixed-count RoIs.

    fg_prob: (B, H, W, A); bbox_deltas: (B, H, W, 4A); im_info: (B, 3) rows
    (height, width, scale); anchors: (K*A, 4) in the (h, w, a) flatten
    order. Returns (rois (B, postN, 5) rows (batch_idx, x1, y1, x2, y2),
    zero-padded past ``valid`` with the batch index kept; valid (B, postN)).
    """
    b = fg_prob.shape[0]
    ka = anchors.shape[0]
    scores = fg_prob.reshape(b, ka)
    deltas = bbox_deltas.reshape(b, ka, 4)

    proposals = bbox_transform_inv(anchors, deltas)              # (B, KA, 4)
    proposals = clip_boxes(proposals, im_info[:, 0], im_info[:, 1])

    k = min(pre_nms_top_n, ka) if pre_nms_top_n > 0 else ka
    top_scores, order = torch.sort(scores, dim=1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    top_boxes = torch.gather(proposals, 1, order[..., None].expand(b, k, 4))

    idx, num = nms_fixed_batched(top_boxes, top_scores,
                                 iou_threshold=nms_thresh,
                                 max_output=post_nms_top_n, presorted=True)
    valid = (torch.arange(post_nms_top_n, device=idx.device)[None, :]
             < num[:, None])
    sel = torch.gather(top_boxes, 1,
                       idx[..., None].expand(b, post_nms_top_n, 4))
    boxes = torch.where(valid[..., None], sel, 0.0)
    batch_col = torch.arange(b, dtype=boxes.dtype, device=boxes.device)
    batch_col = batch_col[:, None, None].expand(b, post_nms_top_n, 1)
    return torch.cat([batch_col, boxes], dim=-1), valid
