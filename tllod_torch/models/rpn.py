"""Region Proposal Network head, proposal layer and target assignment
(``tllod_tpu/models/rpn.py``; reference ``lib/model/rpn/rpn.py``,
``proposal_layer.py:49-161``, ``anchor_target_layer.py:48-193``,
``proposal_target_layer_cascade.py:116-212``).

  * :class:`RPNHead`: 3×3 conv (512) + ReLU, then 1×1 convs for 2A scores
    and 4A deltas.
  * :func:`rpn_probs`: the pairwise (bg, fg) softmax over the 2A channel
    layout, background channels ``[:A]`` and foreground ``[A:]``.
  * :func:`proposal_layer`: decode → clip → top-k → NMS → fixed (B, postN, 5)
    zero-padded RoIs, all images in one NMS launch; the RoIs are detached,
    as the JAX package's ``stop_gradient`` (``rpn.py:144-148``).
  * :func:`anchor_target` and :func:`proposal_target`: IoU assignment and
    random subsampling as masked, fixed-count selections ("i.i.d. uniform
    priority → top by rank"), so a train step never waits on a count.
    Both take their uniform priorities as an argument: the train step's
    :class:`tllod_torch.train.StepRandom` draws (a test feeds them the
    ``jax.random`` draws).

The pre-NMS top-k is a stable descending sort cut to k: ``lax.top_k`` breaks
ties toward the lower index and ``torch.topk`` promises no order, while a
stable sort keeps equal scores in index order, so bucket-padded regions,
where many anchors score the same, select the same boxes as JAX. For the
same reason :func:`proposal_target` ranks with a stable sort, as
``jnp.argsort`` does, and :func:`anchor_target` takes only the *values* of
its top-k cuts.

PA-ATF's target pass samples its proposals (``rpn.py:115-131``; reference
``lib/PA_ATF/proposal_layer1.py:153-161``): :func:`proposal_layer` given
``sample_priorities`` keeps the first quarter of the NMS survivors in rank
order and fills the rest from a random subset of the other survivors. The
priorities are one (B, postN) uniform, which JAX draws per image from
``jax.random.split(sample_rng, B)``; the ranking is a stable ascending sort
of ``-priority``, as ``jnp.argsort`` is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.config import Config
from tllod_torch.models.layers import Conv2d
from tllod_torch.ops.boxes import (bbox_overlaps, bbox_transform,
                                   bbox_transform_inv, clip_boxes)
from tllod_torch.ops.nms import nms_fixed_batched


class RPNHead(nn.Module):
    """NCHW in, NCHW (2A scores, 4A deltas) out."""

    def __init__(self, in_channels: int, num_anchors: int, device=None):
        super().__init__()
        self.conv = Conv2d(in_channels, 512, 3, padding=1, device=device)
        self.cls_score = Conv2d(512, 2 * num_anchors, 1, device=device)
        self.bbox_pred = Conv2d(512, 4 * num_anchors, 1, device=device)

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
                   nms_thresh: float,
                   sample_priorities: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchors + deltas → clipped, NMS-ed, fixed-count RoIs.

    fg_prob: (B, H, W, A); bbox_deltas: (B, H, W, 4A); im_info: (B, 3) rows
    (height, width, scale); anchors: (K*A, 4) in the (h, w, a) flatten
    order. Returns (rois (B, postN, 5) rows (batch_idx, x1, y1, x2, y2),
    zero-padded past ``valid`` with the batch index kept; valid (B, postN)).
    With ``sample_priorities``, a (B, postN) uniform in [0, 1), the
    survivors are PA-ATF's sample (:func:`sample_survivors`).
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
    if sample_priorities is None:
        valid = (torch.arange(post_nms_top_n, device=idx.device)[None, :]
                 < num[:, None])
    else:
        idx, valid = sample_survivors(idx, num, sample_priorities)
    sel = torch.gather(top_boxes, 1,
                       idx[..., None].expand(b, post_nms_top_n, 4))
    boxes = torch.where(valid[..., None], sel, 0.0)
    batch_col = torch.arange(b, dtype=boxes.dtype, device=boxes.device)
    batch_col = batch_col[:, None, None].expand(b, post_nms_top_n, 1)
    return torch.cat([batch_col, boxes], dim=-1).detach(), valid


def sample_survivors(idx: torch.Tensor, num: torch.Tensor,
                     priorities: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PA-ATF's proposal selection (``rpn.py:115-129``): of the NMS keep
    list idx (B, postN), whose first ``num`` (B,) entries are survivors,
    keep the first q = int(0.25·postN) in rank order, then fill the other
    slots with the remaining survivors in the order of their
    ``priorities`` (B, postN), highest first; slots past the survivors sort
    last, in index order. Returns (idx, valid), both (B, postN)."""
    b, post = idx.shape
    q = int(post * 0.25)
    u = _uniforms([priorities], [(b, post)], idx.device)[0]
    slot = torch.arange(post, device=idx.device)[None, :]
    avail = (slot >= q) & (slot < num[:, None])
    pr = torch.where(avail, u, -torch.inf)
    perm = torch.sort(-pr, dim=1, stable=True).indices[:, :post - q]
    idx = torch.cat([idx[:, :q], torch.gather(idx, 1, perm)], dim=1)
    n_head = torch.clamp(num, max=q)[:, None]
    n_tail = torch.clamp(num - q, min=0)[:, None]
    valid = torch.where(slot < q, slot < n_head, slot - q < n_tail)
    return idx, valid


def _uniforms(priorities: Sequence[torch.Tensor], shapes, device):
    """The priorities as float32 tensors on ``device``, checked against
    ``shapes``."""
    out = [torch.as_tensor(u, dtype=torch.float32, device=device)
           for u in priorities]
    if [tuple(u.shape) for u in out] != [tuple(s) for s in shapes]:
        raise ValueError(f"priorities of shapes {[tuple(u.shape) for u in out]}"
                         f" given, {[tuple(s) for s in shapes]} expected")
    return out


def _row(values: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    """A config row as a tensor on ``like``'s device, made by fill kernels:
    ``torch.tensor(..., device=cuda)`` would wait for the card."""
    return torch.stack([torch.full((), float(v), dtype=like.dtype,
                                   device=like.device) for v in values])


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row gather along dim 1: x (B, N, ...), idx (B, K) → (B, K, ...)."""
    idx = idx.long()
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


class AnchorTargets(NamedTuple):
    labels: torch.Tensor        # (B, K*A) in {-1 ignore, 0 bg, 1 fg}
    bbox_targets: torch.Tensor  # (B, K*A, 4)
    in_weights: torch.Tensor    # (B, K*A)
    out_weights: torch.Tensor   # (B, K*A)


def anchor_target(gt_boxes: torch.Tensor, im_info: torch.Tensor,
                  anchors: torch.Tensor, cfg: Config,
                  priorities: Sequence[torch.Tensor]) -> AnchorTargets:
    """Assign anchors to gt and subsample to RPN_BATCHSIZE (``rpn.py:
    158-227``). gt_boxes (B, G, 5) zero-padded; anchors (K*A, 4);
    ``priorities`` = (u_fg, u_bg), each (B, K*A) uniform in [0, 1)."""
    t = cfg.TRAIN
    num_fg = int(t.RPN_FG_FRACTION * t.RPN_BATCHSIZE)
    b, n = gt_boxes.shape[0], anchors.shape[0]
    u_fg, u_bg = _uniforms(priorities, [(b, n), (b, n)], anchors.device)

    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[None, :, 2] < torch.floor(im_info[:, 1:2]))
              & (anchors[None, :, 3] < torch.floor(im_info[:, 0:1])))
    ov = bbox_overlaps(anchors, gt_boxes[..., :4], mask_zero_area=True)
    ov = torch.where(inside[..., None], ov, -1.0)                # (B, N, G)
    max_ov, argmax_ov = ov.max(dim=2)

    labels = torch.full((b, n), -1, dtype=torch.int32, device=ov.device)
    labels = torch.where(inside & (max_ov < t.RPN_NEGATIVE_OVERLAP),
                         0, labels)
    # the best anchor of each gt is positive, ties included; a gt with no
    # overlap is masked out by the 1e-5 substitution
    gt_max = ov.max(dim=1, keepdim=True).values
    gt_max = torch.where(gt_max == 0, 1e-5, gt_max)
    is_best = (ov == gt_max).any(dim=2)
    labels = torch.where(is_best, 1, labels)
    labels = torch.where(inside & (max_ov >= t.RPN_POSITIVE_OVERLAP),
                         1, labels)

    # disable excess fg, then excess bg: "rank(pr) < k" is "pr >= the k-th
    # largest", so only the values of the top-k are needed
    fg = labels == 1
    pr = torch.where(fg, u_fg, -torch.inf)
    fg_thr = torch.topk(pr, min(num_fg, n), dim=1).values[:, -1:]
    labels = torch.where(fg & (pr < fg_thr), -1, labels)
    num_bg = t.RPN_BATCHSIZE - (labels == 1).sum(dim=1, keepdim=True)
    bg = labels == 0
    pr = torch.where(bg, u_bg, -torch.inf)
    k_cap = min(t.RPN_BATCHSIZE, n)
    bg_vals = torch.topk(pr, k_cap, dim=1).values
    bg_thr = torch.gather(bg_vals, 1, torch.clamp(num_bg - 1, 0, k_cap - 1))
    labels = torch.where(bg & (pr < bg_thr), -1, labels)

    targets = bbox_transform(anchors.expand(b, n, 4),
                             _take(gt_boxes[..., :4], argmax_ov))
    targets = torch.where(inside[..., None], targets, 0.0)

    in_w = torch.where(labels == 1, float(t.RPN_BBOX_INSIDE_WEIGHTS[0]), 0.0)
    # uniform example weighting (RPN_POSITIVE_WEIGHT = -1): every sampled
    # example weighs 1 / num_examples
    num_ex = torch.clamp((labels >= 0).sum(dim=1, keepdim=True), min=1)
    out_w = torch.where(labels >= 0, 1.0 / num_ex.float(), 0.0)
    return AnchorTargets(labels, targets, in_w, out_w)


class RoiSamples(NamedTuple):
    rois: torch.Tensor          # (B, S, 5)
    labels: torch.Tensor        # (B, S) int32 class ids (0 = bg)
    bbox_targets: torch.Tensor  # (B, S, 4) normalized, for the labeled class
    in_weights: torch.Tensor    # (B, S, 4)
    out_weights: torch.Tensor   # (B, S, 4)


def proposal_target(rois: torch.Tensor, gt_boxes: torch.Tensor, cfg: Config,
                    priorities: Sequence[torch.Tensor]) -> RoiSamples:
    """Sample S = TRAIN.BATCH_SIZE RoIs per image with fg fraction
    TRAIN.FG_FRACTION (``rpn.py:238-315``). rois (B, N, 5) from the
    proposal layer, gt_boxes (B, G, 5) zero-padded; ``priorities`` =
    (u1, u2, u3, u4): the fg and bg ranking draws, (B, N + G) each, and the
    fg and bg with-replacement draws, (B, S) each."""
    t = cfg.TRAIN
    s = t.BATCH_SIZE
    fg_per_image = int(round(t.FG_FRACTION * s)) or 1
    dev = rois.device
    b, g = gt_boxes.shape[:2]
    gt_as_rois = torch.cat([torch.zeros_like(gt_boxes[..., :1]),
                            gt_boxes[..., :4]], dim=-1)
    cand = torch.cat([rois, gt_as_rois], dim=1)                 # (B, N+G, 5)
    n = cand.shape[1]
    u1, u2, u3, u4 = _uniforms(priorities, [(b, n), (b, n), (b, s), (b, s)],
                               dev)

    ov = bbox_overlaps(cand[..., 1:5], gt_boxes[..., :4], mask_zero_area=True)
    max_ov, gt_assign = ov.max(dim=2)
    cand_labels = _take(gt_boxes[..., 4], gt_assign).to(torch.int32)

    fg = max_ov >= t.FG_THRESH
    bg = (max_ov < t.BG_THRESH_HI) & (max_ov >= t.BG_THRESH_LO)
    n_fg_avail = fg.sum(dim=1, keepdim=True)
    n_bg_avail = bg.sum(dim=1, keepdim=True)

    # fg (resp. bg) candidates first, in uniformly random order; the stable
    # sort keeps the -inf rest in index order, as jnp.argsort does
    fg_order = torch.sort(-torch.where(fg, u1, -torch.inf), dim=1,
                          stable=True).indices
    bg_order = torch.sort(-torch.where(bg, u2, -torch.inf), dim=1,
                          stable=True).indices

    # with-replacement draws (reference floor(rand * count))
    fg_repl = torch.gather(fg_order, 1, torch.floor(
        u3 * torch.clamp(n_fg_avail, min=1)).long())
    bg_repl = torch.gather(bg_order, 1, torch.floor(
        u4 * torch.clamp(n_bg_avail, min=1)).long())

    # three cases: both present / fg only / bg only
    n_fg = torch.where(n_bg_avail > 0,
                       torch.clamp(n_fg_avail, max=fg_per_image), s)
    n_fg = torch.where(n_fg_avail > 0, n_fg, 0)

    slot = torch.arange(s, device=dev)[None, :]
    fg_pick = torch.where(n_bg_avail > 0, fg_order[:, :s], fg_repl)
    bg_pick = torch.gather(bg_repl, 1, torch.clamp(slot - n_fg, 0, s - 1))
    keep = torch.where(slot < n_fg, fg_pick, bg_pick)

    labels = torch.gather(cand_labels, 1, keep)
    labels = torch.where(slot < n_fg, labels, 0)     # bg slots → class 0

    out_rois = _take(cand, keep)
    batch_col = torch.arange(b, dtype=out_rois.dtype, device=dev)
    out_rois = torch.cat([batch_col[:, None, None].expand(b, s, 1),
                          out_rois[..., 1:]], dim=-1)

    gt_rois = _take(gt_boxes, torch.gather(gt_assign, 1, keep))
    targets = bbox_transform(out_rois[..., 1:5], gt_rois[..., :4])
    if t.BBOX_NORMALIZE_TARGETS_PRECOMPUTED:
        targets = ((targets - _row(t.BBOX_NORMALIZE_MEANS, targets))
                   / _row(t.BBOX_NORMALIZE_STDS, targets))
    # only fg rois regress; zero targets elsewhere
    fg_slot = (labels > 0)[..., None]
    targets = torch.where(fg_slot, targets, 0.0)
    in_w = torch.where(fg_slot, _row(t.BBOX_INSIDE_WEIGHTS, targets), 0.0)
    out_w = (in_w > 0).float()
    return RoiSamples(out_rois, labels, targets, in_w, out_w)
