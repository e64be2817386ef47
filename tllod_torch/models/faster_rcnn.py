"""Faster R-CNN assembly, eval path (``tllod_tpu/models/faster_rcnn.py:
37-292``; reference ``lib/model/faster_rcnn/faster_rcnn.py:19-137``).

The granular API of the JAX module is kept so method wrappers can compose
it: :meth:`features`, :meth:`anchors_for`, :meth:`rpn_rois`,
:meth:`roi_features`, :meth:`box_head`, :meth:`box_outputs`,
:meth:`forward_pre_head` / :meth:`finish_head` and
:meth:`forward_from_features`. Public tensors keep the JAX layouts: images
come in as NHWC BGR (``data/loader.py``), the feature map goes out as NHWC,
RoIs are (B, N, 5).

One layout change happens at the entry: the NHWC image batch is viewed as
NCHW with ``channels_last`` strides, the backbone and RPN convolutions run
in ``channels_last``, and the map comes back as an NHWC-contiguous view that
the RoIAlign kernel reads without a copy.

This slice ports inference. RPN losses, proposal-target sampling and the
head losses come with the training slice and raise here for now; so do the
``pool`` and ``crop`` pooling modes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.config import Config
from tllod_torch.device import resolve_device
from tllod_torch.models.backbones import backbone_for
from tllod_torch.models.rpn import RPNHead, proposal_layer, rpn_probs
from tllod_torch.ops.anchors import generate_anchors, shift_anchors
from tllod_torch.ops.roi_align import roi_align_avg


class FasterRCNN(nn.Module):
    """Shared detector. ``num_classes`` includes background (index 0).

    Built on ``device`` (default ``cuda``, raising when there is no card);
    with ``seed`` the weights are drawn from a ``torch.Generator`` seeded
    with it, else left at PyTorch's default init. The module starts in eval
    mode.
    """

    def __init__(self, num_classes: int, cfg: Config, net: str = "vgg16",
                 class_agnostic: bool = False, *, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.cfg = cfg
        self.net = net
        self.class_agnostic = class_agnostic
        backbone, head, feat_ch, head_dim = backbone_for(
            net, cfg.POOLING_SIZE, device=self.device)
        self.backbone = backbone.to(memory_format=torch.channels_last)
        self.head = head
        self.dout_base_model = feat_ch
        self.head_dim = head_dim
        self.num_anchors = len(cfg.ANCHOR_SCALES) * len(cfg.ANCHOR_RATIOS)
        self.rpn = RPNHead(feat_ch, self.num_anchors,
                           device=self.device).to(
                               memory_format=torch.channels_last)
        self.cls_score = nn.Linear(head_dim, num_classes, device=self.device)
        out_dim = 4 if class_agnostic else 4 * num_classes
        self.bbox_pred = nn.Linear(head_dim, out_dim, device=self.device)
        self._base_anchors = generate_anchors(
            base_size=cfg.FEAT_STRIDE[0], ratios=cfg.ANCHOR_RATIOS,
            scales=cfg.ANCHOR_SCALES)
        self._anchors: Dict[tuple, torch.Tensor] = {}
        if seed is not None:
            self.init_weights(seed)
        self.eval()

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed``: He-normal convs and fc6/fc7,
        normal(0, 0.01) for the RPN and ``cls_score``, normal(0, 0.001) for
        ``bbox_pred`` (reference ``faster_rcnn.py:129-131``), zero biases."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        for name, m in self.named_modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            if name == "bbox_pred":
                std = 0.001
            elif name == "cls_score" or name.startswith("rpn."):
                std = 0.01
            else:
                std = math.sqrt(2.0 / m.weight[0].numel())
            nn.init.normal_(m.weight, 0.0, std, generator=g)
            nn.init.zeros_(m.bias)

    # ---- granular pieces (composed by DA method wrappers) ----

    def features(self, im_data: torch.Tensor) -> torch.Tensor:
        """im_data (B, H, W, 3) NHWC BGR mean-subtracted → (B, H/16, W/16,
        C) NHWC-contiguous feature map."""
        x = im_data.permute(0, 3, 1, 2)          # NCHW, channels_last strides
        return self.backbone(x).permute(0, 2, 3, 1)

    def anchors_for(self, feat_h: int, feat_w: int) -> torch.Tensor:
        """(K*A, 4) anchors for a feature-grid size, made once per size."""
        key = (feat_h, feat_w)
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(shift_anchors(
                feat_h, feat_w, self.cfg.FEAT_STRIDE[0],
                self._base_anchors)).to(self.device)
        return self._anchors[key]

    def rpn_rois(self, base_feat: torch.Tensor, im_info: torch.Tensor,
                 gt_boxes=None, *, training: bool = False,
                 compute_loss: bool = False,
                 post_nms_top_n: Optional[int] = None) -> Dict[str, Any]:
        """RPN head + proposal layer. ``training`` picks the TRAIN/TEST
        proposal params like the reference's ``cfg_key``."""
        if compute_loss:
            raise NotImplementedError(
                "RPN losses come with the training slice")
        rcfg = self.cfg.rpn_cfg(training)
        cls_score, bbox_pred = self.rpn(base_feat.permute(0, 3, 1, 2))
        # box decode in float32 whatever the compute dtype
        cls_score = cls_score.permute(0, 2, 3, 1).float()
        bbox_pred = bbox_pred.permute(0, 2, 3, 1).float()
        fg_prob, _ = rpn_probs(cls_score)

        anchors = self.anchors_for(base_feat.shape[1], base_feat.shape[2])
        rois, valid = proposal_layer(
            fg_prob, bbox_pred, im_info, anchors,
            pre_nms_top_n=rcfg.RPN_PRE_NMS_TOP_N,
            post_nms_top_n=post_nms_top_n or rcfg.RPN_POST_NMS_TOP_N,
            nms_thresh=rcfg.RPN_NMS_THRESH)
        zero = torch.zeros((), device=rois.device)
        return {"rois": rois, "rois_valid": valid, "rpn_cls_prob": fg_prob,
                "rpn_loss_cls": zero, "rpn_loss_box": zero}

    def roi_features(self, base_feat: torch.Tensor, rois: torch.Tensor, *,
                     training: bool = False) -> torch.Tensor:
        """Pooled (R, P, P, C) features for (R, 5) RoIs flattened over the
        batch."""
        del training
        cfg = self.cfg
        if cfg.POOLING_MODE != "align":
            raise NotImplementedError(
                f"POOLING_MODE={cfg.POOLING_MODE!r} is not ported yet "
                f"(align only)")
        return roi_align_avg(base_feat, rois, out_size=cfg.POOLING_SIZE,
                             spatial_scale=1.0 / cfg.FEAT_STRIDE[0])

    def box_head(self, pooled: torch.Tensor, *,
                 deterministic: bool = True) -> torch.Tensor:
        return self.head(pooled, deterministic=deterministic)

    def box_outputs(self, fc7: torch.Tensor):
        # f32 logits/deltas regardless of the compute dtype
        return self.cls_score(fc7).float(), self.bbox_pred(fc7).float()

    # ---- full forward ----

    def forward_pre_head(self, base_feat, im_info, gt_boxes=None, *,
                         training: bool = False,
                         supervised: Optional[bool] = None,
                         post_nms_top_n: Optional[int] = None):
        """RPN → RoI pooling. Returns ``(out, samples, pooled)``; ``samples``
        is None, as target sampling comes with the training slice."""
        if supervised is None:
            supervised = training
        if supervised:
            raise NotImplementedError(
                "proposal-target sampling comes with the training slice")
        b = base_feat.shape[0]
        rpn_out = self.rpn_rois(base_feat, im_info, gt_boxes,
                                training=False, compute_loss=False,
                                post_nms_top_n=post_nms_top_n)
        rois = rpn_out["rois"]
        zero = rpn_out["rpn_loss_cls"]
        out: Dict[str, Any] = {
            "base_feat": base_feat,
            "rpn_rois": rois,
            "rois_valid": rpn_out["rois_valid"],
            "rpn_loss_cls": zero,
            "rpn_loss_box": zero,
            "rpn_cls_prob": rpn_out["rpn_cls_prob"],
            "rcnn_loss_cls": zero,
            "rcnn_loss_box": zero,
            "rois_label": None,
            "rois": rois,
        }
        pooled = self.roi_features(base_feat,
                                   rois.reshape(b * rois.shape[1], 5),
                                   training=training)
        return out, None, pooled

    def finish_head(self, out: Dict[str, Any], samples, fc7
                    ) -> Dict[str, Any]:
        """Box-head outputs given fc7 rows for ``out['rois']``."""
        if samples is not None:
            raise NotImplementedError(
                "head losses come with the training slice")
        b, n_rois = out["rois"].shape[:2]
        out["pooled_feat"] = fc7
        cls_score, bbox_pred = self.box_outputs(fc7)
        out["cls_prob"] = F.softmax(cls_score, dim=1).reshape(b, n_rois, -1)
        out["bbox_pred"] = bbox_pred.reshape(b, n_rois, -1)
        return out

    def forward_from_features(self, base_feat, im_info, gt_boxes=None, *,
                              training: bool = False,
                              supervised: Optional[bool] = None,
                              post_nms_top_n: Optional[int] = None
                              ) -> Dict[str, Any]:
        out, samples, pooled = self.forward_pre_head(
            base_feat, im_info, gt_boxes, training=training,
            supervised=supervised, post_nms_top_n=post_nms_top_n)
        fc7 = self.box_head(pooled, deterministic=not training)
        return self.finish_head(out, samples, fc7)

    def forward(self, im_data, im_info, gt_boxes=None, *,
                training: bool = False) -> Dict[str, Any]:
        base_feat = self.features(im_data)
        return self.forward_from_features(base_feat, im_info, gt_boxes,
                                          training=training)
