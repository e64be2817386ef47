"""Faster R-CNN assembly: backbone → RPN → RoI sampling → box head → losses
(``tllod_tpu/models/faster_rcnn.py:37-300``; reference
``lib/model/faster_rcnn/faster_rcnn.py:19-137``).

The granular API of the JAX module is kept so method wrappers can compose
it: :meth:`features`, :meth:`anchors_for`, :meth:`rpn_rois`,
:meth:`roi_features`, :meth:`box_head`, :meth:`box_outputs`,
:meth:`forward_pre_head` / :meth:`finish_head` and
:meth:`forward_from_features`. Public tensors keep the JAX layouts: images
come in as NHWC BGR (``data/loader.py``), the feature map goes out as NHWC,
RoIs are (B, N, 5).

One layout change happens at the entry: the NHWC image batch is viewed as
NCHW with ``channels_last`` strides, the backbone and RPN convolutions (and
a ResNet's layer4 head) run in ``channels_last``, and the map comes back as
an NHWC-contiguous view that the RoIAlign kernel reads without a copy.

Training (``training=True``) draws its random numbers from a ``rng``
argument, a :class:`tllod_torch.train.StepRandom`: the anchor-target and
proposal-target priorities and the dropout masks, in the order the JAX
module draws its ``sampling`` and ``dropout`` keys. ``POOLING_MODE`` is
``align`` (RoIAlignAvg), ``pool`` (RoIPool, :mod:`tllod_torch.ops.roi_pool`)
or ``crop`` (RoICrop, :mod:`tllod_torch.ops.roi_crop`: a 2 * POOLING_SIZE
grid and the 2x2 max with ``CROP_RESIZE_WITH_MAX_POOL``, else a
POOLING_SIZE grid), each on CUDA tensors through its kernels.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.config import Config
from tllod_torch.device import resolve_device
from tllod_torch.models.backbones import Bottleneck, backbone_for
from tllod_torch.models.layers import Linear, set_compute_dtype
from tllod_torch.models.rpn import (RoiSamples, RPNHead, anchor_target,
                                    proposal_layer, proposal_target,
                                    rpn_probs)
from tllod_torch.ops.anchors import generate_anchors, shift_anchors
from tllod_torch.ops.losses import smooth_l1_loss, softmax_cross_entropy
from tllod_torch.ops.roi_align import roi_align_avg
from tllod_torch.ops.roi_crop import roi_crop
from tllod_torch.ops.roi_pool import roi_pool


def nhwc_features(backbone: nn.Module, im_data: torch.Tensor,
                  return_taps: bool = False, **kw):
    """Run a ``channels_last`` backbone on an NHWC image batch, or on the
    NHWC map of an earlier block with a VGG backbone's ``stage_range`` in
    ``kw``: the NCHW view goes in, and each map comes back as its NHWC
    view, contiguous in memory, so no layout copy is made either way."""
    out = backbone(im_data.permute(0, 3, 1, 2), return_taps=return_taps,
                   **kw)
    if return_taps:
        return tuple(t.permute(0, 2, 3, 1) for t in out)
    return out.permute(0, 2, 3, 1)


class FasterRCNN(nn.Module):
    """Shared detector. ``num_classes`` includes background (index 0).

    Built on ``device`` (default ``cuda``, raising when there is no card);
    with ``seed`` the weights are drawn from a ``torch.Generator`` seeded
    with it, else left at PyTorch's default init. The module starts in eval
    mode. ``dtype`` is the compute type of every convolution and fully
    connected layer (:mod:`tllod_torch.models.layers`; JAX's ``dtype``): at
    bfloat16 the maps, the pooled features and fc7 are bfloat16, and the
    RPN's scores and deltas and the box head's logits and deltas return to
    float32 before the decode and the losses (``faster_rcnn.py:96-97,
    172-173``).
    """

    def __init__(self, num_classes: int, cfg: Config, net: str = "vgg16",
                 class_agnostic: bool = False, *, device=None,
                 seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.cfg = cfg
        self.net = net
        self.class_agnostic = class_agnostic
        backbone, head, feat_ch, head_dim = backbone_for(
            net, cfg.POOLING_SIZE, device=self.device)
        self.backbone = backbone.to(memory_format=torch.channels_last)
        # ResNet's layer4 runs channels_last; VGG16's fc weights are 2-D
        self.head = head.to(memory_format=torch.channels_last)
        self.dout_base_model = feat_ch
        self.head_dim = head_dim
        self.num_anchors = len(cfg.ANCHOR_SCALES) * len(cfg.ANCHOR_RATIOS)
        self.rpn = RPNHead(feat_ch, self.num_anchors,
                           device=self.device).to(
                               memory_format=torch.channels_last)
        self.cls_score = Linear(head_dim, num_classes, device=self.device)
        out_dim = 4 if class_agnostic else 4 * num_classes
        self.bbox_pred = Linear(head_dim, out_dim, device=self.device)
        self._base_anchors = generate_anchors(
            base_size=cfg.FEAT_STRIDE[0], ratios=cfg.ANCHOR_RATIOS,
            scales=cfg.ANCHOR_SCALES)
        self._anchors: Dict[tuple, torch.Tensor] = {}
        self.compute_dtype = dtype
        set_compute_dtype(self, dtype)
        if seed is not None:
            self.init_weights(seed)
        self.eval()

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Random weights from ``seed``: He-normal convs and fc6/fc7,
        normal(0, 0.01) for the RPN and ``cls_score``, normal(0, 0.001) for
        ``bbox_pred`` (reference ``faster_rcnn.py:129-131``), zero biases.
        A ResNet's bottleneck ``conv3`` starts at zero, so each residual
        branch gives 0 (``backbones.py:157-158``); its FrozenBN buffers
        keep (1, 0, 0, 1)."""
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
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        for m in self.modules():
            if isinstance(m, Bottleneck):
                nn.init.zeros_(m.conv3.weight)

    # ---- granular pieces (composed by DA method wrappers) ----

    def features(self, im_data: torch.Tensor, return_taps: bool = False):
        """im_data (B, H, W, 3) NHWC BGR mean-subtracted → (B, H/16, W/16,
        C) NHWC-contiguous feature map, or with ``return_taps`` the (c3, c4,
        c5) maps, each NHWC-contiguous."""
        return nhwc_features(self.backbone, im_data, return_taps)

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
                 post_nms_top_n: Optional[int] = None,
                 sample_proposals: bool = False,
                 rng=None, rpn_head: Optional[nn.Module] = None
                 ) -> Dict[str, Any]:
        """RPN head + proposal layer (+ anchor targets and both RPN losses
        when ``training and compute_loss``, ``faster_rcnn.py:112-132``).
        ``training`` picks the TRAIN/TEST proposal params like the
        reference's ``cfg_key``. ``sample_proposals`` takes PA-ATF's random
        sample of the NMS survivors, its priorities drawn from ``rng``
        before the anchor targets' (``rpn.sample_survivors``). ``rpn_head``
        replaces the detector's RPN head (IDF's auxiliary detector,
        ``idf.py:187-226``, the same steps on its own head)."""
        cfg = self.cfg
        rcfg = cfg.rpn_cfg(training)
        cls_score, bbox_pred = (rpn_head or self.rpn)(
            base_feat.permute(0, 3, 1, 2))
        # box decode and losses in float32 whatever the compute dtype; NHWC,
        # so anchors follow the (h, w, a) order of the JAX package
        cls_score = cls_score.permute(0, 2, 3, 1).float()
        bbox_pred = bbox_pred.permute(0, 2, 3, 1).float()
        fg_prob, logits = rpn_probs(cls_score)

        anchors = self.anchors_for(base_feat.shape[1], base_feat.shape[2])
        post = post_nms_top_n or rcfg.RPN_POST_NMS_TOP_N
        rois, valid = proposal_layer(
            fg_prob, bbox_pred, im_info, anchors,
            pre_nms_top_n=rcfg.RPN_PRE_NMS_TOP_N, post_nms_top_n=post,
            nms_thresh=rcfg.RPN_NMS_THRESH,
            sample_priorities=(rng.uniform((base_feat.shape[0], post))
                               if sample_proposals else None))
        zero = torch.zeros((), device=rois.device)
        out = {"rois": rois, "rois_valid": valid, "rpn_cls_prob": fg_prob,
               "rpn_logits": logits, "rpn_loss_cls": zero,
               "rpn_loss_box": zero}
        if not (training and compute_loss):
            return out

        b, h, w = base_feat.shape[:3]
        ka = anchors.shape[0]
        tgt = anchor_target(gt_boxes, im_info, anchors, cfg,
                            priorities=(rng.uniform((b, ka)),
                                        rng.uniform((b, ka))))
        flat_labels = tgt.labels.reshape(-1)
        out["rpn_loss_cls"] = softmax_cross_entropy(
            logits.reshape(b * ka, 2), torch.clamp(flat_labels, min=0),
            (flat_labels >= 0).float())
        a = self.num_anchors
        in_w = tgt.in_weights[..., None].expand(b, ka, 4).reshape(b, h, w,
                                                                  4 * a)
        out_w = tgt.out_weights[..., None].expand(b, ka, 4).reshape(b, h, w,
                                                                    4 * a)
        out["rpn_loss_box"] = smooth_l1_loss(
            bbox_pred, tgt.bbox_targets.reshape(b, h, w, 4 * a), in_w, out_w,
            sigma=3.0, reduce_dims=(1, 2, 3))
        return out

    def roi_features(self, base_feat: torch.Tensor, rois: torch.Tensor, *,
                     training: bool = False) -> torch.Tensor:
        """Pooled (R, P, P, C) features for (R, 5) RoIs flattened over the
        batch, by ``POOLING_MODE`` (``faster_rcnn.py:135-165``)."""
        del training
        cfg = self.cfg
        kw = dict(out_size=cfg.POOLING_SIZE,
                  spatial_scale=1.0 / cfg.FEAT_STRIDE[0])
        if cfg.POOLING_MODE == "align":
            return roi_align_avg(base_feat, rois, **kw)
        if cfg.POOLING_MODE == "pool":
            return roi_pool(base_feat, rois, **kw)
        if cfg.POOLING_MODE == "crop":
            max_pool = cfg.CROP_RESIZE_WITH_MAX_POOL
            return roi_crop(base_feat, rois,
                            grid_size=cfg.POOLING_SIZE * (2 if max_pool
                                                          else 1),
                            max_pool=max_pool)
        raise ValueError(f"unknown POOLING_MODE={cfg.POOLING_MODE!r}")

    def box_head(self, pooled: torch.Tensor, *, deterministic: bool = True,
                 rng=None) -> torch.Tensor:
        return self.head(pooled, deterministic=deterministic, rng=rng)

    def box_outputs(self, fc7: torch.Tensor):
        # f32 logits/deltas regardless of the compute dtype
        return self.cls_score(fc7).float(), self.bbox_pred(fc7).float()

    # ---- full forward ----

    def head_losses(self, fc7: torch.Tensor, samples: RoiSamples,
                    outputs=None) -> Dict[str, Any]:
        """Box-head outputs + RCNN losses for sampled RoIs
        (``faster_rcnn.py:177-198``); ``outputs``, a (cls_score,
        bbox_pred) pair, replaces the detector's own from ``fc7``."""
        cls_score, bbox_pred = outputs or self.box_outputs(fc7)
        labels = samples.labels.reshape(-1)
        if not self.class_agnostic:
            # the 4 regression columns of each RoI's class
            bp = bbox_pred.reshape(bbox_pred.shape[0], -1, 4)
            bbox_pred = torch.gather(
                bp, 1, labels.long()[:, None, None].expand(-1, 1, 4))[:, 0]
        return {
            "cls_score": cls_score,
            "cls_prob": F.softmax(cls_score, dim=1),
            "bbox_pred": bbox_pred,
            "rcnn_loss_cls": softmax_cross_entropy(cls_score, labels),
            "rcnn_loss_box": smooth_l1_loss(
                bbox_pred, samples.bbox_targets.reshape(-1, 4),
                samples.in_weights.reshape(-1, 4),
                samples.out_weights.reshape(-1, 4)),
            "rois_label": labels,
        }

    def forward_pre_head(self, base_feat, im_info, gt_boxes=None, *,
                         training: bool = False,
                         supervised: Optional[bool] = None,
                         post_nms_top_n: Optional[int] = None,
                         sample_proposals: bool = False, rng=None,
                         rpn_head: Optional[nn.Module] = None):
        """RPN → (proposal-target sampling when ``supervised``) → RoI
        pooling. Returns ``(out, samples, pooled)``, so method wrappers can
        run the source and target RoIs through one fc6/fc7 pass.
        ``sample_proposals`` and ``rpn_head`` as in :meth:`rpn_rois`."""
        if supervised is None:
            supervised = training
        b = base_feat.shape[0]
        rpn_out = self.rpn_rois(base_feat, im_info, gt_boxes,
                                training=supervised, compute_loss=supervised,
                                post_nms_top_n=post_nms_top_n,
                                sample_proposals=sample_proposals, rng=rng,
                                rpn_head=rpn_head)
        rois = rpn_out["rois"]
        zero = torch.zeros((), device=rois.device)
        out: Dict[str, Any] = {
            "base_feat": base_feat,
            "rpn_rois": rois,
            "rois_valid": rpn_out["rois_valid"],
            "rpn_loss_cls": rpn_out["rpn_loss_cls"],
            "rpn_loss_box": rpn_out["rpn_loss_box"],
            "rpn_cls_prob": rpn_out["rpn_cls_prob"],
            "rpn_logits": rpn_out["rpn_logits"],
            "rcnn_loss_cls": zero,
            "rcnn_loss_box": zero,
            "rois_label": None,
        }
        samples: Optional[RoiSamples] = None
        if supervised:
            n, s = rois.shape[1] + gt_boxes.shape[1], self.cfg.TRAIN.BATCH_SIZE
            samples = proposal_target(
                rois, gt_boxes, self.cfg,
                priorities=[rng.uniform(shape)
                            for shape in ((b, n), (b, n), (b, s), (b, s))])
            rois = samples.rois
        pooled = self.roi_features(
            base_feat, rois.reshape(b * rois.shape[1], 5).contiguous(),
            training=training)
        out["rois"] = rois
        return out, samples, pooled

    def finish_head(self, out: Dict[str, Any],
                    samples: Optional[RoiSamples], fc7) -> Dict[str, Any]:
        """Box-head outputs (+ losses given ``samples``) from fc7 rows for
        ``out['rois']``."""
        b, n_rois = out["rois"].shape[:2]
        out["pooled_feat"] = fc7
        if samples is not None:
            out.update(self.head_losses(fc7, samples))
            cls_prob, bbox_pred = out["cls_prob"], out["bbox_pred"]
        else:
            cls_score, bbox_pred = self.box_outputs(fc7)
            cls_prob = F.softmax(cls_score, dim=1)
        out["cls_prob"] = cls_prob.reshape(b, n_rois, -1)
        out["bbox_pred"] = bbox_pred.reshape(b, n_rois, -1)
        return out

    def forward_from_features(self, base_feat, im_info, gt_boxes=None, *,
                              training: bool = False,
                              supervised: Optional[bool] = None,
                              post_nms_top_n: Optional[int] = None,
                              rng=None) -> Dict[str, Any]:
        """``training`` turns dropout on; ``supervised`` (default
        ``training``) picks the TRAIN RPN, target sampling and the losses.
        DA target passes use ``training=True, supervised=False``."""
        out, samples, pooled = self.forward_pre_head(
            base_feat, im_info, gt_boxes, training=training,
            supervised=supervised, post_nms_top_n=post_nms_top_n, rng=rng)
        fc7 = self.box_head(pooled, deterministic=not training, rng=rng)
        return self.finish_head(out, samples, fc7)

    def forward(self, im_data, im_info, gt_boxes=None, *,
                training: bool = False, rng=None) -> Dict[str, Any]:
        base_feat = self.features(im_data)
        return self.forward_from_features(base_feat, im_info, gt_boxes,
                                          training=training, rng=rng)


def detection_loss(out: Dict[str, Any]) -> torch.Tensor:
    """The supervised loss, rpn_cls + rpn_box + rcnn_cls + rcnn_box
    (``tllod_tpu/models/faster_rcnn.py:295-300``)."""
    return (out["rpn_loss_cls"] + out["rpn_loss_box"]
            + out["rcnn_loss_cls"] + out["rcnn_loss_box"])
