"""US-DAF — Universal Scale-Aware Domain Adaptive Faster R-CNN
(``tllod_tpu/methods/us_daf.py``; reference ``lib/US_DAF/``).

Source and target class sets differ (VOC 15 = 5 private + 10 common,
Clipart 15 = 10 common + 5 private). Two domain heads behind gradient
reversal (α = 0.1):

  * :class:`ImageDASigmoid`, a 1-channel sigmoid per pixel, plain BCE to 1
    (source) or 0 (target);
  * :class:`InstanceDAScale`, four sigmoids per RoI, [domain, small,
    middle, large], the scale buckets from the RoI's area
    (:func:`scale_labels`), trained by :func:`bce_margin_loss`, whose
    domain column counts only where its own BCE exceeds 0.5.

The detector runs one backbone pass over [source; target] and one layer4
pass over [source RoIs; target RoIs] (JAX's ``fuse_pair`` and
``fuse_head``). The instance head also takes both RoI sets in one pass,
where JAX calls it once a domain: its rows are independent, and its two
dropout masks are drawn over the source rows, then the target rows.

Both probability clips are ``jnp.clip``'s, max then min, whose gradient is
halved where a probability equals a bound; ``torch.clamp`` would pass it
whole.

Total loss (``methods/US_DAF/US_DAF_train.py:428-431``):
    det + λ·(img + ins + tgt_img + tgt_ins).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.config import Config
from tllod_torch.device import resolve_device
from tllod_torch.methods.da_modules import (features_pair, fused_box_head,
                                            init_da_heads)
from tllod_torch.models.backbones import dropout
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.models.layers import Conv2d, Linear, set_compute_dtype
from tllod_torch.ops.grl import grad_reverse
from tllod_torch.parallel.dist import gmean


def _clip(p: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(p, lo, hi)`` with its gradient at the bounds."""
    return torch.minimum(torch.maximum(p, torch.full_like(p, lo)),
                         torch.full_like(p, hi))


class ImageDASigmoid(nn.Module):
    """GRL → 1×1 conv 512 → ReLU → 1×1 conv 1 → sigmoid, both convs
    bias-free (``us_daf.py:43-59``). NHWC map in, (B, H, W, 1) out."""

    def __init__(self, in_channels: int = 1024, alpha: float = 0.1,
                 device=None):
        super().__init__()
        self.alpha = alpha
        self.conv1 = Conv2d(in_channels, 512, 1, bias=False,
                               device=device)
        self.conv2 = Conv2d(512, 1, 1, bias=False, device=device)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = grad_reverse(feat, self.alpha).permute(0, 3, 1, 2)
        x = self.conv2(F.relu(self.conv1(x)))
        return torch.sigmoid(x.permute(0, 2, 3, 1))


class InstanceDAScale(nn.Module):
    """GRL → fc 1024 → ReLU → dropout → fc 1024 → ReLU → dropout → fc 4 →
    sigmoid (``us_daf.py:62-79``); (R, in) → (R, 4) probabilities."""

    def __init__(self, in_features: int = 2048, alpha: float = 0.1,
                 device=None):
        super().__init__()
        self.alpha = alpha
        self.dc_ip1 = Linear(in_features, 1024, device=device)
        self.dc_ip2 = Linear(1024, 1024, device=device)
        self.classifier = Linear(1024, 4, device=device)

    def forward(self, feat: torch.Tensor, *, deterministic: bool = True,
                rng=None) -> torch.Tensor:
        x = F.relu(self.dc_ip1(grad_reverse(feat, self.alpha)))
        if not deterministic:
            x = dropout(x, 0.5, rng)
        x = F.relu(self.dc_ip2(x))
        if not deterministic:
            x = dropout(x, 0.5, rng)
        return torch.sigmoid(self.classifier(x))


def scale_labels(rois: torch.Tensor) -> torch.Tensor:
    """(R, 5) RoIs → (R, 3) one-hot [small, middle, large] by the area
    (x2 − x1)·(y2 − y1), without the "+1", at ≤ 400 and ≥ 1e4 px²
    (``us_daf.py:82-90``)."""
    area = (rois[:, 3] - rois[:, 1]) * (rois[:, 4] - rois[:, 2])
    small = area <= 400
    large = area >= 10000
    middle = (area > 400) & (area < 10000)
    return torch.stack([small, middle, large], dim=1).float()


def bce_margin_loss(probs: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Margin-filtered multi-label BCE (``us_daf.py:93-114``): the domain
    column (0) counts only where its own BCE exceeds 0.5, the three scale
    columns always; the mean over all R×4 entries. Probabilities are
    clipped to [1e-7, 1 − 1e-7], then offset by 1e-10 inside the logs, as
    JAX does, in their own type (at bfloat16 the upper bound rounds to 1;
    the float32 labels promote the products)."""
    eps = 1e-10
    p = _clip(probs, 1e-7, 1.0 - 1e-7)
    bce = -(labels * torch.log(p + eps)
            + (1.0 - labels) * torch.log(1.0 - p + eps))
    domain_w = (bce[:, :1] > 0.5).float()
    weight = torch.cat([domain_w, torch.ones_like(bce[:, 1:])], dim=1)
    return gmean(bce * weight)


def image_sigmoid_loss(prob: torch.Tensor, domain_value: float
                       ) -> torch.Tensor:
    """Mean BCE of a sigmoid map to a constant domain label, clipped at
    1e-7 (``us_daf.py:141-146``), in the map's type as in JAX."""
    p = _clip(prob, 1e-7, 1.0 - 1e-7)
    return -gmean(torch.log(p) if domain_value > 0.5
                  else torch.log(1.0 - p))


def instance_scale_loss(probs: torch.Tensor, rois: torch.Tensor,
                        domain_value: float) -> torch.Tensor:
    """:func:`bce_margin_loss` of (R, 4) probabilities against [domain,
    scale_labels] for the (B, N, 5) RoIs they belong to."""
    flat = rois.reshape(-1, 5)
    labels = torch.cat([torch.full_like(flat[:, :1], domain_value),
                        scale_labels(flat)], dim=1)
    return bce_margin_loss(probs, labels)


class USDAFModel(nn.Module):
    """Detector + US-DAF heads. Submodules ``detector``, ``img_da`` and
    ``ins_da`` follow the flax param subtrees; eval loads ``detector``
    alone. Built on ``device`` (default ``cuda``); with ``seed`` every
    weight is drawn from a generator seeded with it. ``dtype`` is the
    compute type of every layer, the heads' too (``us_daf.py:131-138``)."""

    def __init__(self, num_classes: int, cfg: Config, net: str = "res101",
                 class_agnostic: bool = False, grl_alpha: float = 0.1, *,
                 device=None, seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.detector = FasterRCNN(num_classes, cfg, net, class_agnostic,
                                   device=self.device, dtype=dtype)
        self.img_da = ImageDASigmoid(self.detector.dout_base_model,
                                     alpha=grl_alpha, device=self.device)
        self.ins_da = InstanceDAScale(self.detector.head_dim, alpha=grl_alpha,
                                      device=self.device)
        set_compute_dtype(self, dtype)
        if seed is not None:
            self.init_weights(seed)
        self.train()

    def init_weights(self, seed: int) -> None:
        """The detector's init from ``seed``, then He-normal DA weights
        with zero biases."""
        self.detector.init_weights(seed)
        init_da_heads((self.img_da, self.ins_da), seed + 1, self.device)

    def forward(self, src: Dict[str, Any], tgt: Dict[str, Any], *,
                training: bool = True, rng=None) -> Dict[str, Any]:
        """``src``/``tgt``: dicts of device tensors ``im_data`` (B, H, W, 3),
        ``im_info``, ``gt_boxes``; ``rng`` a
        :class:`tllod_torch.train.StepRandom` when ``training``."""
        det = self.detector
        deterministic = not training
        s_feat, t_feat = features_pair(det, src["im_data"], tgt["im_data"])
        out, s_samples, s_pooled = det.forward_pre_head(
            s_feat, src["im_info"], src["gt_boxes"], training=training,
            rng=rng)
        t_out, _, t_pooled = det.forward_pre_head(
            t_feat, tgt["im_info"], tgt["gt_boxes"], training=training,
            supervised=False, rng=rng)
        fc7_s, fc7_t = fused_box_head(det, (s_pooled, t_pooled),
                                      deterministic=deterministic, rng=rng)
        out = det.finish_head(out, s_samples, fc7_s)

        sizes = [fc7_s.shape[0], fc7_t.shape[0]]
        with rng.rows(sizes) if rng is not None else nullcontext():
            ins = self.ins_da(torch.cat([fc7_s, fc7_t]),
                              deterministic=deterministic, rng=rng)
        ins_s, ins_t = ins.split(sizes)
        out.update({
            "da_img_loss": image_sigmoid_loss(self.img_da(s_feat), 1.0),
            "da_ins_loss": instance_scale_loss(ins_s, out["rois"], 1.0),
            "tgt_da_img_loss": image_sigmoid_loss(self.img_da(t_feat), 0.0),
            "tgt_da_ins_loss": instance_scale_loss(ins_t, t_out["rois"],
                                                   0.0),
        })
        return out


def us_daf_loss(out: Dict[str, Any], lamda: float = 0.1) -> torch.Tensor:
    """det + λ·(img + ins + tgt_img + tgt_ins) (``us_daf.py:189-196``)."""
    det = (out["rpn_loss_cls"] + out["rpn_loss_box"]
           + out["rcnn_loss_cls"] + out["rcnn_loss_box"])
    return det + lamda * (out["da_img_loss"] + out["da_ins_loss"]
                          + out["tgt_da_img_loss"]
                          + out["tgt_da_ins_loss"])
