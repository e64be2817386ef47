"""Shared domain-adaptation building blocks
(``tllod_tpu/methods/da_modules.py``; reference ``lib/DAF/DA.py:36-73``).

The image-level and instance-level domain classifiers of the UDAOD methods,
their losses, and the batched backbone pass over a (source, target) pair.
Module and parameter names follow the flax tree (``conv1``, ``conv2``,
``dc_ip1``, ``dc_ip2``, ``classifier``), so :mod:`tllod_torch.zoo` maps one
onto the other name for name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.models.backbones import dropout
from tllod_torch.ops.grl import grad_reverse
from tllod_torch.ops.losses import binary_cross_entropy


class ImageDA(nn.Module):
    """Pixel-wise 2-class domain head: GRL → 1×1 conv (hidden) → ReLU → 1×1
    conv (2), both bias-free. Takes the NHWC map, returns (B, H, W, 2)
    logits."""

    def __init__(self, in_channels: int = 512, hidden: int = 512,
                 alpha: float = 0.1, device=None):
        super().__init__()
        self.alpha = alpha
        self.conv1 = nn.Conv2d(in_channels, hidden, 1, bias=False,
                               device=device)
        self.conv2 = nn.Conv2d(hidden, 2, 1, bias=False, device=device)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = grad_reverse(feat, self.alpha).permute(0, 3, 1, 2)
        x = self.conv2(F.relu(self.conv1(x)))
        return x.permute(0, 2, 3, 1)


def image_da_loss(logits: torch.Tensor, domain: torch.Tensor
                  ) -> torch.Tensor:
    """Mean 2-class NLL against the broadcast domain label; logits (B, H,
    W, 2), domain (B,) in {0, 1} (reference ``lib/DAF/faster_rcnn.py:
    181-185``)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    is_src = (domain > 0)[:, None, None]
    picked = torch.where(is_src, logp[..., 1], logp[..., 0])
    return -picked.mean()


class InstanceDA(nn.Module):
    """Per-RoI domain head: GRL → fc 1024 → ReLU → dropout → fc 1024 → ReLU
    → dropout → fc 1 → sigmoid; (R, in) → (R, 1) probabilities."""

    def __init__(self, in_features: int = 4096, alpha: float = 0.1,
                 device=None):
        super().__init__()
        self.alpha = alpha
        self.dc_ip1 = nn.Linear(in_features, 1024, device=device)
        self.dc_ip2 = nn.Linear(1024, 1024, device=device)
        self.classifier = nn.Linear(1024, 1, device=device)

    def forward(self, feat: torch.Tensor, *, deterministic: bool = True,
                rng=None) -> torch.Tensor:
        x = F.relu(self.dc_ip1(grad_reverse(feat, self.alpha)))
        if not deterministic:
            x = dropout(x, 0.5, rng)
        x = F.relu(self.dc_ip2(x))
        if not deterministic:
            x = dropout(x, 0.5, rng)
        return torch.sigmoid(self.classifier(x))


def instance_da_loss(probs: torch.Tensor, domain: torch.Tensor,
                     rois_per_image: int) -> torch.Tensor:
    """Mean BCE against the per-RoI domain label; probs (B*R, 1)."""
    labels = torch.repeat_interleave(domain.float(), rois_per_image)[:, None]
    return binary_cross_entropy(probs, labels)


def blocked_instance_labels(domain: torch.Tensor, total_rows: int,
                            block: int = 256) -> torch.Tensor:
    """The reference ``InstanceLabelResizeLayer``'s label layout
    (``lib/ATF/LabelResizeLayer.py:43-60``): image i's label fills rows
    ``[i·256, (i+1)·256)`` of a zero vector whatever the true RoI count;
    returns (total_rows, 1) float labels."""
    rows = torch.arange(total_rows, device=domain.device) // block
    d = domain.float().reshape(-1)
    picked = d[torch.clamp(rows, 0, d.shape[0] - 1)]
    return torch.where(rows < d.shape[0], picked, 0.0)[:, None]


def features_pair(det, src_im: torch.Tensor, tgt_im: torch.Tensor):
    """Backbone maps of a (source, target) pair: one batched pass over
    ``[src; tgt]`` when the shapes match, else two. Every backbone op is per
    image, so both give the same maps; each half of the fused NHWC map stays
    contiguous."""
    if src_im.shape == tgt_im.shape:
        b = src_im.shape[0]
        both = det.features(torch.cat([src_im, tgt_im], dim=0))
        return both[:b], both[b:]
    return det.features(src_im), det.features(tgt_im)
