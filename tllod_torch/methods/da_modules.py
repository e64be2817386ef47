"""Shared domain-adaptation building blocks
(``tllod_tpu/methods/da_modules.py``; reference ``lib/DAF/DA.py:36-73``).

The image-level and instance-level domain classifiers of the UDAOD methods,
their losses, and the batched backbone pass over a (source, target) pair.
Module and parameter names follow the flax tree (``conv1``, ``conv2``,
``dc_ip1``, ``dc_ip2``, ``classifier``), so :mod:`tllod_torch.zoo` maps one
onto the other name for name.
"""

from __future__ import annotations

import math
from contextlib import nullcontext

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.models.backbones import dropout
from tllod_torch.models.layers import Conv2d, Linear
from tllod_torch.ops.grl import grad_reverse
from tllod_torch.ops.losses import binary_cross_entropy
from tllod_torch.parallel.dist import gather_rows, gmean, rank


class ImageDA(nn.Module):
    """Pixel-wise 2-class domain head: GRL → 1×1 conv (hidden) → ReLU → 1×1
    conv (2), both bias-free. Takes the NHWC map, returns (B, H, W, 2)
    logits. ``grl_scale`` multiplies the GRL's α (a tensor under PT-MAF);
    MAF's ``ImageDAPlain`` (``maf.py:71``) is this head."""

    def __init__(self, in_channels: int = 512, hidden: int = 512,
                 alpha: float = 0.1, device=None):
        super().__init__()
        self.alpha = alpha
        self.conv1 = Conv2d(in_channels, hidden, 1, bias=False,
                               device=device)
        self.conv2 = Conv2d(hidden, 2, 1, bias=False, device=device)

    def forward(self, feat: torch.Tensor, grl_scale=1.0) -> torch.Tensor:
        x = grad_reverse(feat, self.alpha * grl_scale).permute(0, 3, 1, 2)
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
    return -gmean(picked)


class InstanceDA(nn.Module):
    """Per-RoI domain head: GRL → fc 1024 → ReLU → dropout → fc 1024 → ReLU
    → dropout → fc 1 → sigmoid; (R, in) → (R, 1) probabilities."""

    def __init__(self, in_features: int = 4096, alpha: float = 0.1,
                 device=None):
        super().__init__()
        self.alpha = alpha
        self.dc_ip1 = Linear(in_features, 1024, device=device)
        self.dc_ip2 = Linear(1024, 1024, device=device)
        self.classifier = Linear(1024, 1, device=device)

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
    returns (total_rows, 1) float labels. The rows and images are the
    global batch's: under a process group this rank's ``total_rows`` are
    its block of them."""
    rows = (torch.arange(total_rows, device=domain.device)
            + rank() * total_rows) // block
    d = gather_rows(domain.float().reshape(-1))
    picked = d[torch.clamp(rows, 0, d.shape[0] - 1)]
    return torch.where(rows < d.shape[0], picked, 0.0)[:, None]


@torch.no_grad()
def init_da_heads(heads, seed: int, device) -> None:
    """He-normal weights and zero biases for every conv and fc of the
    modules ``heads``, drawn from a generator seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    for head in heads:
        for m in head.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.normal_(m.weight, 0.0,
                                math.sqrt(2.0 / m.weight[0].numel()),
                                generator=g)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)


def fused_box_head(det, pooled, *, deterministic: bool, rng):
    """One fc6/fc7 pass over several (R, P, P, C) RoI sets, split back into
    one fc7 block per set: the fc6 weight and its gradient stream once per
    step instead of once per set. The cat is taken in the (R, C, P, P) order
    fc6 flattens in, which is the RoIAlign kernel's own layout on the card:
    the cat is the only copy, and its backward hands each set a contiguous
    (R, C, P, P) gradient. Dropout masks are drawn once, over all rows,
    each set's rows a block of the global draw (:meth:`StepRandom.rows`)."""
    sizes = [p.shape[0] for p in pooled]
    cat = torch.cat([p.permute(0, 3, 1, 2) for p in pooled], dim=0)
    with rng.rows(sizes) if rng is not None else nullcontext():
        fc7 = det.box_head(cat.permute(0, 2, 3, 1),
                           deterministic=deterministic, rng=rng)
    return fc7.split(sizes)


def source_target_pass(det, src, tgt, *, training: bool, rng,
                       return_taps: bool = False):
    """The detector pass DAF, MAF and PT-MAF share: backbone maps (or
    taps) of the pair, the supervised source pre-head, the unsupervised
    target pre-head (RPN under the TEST config), one fc6/fc7 pass over both
    RoI sets. Returns (source maps, target maps, the source's finished
    ``out``, the target's pre-head ``t_out``, the target's fc7)."""
    s_feat, t_feat = features_pair(det, src["im_data"], tgt["im_data"],
                                   return_taps=return_taps)
    out, s_samples, s_pooled = det.forward_pre_head(
        s_feat[-1] if return_taps else s_feat, src["im_info"],
        src["gt_boxes"], training=training, rng=rng)
    t_out, _, t_pooled = det.forward_pre_head(
        t_feat[-1] if return_taps else t_feat, tgt["im_info"],
        tgt["gt_boxes"], training=training, supervised=False, rng=rng)
    fc7_s, fc7_t = fused_box_head(det, (s_pooled, t_pooled),
                                  deterministic=not training, rng=rng)
    return s_feat, t_feat, det.finish_head(out, s_samples, fc7_s), t_out, \
        fc7_t


def features_pair(det, src_im: torch.Tensor, tgt_im: torch.Tensor, *,
                  return_taps: bool = False):
    """Backbone maps of a (source, target) pair, or their (c3, c4, c5) taps
    with ``return_taps``: one batched pass over ``[src; tgt]`` when the
    shapes match, else two. Every backbone op is per image, so both give the
    same maps; each half of a fused NHWC map stays contiguous."""
    if src_im.shape == tgt_im.shape:
        b = src_im.shape[0]
        both = det.features(torch.cat([src_im, tgt_im], dim=0),
                            return_taps=return_taps)
        if return_taps:
            return (tuple(t[:b] for t in both), tuple(t[b:] for t in both))
        return both[:b], both[b:]
    return (det.features(src_im, return_taps=return_taps),
            det.features(tgt_im, return_taps=return_taps))
