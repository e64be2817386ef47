"""MAF — Multi-Adversarial Faster R-CNN (``tllod_tpu/methods/maf.py``;
reference ``lib/MAF/``).

Image-level domain discriminators on the conv3, conv4 and conv5 taps of the
backbone; the two lower taps first go through a Scale Reduce Module (a 1×1
conv to ``inner`` channels, ReLU, then space-to-depth), so all three domain
maps sit at stride 16. The instance discriminator sees fc7 ⊕ ``cls_prob``
and reverses its gradient scaled by its own detached confidence on the
true domain (``WGRLayer``, α = 0.2).

As in DAF, the source and target RoIs go through one fc6/fc7 pass, with its
dropout masks drawn once over both.

Total loss (``methods/MAF/MAF_train.py:415-418``):
    det + λ·(img3+img4+img5 + α·ins + tgt_img3+4+5 + α·tgt_ins).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.config import Config
from tllod_torch.device import resolve_device
from tllod_torch.methods.da_modules import (ImageDA, image_da_loss,
                                            init_da_heads,
                                            source_target_pass)
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.models.layers import Conv2d, Linear, set_compute_dtype
from tllod_torch.ops.grl import (grad_reverse, weak_scalar,
                                 weighted_grad_reverse)
from tllod_torch.ops.losses import softmax_cross_entropy


def space_to_depth(x: torch.Tensor, scale: int) -> torch.Tensor:
    """DRM's chunk-and-stack (``lib/MAF/drm.py:20-42``) on an NHWC map: crop
    H and W to multiples of ``scale``, then fold each scale×scale block into
    channels in the torch (C, i, j) order, channel c·s² + i·s + j."""
    b, h, w, c = x.shape
    hn, wn = h // scale, w // scale
    x = x[:, :hn * scale, :wn * scale, :]
    x = x.reshape(b, hn, scale, wn, scale, c)
    x = x.permute(0, 1, 3, 5, 2, 4)               # (B, hn, wn, C, s, s)
    return x.reshape(b, hn, wn, c * scale * scale)


class ImageDADRM(nn.Module):
    """GRL → DRM (1×1 conv to ``inner``, ReLU, space-to-depth) → 1×1 conv
    512 → ReLU → 1×1 conv 2, all bias-free (``_ImageDA_drm``,
    ``lib/MAF/DA.py:128-149``). NHWC in, (B, H/s, W/s, 2) logits out."""

    def __init__(self, in_channels: int, inner: int, scale: int,
                 alpha: float = 0.1, device=None):
        super().__init__()
        self.alpha = alpha
        self.scale = scale
        self.drm_conv = Conv2d(in_channels, inner, 1, bias=False,
                                  device=device)
        self.conv1 = Conv2d(inner * scale * scale, 512, 1, bias=False,
                               device=device)
        self.conv2 = Conv2d(512, 2, 1, bias=False, device=device)

    def forward(self, feat: torch.Tensor, grl_scale=1.0) -> torch.Tensor:
        x = grad_reverse(feat, self.alpha * grl_scale).permute(0, 3, 1, 2)
        x = F.relu(self.drm_conv(x)).permute(0, 2, 3, 1)
        x = space_to_depth(x, self.scale).permute(0, 3, 1, 2)
        x = self.conv2(F.relu(self.conv1(x)))
        return x.permute(0, 2, 3, 1)


class InstanceDAWeighted(nn.Module):
    """Confidence-weighted instance discriminator (``_InstanceDA_w``,
    ``lib/MAF/DA.py:79-105``): fc 1024 → ReLU → fc 1024 → ReLU → fc 2, no
    dropout. A first pass on the detached features, which gives its weights
    no gradient and so runs under ``no_grad``, yields the softmax
    confidence on the true domain; it scales the reversed gradient of the
    second, loss-bearing pass (α = 0.2). Returns (R, 2) logits."""

    def __init__(self, in_features: int, wgrl_alpha: float = 0.2,
                 device=None):
        super().__init__()
        self.wgrl_alpha = wgrl_alpha
        self.dc_ip1 = Linear(in_features, 1024, device=device)
        self.dc_ip2 = Linear(1024, 1024, device=device)
        self.classifier = Linear(1024, 2, device=device)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dc_ip1(x))
        x = F.relu(self.dc_ip2(x))
        return self.classifier(x)

    def forward(self, feat: torch.Tensor, domain: torch.Tensor
                ) -> torch.Tensor:
        with torch.no_grad():
            score = F.softmax(self._mlp(feat), dim=1)
        dom = domain.reshape(-1)[:1].long()
        weight = score.index_select(1, dom)                    # (R, 1)
        alpha = weak_scalar(self.wgrl_alpha, weight.dtype)     # as JAX's
        return self._mlp(weighted_grad_reverse(feat, alpha * weight))


def instance_domain_loss(ins_da: InstanceDAWeighted, fc7: torch.Tensor,
                         cls_prob: torch.Tensor, domain: torch.Tensor
                         ) -> torch.Tensor:
    """Mean 2-class cross-entropy of ``ins_da`` on fc7 ⊕ ``cls_prob``
    against the image's domain (``maf.py:149-154``)."""
    logits = ins_da(torch.cat([fc7, cls_prob], dim=1), domain)
    labels = domain.reshape(-1)[:1].long().expand(logits.shape[0])
    return softmax_cross_entropy(logits, labels)


class MAFModel(nn.Module):
    """Detector + MAF heads. Submodules ``detector``, ``img_da3``,
    ``img_da4``, ``img_da5`` and ``ins_da`` follow the flax param
    subtrees; eval loads ``detector`` alone. Built on ``device`` (default
    ``cuda``); with ``seed`` every weight is drawn from generators seeded
    with it. ``dtype`` is the compute type of every layer, the heads' too
    (``maf.py:126-141``)."""

    def __init__(self, num_classes: int, cfg: Config, net: str = "vgg16",
                 class_agnostic: bool = False, grl_alpha: float = 0.1, *,
                 device=None, seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_classes = num_classes
        self.detector = FasterRCNN(num_classes, cfg, net, class_agnostic,
                                   device=self.device, dtype=dtype)
        c3, c4, c5 = self.detector.backbone.tap_channels
        # (inner 64, s 4) on c3, (256, 2) on c4, plain on c5
        # (lib/MAF/faster_rcnn.py:41-44)
        self.img_da3 = ImageDADRM(c3, 64, 4, alpha=grl_alpha,
                                  device=self.device)
        self.img_da4 = ImageDADRM(c4, 256, 2, alpha=grl_alpha,
                                  device=self.device)
        self.img_da5 = ImageDA(c5, alpha=grl_alpha, device=self.device)
        self.ins_da = InstanceDAWeighted(
            self.detector.head_dim + num_classes, device=self.device)
        set_compute_dtype(self, dtype)
        if seed is not None:
            self.init_weights(seed)
        self.train()

    def init_weights(self, seed: int) -> None:
        self.detector.init_weights(seed)
        init_da_heads((self.img_da3, self.img_da4, self.img_da5,
                       self.ins_da), seed + 1, self.device)

    def _image_losses(self, taps, domain):
        c3, c4, c5 = taps
        return (image_da_loss(self.img_da3(c3), domain)
                + image_da_loss(self.img_da4(c4), domain)
                + image_da_loss(self.img_da5(c5), domain))

    def forward(self, src: Dict[str, Any], tgt: Dict[str, Any], *,
                training: bool = True, rng=None) -> Dict[str, Any]:
        """``src``/``tgt``: dicts of device tensors ``im_data`` (B, H, W, 3),
        ``im_info``, ``gt_boxes``, ``domain``; ``rng`` a
        :class:`tllod_torch.train.StepRandom` when ``training``."""
        s_taps, t_taps, out, t_out, fc7_t = source_target_pass(
            self.detector, src, tgt, training=training, rng=rng,
            return_taps=True)
        t_out = self.detector.finish_head(t_out, None, fc7_t)
        fc7_s = out["pooled_feat"]
        c = self.num_classes
        out["da_img_loss"] = self._image_losses(s_taps, src["domain"])
        out["da_ins_loss"] = instance_domain_loss(
            self.ins_da, fc7_s, out["cls_prob"].reshape(-1, c), src["domain"])
        out["tgt_da_img_loss"] = self._image_losses(t_taps, tgt["domain"])
        out["tgt_da_ins_loss"] = instance_domain_loss(
            self.ins_da, fc7_t, t_out["cls_prob"].reshape(-1, c),
            tgt["domain"])
        return out


def maf_loss(out: Dict[str, Any], lamda: float = 0.1,
             alpha: float = 1.0) -> torch.Tensor:
    """det + λ·(img + α·ins + tgt_img + α·tgt_ins) (``maf.py:183``)."""
    det = (out["rpn_loss_cls"] + out["rpn_loss_box"]
           + out["rcnn_loss_cls"] + out["rcnn_loss_box"])
    return det + lamda * (out["da_img_loss"] + alpha * out["da_ins_loss"]
                          + out["tgt_da_img_loss"]
                          + alpha * out["tgt_da_ins_loss"])
