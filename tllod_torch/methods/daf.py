"""DAF — Domain Adaptive Faster R-CNN (``tllod_tpu/methods/daf.py``;
reference ``lib/DAF/faster_rcnn.py:22-224``).

A supervised source forward and an unsupervised target forward (RPN under
the TEST config, dropout on), image- and instance-level domain classifiers
behind gradient reversal (α = 0.1), and the consistency loss between each
RoI's domain probability and the detached mean image-level probability.

Kept for parity: the source consistency term reads image-probability
channel 1 and the target term channel 0 (``lib/DAF/faster_rcnn.py:192,
216``), and the consistency loss is a SUM over RoIs (``MSELoss(size_average=
False)``).

Total loss (``methods/DAF/DAF_train.py:397-400``):
    det + λ·(img + ins + cst + tgt_img + tgt_ins + tgt_cst), λ = 0.1.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.config import Config
from tllod_torch.device import resolve_device
from tllod_torch.methods.da_modules import (ImageDA, InstanceDA,
                                            image_da_loss, init_da_heads,
                                            instance_da_loss,
                                            source_target_pass)
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.models.layers import set_compute_dtype
from tllod_torch.parallel.dist import gmean, gsum


class DAFModel(nn.Module):
    """Detector + DAF heads. Submodules ``detector``, ``img_da`` and
    ``ins_da`` follow the flax param subtrees; eval loads ``detector``
    alone. Built on ``device`` (default ``cuda``); with ``seed`` every
    weight is drawn from a generator seeded with it. ``dtype`` is the
    compute type of every layer, the heads' too (``daf.py:52-60``)."""

    def __init__(self, num_classes: int, cfg: Config, net: str = "vgg16",
                 class_agnostic: bool = False, grl_alpha: float = 0.1, *,
                 device=None, seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.detector = FasterRCNN(num_classes, cfg, net, class_agnostic,
                                   device=self.device, dtype=dtype)
        self.img_da = ImageDA(self.detector.dout_base_model, alpha=grl_alpha,
                              device=self.device)
        self.ins_da = InstanceDA(self.detector.head_dim, alpha=grl_alpha,
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

    def _domain_terms(self, base_feat, fc7, domain, rois_per_image: int,
                      consistency_channel: int, deterministic: bool, rng):
        img_logits = self.img_da(base_feat)
        img_loss = image_da_loss(img_logits, domain)
        ins_prob = self.ins_da(fc7, deterministic=deterministic, rng=rng)
        ins_loss = instance_da_loss(ins_prob, domain, rois_per_image)
        img_prob = F.softmax(img_logits, dim=-1)[..., consistency_channel]
        target = gmean(img_prob.detach())
        cst_loss = gsum((ins_prob - target) ** 2)
        return img_loss, ins_loss, cst_loss

    def forward(self, src: Dict[str, Any], tgt: Dict[str, Any], *,
                training: bool = True, rng=None) -> Dict[str, Any]:
        """``src``/``tgt``: dicts of device tensors ``im_data`` (B, H, W, 3),
        ``im_info``, ``gt_boxes``, ``domain``; ``rng`` a
        :class:`tllod_torch.train.StepRandom` when ``training``."""
        deterministic = not training
        _, t_feat, out, t_out, fc7_t = source_target_pass(
            self.detector, src, tgt, training=training, rng=rng)
        fc7_s = out["pooled_feat"]
        img_l, ins_l, cst_l = self._domain_terms(
            out["base_feat"], fc7_s, src["domain"], out["rois"].shape[1],
            consistency_channel=1, deterministic=deterministic, rng=rng)
        t_img_l, t_ins_l, t_cst_l = self._domain_terms(
            t_feat, fc7_t, tgt["domain"], t_out["rois"].shape[1],
            consistency_channel=0, deterministic=deterministic, rng=rng)
        out.update({
            "da_img_loss": img_l, "da_ins_loss": ins_l, "da_cst_loss": cst_l,
            "tgt_da_img_loss": t_img_l, "tgt_da_ins_loss": t_ins_l,
            "tgt_da_cst_loss": t_cst_l,
        })
        return out


def daf_loss(out: Dict[str, Any], lamda: float = 0.1) -> torch.Tensor:
    """det + λ·(6 DA terms) (``daf.py:131``)."""
    det = (out["rpn_loss_cls"] + out["rpn_loss_box"]
           + out["rcnn_loss_cls"] + out["rcnn_loss_box"])
    da = (out["da_img_loss"] + out["da_ins_loss"] + out["da_cst_loss"]
          + out["tgt_da_img_loss"] + out["tgt_da_ins_loss"]
          + out["tgt_da_cst_loss"])
    return det + lamda * da
