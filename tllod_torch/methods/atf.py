"""ATF — Asymmetric Tri-way Faster R-CNN (``tllod_tpu/methods/atf.py``;
reference ``lib/ATF/``).

The source image runs through two backbones, the detector's and an
ancillary ``backbone_anc`` that starts as a copy of it, and both branches
feed the same RPN and box head with summed supervised losses. Image-level
discriminators on conv3/4/5 see the ancillary source taps against the main
target taps. The instance discriminator sees the head features of the full
proposal sets: the ancillary branch's raw source proposals and the
target's, each ``TRAIN.RPN_POST_NMS_TOP_N`` rows (the target RPN runs under
the TEST config with the TRAIN post-NMS count). Their labels follow the
reference's 256-row blocks (:func:`blocked_instance_labels`).

The port runs the main backbone once over [src; tgt] and the four RoI sets
(main and ancillary sampled source RoIs, the target's proposals, the
ancillary raw proposals) through one fc6/fc7 pass, with its dropout masks
drawn once over all rows.

``backbone_anc``'s conv1-2 stay cut from the graph by the backbone's
detach, but stay in the optimizer: the JAX package's optimizer mask
freezes only paths containing ``backbone/conv1_`` or ``backbone/conv2_``
(``tllod_tpu/utils/optim.py:41-43``), so weight decay and momentum move
them. Their ``requires_grad`` is on for that; autograd leaves their
gradient ``None`` and :class:`tllod_torch.utils.optim.SGD` steps them on a
zero gradient, as optax does.

Total loss (``methods/ATF/ATF_train.py:405-408``):
    det + λ·(7·img + ins + 7·tgt_img + tgt_ins).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from tllod_torch.config import Config
from tllod_torch.device import resolve_device
from tllod_torch.methods.da_modules import (ImageDA, InstanceDA,
                                            blocked_instance_labels,
                                            features_pair, fused_box_head,
                                            image_da_loss, init_da_heads)
from tllod_torch.models.backbones import VGG16Features
from tllod_torch.models.faster_rcnn import FasterRCNN, nhwc_features
from tllod_torch.models.layers import set_compute_dtype
from tllod_torch.ops.losses import binary_cross_entropy

SUPERVISED_KEYS = ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls",
                   "rcnn_loss_box")


class ATFModel(nn.Module):
    """Detector + ancillary backbone + ATF heads. Submodules ``detector``,
    ``backbone_anc``, ``img_da3/4/5`` and ``ins_da`` follow the flax param
    subtrees; eval loads ``detector`` alone. Built on ``device`` (default
    ``cuda``); with ``seed`` every weight is drawn from generators seeded
    with it, and ``backbone_anc`` copies the detector's backbone.
    ``dtype`` is the compute type of every layer, the ancillary backbone's
    and the heads' too (``atf.py:49-68``)."""

    def __init__(self, num_classes: int, cfg: Config, net: str = "vgg16",
                 class_agnostic: bool = False, grl_alpha: float = 0.1, *,
                 device=None, seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if net not in ("vgg16", "vgg16_thin"):
            raise ValueError("ATF ships with the VGG16 backbone")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.detector = FasterRCNN(num_classes, cfg, net, class_agnostic,
                                   device=self.device, dtype=dtype)
        self.backbone_anc = VGG16Features(
            width=0.25 if net == "vgg16_thin" else 1.0,
            device=self.device).to(memory_format=torch.channels_last)
        self.backbone_anc.requires_grad_(True)
        c3, c4, c5 = self.backbone_anc.tap_channels
        self.img_da3 = ImageDA(c3, alpha=grl_alpha, device=self.device)
        self.img_da4 = ImageDA(c4, alpha=grl_alpha, device=self.device)
        self.img_da5 = ImageDA(c5, alpha=grl_alpha, device=self.device)
        self.ins_da = InstanceDA(self.detector.head_dim, alpha=grl_alpha,
                                 device=self.device)
        set_compute_dtype(self, dtype)
        if seed is not None:
            self.init_weights(seed)
        self.train()

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """The detector's init from ``seed``, ``backbone_anc`` a copy of its
        backbone (the reference's ``copy.deepcopy``), He-normal DA heads."""
        self.detector.init_weights(seed)
        self.backbone_anc.load_state_dict(self.detector.backbone.state_dict())
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
        det = self.detector
        deterministic = not training
        s_taps, t_taps = features_pair(det, src["im_data"], tgt["im_data"],
                                       return_taps=True)
        a_taps = nhwc_features(self.backbone_anc, src["im_data"],
                               return_taps=True)

        # the source through both branches, sampled and supervised
        out, m_samples, m_pooled = det.forward_pre_head(
            s_taps[-1], src["im_info"], src["gt_boxes"], training=training,
            rng=rng)
        anc, a_samples, a_pooled = det.forward_pre_head(
            a_taps[-1], src["im_info"], src["gt_boxes"], training=training,
            rng=rng)
        # the target: TEST RPN with the TRAIN post-NMS count (atf.py:99-102)
        _, _, t_pooled = det.forward_pre_head(
            t_taps[-1], tgt["im_info"], tgt["gt_boxes"], training=training,
            supervised=False,
            post_nms_top_n=self.cfg.TRAIN.RPN_POST_NMS_TOP_N, rng=rng)
        # the ancillary branch's raw source proposals (atf.py:111-114)
        anc_rois = anc["rpn_rois"]
        r_pooled = det.roi_features(
            a_taps[-1], anc_rois.reshape(-1, 5).contiguous())

        fc7_m, fc7_a, fc7_t, fc7_r = fused_box_head(
            det, (m_pooled, a_pooled, t_pooled, r_pooled),
            deterministic=deterministic, rng=rng)
        out = det.finish_head(out, m_samples, fc7_m)
        anc = det.finish_head(anc, a_samples, fc7_a)
        for k in SUPERVISED_KEYS:
            out[k] = out[k] + anc[k]

        out["da_img_loss"] = self._image_losses(a_taps, src["domain"])
        out["tgt_da_img_loss"] = self._image_losses(t_taps, tgt["domain"])
        ins_prob = self.ins_da(fc7_r, deterministic=deterministic, rng=rng)
        out["da_ins_loss"] = binary_cross_entropy(
            ins_prob, blocked_instance_labels(src["domain"],
                                              ins_prob.shape[0]))
        t_ins_prob = self.ins_da(fc7_t, deterministic=deterministic, rng=rng)
        out["tgt_da_ins_loss"] = binary_cross_entropy(
            t_ins_prob, blocked_instance_labels(tgt["domain"],
                                                t_ins_prob.shape[0]))
        return out


def atf_loss(out: Dict[str, Any], lamda: float = 0.1) -> torch.Tensor:
    """det + λ·(7·img + ins + 7·tgt_img + tgt_ins) (``atf.py:131``)."""
    det = (out["rpn_loss_cls"] + out["rpn_loss_box"]
           + out["rcnn_loss_cls"] + out["rcnn_loss_box"])
    return det + lamda * (7.0 * out["da_img_loss"] + out["da_ins_loss"]
                          + 7.0 * out["tgt_da_img_loss"]
                          + out["tgt_da_ins_loss"])
