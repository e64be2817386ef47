"""PT-MAF — Paradigm-Teacher MAF (``tllod_tpu/methods/pt_maf.py``;
reference ``lib/PT_MAF/``).

MAF's three image discriminators are split into foreground and background
pairs, gated by the RPN objectness map: pixels whose largest anchor
fg-probability is above ``high``·max are foreground, below ``low``·max
background. Each group has its own discriminators; its loss is a masked NLL
and its GRL α is 0.1 times the group's pixel fraction. The instance
discriminator is MAF's confidence-weighted one on fc7 ⊕ ``cls_prob``.

Knowledge distillation from a frozen source-only teacher: temperature-T KL
on the RPN objectness distribution inside the gt boxes' footprint, and on
the box head's class distribution over the positive sampled RoIs.
:func:`teacher_kd` is the teacher's forward and :func:`add_kd_loss` its
wiring into the step (``methods/PT_MAF/PT_MAF_train.py:105-135``); the
teacher is a :class:`FasterRCNN` held apart from the trained model and
passed to :meth:`PTMAFModel.forward` each step.

Kept as the JAX package has it: the level weights are fixed at (1, 1, 1)
(``pt_maf.py:132``), so the train CLI's ``--alpha/--beta/--gamma`` reach
nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.config import Config
from tllod_torch.device import resolve_device
from tllod_torch.methods.da_modules import (ImageDA, init_da_heads,
                                            source_target_pass)
from tllod_torch.methods.maf import (ImageDADRM, InstanceDAWeighted,
                                     instance_domain_loss)
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.models.rpn import rpn_probs
from tllod_torch.parallel.dist import global_max, gsum

LEVEL_WEIGHTS = (1.0, 1.0, 1.0)


def masked_image_nll(logits: torch.Tensor, domain: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """NLL of (B, H, W, 2) logits against the broadcast domain label,
    averaged over the ``mask`` pixels only (``pt_maf.py:36-45``)."""
    logp = F.log_softmax(logits, dim=-1)
    is_src = (domain > 0)[:, None, None]
    picked = torch.where(is_src, logp[..., 1], logp[..., 0])
    denom = torch.clamp(gsum(mask), min=1.0)
    return -gsum(picked * mask) / denom


def fg_bg_maps(fg_prob: torch.Tensor, high: float, low: float):
    """Foreground and background gating maps from the RPN objectness map
    (B, H, W, A) (``pt_maf.py:48-60``): the per-pixel max over anchors,
    thresholded at ``high`` and ``low`` times the global max. Returns (fg
    (B, H, W), bg (B, H, W), ratio_f, ratio_b), the ratios over a detached
    total."""
    per_pixel = fg_prob.amax(dim=-1)
    max_prob = global_max(per_pixel)
    f = (per_pixel > max_prob * high).float()
    b = (per_pixel < max_prob * low).float()
    f_sum, b_sum = gsum(f), gsum(b)
    total = torch.clamp((f_sum + b_sum).detach(), min=1.0)
    return f, b, f_sum / total, b_sum / total


def gt_footprint_mask(gt_boxes: torch.Tensor, feat_h: int, feat_w: int,
                      stride: int = 16) -> torch.Tensor:
    """Binary stride-``stride`` map of the gt boxes' interiors, int-
    truncated coordinates, [x1, x2) × [y1, y2) (``pt_maf.py:177-190``).
    gt_boxes (B, G, 5), zero-padded → (B, feat_h, feat_w)."""
    dev = gt_boxes.device
    ys = torch.arange(feat_h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(feat_w, dtype=torch.float32, device=dev)[None, :]
    bb = torch.floor(gt_boxes[..., :4] / stride)[..., None, None]
    valid = (gt_boxes[..., 2] > gt_boxes[..., 0])[..., None, None]
    inside = ((xs >= bb[..., 0, :, :]) & (xs < bb[..., 2, :, :])
              & (ys >= bb[..., 1, :, :]) & (ys < bb[..., 3, :, :])) & valid
    return inside.any(dim=-3).float()


def pt_maf_kd_loss(student_rpn, teacher_rpn, student_cls, teacher_cls,
                   rois_label, mask) -> torch.Tensor:
    """Masked KL terms (``pt_maf.py:193-209``): (1/(pos+1))·Σ_pos
    student·log(student/teacher) on the RoI class distributions, plus
    (1/(mask+1))·Σ_mask student·log(student/teacher) on the RPN ones."""
    eps = 1e-8
    pos = (rois_label > 0).float()
    cls_kl = gsum(pos[:, None] * student_cls
                  * torch.log((student_cls + eps) / (teacher_cls + eps)))
    cls_kl = cls_kl / (gsum(pos) + 1.0)
    m = mask[:, :, :, None, None]
    rpn_kl = gsum(m * student_rpn
                  * torch.log((student_rpn + eps) / (teacher_rpn + eps)))
    rpn_kl = rpn_kl / (gsum(mask) + 1.0)
    return cls_kl + rpn_kl


@torch.no_grad()
def teacher_kd(teacher: FasterRCNN, im_data: torch.Tensor,
               rois: torch.Tensor, temperature: float):
    """The frozen teacher's temperature-T RPN distribution (B, H, W, A, 2)
    and its temperature-T class distribution on the student's sampled
    ``rois`` (B, N, 5) (``PT_MAF_train.py:105-121``)."""
    base = teacher.features(im_data)
    cls_score, _ = teacher.rpn(base.permute(0, 3, 1, 2))
    _, logits = rpn_probs(cls_score.permute(0, 2, 3, 1).float())
    kd_rpn = F.softmax(logits / temperature, dim=-1)
    pooled = teacher.roi_features(base, rois.reshape(-1, 5).contiguous())
    cls, _ = teacher.box_outputs(teacher.box_head(pooled))
    return kd_rpn, F.softmax(cls / temperature, dim=1)


def add_kd_loss(out: Dict[str, Any], teacher: FasterRCNN,
                src: Dict[str, Any], temperature: float,
                stride: int) -> Dict[str, Any]:
    """``out['kd_loss']`` from the teacher's distributions on the source
    image and the per-image gt footprint masks (``PT_MAF_train.py:
    123-135``)."""
    t_rpn, t_cls = teacher_kd(teacher, src["im_data"], out["rois"],
                              temperature)
    h, w = out["kd_rpn_prob"].shape[1:3]
    mask = gt_footprint_mask(src["gt_boxes"], h, w, stride)
    out["kd_loss"] = pt_maf_kd_loss(out["kd_rpn_prob"], t_rpn,
                                    out["kd_cls_prob"], t_cls,
                                    out["rois_label"], mask)
    return out


class PTMAFModel(nn.Module):
    """Detector + PT-MAF heads. Submodules ``detector``,
    ``img_da{3,4,5}_{f,b}`` and ``ins_da`` follow the flax param subtrees;
    the teacher is not one of them. Built on ``device`` (default ``cuda``);
    with ``seed`` every weight is drawn from generators seeded with it."""

    def __init__(self, num_classes: int, cfg: Config, net: str = "vgg16",
                 class_agnostic: bool = False, temperature: float = 3.0,
                 high: float = 0.7, low: float = 0.1, *, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.num_classes = num_classes
        self.temperature = temperature
        self.high, self.low = high, low
        self.detector = FasterRCNN(num_classes, cfg, net, class_agnostic,
                                   device=self.device)
        c3, c4, c5 = self.detector.backbone.tap_channels
        for group in ("f", "b"):
            self.add_module(f"img_da3_{group}",
                            ImageDADRM(c3, 64, 4, device=self.device))
            self.add_module(f"img_da4_{group}",
                            ImageDADRM(c4, 256, 2, device=self.device))
            self.add_module(f"img_da5_{group}",
                            ImageDA(c5, device=self.device))
        self.ins_da = InstanceDAWeighted(
            self.detector.head_dim + num_classes, device=self.device)
        if seed is not None:
            self.init_weights(seed)
        self.train()

    def init_weights(self, seed: int) -> None:
        self.detector.init_weights(seed)
        init_da_heads([m for n, m in self.named_children()
                       if n != "detector"], seed + 1, self.device)

    def _grouped_image_losses(self, taps, domain, fg_prob):
        """Σ level-weighted (fg-masked f-head NLL + bg-masked b-head NLL),
        each head's GRL α scaled by its group's pixel ratio; the DRM maps
        are cropped to the RPN map's extent before masking."""
        fmap, bmap, ratio_f, ratio_b = fg_bg_maps(fg_prob, self.high,
                                                  self.low)
        total = torch.zeros((), device=fg_prob.device)
        for level, feat, w in zip((3, 4, 5), taps, LEVEL_WEIGHTS):
            lf = getattr(self, f"img_da{level}_f")(feat, grl_scale=ratio_f)
            lb = getattr(self, f"img_da{level}_b")(feat, grl_scale=ratio_b)
            h = min(lf.shape[1], fmap.shape[1])
            w_ = min(lf.shape[2], fmap.shape[2])
            total = total + w * (
                masked_image_nll(lf[:, :h, :w_], domain, fmap[:, :h, :w_])
                + masked_image_nll(lb[:, :h, :w_], domain, bmap[:, :h, :w_]))
        return total

    def forward(self, src: Dict[str, Any], tgt: Dict[str, Any],
                teacher: Optional[FasterRCNN] = None, *,
                training: bool = True, rng=None) -> Dict[str, Any]:
        """As :meth:`MAFModel.forward`; in training it adds the student's
        KD distributions ``kd_cls_prob`` and ``kd_rpn_prob``, and with a
        ``teacher`` the ``kd_loss`` against it."""
        s_taps, t_taps, out, t_out, fc7_t = source_target_pass(
            self.detector, src, tgt, training=training, rng=rng,
            return_taps=True)
        t_out = self.detector.finish_head(t_out, None, fc7_t)
        fc7_s = out["pooled_feat"]
        c = self.num_classes
        out["da_img_loss"] = self._grouped_image_losses(
            s_taps, src["domain"], out["rpn_cls_prob"])
        out["da_ins_loss"] = instance_domain_loss(
            self.ins_da, fc7_s, out["cls_prob"].reshape(-1, c), src["domain"])
        out["tgt_da_img_loss"] = self._grouped_image_losses(
            t_taps, tgt["domain"], t_out["rpn_cls_prob"])
        out["tgt_da_ins_loss"] = instance_domain_loss(
            self.ins_da, fc7_t, t_out["cls_prob"].reshape(-1, c),
            tgt["domain"])
        if training:
            # the student's temperature-T distributions, from the source
            # head's class scores and RPN logits of this pass
            # (pt_maf.py:162-174 runs both heads again for the same values)
            t = self.temperature
            out["kd_cls_prob"] = F.softmax(out["cls_score"] / t, dim=1)
            out["kd_rpn_prob"] = F.softmax(out["rpn_logits"] / t, dim=-1)
            if teacher is not None:
                add_kd_loss(out, teacher, src, t, self.cfg.FEAT_STRIDE[0])
        return out


def pt_maf_loss(out: Dict[str, Any], lamda: float = 0.1,
                kd_loss=0.0) -> torch.Tensor:
    """det + λ·(img + ins + tgt_img + tgt_ins) + kd (``pt_maf.py:212``)."""
    det = (out["rpn_loss_cls"] + out["rpn_loss_box"]
           + out["rcnn_loss_cls"] + out["rcnn_loss_box"])
    return det + lamda * (out["da_img_loss"] + out["da_ins_loss"]
                          + out["tgt_da_img_loss"]
                          + out["tgt_da_ins_loss"]) + kd_loss
