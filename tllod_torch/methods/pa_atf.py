"""PA-ATF — Partial Alignment ATF (``tllod_tpu/methods/pa_atf.py``;
reference ``lib/PA_ATF/``).

ATF's tri-way structure (:mod:`tllod_torch.methods.atf`: the detector's
backbone and an ancillary ``backbone_anc`` copied from it, both source
branches through one RPN and box head with summed supervised losses), plus:

  * partial-alignment image discriminators (:class:`PartialImageDA`) on the
    ancillary source taps against the main target taps; each returns its
    probabilities and a per-channel mask;
  * an L1 instance loss, mean |sigmoid − domain label|, on the ancillary
    branch's sampled source RoIs and the target's proposals;
  * CLUB heads (:class:`CLUBHead`) on the gt RoIs pooled with RoIPool
    (:func:`tllod_torch.ops.roi_pool.roi_pool`) from the c3/c4/c5 taps at
    strides 4/8/16, split by the source mask into aligned (×mask) and
    specific (×(1 − mask)) parts: a pair discriminator calls matched pairs
    "same" and shuffled pairs "diff". The taps are ``backbone_anc``'s, or
    the main backbone's with ``club_branch="main"`` (the reference's
    ``vgg16_source_intra``);
  * the target's proposals: the TEST pre-NMS count with TRAIN's post-NMS
    count, and the sampled selection of the NMS survivors
    (:func:`tllod_torch.models.rpn.sample_survivors`).

The port runs the main backbone once over [src; tgt], the three RoI sets
(main and ancillary sampled source RoIs, the target's proposals) through
one fc6/fc7 pass, and each CLUB head's same and shuffled pairs through one
batched pass. The CLUB fc flattens its (R, 3, 3, 128) map in (H, W, C)
order, as flax does, so JAX's fc kernel carries over unpermuted.

The step's random draws from ``rng`` (:class:`tllod_torch.train.StepRandom`),
in order: the main branch's anchor-target (2) and proposal-target (4)
priorities, the ancillary branch's (2 + 4), the target's proposal sample
(B, postN); the fc6 and fc7 dropout masks over all three RoI sets; the
instance head's two masks on the ancillary source rows, then two on the
target rows; one (R,) uniform per CLUB head (c3, c4, c5), whose stable
ascending argsort is the shuffle. JAX draws a ``sampling`` key per CLUB
head (``jax.random.permutation``) and one for the proposal sample
(per image, from ``jax.random.split``); a test replays them as uniforms
whose sort gives the same permutation and selection.

``backbone_anc``'s conv1-2 stay in the optimizer, as ATF's do.

Total loss (``methods/PA_ATF/PA_ATF_train.py:405-408``):
    det + λ·(img + ins + tgt_img + tgt_ins) + β·pm, λ = β = 0.1.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.config import Config
from tllod_torch.device import resolve_device
from tllod_torch.methods.da_modules import (InstanceDA, features_pair,
                                            fused_box_head, init_da_heads)
from tllod_torch.models.backbones import VGG16Features
from tllod_torch.models.faster_rcnn import FasterRCNN, nhwc_features
from tllod_torch.models.layers import Conv2d, Linear, set_compute_dtype
from tllod_torch.ops.grl import grad_reverse
from tllod_torch.ops.losses import binary_cross_entropy
from tllod_torch.ops.roi_pool import roi_pool
from tllod_torch.parallel.dist import gather_rows, gmean

SUPERVISED_KEYS = ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls",
                   "rcnn_loss_box")
CLUB_STRIDES = (4, 8, 16)
CLUB_POOL = 7                 # pa_atf.py:245, whatever POOLING_SIZE is

# GRL → 1024 → dropout → 1024 → dropout → 1 → sigmoid: the same head as
# DAF's instance discriminator (``pa_atf.py:75-89``); PA-ATF takes an L1
# loss of it
InstanceDAL1 = InstanceDA


class PartialImageDA(nn.Module):
    """Masked 1-channel image discriminator (``pa_atf.py:46-72``): GRL; a
    per-channel mask from 5×5/s3 conv → ReLU → 2×2/s2 max-pool → 3×3/s2
    conv (all VALID) → global spatial max → sigmoid; the masked map →
    1×1 (C/2, no bias) → ReLU → 1×1 (1, no bias) → sigmoid. Takes the NHWC
    map, returns (probs (B, H, W, 1), mask (B, 1, 1, C))."""

    def __init__(self, channels: int, alpha: float = 0.1, device=None):
        super().__init__()
        self.alpha = alpha
        self.mask_conv1 = Conv2d(channels, channels, 5, stride=3,
                                    device=device)
        self.mask_conv2 = Conv2d(channels, channels, 3, stride=2,
                                    device=device)
        self.conv1 = Conv2d(channels, channels // 2, 1, bias=False,
                               device=device)
        self.conv2 = Conv2d(channels // 2, 1, 1, bias=False,
                               device=device)

    def forward(self, feat: torch.Tensor):
        x = grad_reverse(feat, self.alpha).permute(0, 3, 1, 2)
        m = F.max_pool2d(F.relu(self.mask_conv1(x)), 2, 2)
        # amax splits a tied max's gradient equally, as jnp.max does
        mask = torch.sigmoid(self.mask_conv2(m).amax(dim=(2, 3),
                                                     keepdim=True))
        y = self.conv2(F.relu(self.conv1(x * mask)))
        return (torch.sigmoid(y).permute(0, 2, 3, 1),
                mask.permute(0, 2, 3, 1))


class CLUBHead(nn.Module):
    """Pair discriminator on (R, 7, 7, C) gt-RoI features
    (``pa_atf.py:93-134``): GRL 0.1 on both inputs; conv(2C → C, 3×3/s2
    VALID) → ReLU → conv(C → 128, 1×1) → ReLU → fc(3·3·128 → 2), flattened
    in (H, W, C) order. Returns the validity-weighted NLL of "same" (class
    1) on matched pairs plus that of "diff" (class 0) on shuffled pairs."""

    def __init__(self, channels: int, alpha: float = 0.1, device=None):
        super().__init__()
        self.alpha = alpha
        self.conv1 = Conv2d(2 * channels, channels, 3, stride=2,
                               device=device)
        self.conv2 = Conv2d(channels, 128, 1, device=device)
        side = (CLUB_POOL - 3) // 2 + 1
        self.fc = Linear(side * side * 128, 2, device=device)

    def forward(self, xa: torch.Tensor, xs: torch.Tensor,
                valid: torch.Tensor, rng) -> torch.Tensor:
        """xa, xs: (R, P, P, C) aligned and specific features; valid: (R,)
        bool gt-slot validity; ``rng`` draws the shuffle. The shuffle and
        the loss are over the global batch's rows: under a process group
        every rank gathers every rank's rows (:func:`gather_rows`), and the
        gradient of each row returns to the rank that holds it."""
        xa = gather_rows(grad_reverse(xa, self.alpha))
        xs = gather_rows(grad_reverse(xs, self.alpha))
        valid = gather_rows(valid)
        r = xa.shape[0]
        perm = torch.sort(rng.uniform((r,), replicated=True),
                          stable=True).indices
        pairs = torch.cat([torch.cat([xa, xs], dim=-1),
                           torch.cat([xa, xs[perm]], dim=-1)])
        x = F.relu(self.conv1(pairs.permute(0, 3, 1, 2)))
        x = F.relu(self.conv2(x))
        scores = self.fc(x.permute(0, 2, 3, 1).reshape(2 * r, -1))
        logp_same = F.log_softmax(scores[:r], dim=1)[:, 1]
        logp_diff = F.log_softmax(scores[r:], dim=1)[:, 0]
        w_same = valid.float()
        w_diff = (valid & valid[perm]).float()
        return (-(logp_same * w_same).sum() / torch.clamp(w_same.sum(),
                                                          min=1.0)
                - (logp_diff * w_diff).sum() / torch.clamp(w_diff.sum(),
                                                           min=1.0))


class PAATFModel(nn.Module):
    """Detector + ancillary backbone + PA-ATF heads. Submodules
    ``detector``, ``backbone_anc``, ``img_da3/4/5``, ``ins_da`` and
    ``club3/4/5`` follow the flax param subtrees; eval loads ``detector``
    alone. Built on ``device`` (default ``cuda``); with ``seed`` every
    weight is drawn from generators seeded with it, and ``backbone_anc``
    copies the detector's backbone. ``dtype`` is the compute type of the
    detector and ``backbone_anc`` only: JAX builds the image, instance and
    CLUB heads without it (``pa_atf.py:161-166``), so they compute in
    float32 on the bfloat16 maps, pooled features and fc7 they are given."""

    def __init__(self, num_classes: int, cfg: Config, net: str = "vgg16",
                 class_agnostic: bool = False, grl_alpha: float = 0.1, *,
                 club_branch: str = "ancillary", device=None,
                 seed: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if net not in ("vgg16", "vgg16_thin"):
            raise ValueError("PA-ATF ships with the VGG16 backbone")
        if club_branch not in ("ancillary", "main"):
            raise ValueError(f"club_branch {club_branch!r}: 'ancillary' or "
                             f"'main'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.club_branch = club_branch
        self.detector = FasterRCNN(num_classes, cfg, net, class_agnostic,
                                   device=self.device, dtype=dtype)
        self.backbone_anc = VGG16Features(
            width=0.25 if net == "vgg16_thin" else 1.0,
            device=self.device).to(memory_format=torch.channels_last)
        self.backbone_anc.requires_grad_(True)
        set_compute_dtype(self.backbone_anc, dtype)
        taps = self.backbone_anc.tap_channels
        # the heads' conv weights in channels_last, the layout the taps
        # arrive in, so cuDNN converts no weight on a call
        for k, c in zip((3, 4, 5), taps):
            self.add_module(f"img_da{k}", PartialImageDA(
                c, alpha=grl_alpha, device=self.device).to(
                    memory_format=torch.channels_last))
        self.ins_da = InstanceDAL1(self.detector.head_dim, alpha=grl_alpha,
                                   device=self.device)
        for k, c in zip((3, 4, 5), taps):
            self.add_module(f"club{k}", CLUBHead(c, device=self.device).to(
                memory_format=torch.channels_last))
        if seed is not None:
            self.init_weights(seed)
        self.train()

    def _heads(self, prefix):
        return tuple(getattr(self, f"{prefix}{k}") for k in (3, 4, 5))

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """The detector's init from ``seed``, ``backbone_anc`` a copy of its
        backbone, He-normal DA and CLUB heads."""
        self.detector.init_weights(seed)
        self.backbone_anc.load_state_dict(self.detector.backbone.state_dict())
        init_da_heads(self._heads("img_da") + (self.ins_da,)
                      + self._heads("club"), seed + 1, self.device)

    def _image_losses(self, taps, domain):
        loss, masks = 0.0, []
        for head, feat in zip(self._heads("img_da"), taps):
            probs, mask = head(feat)
            label = (domain > 0).float()[:, None, None, None].expand(
                probs.shape)
            loss = loss + binary_cross_entropy(probs, label)
            masks.append(mask)
        return loss, masks

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

        out, m_samples, m_pooled = det.forward_pre_head(
            s_taps[-1], src["im_info"], src["gt_boxes"], training=training,
            rng=rng)
        anc, a_samples, a_pooled = det.forward_pre_head(
            a_taps[-1], src["im_info"], src["gt_boxes"], training=training,
            rng=rng)
        # the target: TEST pre-NMS, TRAIN post-NMS, sampled survivors
        # (pa_atf.py:182-190)
        _, _, t_pooled = det.forward_pre_head(
            t_taps[-1], tgt["im_info"], tgt["gt_boxes"], training=training,
            supervised=False,
            post_nms_top_n=self.cfg.TRAIN.RPN_POST_NMS_TOP_N,
            sample_proposals=training, rng=rng)

        fc7_m, fc7_a, fc7_t = fused_box_head(
            det, (m_pooled, a_pooled, t_pooled), deterministic=deterministic,
            rng=rng)
        out = det.finish_head(out, m_samples, fc7_m)
        anc = det.finish_head(anc, a_samples, fc7_a)
        for k in SUPERVISED_KEYS:
            out[k] = out[k] + anc[k]

        # image DA: ancillary source taps against main target taps; the
        # source masks split the CLUB features
        out["da_img_loss"], masks = self._image_losses(a_taps, src["domain"])
        out["tgt_da_img_loss"], _ = self._image_losses(t_taps,
                                                       tgt["domain"])
        s_ins = self.ins_da(fc7_a, deterministic=deterministic, rng=rng)
        out["da_ins_loss"] = gmean(torch.abs(
            s_ins - (src["domain"] > 0).float()[0]))
        t_ins = self.ins_da(fc7_t, deterministic=deterministic, rng=rng)
        out["tgt_da_ins_loss"] = gmean(torch.abs(
            t_ins - (tgt["domain"] > 0).float()[0]))

        # CLUB on every image's gt boxes, each row with its batch index
        b, g = src["gt_boxes"].shape[:2]
        gt = src["gt_boxes"].reshape(b * g, 5)
        valid = gt[:, 2] > gt[:, 0]
        bidx = torch.arange(b, dtype=gt.dtype, device=gt.device)
        gt_rois = torch.cat([bidx.repeat_interleave(g)[:, None], gt[:, :4]],
                            dim=1)
        club_taps = a_taps if self.club_branch == "ancillary" else s_taps
        pm = torch.zeros((), device=gt.device)
        for club, feat, stride, mask in zip(self._heads("club"), club_taps,
                                            CLUB_STRIDES, masks):
            pooled = roi_pool(feat, gt_rois, out_size=CLUB_POOL,
                              spatial_scale=1.0 / stride)
            mask = mask.detach().repeat_interleave(g, dim=0)   # (R,1,1,C)
            pm = pm + club(pooled * mask, pooled * (1.0 - mask), valid, rng)
        out["pm_loss"] = pm
        return out


def pa_atf_loss(out: Dict[str, Any], lamda: float = 0.1,
                beta: float = 0.1) -> torch.Tensor:
    """det + λ·(img + ins + tgt_img + tgt_ins) + β·pm (``pa_atf.py:255``)."""
    det = (out["rpn_loss_cls"] + out["rpn_loss_box"]
           + out["rcnn_loss_cls"] + out["rcnn_loss_box"])
    return det + lamda * (out["da_img_loss"] + out["da_ins_loss"]
                          + out["tgt_da_img_loss"]
                          + out["tgt_da_ins_loss"]) + beta * out["pm_loss"]
