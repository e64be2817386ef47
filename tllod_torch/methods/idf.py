"""IDF — Implicit Domain-invariant Feature learning, the dual-branch model
of stage ⑤ of the IDF pipeline (``tllod_tpu/methods/idf.py``; reference
``lib/IDF/``).

Each image runs through two VGG16 branches, split into blocks 1-3, 4 and 5
(``VGG16Features(stage_range=)``): the detector's invariant branch and a
private branch ``backbone_b``. After blocks 4 and 5 each branch is scaled
by the other's domain-attention map (:func:`dam`, on detached features),
and the branches' distances after each block are reported, those after
blocks 4 and 5 (both taken on ``f · att_b``, as JAX does) weighed into
``se_loss`` from the epoch the batch's ``separation`` value turns on.
Per block, a GRL'd discriminator on the invariant branch (``netd_1/2/3``)
and a plain one on the private branch (``netd_*_b``), each a
:class:`NetDConv` with flax's :class:`BatchStatNorm`; an instance
discriminator ``netd_da`` behind a GRL on the box head's rows, trained
with the focal (or E-focal) loss; and an auxiliary detector (``rpn_aux``,
``head_aux``, ``cls_score_aux``, ``bbox_pred_aux``) on the target's
private map, trained on the target's pseudo labels.

The target's invariant branch runs the detector under TRAIN's proposals
and sampling on all-zero gt rows, as the reference zeroes the target's gt
(``IDF_train.py:306-310``): its samples are all background, and only its
head rows reach a loss, through ``netd_da``. Every head pass is its own
call, in JAX's order, so the random draws replay JAX's one for one:
source anchor and proposal targets, its fc6/fc7 masks, ``netd_da``'s two,
the six ``NetDConv`` heads' three each; the same for the target; then the
auxiliary detector's targets and its ``head_aux`` masks. A ``NetDConv``
mask is drawn over the NHWC map, as flax draws it.

:class:`IDFInfer` is ``idf_infer`` (``idf.py:340-351``) as a module that
``eval_engine.detect_chunks`` drives: both branches, then the detector's
RPN and head on the attended invariant map.

Total loss (``idf_loss``, ``IDF_train.py:229-335``): source det + 0.5·aux
det + adversarial + non-adversarial + instance focal + separation.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.config import Config
from tllod_torch.device import resolve_device
from tllod_torch.methods.da_modules import init_da_heads
from tllod_torch.methods.mad import BatchStatNorm
from tllod_torch.models.backbones import VGG16Features, VGG16Head, dropout
from tllod_torch.models.faster_rcnn import FasterRCNN, nhwc_features
from tllod_torch.models.rpn import RPNHead
from tllod_torch.ops.grl import grad_reverse
from tllod_torch.ops.losses import softmax_cross_entropy
from tllod_torch.parallel.dist import gmean

# (lo, hi) blocks of each branch stage: conv1-3, conv4, conv5
STAGES = ((0, 3), (3, 4), (4, 5))
AUX_DIM = 4096        # head_aux is VGG16Head's default width at every net


def dam(feat: torch.Tensor) -> torch.Tensor:
    """Domain-attention map (``idf.py:47-52``) of an NHWC map, detached:
    the channel mean of its sigmoid, zeroed below its own mean over the
    whole batch. (B, H, W, 1)."""
    avg = torch.sigmoid(feat.detach()).mean(dim=-1, keepdim=True)
    return torch.where(avg < gmean(avg), 0.0, avg)


def pairwise_dist(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """The mean over positions of ``‖a − b + ε‖₂`` over the channels (the
    last axis), ``F.pairwise_distance``'s ε in the difference
    (``idf.py:55-59``)."""
    return gmean(torch.sqrt(((a - b + eps) ** 2).sum(dim=-1)))


def focal_loss(logits: torch.Tensor, label: int, gamma: float = 5.0,
               efocal: bool = False) -> torch.Tensor:
    """Focal ``−(1 − p)^γ · log p``, or E-focal ``−exp(−γp) · log p``, of
    the softmax probability of ``label``, meaned over the rows
    (``idf.py:62-68``). ``p`` is clipped to [1e-10, 1] as ``jnp.clip``
    does, max then min, so a ``p`` on a bound passes half its gradient."""
    p = F.softmax(logits.float(), dim=1)[:, label]
    clipped = torch.minimum(torch.maximum(p, torch.full_like(p, 1e-10)),
                            torch.ones_like(p))
    mod = torch.exp(-gamma * p) if efocal else (1.0 - p) ** gamma
    return gmean(-mod * torch.log(clipped))


class NetDConv(nn.Module):
    """A block's domain head (``idf.py:73-92``): per width in ``channels``
    a conv (``kernel`` 1 at stride 1 unpadded, or 3 at ``stride`` padded
    1), :class:`BatchStatNorm`, ReLU and dropout 0.5 on the map; then the
    mean over the map and ``fc`` to 2 logits. Takes an NHWC map and runs
    ``channels_last``; each dropout mask is drawn over the NHWC map."""

    def __init__(self, in_channels: int, channels: Sequence[int],
                 kernel: int = 3, stride: int = 2, device=None):
        super().__init__()
        self.n = len(channels)
        for i, ch in enumerate(channels):
            setattr(self, f"conv{i + 1}", nn.Conv2d(
                in_channels, ch, kernel, stride, 1 if kernel == 3 else 0,
                device=device))
            setattr(self, f"bn{i + 1}", BatchStatNorm(ch, device=device))
            in_channels = ch
        self.fc = nn.Linear(in_channels, 2, device=device)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                rng=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(1, self.n + 1):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
            if not deterministic:
                x = dropout(x.permute(0, 2, 3, 1), 0.5, rng).permute(
                    0, 3, 1, 2)
        return self.fc(x.mean(dim=(2, 3)))


class NetDInstance(nn.Module):
    """The instance domain head ``netd_da`` (``idf.py:95-110``): fc to 100,
    BatchStatNorm, ReLU, dropout; again; fc to 2 logits."""

    def __init__(self, in_features: int = 4096, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 100, device=device)
        self.bn1 = BatchStatNorm(100, device=device)
        self.fc2 = nn.Linear(100, 100, device=device)
        self.bn2 = BatchStatNorm(100, device=device)
        self.fc3 = nn.Linear(100, 2, device=device)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                rng=None) -> torch.Tensor:
        for fc, bn in ((self.fc1, self.bn1), (self.fc2, self.bn2)):
            x = F.relu(bn(fc(x)))
            if not deterministic:
                x = dropout(x, 0.5, rng)
        return self.fc3(x)


class IDFModel(nn.Module):
    """Detector + IDF's private branch and heads. Submodules follow the
    flax param subtrees: ``detector`` (the invariant branch and the shared
    RPN and head), ``backbone_b``, ``netd_1/2/3`` and ``netd_1/2/3_b``,
    ``netd_da``, ``rpn_aux``, ``head_aux``, ``cls_score_aux``,
    ``bbox_pred_aux``. VGG16 only, as in JAX. Built on ``device`` (default
    ``cuda``); with ``seed`` every weight is drawn from generators seeded
    with it.

    ``backbone_b``'s conv1-2 are cut from the graph by the backbone's
    detach and stay in the optimizer: JAX's mask freezes only paths
    holding ``backbone/conv1_`` and ``backbone/conv2_``, so decay and
    momentum move them on a zero gradient, as ATF's ``backbone_anc``.
    Every ``netd_*`` BatchStatNorm ``scale`` and ``bias`` is frozen by the
    same mask (``/bn`` in the path)."""

    def __init__(self, num_classes: int, cfg: Config, net: str = "vgg16",
                 class_agnostic: bool = False, eta: float = 1.0,
                 gamma: float = 5.0, efocal: bool = False, *, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        if net not in ("vgg16", "vgg16_thin"):
            raise ValueError("IDF ships with the VGG16 backbone")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.eta, self.gamma, self.efocal = eta, gamma, efocal
        dev = self.device
        self.detector = FasterRCNN(num_classes, cfg, net, class_agnostic,
                                   device=dev)
        self.backbone_b = VGG16Features(
            width=0.25 if net == "vgg16_thin" else 1.0,
            device=dev).to(memory_format=torch.channels_last)
        self.backbone_b.requires_grad_(True)
        # block 3's heads are 1x1 convs; blocks 4 and 5's 3x3 at stride 2
        plans = zip(self.backbone_b.tap_channels,
                    ((256, 1, 1), (512, 3, 2), (512, 3, 2)))
        for i, (ch, (width, kernel, stride)) in enumerate(plans):
            for suffix in ("", "_b"):
                setattr(self, f"netd_{i + 1}{suffix}", NetDConv(
                    ch, (width, 128, 128), kernel, stride, device=dev).to(
                        memory_format=torch.channels_last))
        det = self.detector
        self.netd_da = NetDInstance(det.head_dim, device=dev)
        self.rpn_aux = RPNHead(det.dout_base_model, det.num_anchors,
                               device=dev).to(
                                   memory_format=torch.channels_last)
        p = cfg.POOLING_SIZE
        self.head_aux = VGG16Head(det.dout_base_model * p * p, AUX_DIM,
                                  device=dev)
        self.cls_score_aux = nn.Linear(AUX_DIM, num_classes, device=dev)
        self.bbox_pred_aux = nn.Linear(
            AUX_DIM, 4 if class_agnostic else 4 * num_classes, device=dev)
        if seed is not None:
            self.init_weights(seed)
        self.train()

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """The detector's init from ``seed``; He-normal ``backbone_b``,
        ``head_aux`` and discriminators with zero biases; the auxiliary
        RPN and ``cls_score_aux`` normal(0, 0.01), ``bbox_pred_aux``
        normal(0, 0.001), as the detector's own; norms at scale 1, bias
        0."""
        self.detector.init_weights(seed)
        heads = [self.backbone_b, self.head_aux, self.netd_da] + [
            getattr(self, f"netd_{i}{s}") for i in (1, 2, 3)
            for s in ("", "_b")]
        init_da_heads(heads, seed + 1, self.device)
        g = torch.Generator(device=self.device).manual_seed(seed + 2)
        for m, std in ((self.rpn_aux.conv, 0.01),
                       (self.rpn_aux.cls_score, 0.01),
                       (self.rpn_aux.bbox_pred, 0.01),
                       (self.cls_score_aux, 0.01),
                       (self.bbox_pred_aux, 0.001)):
            nn.init.normal_(m.weight, 0.0, std, generator=g)
            nn.init.zeros_(m.bias)

    def _dual_branch(self, im_data: torch.Tensor):
        """Both branches on an NHWC image batch with DAM cross-attention
        after blocks 4 and 5 (``idf.py:139-163``). Returns the three NHWC
        maps of each branch and the three branch distances."""
        backbone = self.detector.backbone
        f = f_b = im_data
        feats, feats_b, dists = [], [], []
        for k, stage in enumerate(STAGES):
            f = nhwc_features(backbone, f, stage_range=stage)
            f_b = nhwc_features(self.backbone_b, f_b, stage_range=stage)
            if k == 0:
                dists.append(pairwise_dist(f, f_b))
            else:
                att, att_b = dam(f), dam(f_b)
                dists.append(pairwise_dist(f * att_b, f_b * att_b))
                f, f_b = f * (1.0 + att_b), f_b * (1.0 + att)
            feats.append(f)
            feats_b.append(f_b)
        return feats, feats_b, dists

    def _domains(self, feats, feats_b, deterministic: bool, rng):
        """The block heads: GRL'd on the invariant branch, plain on the
        private one (``idf.py:165-180``)."""
        kw = dict(deterministic=deterministic, rng=rng)
        adv = [getattr(self, f"netd_{i + 1}")(grad_reverse(f, self.eta),
                                              **kw)
               for i, f in enumerate(feats)]
        priv = [getattr(self, f"netd_{i + 1}_b")(f, **kw)
                for i, f in enumerate(feats_b)]
        return adv, priv

    def _aux_tail(self, base_feat_b, im_info, gt_boxes_p, *,
                  training: bool, rng) -> Dict[str, torch.Tensor]:
        """The auxiliary detector on the private map, trained on the
        pseudo labels ``gt_boxes_p`` (``idf.py:182-251``): the detector's
        RPN steps on ``rpn_aux``, RoIAlign on the private map,
        ``head_aux`` and its outputs with the class-specific gather."""
        det = self.detector
        out, samples, pooled = det.forward_pre_head(
            base_feat_b, im_info, gt_boxes_p, training=training, rng=rng,
            rpn_head=self.rpn_aux)
        losses = {k: out[k] for k in ("rpn_loss_cls", "rpn_loss_box",
                                      "rcnn_loss_cls", "rcnn_loss_box")}
        if samples is None:
            return losses
        fc7 = self.head_aux(pooled, deterministic=not training, rng=rng)
        head = det.head_losses(fc7, samples, (
            self.cls_score_aux(fc7).float(), self.bbox_pred_aux(fc7).float()))
        losses.update(rcnn_loss_cls=head["rcnn_loss_cls"],
                      rcnn_loss_box=head["rcnn_loss_box"])
        return losses

    def _domain_ce(self, adv, priv, ins_logits, label: int):
        """0.5 × the CE of each block head, 0.25 × the instance focal loss
        (``idf.py:253-263``)."""
        def labels(x):
            return torch.full((x.shape[0],), label, dtype=torch.long,
                              device=x.device)
        ce = sum(0.5 * softmax_cross_entropy(a, labels(a)) for a in adv)
        na = sum(0.5 * softmax_cross_entropy(p, labels(p)) for p in priv)
        ins = 0.25 * focal_loss(ins_logits, label, self.gamma, self.efocal)
        return ce, na, ins

    def _domain_pass(self, batch, gt_boxes, label: int, training: bool, rng):
        """One domain: both branches, the detector on the invariant map,
        ``netd_da`` on its head rows and the block heads. Returns (the
        detector's out, the private maps, the distances, the CE terms)."""
        feats, feats_b, dists = self._dual_branch(batch["im_data"])
        out = self.detector.forward_from_features(
            feats[2], batch["im_info"], gt_boxes, training=training,
            supervised=training, rng=rng)
        kw = dict(deterministic=not training, rng=rng)
        ins = self.netd_da(grad_reverse(out["pooled_feat"], self.eta), **kw)
        adv, priv = self._domains(feats, feats_b, not training, rng)
        return out, feats_b, dists, self._domain_ce(adv, priv, ins, label)

    def forward(self, src: Dict[str, Any], tgt: Dict[str, Any], *,
                training: bool = True, rng=None) -> Dict[str, Any]:
        """``src``/``tgt``: dicts of device tensors ``im_data`` (B, H, W, 3),
        ``im_info``, ``gt_boxes`` (the target's: its pseudo labels),
        ``domain``; a ``separation`` (B,) in ``src`` gates ``se_loss``
        (its first value; 1 when absent). ``rng`` a
        :class:`tllod_torch.train.StepRandom` when ``training``."""
        sep = src.get("separation")
        sep_w = (1.0 if sep is None else sep.reshape(-1)[0].float())
        out, _, s_d, (s_ce, s_na, s_ins) = self._domain_pass(
            src, src["gt_boxes"], 0, training, rng)
        # the target's primary pass on zeroed gt: its det losses dropped
        _, t_feats_b, t_d, (t_ce, t_na, t_ins) = self._domain_pass(
            tgt, torch.zeros_like(tgt["gt_boxes"]), 1, training, rng)
        aux = self._aux_tail(t_feats_b[2], tgt["im_info"], tgt["gt_boxes"],
                             training=training, rng=rng)
        out.update({f"aux_{k}": v for k, v in aux.items()})
        out.update({
            "adv_loss": s_ce + t_ce,
            "nonadv_loss": s_na + t_na,
            "ins_loss": s_ins + t_ins,
            "se_loss": sep_w * 0.001 * (s_d[1] + s_d[2] + t_d[1] + t_d[2]),
        })
        for k in range(3):
            out[f"dist{k + 1}_s"] = s_d[k]
            out[f"dist{k + 1}_t"] = t_d[k]
        return out


class IDFInfer(nn.Module):
    """``idf_infer`` (``idf.py:340-351``) as a detector module: both
    branches of ``model`` with their attention, then the detector's RPN
    (TEST config) and head on the fused invariant map. ``forward(im_data,
    im_info, gt_boxes=None, training=False)``, ``device``, ``cfg`` and
    ``num_classes``, as ``eval_engine.detect_chunks`` drives a
    :class:`FasterRCNN`."""

    def __init__(self, model: IDFModel):
        super().__init__()
        self.model = model
        self.device = model.device
        self.cfg = model.cfg
        self.num_classes = model.detector.num_classes

    def forward(self, im_data, im_info, gt_boxes=None, *,
                training: bool = False, rng=None) -> Dict[str, Any]:
        if training:
            raise ValueError("IDFInfer is the eval forward; train through "
                             "IDFModel")
        feats, _, _ = self.model._dual_branch(im_data)
        return self.model.detector.forward_from_features(
            feats[2], im_info, gt_boxes, training=False, supervised=False)


def idf_loss(out: Dict[str, Any]) -> torch.Tensor:
    """source det + 0.5·aux (pseudo) det + adversarial + non-adversarial +
    focal instance + separation (``idf.py:354-362``)."""
    det = (out["rpn_loss_cls"] + out["rpn_loss_box"]
           + out["rcnn_loss_cls"] + out["rcnn_loss_box"])
    aux = 0.5 * (out["aux_rpn_loss_cls"] + out["aux_rpn_loss_box"]
                 + out["aux_rcnn_loss_cls"] + out["aux_rcnn_loss_box"])
    return (det + aux + out["adv_loss"] + out["nonadv_loss"]
            + out["ins_loss"] + out["se_loss"])
