"""MAD — Multi-view Adversarial Discriminator, domain generalization
(``tllod_tpu/methods/mad.py``; reference ``lib/MAD/``).

No target data: two supervised source views s1 and s2 run the detector
under TRAIN's proposals and sampling. Three view encoders (3×3 convs with
dilation 1, 2 and 3 on the backbone map resized to ``img_size``) and three
instance encoders (MLPs on fc7), each with a decoder whose reconstruction
MSE targets the detached input, a shared LayerNorm per kind and a domain
head, and a view-difference loss that pushes the views apart:
``exp(-Σ pairwise MSE)`` for the image views, ``1/Σ`` for the instance
views; plus the MV consistency between the views' averaged per-RoI sigmoid
and their averaged image-head probability.

The single-view DA terms (``da_img_loss``, ``da_ins_loss``,
``da_cst_loss``) are computed and reported but left out of the loss, as the
reference ships them (``methods/MAD/MAD_train.py:583``): they run under
``no_grad``, so ``img_da`` and ``ins_da`` get no gradient, and ``ins_da``
still draws its dropout masks, in JAX's order. JAX's label quirk is kept:
the image heads take s1 → 0 and s2 → 1, the instance heads s1 → 1 and s2
→ 0.

Where flax and PyTorch differ, the layers are written as flax computes:

  * :class:`BatchStatNorm` normalizes by the batch's population variance,
    ``(x − mean) · rsqrt(var + ε) · γ + β``;
  * stride-2 ``'SAME'`` convs pad asymmetrically, (d − 1, d) on an even
    input (:func:`same_pads`);
  * :class:`ConvTranspose` is ``lax.conv_transpose`` with
    ``transpose_kernel=False``: a conv over the zero-inserted input with
    the kernel unflipped, padded (d + 1, d) at stride 2;
  * :class:`FlaxLayerNorm` is flax's ``nn.LayerNorm``: ε 1e-6, the fast
    variance ``E[x²] − E[x]²`` clipped at 0, ``rsqrt`` times ``scale``
    before it meets ``x − mean``;
  * :func:`bilinear_resize` is ``jax.image.resize(..., "bilinear")``: a
    separable weight matrix per axis, anti-aliased when it shrinks.

The image views run NCHW with ``channels_last`` strides, so the NHWC map
of the backbone goes in without a copy; the parameter layouts follow the
flax tree through :mod:`tllod_torch.zoo` (a ``ConvTranspose`` kernel
(kh, kw, in, out) becomes the weight (out, in, kh, kw), as a conv's).

Total loss (``mad.py:316-326``): det_s1 + det_s2 + epoch·0.12·(0.1·(recon
+ cls) + 0.01·dis + 0.1·cst).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.config import Config
from tllod_torch.device import resolve_device
from tllod_torch.methods.da_modules import (ImageDA, InstanceDA,
                                            features_pair, fused_box_head,
                                            image_da_loss, init_da_heads,
                                            instance_da_loss)
from tllod_torch.models.backbones import dropout
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.ops.grl import grad_reverse
from tllod_torch.ops.losses import binary_cross_entropy
from tllod_torch.parallel import dist
from tllod_torch.parallel.dist import gmean, gsum

IMG_SIZE = (40, 76)   # the fixed upsample target (lib/MAD/faster_rcnn.py:92)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """lax's ``'SAME'`` padding (before, after) of an input of length ``n``
    for an effective kernel ``k`` at stride ``s``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class BatchStatNorm(nn.Module):
    """Normalization by the batch's own statistics over every dimension but
    the channels (dim 1): (B, H, W) for an NCHW map, B for (B, C); learned
    ``scale`` and ``bias``, no running averages (``mad.py:41-56``). Under
    a process group the statistics are the global batch's, the mean and
    then the variance about it as JAX's two passes, each a differentiable
    all-reduce (:func:`tllod_torch.parallel.dist.global_sum`)."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = [0] + list(range(2, x.dim()))
        if dist.active():
            n = x.numel() // x.shape[1] * dist.world()
            mean = dist.global_sum(x.sum(dims, keepdim=True)) / n
            var = dist.global_sum(((x - mean) ** 2).sum(dims,
                                                        keepdim=True)) / n
        else:
            var, mean = torch.var_mean(x, dim=dims, correction=0,
                                       keepdim=True)
        shape = [1, -1] + [1] * (x.dim() - 2)
        return ((x - mean) * torch.rsqrt(var + self.eps)
                * self.scale.view(shape) + self.bias.view(shape))


def same_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built unpadded) with flax's ``'SAME'`` padding: through the
    conv's own padding where it is symmetric, else an explicit ``F.pad``."""
    d, s = conv.dilation[0], conv.stride[0]
    k = d * (conv.kernel_size[0] - 1) + 1
    (top, bottom), (left, right) = (same_pads(n, k, s) for n in x.shape[2:])
    if top == bottom and left == right:
        return F.conv2d(x, conv.weight, conv.bias, s, (top, left), d)
    return conv(F.pad(x, (left, right, top, bottom)))


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` (3×3, ``'SAME'``, no bias, stride 1 or 2):
    a conv over the input with ``stride − 1`` zeros between its pixels and
    the kernel unflipped, the zero-inserted input padded (d, d) at stride 1
    and (d + 1, d) at stride 2 for dilation d
    (``jax/_src/lax/convolution.py::_conv_transpose_padding``). ``weight``
    is (out, in, 3, 3), a conv's layout. Stride 1 is that conv; stride 2
    runs as PyTorch's transposed conv (the gradient of a conv: the kernel
    flipped, as (in, out, 3, 3)), which pads 2d − ``padding`` a side, so
    ``padding`` d − 1 and the extra last row and column cropped."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 dilation: int, device=None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"ConvTranspose: stride {stride}, 1 or 2 only")
        self.stride, self.dilation = stride, dilation
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3,
                                               3, device=device))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dilation
        if self.stride == 1:
            return F.conv2d(x, self.weight, None, 1, d, d)
        y = F.conv_transpose2d(x, self.weight.flip(2, 3).transpose(0, 1),
                               None, 2, d - 1, 0, 1, d)
        return y[:, :, :-1, :-1]


class ImgEncoder(nn.Module):
    """in → 1024 → 512 (s2) → 256 → 128 (s2): bias-free 3×3 convs with
    dilation ``d``, each followed by :class:`BatchStatNorm` and ReLU
    (``mad.py:59-74``). NCHW in and out."""

    PLAN = ((1024, 1), (512, 2), (256, 1), (128, 2))

    def __init__(self, in_channels: int, dilation: int = 1, device=None):
        super().__init__()
        ch = in_channels
        for i, (out, stride) in enumerate(self.PLAN):
            setattr(self, f"conv{i}", nn.Conv2d(
                ch, out, 3, stride, 0, dilation, bias=False, device=device))
            setattr(self, f"bn{i}", BatchStatNorm(out, device=device))
            ch = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.PLAN)):
            x = same_conv(getattr(self, f"conv{i}"), x)
            x = F.relu(getattr(self, f"bn{i}")(x))
        return x


class ImgDecoder(nn.Module):
    """128 → 256 (s2) → 512 → 1024 (s2) → ``out_ch``: bias-free 3×3
    :class:`ConvTranspose` layers with dilation ``d``, BatchStatNorm after
    the first three, ReLU after all four (``mad.py:77-96``)."""

    def __init__(self, dilation: int = 1, out_ch: int = 512, device=None):
        super().__init__()
        self.plan = ((256, 2, True), (512, 1, True), (1024, 2, True),
                     (out_ch, 1, False))
        ch = 128
        for i, (out, stride, bn) in enumerate(self.plan):
            setattr(self, f"deconv{i}", ConvTranspose(ch, out, stride,
                                                      dilation, device))
            if bn:
                setattr(self, f"bn{i}", BatchStatNorm(out, device=device))
            ch = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (_, _, bn) in enumerate(self.plan):
            x = getattr(self, f"deconv{i}")(x)
            if bn:
                x = getattr(self, f"bn{i}")(x)
            x = F.relu(x)
        return x


class InsEncoder(nn.Module):
    """in → 2048 → 1024 → 512, ReLU between (``mad.py:99-107``)."""

    def __init__(self, in_features: int = 4096, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 2048, device=device)
        self.fc2 = nn.Linear(2048, 1024, device=device)
        self.fc3 = nn.Linear(1024, 512, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))


class InsDecoder(nn.Module):
    """512 → 1024 → 2048 → ``out_dim``, ReLU between (``mad.py:110-119``)."""

    def __init__(self, out_dim: int = 4096, device=None):
        super().__init__()
        self.fc1 = nn.Linear(512, 1024, device=device)
        self.fc2 = nn.Linear(1024, 2048, device=device)
        self.fc3 = nn.Linear(2048, out_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(x)))))


class InstanceDAEn(nn.Module):
    """GRL(α) → 512→256 → ReLU → dropout → 256→64 → ReLU → dropout → 64→1
    → sigmoid (``mad.py:122-135``); the masks come from ``rng``."""

    def __init__(self, alpha: float = 0.1, device=None):
        super().__init__()
        self.alpha = alpha
        self.dc_ip1 = nn.Linear(512, 256, device=device)
        self.dc_ip2 = nn.Linear(256, 64, device=device)
        self.classifier = nn.Linear(64, 1, device=device)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                rng=None) -> torch.Tensor:
        x = F.relu(self.dc_ip1(grad_reverse(x, self.alpha)))
        if not deterministic:
            x = dropout(x, 0.5, rng)
        x = F.relu(self.dc_ip2(x))
        if not deterministic:
            x = dropout(x, 0.5, rng)
        return torch.sigmoid(self.classifier(x))


class FlaxLayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the dimensions ``dims``, whose sizes are
    ``shape``, the shape of ``scale`` and ``bias``: ε 1e-6, the variance
    ``max(E[x²] − E[x]², 0)``, and ``(x − mean) · (rsqrt(var + ε) ·
    scale) + bias``."""

    def __init__(self, shape: Sequence[int], dims: Sequence[int],
                 eps: float = 1e-6, device=None):
        super().__init__()
        self.dims, self.eps = tuple(dims), eps
        self.scale = nn.Parameter(torch.ones(tuple(shape), device=device))
        self.bias = nn.Parameter(torch.zeros(tuple(shape), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(self.dims, keepdim=True)
        mean2 = (x * x).mean(self.dims, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


@functools.lru_cache(maxsize=None)
def resize_weights(n_in: int, n_out: int, device: str) -> torch.Tensor:
    """(n_out, n_in) float32 weights of ``jax.image.resize``'s bilinear
    (triangle) kernel along one axis (``jax/_src/image/scale.py::
    compute_weight_mat``): half-pixel centres, the kernel widened by the
    ratio when shrinking, each output's weights renormalized to sum 1."""
    inv = torch.tensor(n_in / n_out, dtype=torch.float32)
    kernel_scale = torch.clamp_min(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp_min(1.0 - x.abs(), 0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).T.contiguous().to(device)


def bilinear_resize(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), "bilinear")`` of an NHWC map:
    the height weights, then the width weights, each one matrix product, in
    the order XLA contracts them. Returns an NHWC-contiguous map."""
    b, h, w, c = x.shape
    oh, ow = size
    dev = str(x.device)
    if oh != h:
        x = torch.matmul(resize_weights(h, oh, dev).to(x.dtype),
                         x.reshape(b, h, w * c))
    if ow != w:
        x = torch.matmul(resize_weights(w, ow, dev).to(x.dtype),
                         x.reshape(b * oh, w, c))
    return x.reshape(b, oh, ow, c)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gmean((a - b) ** 2)


def sym_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(MSE(a, sg(b)) + MSE(b, sg(a))) / 2 (``mad.py:147-150``)."""
    return 0.5 * (mse(a, b.detach()) + mse(b, a.detach()))


def pairwise(fs1: Sequence[torch.Tensor], fs2: Sequence[torch.Tensor]
             ) -> torch.Tensor:
    """Σ over view pairs of both sources' symmetric diffs
    (``MADModel._pairwise``, ``mad.py:240-248``)."""
    total = torch.zeros((), device=fs1[0].device)
    for i in range(3):
        for j in range(i + 1, 3):
            total = total + sym_diff(fs1[i], fs1[j]) \
                + sym_diff(fs2[i], fs2[j])
    return total


def mv_consistency(ins_prob_mean: torch.Tensor, img_score_mean: torch.Tensor,
                   channel: int) -> torch.Tensor:
    """Σ((mean per-RoI sigmoid − detached mean image-head probability on
    ``channel``)²) (``mad.py:153-160``)."""
    target = gmean(F.softmax(img_score_mean.detach(), -1)[..., channel])
    return gsum((ins_prob_mean - target) ** 2)


class MADModel(nn.Module):
    """Detector + MAD's views. Submodules follow the flax param subtrees:
    ``detector``, ``img_da``, ``ins_da``, per view v ∈ {1, 2, 3}
    ``img_enc{v}``, ``img_dec{v}``, ``img_da_en{v}``, ``ins_enc{v}``,
    ``ins_dec{v}``, ``ins_da_en{v}``, and the shared ``ln_img`` (over the
    encoders' (H, W), ``img_size / 4``) and ``ln_ins``. Built on ``device``
    (default ``cuda``); with ``seed`` every weight is drawn from a
    generator seeded with it."""

    def __init__(self, num_classes: int, cfg: Config, net: str = "vgg16",
                 class_agnostic: bool = False, grl_alpha: float = 0.1,
                 img_size: Sequence[int] = IMG_SIZE, *, device=None,
                 seed: Optional[int] = None):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.img_size = tuple(img_size)
        dev = self.device
        self.detector = FasterRCNN(num_classes, cfg, net, class_agnostic,
                                   device=dev)
        feat_ch = self.detector.dout_base_model
        head_dim = self.detector.head_dim
        self.img_da = ImageDA(feat_ch, alpha=grl_alpha, device=dev)
        self.ins_da = InstanceDA(head_dim, alpha=grl_alpha, device=dev)
        for v in (1, 2, 3):
            setattr(self, f"img_enc{v}", ImgEncoder(feat_ch, v, dev).to(
                memory_format=torch.channels_last))
            setattr(self, f"img_dec{v}", ImgDecoder(v, feat_ch, dev))
            setattr(self, f"img_da_en{v}", ImageDA(128, alpha=grl_alpha,
                                                   device=dev))
            setattr(self, f"ins_enc{v}", InsEncoder(head_dim, dev))
            setattr(self, f"ins_dec{v}", InsDecoder(head_dim, dev))
            setattr(self, f"ins_da_en{v}", InstanceDAEn(grl_alpha, dev))
        enc = tuple(-(-n // 4) for n in self.img_size)  # two stride-2 convs
        self.ln_img = FlaxLayerNorm(enc, (2, 3), device=dev)
        self.ln_ins = FlaxLayerNorm((512,), (-1,), device=dev)
        if seed is not None:
            self.init_weights(seed)
        self.train()

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """The detector's init from ``seed``, then He-normal weights with
        zero biases for every conv, transposed conv and fc around it;
        norms at scale 1, bias 0."""
        self.detector.init_weights(seed)
        heads = [m for name, m in self.named_children() if name != "detector"]
        init_da_heads(heads, seed + 1, self.device)
        g = torch.Generator(device=self.device).manual_seed(seed + 2)
        for m in self.modules():
            if isinstance(m, ConvTranspose):
                nn.init.normal_(m.weight, 0.0,
                                math.sqrt(2.0 / m.weight[0].numel()),
                                generator=g)

    def _image_views(self, up: torch.Tensor, domain: torch.Tensor):
        """Per view: encode, decode and reconstruct, LayerNorm, domain
        head, on the NCHW map ``up``. Returns (views, recon, cls, scores)."""
        views, scores = [], []
        recon = cls = torch.zeros((), device=up.device)
        target = up.detach()
        for v in (1, 2, 3):
            enc = getattr(self, f"img_enc{v}")(up)
            dec = getattr(self, f"img_dec{v}")(enc)
            recon = recon + mse(dec, target)
            enc = self.ln_img(enc)
            score = getattr(self, f"img_da_en{v}")(enc.permute(0, 2, 3, 1))
            cls = cls + image_da_loss(score, domain)
            views.append(enc)
            scores.append(score)
        return views, recon, cls, scores

    def _ins_views(self, fc7: torch.Tensor, domain: float,
                   deterministic: bool, rng):
        views, probs = [], []
        recon = cls = torch.zeros((), device=fc7.device)
        target = fc7.detach()
        for v in (1, 2, 3):
            enc = getattr(self, f"ins_enc{v}")(fc7)
            dec = getattr(self, f"ins_dec{v}")(enc)
            recon = recon + mse(dec, target)
            enc = self.ln_ins(enc)
            prob = getattr(self, f"ins_da_en{v}")(
                enc, deterministic=deterministic, rng=rng)
            cls = cls + binary_cross_entropy(prob,
                                             torch.full_like(prob, domain))
            views.append(enc)
            probs.append(prob)
        return views, recon, cls, probs

    def forward(self, s1: Dict[str, Any], s2: Dict[str, Any], *,
                training: bool = True, rng=None) -> Dict[str, Any]:
        """``s1``/``s2``: dicts of device tensors ``im_data`` (B, H, W, 3),
        ``im_info``, ``gt_boxes``, ``domain``; an ``epoch`` (B,) in ``s1``
        comes back as ``out['epoch']``, the weight :func:`mad_loss` ramps
        on. ``rng`` a :class:`tllod_torch.train.StepRandom` when
        ``training``."""
        det = self.detector
        deterministic = not training
        f1, f2 = features_pair(det, s1["im_data"], s2["im_data"])
        out1, samples1, pooled1 = det.forward_pre_head(
            f1, s1["im_info"], s1["gt_boxes"], training=training, rng=rng)
        out2, samples2, pooled2 = det.forward_pre_head(
            f2, s2["im_info"], s2["gt_boxes"], training=training, rng=rng)
        fc7_1, fc7_2 = fused_box_head(det, (pooled1, pooled2),
                                      deterministic=deterministic, rng=rng)
        out1 = det.finish_head(out1, samples1, fc7_1)
        out2 = det.finish_head(out2, samples2, fc7_2)
        out: Dict[str, Any] = {k: out1[k] for k in (
            "rois", "cls_prob", "bbox_pred", "rois_label")}
        for k in ("rpn_loss_cls", "rpn_loss_box", "rcnn_loss_cls",
                  "rcnn_loss_box"):
            out[k] = out1[k] + out2[k]
        if "epoch" in s1:
            out["epoch"] = s1["epoch"][0]

        zero = torch.zeros_like(s1["domain"])
        one = torch.ones_like(s1["domain"])
        with torch.no_grad():        # reported, not in the loss
            score1, score2 = self.img_da(f1), self.img_da(f2)
            ins1 = self.ins_da(fc7_1, deterministic=deterministic, rng=rng)
            ins2 = self.ins_da(fc7_2, deterministic=deterministic, rng=rng)
            out["da_img_loss"] = (image_da_loss(score1, zero)
                                  + image_da_loss(score2, one))
            out["da_ins_loss"] = (
                instance_da_loss(ins1, one, out1["rois"].shape[1])
                + instance_da_loss(ins2, zero, out2["rois"].shape[1]))
            out["da_cst_loss"] = (
                gsum((ins1 - gmean(F.softmax(score1, -1)[..., 1])) ** 2)
                + gsum((ins2 - gmean(F.softmax(score2, -1)[..., 0])) ** 2))

        up1 = bilinear_resize(f1, self.img_size).permute(0, 3, 1, 2)
        up2 = bilinear_resize(f2, self.img_size).permute(0, 3, 1, 2)
        mv1, rec1, cls1, scores1 = self._image_views(up1, zero)
        mv2, rec2, cls2, scores2 = self._image_views(up2, one)
        out["img_mv_recon_loss"] = rec1 + rec2
        out["img_mv_cls_loss"] = cls1 + cls2
        out["img_mv_dis_loss"] = torch.exp(-pairwise(mv1, mv2))

        imv1, irec1, icls1, iprobs1 = self._ins_views(fc7_1, 1.0,
                                                      deterministic, rng)
        imv2, irec2, icls2, iprobs2 = self._ins_views(fc7_2, 0.0,
                                                      deterministic, rng)
        out["ins_mv_recon_loss"] = irec1 + irec2
        out["ins_mv_cls_loss"] = icls1 + icls2
        out["ins_mv_dis_loss"] = 1.0 / (pairwise(imv1, imv2) + 1e-8)

        out["mv_cst_loss"] = (
            mv_consistency(sum(iprobs1) / 3.0, sum(scores1) / 3.0, 1)
            + mv_consistency(sum(iprobs2) / 3.0, sum(scores2) / 3.0, 0))
        return out


def mad_loss(out: Dict[str, Any], epoch) -> torch.Tensor:
    """det_s1+s2 + epoch·0.12·(0.1·(recon+cls) + 0.01·dis + 0.1·cst), the
    shipped 'abl_bl' combination (``mad.py:316-326``); ``epoch`` a number
    or a 0-d tensor."""
    det = (out["rpn_loss_cls"] + out["rpn_loss_box"]
           + out["rcnn_loss_cls"] + out["rcnn_loss_box"])
    img_mv = (0.1 * out["img_mv_recon_loss"] + 0.1 * out["img_mv_cls_loss"]
              + 0.01 * out["img_mv_dis_loss"])
    ins_mv = (0.1 * out["ins_mv_recon_loss"] + 0.1 * out["ins_mv_cls_loss"]
              + 0.01 * out["ins_mv_dis_loss"])
    cst_mv = 0.1 * out["mv_cst_loss"]
    return det + (img_mv + ins_mv + cst_mv) * epoch * 0.12
