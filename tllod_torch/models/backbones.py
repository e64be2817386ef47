"""VGG16 feature extractor and box head (``tllod_tpu/models/backbones.py:
36-94, 238-258``; reference ``lib/model/faster_rcnn/vgg16.py:20-66``).

  * :class:`VGG16Features`: 13 convs with max-pools after blocks 1-4 and
    pool5 dropped, so stride 16 and 512 channels. It runs in
    ``torch.channels_last``: the model hands it the NCHW view of an NHWC
    image batch, and the map it returns is NHWC-contiguous, ready for the
    RoIAlign kernel without a copy.
  * :class:`VGG16Head`: fc6/fc7, flattening the pooled (R, P, P, C) features
    in (C, H, W) order (``backbones.py:87``) so torchvision/caffe state dicts
    apply unchanged; dropout 0.5 only when training. The flatten copies
    nothing when the pooled tensor is the (R, P, P, C) view of an
    (R, C, P, P) one, as the RoIAlign kernel returns it.

Parameter names follow the flax tree (``conv1_1`` … ``conv5_3``, ``fc6``,
``fc7``), so :func:`tllod_torch.zoo.from_jax_params` maps one onto the other
name for name. ``frozen_blocks=2`` freezes conv1-2 as ``backbones.py:69-70``
does: the graph is cut after block 2 and those weights take no gradient.
``return_taps`` gives the c3/c4/c5 maps MAF, ATF and PT-MAF put their image
discriminators on (``backbones.py:71-73``); ``stage_range=(lo, hi)`` runs
conv blocks ``[lo, hi)`` alone, so IDF can attend across its two branches
between blocks (``backbones.py:51-76``).

The ResNet-50/101/152 backbones (``backbones.py:97-227``; reference
``lib/model/faster_rcnn/resnet.py:105-288``), and ``res14``, the JAX
package's test-only variant with one bottleneck a stage:

  * :class:`FrozenBN`: every BatchNorm as the frozen affine
    ``x · scale + (beta − mean · scale)``, ``scale = gamma · rsqrt(var +
    eps)``, its four vectors buffers that no optimizer sees.
  * :class:`ResNetFeatures`: the stem and layer1..layer3, stride 16 and 1024
    channels, in ``channels_last`` like the VGG features. The graph is cut
    after the stem and after layer1: ``backbone_for`` never passes
    ``cfg.RESNET.FIXED_BLOCKS`` (``backbones.py:238-257``), so whatever the
    config says, only the stem and layer1 are frozen, as in JAX.
  * :class:`ResNetHead`: layer4 on the pooled RoIs, then the mean over the
    bins, (R, 2048). It runs in ``channels_last`` like the backbone: it
    copies the RoIAlign kernel's (R, C, P, P) output into (R, P, P, C) order
    once, and the pooled gradient comes back (R, P, P, C)-contiguous, a
    layout the backward kernel reads as it is. Run in the kernel's own NCHW
    order, cuDNN transposed every layer4 convolution's input and output
    instead.

Each Bottleneck's ``conv3`` starts at zero (``init_weights`` of the
detector, as ``kernel_init=zeros`` at ``backbones.py:157-158``): with every
BN frozen, a random-init ResNet-101 otherwise diverges.

On a ``--tp`` rank grid (:func:`tllod_torch.parallel.mesh.parallelize`)
``VGG16Head`` and the ``layer4_*`` bottlenecks hold their rank's shards and
run split (``tp``); under ``--sp`` the feature extractors run on the
rank's rows of the image (``spatial``), each window reading its
neighbours' rows through the halo exchange.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tllod_torch.models.layers import Conv2d, Linear
from tllod_torch.parallel import dist, mesh

# torchvision VGG16 conv plan: (out_channels, convs per block)
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16Features(nn.Module):
    """conv1_1 .. conv5_3, maxpools after blocks 1-4 (pool5 dropped)."""

    def __init__(self, width: float = 1.0, frozen_blocks: int = 2,
                 device=None):
        super().__init__()
        self.frozen_blocks = frozen_blocks
        in_ch = 3
        widths = []
        for bi, (ch, n_convs) in enumerate(_VGG_BLOCKS):
            ch = max(8, int(ch * width))
            widths.append(ch)
            for ci in range(n_convs):
                conv = Conv2d(in_ch, ch, 3, padding=1, device=device)
                conv.requires_grad_(bi >= frozen_blocks)
                self.add_module(f"conv{bi + 1}_{ci + 1}", conv)
                in_ch = ch
        self.out_channels = in_ch
        self.tap_channels = tuple(widths[2:])          # c3, c4, c5

    spatial = False      # --sp: run on this rank's rows (mesh.parallelize)

    def forward(self, x: torch.Tensor, *, return_taps: bool = False,
                stage_range: Tuple[int, int] = (0, 5)):
        """x: (B, 3, H, W), NCHW; returns (B, C, H/16, W/16), or with
        ``return_taps`` the conv3_3, conv4_3 and conv5_3 outputs (c3, c4,
        c5 at strides 4, 8, 16). ``stage_range=(lo, hi)`` runs blocks
        ``[lo, hi)`` on ``x``, the output of block ``lo - 1``: the max-pool
        before each block but the first, the detach after block 2 only
        when block 2 runs, as the JAX module does."""
        if self.spatial:
            return _vgg_spatial(self, x, return_taps, stage_range)
        lo, hi = stage_range
        taps = []
        for bi, (_, n_convs) in enumerate(_VGG_BLOCKS):
            if not lo <= bi < hi:
                continue
            if bi > 0:
                x = F.max_pool2d(x, 2, 2)
            for ci in range(n_convs):
                x = F.relu(getattr(self, f"conv{bi + 1}_{ci + 1}")(x),
                           inplace=True)
            if bi + 1 == self.frozen_blocks:
                x = x.detach()
            if bi >= 2:
                taps.append(x)
        return tuple(taps) if return_taps else x


def _spatial_input(x: torch.Tensor, image: bool) -> None:
    """JAX places an ``--sp`` image under ``P("data", "model")``, which
    needs its height to split evenly over the model axis."""
    n = dist.model_world()
    if image and x.shape[2] % n:
        b, c, h, w = x.shape
        raise ValueError(
            f"--sp: an image sharded on its height over the {n}-way model "
            f"axis should have a height divisible by {n}, but it is equal "
            f"to {h} (full shape: {(b, h, w, c)})")


def _vgg_spatial(net: "VGG16Features", x, return_taps, stage_range):
    """``VGG16Features.forward`` on this rank's rows (``--sp``): each conv
    and pool on its slab with the rows its window reaches from the
    neighbours (:class:`tllod_torch.parallel.mesh.SlabPlan`), the map (or
    each tap) gathered by height at the end."""
    lo, hi = stage_range
    _spatial_input(x, lo == 0)
    plan = mesh.SlabPlan(x.shape[2], 16 >> max(lo - 1, 0))
    level, first, taps = (1, x.shape[2]), True, []
    for bi, (_, n_convs) in enumerate(_VGG_BLOCKS):
        if not lo <= bi < hi:
            continue
        if bi > 0:
            x, level = plan.layer(lambda t: F.max_pool2d(t, 2, 2), x, level,
                                  2, 2, 0, float("-inf"), first)
            first = False
        for ci in range(n_convs):
            conv = getattr(net, f"conv{bi + 1}_{ci + 1}")
            x, level = plan.layer(lambda t: conv(t, padding=(0, 1)), x,
                                  level, 3, 1, 1, 0.0, first)
            first = False
            x = F.relu(x, inplace=True)
        if bi + 1 == net.frozen_blocks:
            x = x.detach()
        if bi >= 2:
            taps.append((x, level))
    if return_taps:
        return tuple(plan.gather(t, lv) for t, lv in taps)
    return plan.gather(x, level)


def dropout(x: torch.Tensor, p: float, rng, cols=None) -> torch.Tensor:
    """Inverted dropout with its keep mask drawn from ``rng`` (a
    :class:`tllod_torch.train.StepRandom`), written as flax's
    ``where(keep, x / (1 - p), 0)``. ``cols=(lo, hi, width)``: ``x`` is
    columns ``[lo, hi)`` of a ``width``-wide tensor (an fc6 shard under
    ``--tp``), whose mask is those columns of the whole tensor's."""
    if cols is None:
        keep = rng.uniform(x.shape) < 1.0 - p
    else:
        lo, hi, width = cols
        keep = rng.uniform(x.shape[:-1] + (width,))[..., lo:hi] < 1.0 - p
    return torch.where(keep, x * (1.0 / (1.0 - p)), 0.0)


def _row_parallel(layer, x: torch.Tensor) -> torch.Tensor:
    """``layer`` (a :class:`Linear` or :class:`Conv2d`), split on its input
    features, on this rank's share ``x`` of them: the partial products
    summed over the model group, then the bias. Below float32 the partial
    products are float32 (the compute type's operands, multiplied
    exactly), summed, and rounded once, as one process's product rounds."""
    dt = layer.compute_dtype
    w = layer.weight.to(dt)
    x = x.to(dt)
    if dt != torch.float32:
        x, w = x.float(), w.float()
    if isinstance(layer, Conv2d):
        y = F.conv2d(x, w, None, layer.stride, layer.padding)
    else:
        y = F.linear(x, w)
    y = mesh.reduce_from_model(y).to(dt)
    if layer.bias is None:
        return y
    b = layer.bias.to(dt)
    return y + (b[:, None, None] if y.dim() == 4 else b)


class VGG16Head(nn.Module):
    """fc6/fc7 over (R, P, P, C) pooled features → (R, dim); dropout 0.5
    after each when ``deterministic`` is False, with masks from ``rng``."""

    def __init__(self, in_features: int, dim: int = 4096, device=None):
        super().__init__()
        self.fc6 = Linear(in_features, dim, device=device)
        self.fc7 = Linear(dim, dim, device=device)

    tp = 1      # --tp: fc6 split on its outputs, fc7 on its inputs

    def forward(self, pooled: torch.Tensor, *, deterministic: bool = True,
                rng=None) -> torch.Tensor:
        """Under ``--tp`` (``mesh.parallelize``) this rank holds fc6's
        output columns ``[lo, hi)`` and fc7's matching input rows: the
        activations stay split through the ReLU and dropout (the mask the
        columns of the whole draw), fc7's partial products are summed over
        the model group and its bias added once, with no gather."""
        r = pooled.shape[0]
        x = pooled.permute(0, 3, 1, 2).reshape(r, -1)    # (R, C*P*P)
        cols = None
        if self.tp > 1:
            x = mesh.copy_to_model(x)
        x = F.relu(self.fc6(x))
        if self.tp > 1:
            n = x.shape[1]
            lo = dist.model_rank() * n
            cols = (lo, lo + n, n * self.tp)
        if not deterministic:
            x = dropout(x, 0.5, rng, cols)
        x = F.relu(_row_parallel(self.fc7, x) if self.tp > 1
                   else self.fc7(x))
        if not deterministic:
            x = dropout(x, 0.5, rng)
        return x


class FrozenBN(nn.Module):
    """BatchNorm frozen to an affine map, over dim 1 of an NCHW tensor
    (``backbones.py:97-122``). ``scale``, ``bias``, ``mean`` and ``var``
    (gamma, beta and the running statistics) are buffers, at (1, 0, 0, 1)
    until weights are loaded. The expression is JAX's, op for op: at
    bfloat16 the input is promoted by the float32 scale and shift, and the
    float32 result rounded back once (``backbones.py:120-121``)."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        for name, fill in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0),
                           ("var", 1.0)):
            self.register_buffer(name, torch.full((features,), fill,
                                                  device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.scale * torch.rsqrt(self.var + self.eps)
        shift = self.bias - self.mean * scale
        return (x * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (the stride) → 1x1 ×4, each behind a FrozenBN, plus the
    residual, a 1x1 conv with the stride behind ``downsample_bn`` when
    ``downsample`` (``backbones.py:124-170``). flax's ``SAME`` never pads a
    1x1 stride-2 conv, so ``padding=0`` gives its size at odd inputs too."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, device=None):
        super().__init__()
        kw = dict(bias=False, device=device)
        self.conv1 = Conv2d(in_ch, planes, 1, **kw)
        self.bn1 = FrozenBN(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, **kw)
        self.bn2 = FrozenBN(planes, device=device)
        self.conv3 = Conv2d(planes, planes * 4, 1, **kw)
        self.bn3 = FrozenBN(planes * 4, device=device)
        if downsample:
            self.downsample_conv = Conv2d(in_ch, planes * 4, 1, stride,
                                             **kw)
            self.downsample_bn = FrozenBN(planes * 4, device=device)
        self.downsample = downsample

    tp = 1      # --tp in layer4: split on the channels (mesh.parallelize)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Under ``--tp`` this rank holds ``planes / tp`` of conv1's and
        4 ``planes / tp`` of conv3's and downsample_conv's output channels
        (their FrozenBNs to match) and conv2's matching input channels:
        conv2's partial products are summed over the model group before
        bn2, the residual add stays split (an identity residual takes this
        rank's channels), and the block's output is gathered whole."""
        if self.tp > 1:
            x = mesh.copy_to_model(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = _row_parallel(self.conv2, y) if self.tp > 1 else self.conv2(y)
        y = F.relu(self.bn2(y))
        y = self.bn3(self.conv3(mesh.copy_to_model(y) if self.tp > 1
                                else y))
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        elif self.tp > 1:
            n = y.shape[1]
            residual = x[:, dist.model_rank() * n:(dist.model_rank() + 1)
                         * n]
        else:
            residual = x
        out = F.relu(y + residual)
        return mesh.gather_from_model(out, 1) if self.tp > 1 else out

    def forward_rows(self, x: torch.Tensor, plan, level):
        """:meth:`forward` on a slab of rows at ``level`` (``--sp``):
        the 3x3 conv2 and the strided downsample through ``plan``."""
        y = F.relu(self.bn1(self.conv1(x)))
        s = self.conv2.stride[0]
        y, out_level = plan.layer(lambda t: self.conv2(t, padding=(0, 1)),
                                  y, level, 3, s, 1, 0.0)
        y = self.bn3(self.conv3(F.relu(self.bn2(y))))
        residual = x
        if self.downsample:
            residual, _ = plan.layer(self.downsample_conv, x, level, 1, s,
                                     0, 0.0)
            residual = self.downsample_bn(residual)
        return F.relu(y + residual), out_level


# bottlenecks per stage (reference resnet.py:186-218); 14 is the JAX
# package's test-only variant, one a stage
RESNET_STAGES = {14: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                 152: (3, 8, 36, 3)}


def _stage(module: nn.Module, stage: int, in_ch: int, planes: int,
           blocks: int, stride: int, device) -> int:
    """Add ``layer<stage>_0 ..`` to ``module``; returns the width out."""
    for blk in range(blocks):
        module.add_module(f"layer{stage}_{blk}", Bottleneck(
            in_ch, planes, stride if blk == 0 else 1, blk == 0,
            device=device))
        in_ch = planes * 4
    return in_ch


class ResNetFeatures(nn.Module):
    """conv1, bn1, ReLU, 3x3 stride-2 max pool, then layer1..layer3 → (B,
    1024, H/16, W/16) (``backbones.py:177-210``). The stem and the stages
    up to ``fixed_blocks`` are frozen: the graph is cut after each, and
    their weights take no gradient."""

    def __init__(self, depth: int = 101, fixed_blocks: int = 1, device=None):
        super().__init__()
        self.fixed_blocks = fixed_blocks
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = FrozenBN(64, device=device)
        self.conv1.requires_grad_(False)
        ch = 64
        for s, planes in enumerate((64, 128, 256)):
            ch = _stage(self, s + 1, ch, planes, RESNET_STAGES[depth][s],
                        1 if s == 0 else 2, device)
            if s + 1 <= fixed_blocks:
                for blk in range(RESNET_STAGES[depth][s]):
                    getattr(self, f"layer{s + 1}_{blk}").requires_grad_(False)
        self.out_channels = ch
        self.stages = RESNET_STAGES[depth][:3]
        self.tap_channels = (256, 512, 1024)          # layer1..layer3

    spatial = False      # --sp: run on this rank's rows (mesh.parallelize)

    def forward(self, x: torch.Tensor, *, return_taps: bool = False):
        """x: (B, 3, H, W); returns the layer3 map, or with ``return_taps``
        the layer1, layer2 and layer3 maps (strides 4, 8, 16)."""
        if self.spatial:
            return self._forward_rows(x, return_taps)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1).detach()       # the stem is frozen
        taps = []
        for s, blocks in enumerate(self.stages):
            for blk in range(blocks):
                x = getattr(self, f"layer{s + 1}_{blk}")(x)
            if s + 1 <= self.fixed_blocks:
                x = x.detach()
            taps.append(x)
        return tuple(taps) if return_taps else x


    def _forward_rows(self, x: torch.Tensor, return_taps: bool):
        """:meth:`forward` on this rank's rows of the image (``--sp``): the
        7x7 stride-2 stem reads 3 rows above its slab and 2 below, the
        3x3 stride-2 max pool one above, filled with -inf past the image;
        the map (or each tap) is gathered by height at the end."""
        _spatial_input(x, True)
        plan = mesh.SlabPlan(x.shape[2], 16)
        x, level = plan.layer(lambda t: self.conv1(t, padding=(0, 3)), x,
                              (1, x.shape[2]), 7, 2, 3, 0.0, first=True)
        x = F.relu(self.bn1(x))
        x, level = plan.layer(lambda t: F.max_pool2d(t, 3, 2, (0, 1)), x,
                              level, 3, 2, 1, float("-inf"))
        x = x.detach()                               # the stem is frozen
        taps = []
        for s, blocks in enumerate(self.stages):
            for blk in range(blocks):
                x, level = getattr(self, f"layer{s + 1}_{blk}").forward_rows(
                    x, plan, level)
            if s + 1 <= self.fixed_blocks:
                x = x.detach()
            taps.append((x, level))
        if return_taps:
            return tuple(plan.gather(t, lv) for t, lv in taps)
        return plan.gather(x, level)


class ResNetHead(nn.Module):
    """layer4 on the pooled (R, P, P, C) RoIs, then the mean over the bins →
    (R, 2048) (``backbones.py:213-227``), in ``channels_last`` (the detector
    converts its weights): the pooled tensor is made (R, P, P, C)-contiguous
    first, a copy when it is the kernel's (R, C, P, P) view. No dropout:
    ``deterministic`` and ``rng`` are taken and unused, as ``VGG16Head``
    takes them."""

    def __init__(self, depth: int = 101, in_ch: int = 1024, device=None):
        super().__init__()
        self.blocks = RESNET_STAGES[depth][3]
        _stage(self, 4, in_ch, 512, self.blocks, 2, device)

    def forward(self, pooled: torch.Tensor, *, deterministic: bool = True,
                rng=None) -> torch.Tensor:
        del deterministic, rng
        x = pooled.contiguous().permute(0, 3, 1, 2)   # NCHW, channels_last
        for blk in range(self.blocks):
            x = getattr(self, f"layer4_{blk}")(x)
        return x.mean(dim=(2, 3))


def backbone_dims(net: str) -> Tuple[int, int]:
    """(feature_channels, head_dim) of a backbone name
    (``backbones.py:230-235``)."""
    return {"vgg16": (512, 4096), "vgg16_thin": (128, 512),
            "res14": (1024, 2048), "res50": (1024, 2048),
            "res101": (1024, 2048), "res152": (1024, 2048)}[net]


def backbone_for(net: str, pool_size: int, device=None
                 ) -> Tuple[nn.Module, nn.Module, int, int]:
    """name → (features, head, feature_channels, head_dim).

    ``vgg16_thin`` is the width-0.25 variant (128-channel map, 512-wide
    head) the JAX package's tests use; ``res14`` the ResNet one (one
    bottleneck a stage, full widths)."""
    if net not in ("vgg16", "vgg16_thin", "res14", "res50", "res101",
                   "res152"):
        raise ValueError(f"unknown backbone {net!r}")
    ch, dim = backbone_dims(net)
    if net.startswith("res"):
        depth = int(net[3:])
        return (ResNetFeatures(depth, device=device),
                ResNetHead(depth, ch, device=device), ch, dim)
    features = VGG16Features(width=1.0 if net == "vgg16" else 0.25,
                             device=device)
    head = VGG16Head(ch * pool_size * pool_size, dim, device=device)
    return features, head, ch, dim
