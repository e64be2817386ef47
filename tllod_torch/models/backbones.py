"""VGG16 feature extractor and box head (``tllod_tpu/models/backbones.py:
36-94, 238-258``; reference ``lib/model/faster_rcnn/vgg16.py:20-66``).

  * :class:`VGG16Features`: 13 convs with max-pools after blocks 1-4 and
    pool5 dropped, so stride 16 and 512 channels. It runs in
    ``torch.channels_last``: the model hands it the NCHW view of an NHWC
    image batch, and the map it returns is NHWC-contiguous, ready for the
    RoIAlign kernel without a copy.
  * :class:`VGG16Head`: fc6/fc7, flattening the pooled (R, P, P, C) features
    in (C, H, W) order (``backbones.py:87``) so torchvision/caffe state dicts
    apply unchanged; dropout 0.5 only when training.

Parameter names follow the flax tree (``conv1_1`` … ``conv5_3``, ``fc6``,
``fc7``), so :func:`tllod_torch.zoo.from_jax_params` maps one onto the other
name for name. The frozen-block cut of training (``backbones.py:69-70``)
comes with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# torchvision VGG16 conv plan: (out_channels, convs per block)
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16Features(nn.Module):
    """conv1_1 .. conv5_3, maxpools after blocks 1-4 (pool5 dropped)."""

    def __init__(self, width: float = 1.0, device=None):
        super().__init__()
        in_ch = 3
        for bi, (ch, n_convs) in enumerate(_VGG_BLOCKS):
            ch = max(8, int(ch * width))
            for ci in range(n_convs):
                self.add_module(f"conv{bi + 1}_{ci + 1}", nn.Conv2d(
                    in_ch, ch, 3, padding=1, device=device))
                in_ch = ch
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W), NCHW; returns (B, C, H/16, W/16)."""
        for bi, (_, n_convs) in enumerate(_VGG_BLOCKS):
            if bi > 0:
                x = F.max_pool2d(x, 2, 2)
            for ci in range(n_convs):
                x = F.relu(getattr(self, f"conv{bi + 1}_{ci + 1}")(x),
                           inplace=True)
        return x


class VGG16Head(nn.Module):
    """fc6/fc7 over (R, P, P, C) pooled features → (R, dim)."""

    def __init__(self, in_features: int, dim: int = 4096, device=None):
        super().__init__()
        self.fc6 = nn.Linear(in_features, dim, device=device)
        self.fc7 = nn.Linear(dim, dim, device=device)

    def forward(self, pooled: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        r = pooled.shape[0]
        x = pooled.permute(0, 3, 1, 2).reshape(r, -1)    # (R, C*P*P)
        x = F.relu(self.fc6(x))
        x = F.dropout(x, 0.5, training=not deterministic)
        x = F.relu(self.fc7(x))
        return F.dropout(x, 0.5, training=not deterministic)


def backbone_for(net: str, pool_size: int, device=None
                 ) -> Tuple[nn.Module, nn.Module, int, int]:
    """name → (features, head, feature_channels, head_dim).

    ``vgg16_thin`` is the width-0.25 variant (128-channel map, 512-wide
    head) the JAX package's tests use."""
    if net == "vgg16":
        width, dim = 1.0, 4096
    elif net == "vgg16_thin":
        width, dim = 0.25, 512
    else:
        raise ValueError(f"backbone {net!r} is not ported yet "
                         f"(vgg16, vgg16_thin)")
    features = VGG16Features(width=width, device=device)
    ch = features.out_channels
    head = VGG16Head(ch * pool_size * pool_size, dim, device=device)
    return features, head, ch, dim
