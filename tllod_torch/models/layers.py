"""Convolution and fully connected layers with a compute type, as flax's
``nn.Conv``/``nn.Dense`` with ``dtype=`` (the JAX package's ``--bf16``,
``methods/da_runner.py:75-76``).

The parameters stay float32. Each call casts its input, its weight and its
bias to ``compute_dtype`` and returns a tensor of that type, so a bfloat16
layer's gradient reaches its float32 weight through the cast. Below float32
the bias is added as flax adds it, after the product is rounded to the
compute type (``y = conv(x, w); y += b``: two roundings), not fused into
the product's epilogue; at float32 the two are the same and the bias stays
fused. What runs
between the layers (ReLU, max pool, dropout) runs in the type it is given,
as in JAX. A layer at float32 casts a bfloat16 input up, as flax does for a
head built without ``dtype`` behind a bfloat16 one (PA-ATF's heads,
``tllod_tpu/methods/pa_atf.py:161-166``). At float32 with a float32 input
every cast is the tensor itself: no copy, no launch.

:func:`set_compute_dtype` sets the type of every such layer under a module;
the models call it where JAX passes its ``dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``padding`` of a call, where given, takes the layer's place (a slab
    of rows padded already on the height axis, :mod:`tllod_torch.parallel.
    mesh`)."""
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor, padding=None) -> torch.Tensor:
        dt = self.compute_dtype
        pad = self.padding if padding is None else padding

        def conv(x, w, b):
            return F.conv2d(x, w, b, self.stride, pad, self.dilation,
                            self.groups)
        if dt == torch.float32 or self.bias is None:
            bias = None if self.bias is None else self.bias.to(dt)
            return conv(x.to(dt), self.weight.to(dt), bias)
        y = conv(x.to(dt), self.weight.to(dt), None)
        return y + self.bias.to(dt)[:, None, None]


class Linear(nn.Linear):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32 or self.bias is None:
            bias = None if self.bias is None else self.bias.to(dt)
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every :class:`Conv2d` and :class:`Linear` under ``module`` computes
    in ``dtype`` (float32 or bfloat16); returns ``module``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.compute_dtype = dtype
    return module
