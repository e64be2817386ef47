"""Gradient reversal layers (``tllod_tpu/ops/grl.py:18-60``; reference
``lib/DAF/DA.py:19-33``, ``lib/MAF/DA.py:34-53``).

Both are the identity forward. :func:`grad_reverse` multiplies the incoming
gradient by ``-alpha``; :func:`weighted_grad_reverse` by ``-weight``
elementwise, with ``weight`` detached.
"""

from __future__ import annotations

import torch


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


class _WeightedGradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(weight)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (weight,) = ctx.saved_tensors
        return -weight * g, None


def grad_reverse(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    """Identity forward; backward multiplies the gradient by ``-alpha``."""
    return _GradReverse.apply(x, alpha)


def weighted_grad_reverse(x: torch.Tensor, weight: torch.Tensor
                          ) -> torch.Tensor:
    """MAF's WGRLayer: backward multiplies the gradient by ``-weight``
    (detached; must broadcast against ``x``)."""
    return _WeightedGradReverse.apply(x, weight.detach())
