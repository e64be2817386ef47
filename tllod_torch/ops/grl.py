"""Gradient reversal layers (``tllod_tpu/ops/grl.py:18-60``; reference
``lib/DAF/DA.py:19-33``, ``lib/MAF/DA.py:34-53``).

Both are the identity forward. :func:`grad_reverse` multiplies the incoming
gradient by ``-alpha`` taken in the input's type, as JAX's
``jnp.asarray(alpha, x.dtype)`` (``grl.py:37``): at bfloat16, α = 0.1 is
0.10009765625 and the product a bfloat16 product.
:func:`weighted_grad_reverse` multiplies it by ``-weight`` elementwise, with
``weight`` detached.
"""

from __future__ import annotations

import torch


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """A Python number as JAX takes it against an array of ``dtype``: a
    weak type, rounded to ``dtype`` (0.1 against bfloat16 is
    0.10009765625). PyTorch would compute in float32 with the number
    unrounded; multiplying by this value gives JAX's product."""
    return float(torch.tensor(value, dtype=dtype))


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        alpha = ctx.alpha
        alpha = (alpha.to(g.dtype) if isinstance(alpha, torch.Tensor)
                 else weak_scalar(alpha, g.dtype))
        return -alpha * g, None


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
    """Identity forward; backward multiplies the gradient by ``-alpha``, in
    ``x``'s type."""
    return _GradReverse.apply(x, alpha)


def weighted_grad_reverse(x: torch.Tensor, weight: torch.Tensor
                          ) -> torch.Tensor:
    """MAF's WGRLayer: backward multiplies the gradient by ``-weight``
    (detached; must broadcast against ``x``)."""
    return _WeightedGradReverse.apply(x, weight.detach())
