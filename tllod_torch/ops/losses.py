"""Detection losses (``tllod_tpu/ops/losses.py:16-68``; reference
``lib/model/utils/net_utils.py:72-86``, ``rpn.py:90-97``).

Mask-based, fixed-shape forms of the reference's loss helpers: where the
reference index-selects the kept entries, these take weighted means over
masks, so a train step never waits on a data-dependent count. All three
compute in float32. Every sum and mean is over the global batch: under a
process group each rank's value is the global batch's, through
:mod:`tllod_torch.parallel.dist` (without one, the plain expression).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tllod_torch.parallel.dist import gmean, gsum


def smooth_l1_loss(pred: torch.Tensor, targets: torch.Tensor,
                   inside_weights: torch.Tensor,
                   outside_weights: torch.Tensor, *, sigma: float = 1.0,
                   reduce_dims: Sequence[int] = (1,)) -> torch.Tensor:
    """outside · SmoothL1(inside · (pred - target)), summed over
    ``reduce_dims`` and meaned over the rest, as the reference's
    ``sum(dim)`` + ``.mean()``."""
    sigma2 = sigma ** 2
    diff = inside_weights * (pred - targets)
    abs_diff = diff.abs()
    flag = (abs_diff < 1.0 / sigma2).to(pred.dtype)
    per_elem = (flag * 0.5 * sigma2 * diff * diff
                + (1.0 - flag) * (abs_diff - 0.5 / sigma2))
    out = outside_weights * per_elem
    for d in sorted(reduce_dims, reverse=True):
        out = out.sum(dim=d)
    return gmean(out)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          weights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean softmax cross-entropy over (N, C) logits and (N,) int labels;
    with (N,) ``weights``, the weighted sum over ``max(Σw, 1)``."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    nll = lse - torch.gather(logits, 1, labels[:, None].long())[:, 0]
    if weights is None:
        return gmean(nll)
    return gsum(nll * weights) / torch.clamp(gsum(weights), min=1.0)


def binary_cross_entropy(probs: torch.Tensor, labels: torch.Tensor,
                         weights: Optional[torch.Tensor] = None,
                         eps: float = 1e-7) -> torch.Tensor:
    """Mean BCE on probabilities clipped to [eps, 1 - eps] (the reference's
    ``nn.BCELoss`` on sigmoid outputs, ``lib/DAF/faster_rcnn.py:188``).
    The clip is ``jnp.clip``'s max-then-min, whose gradient is halved where
    a probability equals a bound (a sigmoid saturates onto 1 - 1e-7 in
    float32); ``torch.clamp`` would pass it whole."""
    p = probs.float()
    p = torch.minimum(torch.maximum(p, torch.full_like(p, eps)),
                      torch.full_like(p, 1.0 - eps))
    loss = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    if weights is None:
        return gmean(loss)
    return gsum(loss * weights) / torch.clamp(gsum(weights), min=1.0)
