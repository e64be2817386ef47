"""The reference optimizers (``tllod_tpu/utils/optim.py:36-202``;
reference ``methods/DAF/DAF_train.py:311-325``, ``lib/model/utils/
net_utils.py:38-49``).

:class:`SGD` applies, in the order of the JAX package's optax chain
(``make_sgd``, ``optim.py:74-112``):

    mask frozen → clip by global norm → + wd·w (trainable, non-bias)
    → momentum (v ← g + μ·v) → × −lr → × 2 on biases → mask frozen

and :class:`Adam` (``--o adam``, ``make_adam``, ``optim.py:115-146``) the
same chain with optax's ``scale_by_adam`` in the momentum's place:

    m ← (1 − b1)·g + b1·m,  n ← (1 − b2)·g² + b2·n,
    u = (m / (1 − b1^t)) / (sqrt(n / (1 − b2^t)) + eps)

with t the update's 1-based number, eps outside the root and the decay
folded into g before the moments (``torch.optim.Adam`` divides by its bias
corrections elsewhere and knows neither the bias group nor the clip).

Both run over two param groups: frozen parameters are in neither, biases
take twice the learning rate and no decay. A trainable parameter with no
gradient (ATF's and PA-ATF's ``backbone_anc`` conv1-2, IDF's
``backbone_b`` conv1-2: JAX's mask keeps them) steps on a zero gradient,
as optax does: decay and momentum move it under SGD, and under Adam the
moments of its pure decay gradient move it by about lr a step. The clip is
optax's ``clip_by_global_norm``: ``(g / ‖g‖) · max`` unless ``‖g‖ < max``,
with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6). Under
``--tp`` a rank holds the shards of the split tensors
(:mod:`tllod_torch.parallel.mesh`) and their optimizer state; the norm
sums a split tensor's squares over the model group, and a replicated
one's once. The moments start at 0, as optax's do. The update is ``torch._foreach_*`` ops
that read the rate (and Adam's bias corrections) from device tensors: they
are host-side functions of the update count, filled in before each update,
so no step waits for the card and a CUDA graph can replay the update
(``update``) with each replay's own values. ``p − (lr·v)`` rounds the
product and then the sum, as optax's scale and ``apply_updates`` do.

``--bf16_momentum`` (``make_sgd(momentum_dtype=bfloat16)``) stores SGD's
trace in bfloat16, as optax 0.2.6's ``trace`` does: v = g + μ·t with
μ·t a bfloat16 product (μ itself rounded to bfloat16, 0.8984375, as JAX
takes a Python scalar in the type of the array it meets) promoted by the
float32 g, the step takes that unrounded v, and v is stored rounded to
bfloat16.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tllod_torch.ops.grl import weak_scalar
from tllod_torch.parallel import dist


def is_bias(name: str) -> bool:
    p = name.replace(".", "/").lower()
    return p.endswith("bias") or p.endswith("/b")


def default_trainable(name: str) -> bool:
    """Frozen-parameter predicate for the stock backbones (``optim.py:
    36``): VGG conv1/conv2, ResNet conv1/bn1/layer1 and every FrozenBN
    entry are frozen. ``name`` is a ``state_dict`` key or a flax path."""
    p = name.replace(".", "/").lower()
    if any(f"backbone/{fp}" in p for fp in ("conv1_", "conv2_")):
        return False
    if "backbone/conv1/" in p or p.endswith("backbone/conv1"):
        return False
    if "backbone/bn1" in p or "backbone/layer1_" in p:
        return False
    if "/bn" in p and (p.endswith("mean") or p.endswith("var")):
        return False
    if ("/bn" in p or "downsample_bn" in p) and (
            p.endswith("scale") or p.endswith("bias")):
        return False
    return True


def epoch_decay_schedule(base_lr: float, steps_per_epoch: int,
                         lr_decay_step: int, gamma: float = 0.1
                         ) -> Callable[[int], float]:
    """lr × gamma at the top of every epoch with ``epoch % (lr_decay_step
    + 1) == 0``, epochs numbered from 1, driven by the update count
    (``optim.py:159``; reference ``DAF_train.py:362-365``)."""
    period = max(int(lr_decay_step) + 1, 1)
    spe = max(int(steps_per_epoch), 1)

    def schedule(count: int) -> float:
        epoch = count // spe + 1
        return base_lr * gamma ** (epoch // period)

    return schedule


class _Chain(torch.optim.Optimizer):
    """The steps the optax chains share: two param groups of the trainable
    named parameters, weights (lr, decay) and biases (``2·lr`` under
    ``double_bias``, no decay unless ``bias_decay``), optax's clip in front,
    and the learning rate set from the update count ``count``.

    :meth:`step` is :meth:`fill_rate`, :meth:`update` and ``count += 1``.
    :meth:`update` changes no host value and allocates only where a
    parameter has no gradient, so a CUDA graph can capture it; the graph's
    runner calls :meth:`fill_rate` before each replay and advances
    ``count`` after it. ``state_dict``/``load_state_dict`` carry each
    per-parameter state in ``STATE`` by parameter name, and the count."""

    STATE: Tuple[str, ...] = ()

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 learning_rate: Callable[[int], float], *,
                 weight_decay: float = 5e-4, double_bias: bool = True,
                 bias_decay: bool = False, clip_norm: Optional[float] = None,
                 trainable: Callable[[str], bool] = default_trainable):
        named = [(n, p) for n, p in named_params
                 if trainable(n) and p.requires_grad]
        groups = [
            {"params": [p for n, p in named if not is_bias(n)],
             "names": [n for n, _ in named if not is_bias(n)],
             "lr_scale": 1.0, "weight_decay": weight_decay},
            {"params": [p for n, p in named if is_bias(n)],
             "names": [n for n, _ in named if is_bias(n)],
             "lr_scale": 2.0 if double_bias else 1.0,
             "weight_decay": weight_decay if bias_decay else 0.0}]
        super().__init__([g for g in groups if g["params"]],
                         {"lr": learning_rate(0)})
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm
        self.weight_decay, self.double_bias = weight_decay, double_bias
        self.count = 0
        # each group's −lr·scale, on its parameters' device
        self.rates = [torch.zeros((), device=g["params"][0].device)
                      for g in self.param_groups]
        # the shards of --tp's split tensors, in the clip's order
        split = [bool(getattr(p, "tp_split", False))
                 for g in self.param_groups for p in g["params"]]
        self.split = (torch.tensor(split, device=self.rates[0].device)
                      if any(split) else None)

    def named_params(self) -> Dict[str, nn.Parameter]:
        return {n: p for g in self.param_groups
                for n, p in zip(g["names"], g["params"])}

    def fill_rate(self) -> None:
        """Set each group's ``lr`` and fill its device rate for update
        ``count``: a fill launch with the value as its argument, no copy
        from the host."""
        lr = self.learning_rate(self.count)
        for g, rate in zip(self.param_groups, self.rates):
            g["lr"] = lr * g["lr_scale"]
            rate.fill_(-g["lr"])

    def grad_norm(self) -> torch.Tensor:
        """The L2 norm of every trained parameter's gradient together:
        optax's ``global_norm``, over JAX's whole sharded tree under
        ``--tp`` (a split tensor's squares summed over the model group,
        once, a replicated one's once)."""
        norms = torch.stack(torch._foreach_norm(
            [p.grad for g in self.param_groups for p in g["params"]]))
        if self.split is None:
            return torch.linalg.vector_norm(norms)
        sq = norms.square()
        shards = dist.all_reduce_(torch.where(self.split, sq, 0.0).sum(),
                                  group="model")
        return torch.sqrt(torch.where(self.split, 0.0, sq).sum() + shards)

    def _decayed_grads(self):
        """Per group (its parameters, their clipped gradients with the
        decay added, its rate): the chain up to the moments."""
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:          # optax decays and carries momentum
                p.grad = torch.zeros_like(p)
        if self.clip_norm is not None:
            grads = [p.grad for p in params]
            norm = self.grad_norm()
            # (g / norm) * max unless norm < max, with no epsilon
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(norm, self.clip_norm)))
        for g, rate in zip(self.param_groups, self.rates):
            ps = g["params"]
            grads = [p.grad for p in ps]
            if g["weight_decay"]:
                grads = torch._foreach_add(grads, ps,
                                           alpha=g["weight_decay"])
            yield ps, grads, rate

    def step(self) -> None:
        self.fill_rate()
        self.update()
        self.count += 1

    def state_dict(self) -> dict:
        named = self.named_params().items()
        return {**{key: {n: self.state[p][key] for n, p in named}
                   for key in self.STATE}, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        params = self.named_params()
        for key in self.STATE:
            if key not in state:
                raise KeyError(f"optimizer state has no {key!r} (saved by "
                               f"another optimizer?)")
            unknown = sorted(set(state[key]) - set(params))
            if unknown:
                raise KeyError(f"optimizer state names parameters this "
                               f"model does not train: {unknown[:5]}")
            missing = [n for n in params if n not in state[key]]
            if missing:
                raise KeyError(f"optimizer state has no {key} for "
                               f"{missing[0]}")
            for n, t in state[key].items():
                buf = self.state[params[n]][key]
                if t.shape != buf.shape:
                    raise ValueError(f"{key} of {n} has shape "
                                     f"{tuple(t.shape)}, the parameter "
                                     f"{tuple(buf.shape)}")
            for n, t in state[key].items():    # in place: a graph reads it
                self.state[params[n]][key].copy_(t)
        self.count = int(state["count"])


class SGD(_Chain):
    """SGD with momentum μ over :class:`_Chain`'s groups: v ← g + μ·v, then
    p ← p − lr·v. ``momentum_dtype`` bfloat16 stores v in bfloat16
    (``--bf16_momentum``). ``state_dict`` carries v as ``trace``."""

    STATE = ("trace",)

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 learning_rate: Callable[[int], float], *,
                 momentum: float = 0.9,
                 momentum_dtype: torch.dtype = torch.float32, **kw):
        super().__init__(named_params, learning_rate, **kw)
        self.momentum = momentum
        self.momentum_dtype = momentum_dtype
        for p in self.named_params().values():
            self.state[p]["trace"] = torch.zeros_like(p, dtype=momentum_dtype)

    @torch.no_grad()
    def update(self) -> None:
        """Clip, decay, momentum and the step, at the rates
        :meth:`fill_rate` left."""
        for ps, grads, rate in self._decayed_grads():
            bufs = [self.state[p]["trace"] for p in ps]
            if self.momentum_dtype == torch.float32:
                torch._foreach_mul_(bufs, self.momentum)
                torch._foreach_add_(bufs, grads)
                torch._foreach_add_(ps, torch._foreach_mul(bufs, rate))
                continue
            # v = g + μ·t in place of g, μ·t a product in the trace's type
            # (JAX takes the weak μ in that type too: 0.8984375)
            torch._foreach_add_(grads, torch._foreach_mul(
                bufs, weak_scalar(self.momentum, self.momentum_dtype)))
            torch._foreach_add_(ps, torch._foreach_mul(grads, rate))
            torch._foreach_copy_(bufs, grads)


class Adam(_Chain):
    """optax's ``scale_by_adam`` (b1, b2, eps outside the root) over
    :class:`_Chain`'s groups. The bias corrections ``1 − b^t`` of update
    ``count`` are float32 device tensors that :meth:`fill_rate` fills, as
    the rate. ``state_dict`` carries the moments as ``mu`` and ``nu``."""

    STATE = ("mu", "nu")

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 learning_rate: Callable[[int], float], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, **kw):
        super().__init__(named_params, learning_rate, **kw)
        self.b1, self.b2, self.eps = b1, b2, eps
        for p in self.named_params().values():
            self.state[p]["mu"] = torch.zeros_like(p)
            self.state[p]["nu"] = torch.zeros_like(p)
        dev = self.rates[0].device
        self.corrections = (torch.ones((), device=dev),
                            torch.ones((), device=dev))

    def fill_rate(self) -> None:
        """The rates, and ``1 − b1^t``, ``1 − b2^t`` for t = ``count`` + 1
        in float32, as optax's ``bias_correction`` takes them."""
        super().fill_rate()
        t = np.float32(self.count + 1)
        for corr, b in zip(self.corrections, (self.b1, self.b2)):
            corr.fill_(float(np.float32(1) - np.float32(b) ** t))

    @torch.no_grad()
    def update(self) -> None:
        """Clip, decay, the moments and the step, at the rates and bias
        corrections :meth:`fill_rate` left."""
        bc1, bc2 = self.corrections
        for ps, grads, rate in self._decayed_grads():
            mus = [self.state[p]["mu"] for p in ps]
            nus = [self.state[p]["nu"] for p in ps]
            torch._foreach_mul_(mus, self.b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - self.b1))
            torch._foreach_mul_(nus, self.b2)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - self.b2))
            den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(den, self.eps)
            u = torch._foreach_div(torch._foreach_div(mus, bc1), den)
            torch._foreach_add_(ps, torch._foreach_mul(u, rate))


def build_optimizer(args, cfg, model: nn.Module, steps_per_epoch: int
                    ) -> Tuple[Callable[[int], float], _Chain]:
    """The train CLIs' factory (``optim.py:179-202``): the repeating LR
    decay, the vgg16-only clip at 10, ``--o sgd`` (with
    ``--bf16_momentum``) or ``--o adam``. Returns ``(schedule, opt)``."""
    schedule = epoch_decay_schedule(args.lr, steps_per_epoch,
                                    args.lr_decay_step, args.lr_decay_gamma)
    common = dict(weight_decay=cfg.TRAIN.WEIGHT_DECAY,
                  double_bias=cfg.TRAIN.DOUBLE_BIAS,
                  bias_decay=cfg.TRAIN.BIAS_DECAY,
                  clip_norm=10.0 if args.net == "vgg16" else None)
    name = getattr(args, "optimizer", "sgd")
    if name == "adam":
        return schedule, Adam(model.named_parameters(), schedule, **common)
    if name != "sgd":
        raise ValueError(f"unknown optimizer {name!r} (expected sgd|adam)")
    return schedule, SGD(
        model.named_parameters(), schedule, momentum=cfg.TRAIN.MOMENTUM,
        momentum_dtype=(torch.bfloat16 if getattr(args, "bf16_momentum",
                                                  False)
                        else torch.float32), **common)
