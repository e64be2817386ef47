"""The reference SGD (``tllod_tpu/utils/optim.py:36-202``; reference
``methods/DAF/DAF_train.py:311-325``, ``lib/model/utils/net_utils.py:
38-49``).

:class:`SGD` applies, in the order of the JAX package's optax chain
(``make_sgd``, ``optim.py:74-112``):

    mask frozen → clip by global norm → + wd·w (trainable, non-bias)
    → momentum (v ← g + μ·v) → × −lr → × 2 on biases → mask frozen

over two param groups: frozen parameters are in neither, biases take twice
the learning rate and no decay. The clip is optax's
``clip_by_global_norm``: ``(g / ‖g‖) · max`` unless ``‖g‖ < max``, with no
epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6). The momentum starts
at 0, as optax's trace does, so the first step sets it to g. The update is
``torch._foreach_*`` ops that read the rate from a device tensor: the
learning rate is a host-side function of the update count, filled into that
tensor before each update, so no step waits for the card and a CUDA graph
can replay the update (:meth:`SGD.update`) with each replay's own rate.
``p − (lr·v)`` rounds the product and then the sum, as optax's scale and
``apply_updates`` do. ``--o adam`` and ``--bf16_momentum`` are not ported
yet and raise.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn


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


class SGD(torch.optim.Optimizer):
    """SGD over the trainable named parameters of a module in two groups,
    weights (lr, decay) and biases (``2·lr`` under ``double_bias``, no
    decay unless ``bias_decay``), with optax's clip in front and the
    learning rate set from the update count ``count``.

    :meth:`step` is :meth:`fill_rate`, :meth:`update` and ``count += 1``.
    :meth:`update` changes no host value and allocates only where a
    parameter has no gradient, so a CUDA graph can capture it; the graph's
    runner calls :meth:`fill_rate` before each replay and advances
    ``count`` after it. ``state_dict``/``load_state_dict`` carry the
    momentum buffers by parameter name, and the count."""

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 learning_rate: Callable[[int], float], *,
                 momentum: float = 0.9, weight_decay: float = 5e-4,
                 double_bias: bool = True, bias_decay: bool = False,
                 clip_norm: Optional[float] = None,
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
        self.momentum = momentum
        self.clip_norm = clip_norm
        self.count = 0
        for p in self.named_params().values():
            self.state[p]["momentum_buffer"] = torch.zeros_like(p)
        # each group's −lr·scale, on its parameters' device
        self.rates = [torch.zeros((), device=g["params"][0].device)
                      for g in self.param_groups]

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

    @torch.no_grad()
    def update(self) -> None:
        """Clip, decay, momentum and the step, at the rates
        :meth:`fill_rate` left."""
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:          # optax decays and carries momentum
                p.grad = torch.zeros_like(p)
        if self.clip_norm is not None:
            grads = [p.grad for p in params]
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            # (g / norm) * max unless norm < max, with no epsilon
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(norm, self.clip_norm)))
        for g, rate in zip(self.param_groups, self.rates):
            ps = g["params"]
            grads = [p.grad for p in ps]
            bufs = [self.state[p]["momentum_buffer"] for p in ps]
            if g["weight_decay"]:
                grads = torch._foreach_add(grads, ps,
                                           alpha=g["weight_decay"])
            torch._foreach_mul_(bufs, self.momentum)
            torch._foreach_add_(bufs, grads)
            torch._foreach_add_(ps, torch._foreach_mul(bufs, rate))

    def step(self) -> None:
        self.fill_rate()
        self.update()
        self.count += 1

    def state_dict(self) -> dict:
        return {"trace": {n: self.state[p]["momentum_buffer"]
                          for n, p in self.named_params().items()
                          if "momentum_buffer" in self.state[p]},
                "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        params = self.named_params()
        unknown = sorted(set(state["trace"]) - set(params))
        if unknown:
            raise KeyError(f"optimizer state names parameters this model "
                           f"does not train: {unknown[:5]}")
        for n, t in state["trace"].items():    # in place: a graph reads it
            self.state[params[n]]["momentum_buffer"].copy_(t)
        self.count = int(state["count"])


def build_optimizer(args, cfg, model: nn.Module, steps_per_epoch: int
                    ) -> Tuple[Callable[[int], float], SGD]:
    """The train CLIs' factory (``optim.py:179``): the repeating LR decay,
    the vgg16-only clip at 10, ``--o sgd``. Returns ``(schedule, opt)``."""
    if getattr(args, "optimizer", "sgd") != "sgd":
        raise NotImplementedError(f"--o {args.optimizer} is not ported yet "
                                  f"(sgd only)")
    if getattr(args, "bf16_momentum", False):
        raise NotImplementedError("--bf16_momentum is not ported yet")
    schedule = epoch_decay_schedule(args.lr, steps_per_epoch,
                                    args.lr_decay_step, args.lr_decay_gamma)
    opt = SGD(model.named_parameters(), schedule,
              momentum=cfg.TRAIN.MOMENTUM,
              weight_decay=cfg.TRAIN.WEIGHT_DECAY,
              double_bias=cfg.TRAIN.DOUBLE_BIAS,
              bias_decay=cfg.TRAIN.BIAS_DECAY,
              clip_norm=10.0 if args.net == "vgg16" else None)
    return schedule, opt
