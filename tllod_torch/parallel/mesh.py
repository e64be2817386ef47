"""Tensor and spatial parallelism over the ``(data, model)`` rank grid
(``tllod_tpu/parallel/mesh.py:32-135``; ``methods/common.py:423-461``).

JAX places the parameters on a 2-D mesh under path-suffix rules and lets
GSPMD insert the collectives. Here each rank of a model group
(:func:`tllod_torch.parallel.dist.make_grid`) holds its shard of the split
tensors, and the collectives are written out:

- :func:`tp_split_names`: which ``state_dict`` entries are split and on
  which dim, by JAX's rules: every ``fc6`` (output features) and ``fc7``
  (input features) in the tree, and in every ``layer4_*`` bottleneck
  ``conv1``, ``conv3``, ``downsample_conv`` (output channels), ``conv2``
  (input channels) and the FrozenBN vectors of ``bn1``, ``bn3`` and
  ``downsample_bn``. The rest is replicated.
- :func:`parallelize` cuts a model that holds full tensors down to this
  rank's shards and marks the modules that run split
  (:mod:`tllod_torch.models.backbones`); with ``sp`` every VGG16 and
  ResNet feature extractor runs on this rank's rows of the image.
- :func:`gather_state_dict` / :func:`shard_state_dict` (and
  :func:`gather_named` / :func:`shard_named` for the optimizer's state)
  turn shards into full tensors under the full names and back, so a
  checkpoint written at any ``--tp`` reads at any other.
- The autograd collectives over the model axis: :func:`copy_to_model`
  (identity forward, all-reduce backward: before a layer split on its
  output), :func:`reduce_from_model` (all-reduce forward, identity
  backward: after a layer split on its input), :func:`gather_from_model`
  (all-gather forward, this rank's slice backward: before replicated
  work) and :func:`halo_rows` (the rows of a map that a window reaches
  across a slab boundary, with their gradients sent back to their owners
  and added).
- :class:`SlabPlan`: the rows each rank owns at every level of a
  backbone, cut at multiples of the backbone stride (16 rows of the image)
  with the last slab taking the remainder, so no 2x2 pool window and no
  stride-2 window crosses a slab except through the halo.

Every gradient reduction over the grid is :func:`tllod_torch.parallel.dist.
reduce_gradients`'s; it reads the marks :func:`parallelize` leaves on the
parameters (``tp_split``, ``sp_partial``).
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from tllod_torch.parallel import dist

SPLIT = "tp_split"          # a parameter this rank holds a shard of
PARTIAL = "sp_partial"      # a backbone weight whose gradient is partial

# (name suffix, torch dim): JAX's _TP_RULES on torch layouts (Linear weight
# (out, in), conv weight (out, in, kh, kw))
_TP_RULES = (
    (("fc6", "weight"), 0),
    (("fc6", "bias"), 0),
    (("fc7", "weight"), 1),
)
# JAX's _TP_RESNET_HEAD_RULES, applied under a ``layer4_*`` module
_TP_RESNET_HEAD_RULES = (
    (("conv1", "weight"), 0),
    (("conv2", "weight"), 1),
    (("conv3", "weight"), 0),
    (("downsample_conv", "weight"), 0),
    (("bn1",), 0),
    (("bn3",), 0),
    (("downsample_bn",), 0),
)

_BLOCK_SPLIT = {suffix[0] for suffix, _ in _TP_RESNET_HEAD_RULES}

# what the last backbone call and parallelize saw, for measurement
stats = {"first_rows": None, "split_bytes": 0}


def tp_split_names(model: nn.Module) -> Dict[str, int]:
    """``{state_dict name: dim}`` of the tensors ``--tp`` splits, by the
    path-suffix rules of ``tp_param_shardings`` (``mesh.py:96-135``);
    warns as JAX does when nothing matches."""
    out = {}
    for name in model.state_dict():
        keys = tuple(name.split("."))
        dim = next((d for suffix, d in _TP_RULES
                    if keys[-len(suffix):] == suffix), None)
        if dim is None and any(k.startswith("layer4_") for k in keys):
            dim = next((d for suffix, d in _TP_RESNET_HEAD_RULES
                        if keys[-len(suffix) - 1:-1] == suffix
                        or keys[-len(suffix):] == suffix), None)
        if dim is not None:
            out[name] = dim
    if not out:
        warnings.warn(
            "tp_split_names: no parameter matched the tensor-parallel "
            "rules (fc6/fc7 or layer4 bottlenecks) — nothing to split; "
            "--tp will only replicate. Use pure data parallelism (--mGPUs) "
            "instead.", stacklevel=2)
    return out


def _lookup(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    mod_name, _, leaf = name.rpartition(".")
    return model.get_submodule(mod_name), leaf


def _shard(t: torch.Tensor, dim: int) -> torch.Tensor:
    n = dist.model_world()
    if t.shape[dim] % n:
        raise ValueError(f"a {tuple(t.shape)} tensor does not split "
                         f"{n} ways on dim {dim}")
    size = t.shape[dim] // n
    part = t.narrow(dim, dist.model_rank() * size, size)
    fmt = (torch.channels_last if t.dim() == 4 and not t.is_contiguous()
           and t.is_contiguous(memory_format=torch.channels_last)
           else torch.contiguous_format)
    return part.clone(memory_format=fmt)


def parallelize(model: nn.Module, sp: bool = False) -> nn.Module:
    """Cut ``model``, which holds full tensors, to this rank's shards on
    the grid's model axis (``setup_parallelism``'s ``device_put`` under
    ``tp_param_shardings``), and with ``sp`` run its feature extractors on
    this rank's rows. Call it before the optimizer is built. Identity
    without a grid."""
    from tllod_torch.models.backbones import (Bottleneck, ResNetFeatures,
                                              VGG16Features, VGG16Head)

    tp = dist.model_world()
    if tp == 1:
        return model
    split = tp_split_names(model)
    handled = set()
    for name, m in model.named_modules():
        prefix = name + "." if name else ""
        if isinstance(m, VGG16Head):
            m.tp = tp
            handled |= {prefix + k for k in ("fc6.weight", "fc6.bias",
                                             "fc7.weight")}
        elif isinstance(m, Bottleneck) and \
                name.rpartition(".")[2].startswith("layer4_"):
            m.tp = tp
            handled |= {prefix + k for k in m.state_dict()
                        if k.split(".")[0] in _BLOCK_SPLIT}
        elif sp and isinstance(m, (VGG16Features, ResNetFeatures)):
            m.spatial = True
            for p in m.parameters():
                setattr(p, PARTIAL, True)
    unknown = sorted(set(split) - handled)
    if unknown:
        raise NotImplementedError(f"--tp splits {unknown[:3]}, which no "
                                  f"split module of the port computes")
    nbytes = 0
    with torch.no_grad():
        for name, dim in split.items():
            mod, leaf = _lookup(model, name)
            part = _shard(getattr(mod, leaf), dim)
            if leaf in mod._parameters:
                p = mod._parameters[leaf]
                p.data = part
                setattr(p, SPLIT, True)
            else:
                mod._buffers[leaf] = part
            nbytes += part.numel() * part.element_size()
    model.tp_split_dims = split
    stats["split_bytes"] = nbytes
    return model


def split_dims(model: nn.Module) -> Dict[str, int]:
    """``{name: dim}`` of the tensors ``model`` holds in shards (none
    unless :func:`parallelize` cut it)."""
    return getattr(model, "tp_split_dims", {})


def gather_tensor(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The full tensor of the model group's equal shards ``t`` on
    ``dim`` (outside autograd)."""
    n, r = dist.model_world(), dist.model_rank()
    size = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = size * n
    with torch.no_grad():
        full = t.new_zeros(shape)
        full.narrow(dim, r * size, size).copy_(t)
        return dist.all_reduce_(full, group="model")


def gather_named(tensors: Dict[str, torch.Tensor], dims: Dict[str, int]
                 ) -> Dict[str, torch.Tensor]:
    """``tensors`` with each entry named in ``dims`` gathered to its full
    tensor; every rank of the model group calls it."""
    return {k: gather_tensor(v, dims[k]) if k in dims else v
            for k, v in tensors.items()}


def shard_named(tensors: Dict[str, torch.Tensor], dims: Dict[str, int]
                ) -> Dict[str, torch.Tensor]:
    """``tensors`` (full) with each entry named in ``dims`` cut to this
    rank's shard."""
    return {k: _shard(v, dims[k]) if k in dims else v
            for k, v in tensors.items()}


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with full tensors under the full names, as
    JAX's ``_to_host`` writes a sharded tree (collective on the model
    axis)."""
    return gather_named(model.state_dict(), split_dims(model))


def shard_state_dict(sd: Dict[str, torch.Tensor], model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` cut to what ``model`` holds on this rank."""
    return shard_named(sd, split_dims(model))


# ---- autograd collectives over the model axis -----------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return dist.all_reduce_(g.clone(), group="model")


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return dist.all_reduce_(x.clone(), group="model")

    @staticmethod
    def backward(ctx, g):
        return g


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, bounds):
        lo, hi = bounds[dist.model_rank()]
        shape = list(x.shape)
        shape[dim] = bounds[-1][1]
        fmt = (torch.channels_last if x.dim() == 4 and x.is_contiguous(
            memory_format=torch.channels_last) else torch.contiguous_format)
        full = x.new_zeros(shape).contiguous(memory_format=fmt)
        full.narrow(dim, lo, hi - lo).copy_(x)
        ctx.dim, ctx.lo, ctx.hi = dim, lo, hi
        return dist.all_reduce_(full, group="model")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.hi - ctx.lo), None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (replicated on the model axis) as it is; its gradient summed
    over the model group, whose ranks each hold a part of it."""
    return _CopyToModel.apply(x) if dist.model_world() > 1 else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model group's partial ``x``; its gradient, the same
    on every rank, passed on as it is."""
    return _ReduceFromModel.apply(x) if dist.model_world() > 1 else x


def gather_from_model(x: torch.Tensor, dim: int,
                      bounds: Optional[Sequence[Tuple[int, int]]] = None
                      ) -> torch.Tensor:
    """The whole tensor of which each rank of the model group holds
    ``[lo, hi)`` on ``dim`` (``bounds``, by model rank; default equal
    shards); the backward takes this rank's slice of the gradient, which
    the replicated work after it makes the same on every rank."""
    n = dist.model_world()
    if n == 1:
        return x
    if bounds is None:
        size = x.shape[dim]
        bounds = [(j * size, (j + 1) * size) for j in range(n)]
    return _Gather.apply(x, dim, tuple(bounds))


class _Halo(torch.autograd.Function):
    """Rows ``[need_lo, need_hi)`` of a map held in row slabs: this rank's
    own, the neighbours' edge rows (one all-reduce over the model group of
    every rank's first and last ``m`` rows, each in its own slot), and
    ``fill`` outside the map. The backward sends each borrowed row's
    gradient back to its owner the same way and adds it there."""

    @staticmethod
    def forward(ctx, x, bounds, needs, fill):
        r, n = dist.model_rank(), len(bounds)
        height = bounds[-1][1]
        lo, hi = bounds[r]
        above = [0] * n
        below = [0] * n
        for j, need in enumerate(needs):
            if need is None:
                continue
            a = max(0, bounds[j][0] - max(need[0], 0))
            b = max(0, min(need[1], height) - bounds[j][1])
            if (a and (j == 0 or a > bounds[j - 1][1] - bounds[j - 1][0])) \
                    or (b and (j == n - 1
                               or b > bounds[j + 1][1] - bounds[j + 1][0])):
                raise ValueError(f"slab {bounds[j]} needs rows {need} "
                                 f"beyond its neighbours' {bounds}")
            above[j], below[j] = a, b
        m = max(above + below)
        need = needs[r] or (lo, lo)
        own = (max(need[0], lo) - lo, max(min(need[1], hi), max(need[0], lo))
               - lo)
        size = hi - lo
        b_, c, _, w = x.shape
        buf = None
        if m:
            buf = x.new_zeros((n, 2, b_, c, m, w))
            k = min(m, size)
            buf[r, 0, :, :, :k] = x[:, :, :k]
            buf[r, 1, :, :, m - k:] = x[:, :, size - k:]
            dist.all_reduce_(buf, group="model")
        top_fill = max(0, -need[0])
        bot_fill = max(0, need[1] - max(height, hi))
        parts = []
        if top_fill:
            parts.append(x.new_full((b_, c, top_fill, w), fill))
        if above[r]:
            parts.append(buf[r - 1, 1, :, :, m - above[r]:])
        parts.append(x[:, :, own[0]:own[1]])
        if below[r]:
            parts.append(buf[r + 1, 0, :, :, :below[r]])
        if bot_fill:
            parts.append(x.new_full((b_, c, bot_fill, w), fill))
        ctx.save = (r, m, size, own, top_fill, above, below)
        out = torch.cat(parts, 2)
        return out.contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        r, m, size, own, top_fill, above, below = ctx.save
        b_, c, _, w = g.shape
        gx = g.new_zeros((b_, c, size, w))
        at = top_fill
        if above[r]:
            g_above = g[:, :, at:at + above[r]]
            at += above[r]
        gx[:, :, own[0]:own[1]] += g[:, :, at:at + own[1] - own[0]]
        at += own[1] - own[0]
        if m:
            buf = g.new_zeros((len(above), 2, b_, c, m, w))
            if above[r]:
                buf[r - 1, 1, :, :, m - above[r]:] = g_above
            if below[r]:
                buf[r + 1, 0, :, :, :below[r]] = g[:, :, at:at + below[r]]
            dist.all_reduce_(buf, group="model")
            k = min(m, size)
            gx[:, :, :k] += buf[r, 0, :, :, :k]
            gx[:, :, size - k:] += buf[r, 1, :, :, m - k:]
        return gx, None, None, None


def halo_rows(x: torch.Tensor, bounds: Sequence[Tuple[int, int]],
              needs: Sequence[Optional[Tuple[int, int]]], fill: float
              ) -> torch.Tensor:
    """Rows ``needs[r]`` (global ``[lo, hi)``, reaching past the map into
    ``fill``) of a map of which rank j holds rows ``bounds[j]``, ``x``
    this rank's; ``needs[j]`` is None where rank j needs none. Each rank
    may borrow only from its two neighbours. Collective on the model
    axis."""
    return _Halo.apply(x, tuple(bounds), tuple(needs), fill)


def take_rows(full: torch.Tensor, need: Tuple[int, int], fill: float
              ) -> torch.Tensor:
    """Rows ``[lo, hi)`` of a map every rank holds whole, ``fill`` outside
    it; its gradient is summed over the model group."""
    if full.requires_grad:
        full = copy_to_model(full)
    lo, hi = need
    h = full.shape[2]
    b, c, _, w = full.shape
    parts = []
    if lo < 0:
        parts.append(full.new_full((b, c, -lo, w), fill))
    parts.append(full[:, :, max(lo, 0):min(hi, h)])
    if hi > h:
        parts.append(full.new_full((b, c, hi - max(h, lo), w), fill))
    out = torch.cat(parts, 2) if len(parts) > 1 else parts[0]
    return out.contiguous(memory_format=torch.channels_last)


class SlabPlan:
    """The model group's rows of a backbone run on a map of ``height``
    rows whose deepest level lies ``unit`` times further down (16 for an
    image; 16 / s for a map at stride s): rank j starts at ``j · step``,
    ``step`` the least multiple of ``unit`` that covers ``height`` in
    ``model_world()`` slabs, and the last slab takes the remainder. At a
    level ``s`` times further down with ``h`` rows, rank j holds ``[a_j /
    s, a_{j+1} / s)``, clipped to ``h``, the last up to ``h``.

    :meth:`layer` runs one window op (convolution or max pool) of kernel
    ``k``, stride ``s`` and padding ``p`` on the height axis on this
    rank's slab, reading the rows its output slab needs from the
    neighbours (:func:`halo_rows`) or, for the first op, from the whole
    input (:func:`take_rows`); :meth:`gather` assembles a level's map."""

    def __init__(self, height: int, unit: int):
        n = dist.model_world()
        step = unit * max(1, math.ceil(height / (unit * n)))
        self.starts = [min(j * step, height) for j in range(n)] + [None]
        self.unit = unit

    def bounds(self, s: int, h: int) -> List[Tuple[int, int]]:
        assert self.unit % s == 0, (self.unit, s)
        out = []
        for a, b in zip(self.starts[:-1], self.starts[1:]):
            out.append((min(a // s, h), h if b is None else min(b // s, h)))
        return out

    def layer(self, fn, x, level, k: int, s: int, p: int, fill: float,
              first: bool = False):
        """``fn`` (rows → output rows, the width padded by ``fn``) on this
        rank's slab ``x`` at ``level`` = (stride, height); returns (this
        rank's output slab, the output level)."""
        stride, h = level
        out_level = (stride * s, (h + 2 * p - k) // s + 1)
        needs = [(lo * s - p, (hi - 1) * s - p + k) if hi > lo else None
                 for lo, hi in self.bounds(*out_level)]
        r = dist.model_rank()
        if first:
            rows = take_rows(x, needs[r] or (0, 0), fill)
            stats["first_rows"] = (rows.shape[2], x.shape[2])
        else:
            rows = halo_rows(x, self.bounds(*level), needs, fill)
        if needs[r] is not None:
            return fn(rows), out_level
        # an empty slab: one row of fill through fn keeps this rank's
        # weights and collectives in the graph, then none of it is kept
        pad = rows.new_full(rows.shape[:2] + (k,) + rows.shape[3:], fill)
        y = fn(torch.cat([rows, pad], 2).contiguous(
            memory_format=torch.channels_last))
        return y[:, :, :0], out_level

    def gather(self, x: torch.Tensor, level) -> torch.Tensor:
        return gather_from_model(x, 2, self.bounds(*level))
