"""Data parallelism over ``torch.distributed`` (``tllod_tpu/parallel/
mesh.py:23-30, 140-189``; ``methods/common.py:399-462``).

JAX shards the global batch over a ``data`` mesh axis and lets GSPMD
insert the collectives, so every reduction over the batch is a reduction
over the global batch. Here each rank is one process holding ``B / world``
images (rank r the r-th block of the global batch, as JAX's multi-process
``place_global`` assembles it), and every such reduction is an explicit
collective:

- every loss term is the global batch's value on every rank:
  :func:`gsum`, :func:`gmean` and :func:`global_sum` (an all-reduce whose
  backward all-reduces the gradient) for sums and means over the batch,
  :func:`gather_rows` for a term that mixes rows across images (PA-ATF's
  CLUB permutation); :func:`global_max` for a detached maximum;
- as every rank differentiates the same global loss, each rank's gradient
  is ``world`` times its own images' share of the true gradient (each
  collective's backward sums ``world`` equal cotangents), and
  :func:`reduce_gradients` takes the mean over ranks, which is the
  single-process gradient of the global batch; the clip and the update
  follow on every rank alike, so the parameters stay equal;
- the random draws of a step are the global batch's (each rank draws the
  global tensor from the same seeded generator and takes its rows,
  :class:`tllod_torch.train.StepRandom`).

With no group every helper is the plain single-process expression, bit for
bit. A group of one rank runs every collective (``--mGPUs`` on one card).

Under ``--tp N`` (:func:`make_grid`) the ``n`` ranks form JAX's 2-D
``(data, model)`` mesh (``mesh.py:32-52``): ``data = n / N`` by
``model = N``, global rank ``d · N + m``. The ranks of one data index
``d`` (its model group) read the same images and draw the same random
numbers; they split the big layers and, under ``--sp``, the backbone's
rows between them (:mod:`tllod_torch.parallel.mesh`). So :func:`rank` and
:func:`world`, and every helper that counts images or rows (:func:`gsum`,
:func:`gmean`, :func:`global_sum`, :func:`global_max`,
:func:`gather_rows`), mean the data axis; :func:`global_rank` and
:func:`global_world` the whole group, :func:`model_rank` and
:func:`model_world` the model axis. Without ``--tp`` the data axis is the
whole group.

The group is NCCL on the card and gloo on the CPU (:func:`join`), never
switched quietly. gloo takes CUDA tensors only for some collectives, so
under gloo a CUDA tensor is staged through the host for each one (the
card's two-ranks-on-one-GPU check, where NCCL refuses to run).
"""

from __future__ import annotations

import datetime
import os
import runpy
import socket
import sys
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as tdist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

ENV_COORD = "TLLOD_DIST_COORD"      # host:port, or a tcp:// or file:// URL
ENV_NPROCS = "TLLOD_DIST_NPROCS"
ENV_PID = "TLLOD_DIST_PID"
ENV_LOCAL = "TLLOD_DIST_LOCAL_RANK"  # the GPU index; default pid % GPUs

JOIN_TIMEOUT_S = 600.0               # how long a rank waits in a collective
_state: Dict[str, object] = {"device": None, "backend": None, "tp": 1,
                             "groups": {}}
# bytes that reduce_gradients has all-reduced, for measurement
stats = {"gradient_bytes": 0}


def active() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def global_rank() -> int:
    return tdist.get_rank() if active() else 0


def global_world() -> int:
    return tdist.get_world_size() if active() else 1


def model_world() -> int:
    """Ranks a model group holds: ``--tp``'s N (1 without a grid)."""
    return _state["tp"] if active() else 1


def model_rank() -> int:
    return global_rank() % model_world()


def rank() -> int:
    """This rank's index on the data axis."""
    return global_rank() // model_world()


def world() -> int:
    """Ranks on the data axis: the images of a step split ``world`` ways."""
    return global_world() // model_world()


def backend() -> Optional[str]:
    return _state["backend"] if active() else None


def device() -> Optional[torch.device]:
    """The device this rank joined with (``None`` without a group)."""
    return _state["device"] if active() else None


def init_method(coord: str) -> str:
    return coord if "://" in coord else f"tcp://{coord}"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join(dev, *, coord: str, world_size: int, rank: int,
         backend: Optional[str] = None) -> torch.device:
    """Join a group of ``world_size`` ranks at ``coord`` as ``rank``.
    ``dev`` ``cuda`` takes ``cuda:<local rank>`` (``TLLOD_DIST_LOCAL_RANK``,
    else ``rank`` modulo the visible GPUs; an explicit index is kept) and
    NCCL; ``cpu`` takes gloo. ``backend`` overrides that choice only when
    the caller names it. Returns the rank's device."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get(ENV_LOCAL)
            dev = torch.device("cuda", int(local) if local is not None
                               else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    tdist.init_process_group(
        backend, init_method=init_method(coord), world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    _state.update(device=dev, backend=backend)
    return dev


def join_from_env(dev) -> Optional[torch.device]:
    """The env-gated launch (``methods/common.py:399``): with
    ``TLLOD_DIST_COORD``, ``TLLOD_DIST_NPROCS`` and ``TLLOD_DIST_PID`` set,
    join that group and return the rank's device; else ``None``."""
    coord = os.environ.get(ENV_COORD)
    if not coord or active():
        return device()
    dev = join(dev, coord=coord, world_size=int(os.environ[ENV_NPROCS]),
               rank=int(os.environ[ENV_PID]))
    print(f"torch.distributed: rank {global_rank()}/{global_world()} on "
          f"{dev} ({_state['backend']})", flush=True)
    return dev


def _spawned(index: int, module: str, argv, world_size: int,
             coord: str) -> None:
    os.environ.update({ENV_COORD: coord, ENV_NPROCS: str(world_size),
                       ENV_PID: str(index), ENV_LOCAL: str(index)})
    sys.argv = [module] + list(argv)
    runpy.run_module(module, run_name="__main__", alter_sys=True)


def spawn_cli(n: int) -> None:
    """Run the CLI module this process runs again in ``n`` spawned
    workers, rank i on ``cuda:i``, with the ``TLLOD_DIST_*`` variables set
    (a free port on localhost), and wait for them."""
    spec = getattr(sys.modules["__main__"], "__spec__", None)
    if spec is None or not spec.name.startswith("tllod_torch.cli."):
        raise RuntimeError(
            "several GPUs take one worker each, started by running the CLI "
            "module again: run it as python -m tllod_torch.cli.<name>, or "
            "start every rank with TLLOD_DIST_COORD, TLLOD_DIST_NPROCS and "
            "TLLOD_DIST_PID")
    import torch.multiprocessing as mp

    mp.spawn(_spawned, args=(spec.name, sys.argv[1:], n,
                             f"localhost:{free_port()}"), nprocs=n, join=True)


def leave() -> None:
    if active():
        tdist.destroy_process_group()
    _state.update(device=None, backend=None, tp=1, groups={})


def make_grid(tp: int) -> None:
    """Arrange the joined ranks as a ``(data, model)`` grid of ``model =
    tp`` (``make_mesh_2d``): a model group per data index, a data group per
    model index. Every rank calls it, with the same ``tp``."""
    n = global_world()
    check_grid(tp, False, n)
    groups = {}
    if tp > 1:
        for d in range(n // tp):          # every rank makes every group
            g = tdist.new_group(list(range(d * tp, (d + 1) * tp)))
            if d == global_rank() // tp:
                groups["model"] = g
        for m in range(tp):
            g = tdist.new_group(list(range(m, n, tp)))
            if m == global_rank() % tp:
                groups["data"] = g
    _state.update(tp=tp, groups=groups)


def check_batch_divisible(batch_size: int, n: int) -> None:
    """Fail fast when the global batch cannot be split evenly over the
    ``n`` ranks (``mesh.py:140-150``)."""
    if batch_size % n != 0:
        raise ValueError(
            f"--mGPUs: global batch size {batch_size} is not divisible by "
            f"the {n}-way data axis; use --bs with a multiple of {n} "
            f"(e.g. --bs {((batch_size // n) + 1) * n}).")


def check_grid(tp: int, sp: bool, n: Optional[int] = None) -> None:
    """JAX's checks of ``--tp`` and ``--sp`` (``methods/common.py:
    438-447``): ``--sp`` needs a model axis, ``--tp`` must divide the ``n``
    ranks in use."""
    if sp and tp < 2:
        raise ValueError("--sp shards images over the 'model' mesh axis; "
                         "it requires --tp >= 2 to define that axis")
    if n is not None and tp > 1 and n % tp != 0:
        raise ValueError(f"--tp {tp} does not divide the {n} devices "
                         f"in use")


# ---- collectives -------------------------------------------------------

def _collective_device() -> torch.device:
    return _state["device"] if _state["backend"] == "nccl" \
        else torch.device("cpu")


def all_reduce_(t: torch.Tensor, op: str = "sum",
                group: str = "data") -> torch.Tensor:
    """In-place all-reduce (``sum`` or ``max``) outside autograd over the
    ``group`` axis: ``data`` (the default), ``model`` or ``world``. A CUDA
    tensor under gloo goes through the host, a bfloat16 one through
    float32 (so a sum rounds once); a ``channels_last`` tensor is reduced
    as its NHWC view. Identity without a group, and over the model axis
    without a grid."""
    if not active() or (group == "model" and _state["tp"] == 1):
        return t
    pg = _state["groups"].get(group) if group != "world" else None
    rop = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}[op]
    gloo = _state["backend"] == "gloo"
    if t.dim() == 4 and not t.is_contiguous() \
            and t.is_contiguous(memory_format=torch.channels_last):
        buf = t.permute(0, 2, 3, 1)
    else:
        buf = t
    if (gloo and (t.is_cuda or t.dtype == torch.bfloat16)) \
            or not buf.is_contiguous():
        host = buf.to("cpu" if gloo else buf.device,
                      torch.float32 if gloo and t.dtype == torch.bfloat16
                      else t.dtype, memory_format=torch.contiguous_format)
        tdist.all_reduce(host, rop, group=pg)
        buf.copy_(host)
    else:
        tdist.all_reduce(buf, rop, group=pg)
    return t


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        n = x.shape[0]
        ctx.rows = slice(rank() * n, (rank() + 1) * n)
        out = x.new_zeros((n * world(),) + tuple(x.shape[1:]))
        out[ctx.rows] = x
        return all_reduce_(out)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())[ctx.rows]


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks, differentiable (its
    backward sums the cotangents over the ranks). Identity without a
    group."""
    return _GlobalSum.apply(x) if active() else x


def gsum(x: torch.Tensor) -> torch.Tensor:
    """Σ of every entry of ``x`` over the global batch."""
    return global_sum(x.sum()) if active() else x.sum()


def gmean(x: torch.Tensor) -> torch.Tensor:
    """Mean of every entry of ``x`` over the global batch. Every rank
    holds as many entries (one padded shape, :func:`sync_image_shapes`)."""
    if not active():
        return x.mean()
    return global_sum(x.sum()) / (x.numel() * world())


def global_max(x: torch.Tensor) -> torch.Tensor:
    """Max of every entry of ``x`` over the global batch, detached."""
    if not active():
        return x.max()
    return all_reduce_(x.detach().max().clone(), "max")


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of a per-rank (n, ...) tensor, in rank
    order (an all-reduce of each rank's rows placed in zeros, so any
    backend and a CUDA graph take it); the backward returns each rank the
    summed cotangent of its own rows. Identity without a group."""
    if not active():
        return x
    if x.dtype == torch.bool:
        return _GatherRows.apply(x.float()) > 0.5
    return _GatherRows.apply(x)


def _reduce_flat(grads, group: str, divisors) -> None:
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    stats["gradient_bytes"] += flat.numel() * flat.element_size()
    all_reduce_(flat, group=group)
    for g, r, d in zip(grads, _unflatten_dense_tensors(flat, grads),
                       divisors):
        g.copy_(r.div_(d))


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every gradient of ``params`` by the single-process gradient
    of the global batch: without a grid, the mean over the ranks (one
    all-reduce of them all flattened into one buffer). On a grid, each
    rank of a data index holds ``world()`` times its images' share
    (:mod:`tllod_torch.parallel.mesh`): of a split parameter's shard (its
    mean over the data axis), of a replicated one (alike on the model axis:
    its mean over all ranks, so the copies stay bit-equal), or, under
    ``--sp``, a backbone weight's partial sum over this rank's rows (its
    sum over the model axis, then mean over the data axis). Every trained
    parameter takes part, at zero where this rank computed no gradient."""
    if not active():
        return
    params = [p for p in params if p.requires_grad or p.grad is not None]
    tp = _state["tp"]
    if tp == 1:
        grads = [p.grad for p in params if p.grad is not None]
        _reduce_flat(grads, "world", [world()] * len(grads))
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    split = [p.grad for p in params if getattr(p, "tp_split", False)]
    rest = [p for p in params if not getattr(p, "tp_split", False)]
    _reduce_flat([p.grad for p in rest], "world",
                 [world() if getattr(p, "sp_partial", False)
                  else global_world() for p in rest])
    if world() > 1:
        _reduce_flat(split, "data", [world()] * len(split))


def sync_image_shapes(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Agree on one padded image shape across ranks (``mesh.py:168-189``):
    each rank's loader pads to its own bucket, so zero-pad every rank's
    ``im_data`` to the elementwise max of the ranks' (H, W), as the loader
    pads within a batch (``im_info`` keeps the true sizes). ``im_data`` is
    (B, H, W, C), or (K, B, H, W, C) stacked for ``--fuse_steps``."""
    if not active():
        return batch
    im = np.asarray(batch["im_data"])
    hw = torch.tensor(im.shape[-3:-1], dtype=torch.int64,
                      device=_collective_device())
    # over the data axis: a model group's ranks read the same images
    h, w = (int(v) for v in all_reduce_(hw, "max").cpu())
    if (h, w) == im.shape[-3:-1]:
        return batch
    padded = np.zeros(im.shape[:-3] + (h, w, im.shape[-1]), im.dtype)
    padded[..., :im.shape[-3], :im.shape[-2], :] = im
    return dict(batch, im_data=padded)


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in global rank order (``[obj]`` without a
    group)."""
    if not active():
        return [obj]
    out = [None] * global_world()
    tdist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if active():
        tdist.barrier()
