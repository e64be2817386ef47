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
_state: Dict[str, object] = {"device": None, "backend": None}
# bytes that reduce_gradients has all-reduced, for measurement
stats = {"gradient_bytes": 0}


def active() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if active() else 0


def world() -> int:
    return tdist.get_world_size() if active() else 1


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
    print(f"torch.distributed: rank {rank()}/{world()} on {dev} "
          f"({_state['backend']})", flush=True)
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
    _state.update(device=None, backend=None)


def check_batch_divisible(batch_size: int, n: int) -> None:
    """Fail fast when the global batch cannot be split evenly over the
    ``n`` ranks (``mesh.py:140-150``)."""
    if batch_size % n != 0:
        raise ValueError(
            f"--mGPUs: global batch size {batch_size} is not divisible by "
            f"the {n}-way data axis; use --bs with a multiple of {n} "
            f"(e.g. --bs {((batch_size // n) + 1) * n}).")


def check_model_parallel(tp: int, sp: bool) -> None:
    if tp > 1 or sp:
        raise NotImplementedError(
            "--tp and --sp (tensor and spatial parallelism, "
            "tllod_tpu/parallel/mesh.py:32-135) are not ported yet; "
            "--mGPUs is data parallelism over torch.distributed")


# ---- collectives -------------------------------------------------------

def _collective_device() -> torch.device:
    return _state["device"] if _state["backend"] == "nccl" \
        else torch.device("cpu")


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce (``sum`` or ``max``) outside autograd; a CUDA
    tensor under gloo goes through the host. Identity without a group."""
    if not active():
        return t
    rop = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}[op]
    if _state["backend"] == "gloo" and t.is_cuda:
        host = t.cpu()
        tdist.all_reduce(host, rop)
        t.copy_(host)
    else:
        tdist.all_reduce(t, rop)
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


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every gradient of ``params`` by its mean over the ranks: one
    all-reduce of all of them flattened into one buffer."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _flatten_dense_tensors(grads)
    stats["gradient_bytes"] += flat.numel() * flat.element_size()
    all_reduce_(flat).div_(world())
    for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(r)


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
    h, w = (int(v) for v in all_reduce_(hw, "max").cpu())
    if (h, w) == im.shape[-3:-1]:
        return batch
    padded = np.zeros(im.shape[:-3] + (h, w, im.shape[-1]), im.dtype)
    padded[..., :im.shape[-3], :im.shape[-2], :] = im
    return dict(batch, im_data=padded)


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` without a group)."""
    if not active():
        return [obj]
    out = [None] * world()
    tdist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if active():
        tdist.barrier()
