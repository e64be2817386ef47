"""Train checkpoints (``tllod_tpu/utils/checkpoint.py``; reference
``net_utils.save_checkpoint`` and the resume at ``methods/DAF/
DAF_train.py:327-339``).

One ``torch.save`` file holds ``params`` (the model's ``state_dict``),
``opt_state`` (momentum buffers and update count), ``step``, ``epoch``,
``session`` and ``meta``. Evaluation loads the ``detector`` subset of a
DA-method checkpoint into the plain detector, as the filtered
``state_dict`` load of ``methods/DAF/DAF_test.py:194`` does.

A ``--tp`` run writes full tensors under the full names, as JAX's
``_to_host`` gathers a sharded tree (``tllod_tpu/utils/checkpoint.py:
24-25``): every rank calls :func:`save_checkpoint`, the model group
gathers the shards, and global rank 0 writes. So the file evaluates in the
test CLIs and resumes at any ``--tp``: :func:`resume_train_state` cuts
what it reads to the model's shards.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from tllod_torch.parallel import dist, mesh


def _opt_state(state: dict, fn) -> dict:
    return {k: fn(v) if isinstance(v, dict) else v for k, v in state.items()}


def save_checkpoint(path: str, *, model: torch.nn.Module, optimizer=None,
                    step: int = 0, epoch: int = 0, session: int = 1,
                    meta: Optional[Dict[str, Any]] = None) -> bool:
    """Write the checkpoint file at ``path`` (overwrites) with full
    tensors; under a process group every rank calls it and global rank 0
    alone writes. Returns whether this rank wrote."""
    dims = mesh.split_dims(model)
    payload = {"params": mesh.gather_state_dict(model), "step": step,
               "epoch": epoch, "session": session, "meta": meta or {}}
    if optimizer is not None:
        payload["opt_state"] = _opt_state(
            optimizer.state_dict(), lambda d: mesh.gather_named(d, dims))
    if dist.global_rank() != 0:
        return False
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return True


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)


def resume_train_state(model: torch.nn.Module, optimizer, path: str
                       ) -> Tuple[int, int]:
    """Restore params, momentum buffers, update count and step into
    ``model`` and ``optimizer``; returns ``(epoch, step)``, the checkpoint's
    epoch (training resumes at ``epoch + 1``) and step."""
    ckpt = load_checkpoint(path, map_location=model.device)
    dims = mesh.split_dims(model)
    model.load_state_dict(mesh.shard_state_dict(ckpt["params"], model),
                          strict=True)
    if optimizer is not None and ckpt.get("opt_state") is not None:
        optimizer.load_state_dict(_opt_state(
            ckpt["opt_state"], lambda d: mesh.shard_named(d, dims)))
    return int(ckpt.get("epoch", 0)), int(ckpt.get("step", 0))


def detector_params(params: Dict[str, torch.Tensor],
                    detector_key: str = "detector") -> Dict[str, torch.Tensor]:
    """The ``detector.*`` entries of a DA-method ``state_dict`` with the
    prefix dropped; a bare detector's ``state_dict`` comes back as is."""
    prefix = detector_key + "."
    if not any(k.startswith(prefix) for k in params):
        return dict(params)
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}
