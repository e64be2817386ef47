"""Train checkpoints (``tllod_tpu/utils/checkpoint.py``; reference
``net_utils.save_checkpoint`` and the resume at ``methods/DAF/
DAF_train.py:327-339``).

One ``torch.save`` file holds ``params`` (the model's ``state_dict``),
``opt_state`` (momentum buffers and update count), ``step``, ``epoch``,
``session`` and ``meta``. Evaluation loads the ``detector`` subset of a
DA-method checkpoint into the plain detector, as the filtered
``state_dict`` load of ``methods/DAF/DAF_test.py:194`` does.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


def save_checkpoint(path: str, *, model: torch.nn.Module, optimizer=None,
                    step: int = 0, epoch: int = 0, session: int = 1,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write the checkpoint file at ``path`` (overwrites)."""
    payload = {"params": model.state_dict(), "step": step, "epoch": epoch,
               "session": session, "meta": meta or {}}
    if optimizer is not None:
        payload["opt_state"] = optimizer.state_dict()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)


def resume_train_state(model: torch.nn.Module, optimizer, path: str
                       ) -> Tuple[int, int]:
    """Restore params, momentum buffers, update count and step into
    ``model`` and ``optimizer``; returns ``(epoch, step)``, the checkpoint's
    epoch (training resumes at ``epoch + 1``) and step."""
    ckpt = load_checkpoint(path, map_location=model.device)
    model.load_state_dict(ckpt["params"], strict=True)
    if optimizer is not None and ckpt.get("opt_state") is not None:
        optimizer.load_state_dict(ckpt["opt_state"])
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
