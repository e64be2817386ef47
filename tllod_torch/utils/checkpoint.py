"""Train checkpoints (``tllod_tpu/utils/checkpoint.py``; reference
``net_utils.save_checkpoint`` and the resume at ``methods/DAF/
DAF_train.py:327-339``), in the port's own ``.pth`` or in the ``.npz``
layout that the JAX package reaches through ``tools/jax_checkpoint.py``.

A ``.pth`` (``torch.save``) holds ``params`` (the model's ``state_dict``),
``opt_state`` (the optimizer's ``state_dict``: per-parameter state by
parameter name, and the update count), ``step``, ``epoch``, ``session``,
``meta`` and ``chain`` (the optimizer's settings, below). Evaluation loads
the ``detector`` subset of a DA-method checkpoint into the plain detector,
as the filtered ``state_dict`` load of ``methods/DAF/DAF_test.py:194``
does.

The ``.npz`` interchange layout is flat and numpy only
(``np.load(path, allow_pickle=False)`` reads it):

- ``params/<flax path>``: every leaf of the JAX ``params`` tree in JAX's
  layout (conv kernels (kh, kw, I, O), dense kernels (I, O), FrozenBN
  leaves as they are; :func:`tllod_torch.zoo.to_jax_params`);
- ``opt/trace/<flax path>`` (SGD) or ``opt/mu/<flax path>`` and
  ``opt/nu/<flax path>`` (Adam): optax's state under the same paths and in
  the same layout, one entry for every ``params`` leaf. A leaf the
  optimizer does not train has state 0 there, as JAX's masked chain keeps
  it. A bfloat16 trace (``--bf16_momentum``) is stored as float32, which
  holds it exactly, and rounded back on load;
- ``count`` (the schedule's update count, and Adam's), ``step``,
  ``epoch``, ``session``;
- ``meta/<key>``: the train CLI's meta (``net``, ``pooling_mode``,
  ``class_agnostic``, ...) and what rebuilds JAX's optax chain:
  ``optimizer`` (``sgd`` or ``adam``), ``momentum_dtype``, ``clip`` (0 for
  none), ``weight_decay``, ``double_bias``.

A params-only ``.npz`` (flax paths without ``params/``) is read too.

One seam is pinned: JAX's mask trains the ``downsample_bn`` ``mean`` and
``var`` leaves of a ResNet (it decays them), where the port keeps them as
buffers. Their values cross both ways; their trace or moments do not: they
are dropped on load and written as 0. Any other nonzero state on a leaf
that the port does not train is refused, and so is a name or shape that
does not match the model, with the first offending key. Loading copies
into the model's and the optimizer's live tensors (``load_state_dict``):
a captured CUDA graph (``--fuse_steps``) reads them in place.

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

import numpy as np
import torch

from tllod_torch.parallel import dist, mesh
from tllod_torch.utils.optim import SGD, Adam
from tllod_torch.zoo import from_jax_params, to_jax_params

STATE_KEYS = ("trace", "mu", "nu")
CHAIN_KEYS = ("optimizer", "momentum_dtype", "clip", "weight_decay",
              "double_bias")
# JAX decays these; the port keeps them as buffers (see above)
PINNED = ("downsample_bn.mean", "downsample_bn.var")


def _opt_state(state: dict, fn) -> dict:
    return {k: fn(v) if isinstance(v, dict) else v for k, v in state.items()}


def optimizer_chain(optimizer) -> Dict[str, Any]:
    """The settings that rebuild ``optimizer`` as JAX's optax chain
    (``tllod_tpu/utils/optim.py::build_optimizer``)."""
    bf16 = (isinstance(optimizer, SGD)
            and optimizer.momentum_dtype == torch.bfloat16)
    return {"optimizer": "adam" if isinstance(optimizer, Adam) else "sgd",
            "momentum_dtype": "bfloat16" if bf16 else "float32",
            "clip": float(optimizer.clip_norm or 0.0),
            "weight_decay": float(optimizer.weight_decay),
            "double_bias": bool(optimizer.double_bias)}


def save_checkpoint(path: str, *, model: torch.nn.Module, optimizer=None,
                    step: int = 0, epoch: int = 0, session: int = 1,
                    meta: Optional[Dict[str, Any]] = None) -> bool:
    """Write the checkpoint file at ``path`` (overwrites) with full
    tensors, as an ``.npz`` in the interchange layout where ``path`` ends
    so, else with ``torch.save``; under a process group every rank calls
    it and global rank 0 alone writes. Returns whether this rank wrote."""
    dims = mesh.split_dims(model)
    payload = {"params": mesh.gather_state_dict(model), "step": step,
               "epoch": epoch, "session": session, "meta": meta or {}}
    if optimizer is not None:
        payload["opt_state"] = _opt_state(
            optimizer.state_dict(), lambda d: mesh.gather_named(d, dims))
        payload["chain"] = optimizer_chain(optimizer)
    if dist.global_rank() != 0:
        return False
    if path.endswith(".npz"):
        write_npz(path, payload)
    else:
        _write(path, lambda f: torch.save(payload, f))
    return True


def _write(path: str, write) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)


def write_npz(path: str, ckpt: Dict[str, Any]) -> None:
    """Write ``ckpt`` (as :func:`load_checkpoint` returns it) at ``path``
    in the ``.npz`` layout."""
    arrays = npz_arrays(ckpt)
    _write(path, lambda f: np.savez(f, **arrays))


def _meta_array(value) -> np.ndarray:
    a = np.asarray(value)
    return np.asarray(str(value)) if a.dtype.kind == "O" else a


def npz_arrays(payload: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A checkpoint as :func:`load_checkpoint` returns it (full tensors)
    → the arrays of the ``.npz`` layout."""
    params = to_jax_params(payload["params"])
    out = {f"params/{k}": v for k, v in params.items()}
    meta = dict(payload.get("meta") or {})
    opt = payload.get("opt_state")
    if opt is not None:
        keys = [k for k in STATE_KEYS if k in opt]
        for key in keys:
            named = to_jax_params(opt[key])
            unknown = [k for k in named if k not in params]
            if unknown:
                raise KeyError(f"optimizer {key} names {unknown[0]}, which "
                               f"the params lack")
            for path, leaf in params.items():
                out[f"opt/{key}/{path}"] = named.get(
                    path, np.zeros(leaf.shape, np.float32))
        out["count"] = np.asarray(int(opt["count"]))
        # a file written before the chain was recorded: what its state shows
        trace = opt.get("trace", {})
        meta.update(payload.get("chain") or {
            "optimizer": "sgd" if "trace" in keys else "adam",
            "momentum_dtype": ("bfloat16" if any(
                t.dtype == torch.bfloat16 for t in trace.values())
                else "float32")})
    for key in ("step", "epoch", "session"):
        out[key] = np.asarray(int(payload.get(key, 0)))
    out.update((f"meta/{k}", _meta_array(v)) for k, v in meta.items())
    return out


def _bfloat16(t: torch.Tensor, name: str) -> torch.Tensor:
    out = t.to(torch.bfloat16)
    if not torch.equal(out.float(), t):
        raise ValueError(f"{name} is recorded as bfloat16 but holds values "
                         f"that bfloat16 does not")
    return out


def read_npz(path: str, map_location="cpu") -> Dict[str, Any]:
    """An ``.npz`` of the interchange layout (or params-only) → the
    checkpoint as :func:`load_checkpoint` returns it, its tensors on
    ``map_location``, under the port's names. The optimizer state names
    every params leaf."""
    with np.load(path, allow_pickle=False) as z:
        files = z.files

        def subtree(prefix):
            return from_jax_params({k[len(prefix):]: z[k] for k in files
                                    if k.startswith(prefix)}, map_location)

        if not any(k.startswith("params/") for k in files):
            return {"params": subtree(""), "step": 0, "epoch": 0,
                    "session": 1, "meta": {}}
        meta = {k[5:]: z[k].item() for k in files if k.startswith("meta/")}
        chain = {k: meta.pop(k) for k in CHAIN_KEYS if k in meta}

        out = {"params": subtree("params/"), "meta": meta, "chain": chain}
        for key, default in (("step", 0), ("epoch", 0), ("session", 1)):
            out[key] = int(z[key]) if key in files else default
        keys = sorted({k.split("/")[1] for k in files
                       if k.startswith("opt/")})
        if keys:
            bad = [k for k in keys if k not in STATE_KEYS]
            if bad:
                raise KeyError(f"{path}: unknown optimizer state opt/{bad[0]}")
            opt = {"count": int(z["count"])}
            for key in keys:
                opt[key] = subtree(f"opt/{key}/")
                if key == "trace" and chain.get("momentum_dtype") == \
                        "bfloat16":
                    opt[key] = {n: _bfloat16(t, n)
                                for n, t in opt[key].items()}
            out["opt_state"] = opt
    return out


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """A ``.pth`` or an ``.npz`` as one dict, its tensors on
    ``map_location``."""
    if path.endswith(".npz"):
        return read_npz(path, map_location)
    return torch.load(path, map_location=map_location, weights_only=True)


def load_params(path: str, map_location="cpu") -> Dict[str, torch.Tensor]:
    """The weights in any file the test CLIs take, as a ``state_dict``: a
    train checkpoint (``.pth`` or ``.npz``), a port ``state_dict``
    (``.pt``) or a params-only ``.npz``. An ``.npz``'s optimizer state is
    not read."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            full = any(k.startswith("params/") for k in z.files)
            return from_jax_params({k[7:] if full else k: z[k]
                                    for k in z.files
                                    if k.startswith("params/") or not full},
                                   map_location)
    sd = torch.load(path, map_location=map_location, weights_only=True)
    return sd["params"] if "params" in sd else sd


def load_exact(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """``model.load_state_dict(sd)`` (copies into the live tensors) after
    checking that ``sd`` names exactly the model's tensors at their
    shapes; raises on the first offending key."""
    own = model.state_dict()
    for k in sd:
        if k not in own:
            raise KeyError(f"the checkpoint's {k} names no tensor of the "
                           f"model")
    for k, t in own.items():
        if k not in sd:
            raise KeyError(f"the checkpoint lacks {k}")
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError(f"{k} has shape {tuple(sd[k].shape)} in the "
                             f"checkpoint, {tuple(t.shape)} in the model")
    model.load_state_dict(sd, strict=True)


def trained_state(opt_state: dict, optimizer, model: torch.nn.Module
                  ) -> dict:
    """``opt_state`` cut to the parameters ``optimizer`` trains: the
    state of a tensor it does not train is dropped if it is 0 (JAX keeps
    state for every leaf) or on a pinned ``downsample_bn`` statistic, and
    refused otherwise, as is a name the model lacks."""
    trained, own = optimizer.named_params(), model.state_dict()
    out = {}
    for key, named in opt_state.items():
        if not isinstance(named, dict):
            out[key] = named
            continue
        out[key] = {}
        for n, t in named.items():
            if n in trained:
                out[key][n] = t
            elif n not in own:
                raise KeyError(f"optimizer {key} names {n}, which the "
                               f"model lacks")
            elif not n.endswith(PINNED) and bool(t.any()):
                raise ValueError(f"nonzero optimizer {key} on {n}, which "
                                 f"this optimizer does not train")
    return out


def resume_train_state(model: torch.nn.Module, optimizer, path: str
                       ) -> Tuple[int, int]:
    """Restore params, optimizer state, update count and step from a
    ``.pth`` or an ``.npz`` into ``model`` and ``optimizer``, in place;
    returns ``(epoch, step)``, the checkpoint's epoch (training resumes at
    ``epoch + 1``) and step."""
    ckpt = load_checkpoint(path, map_location=model.device)
    dims = mesh.split_dims(model)
    load_exact(model, mesh.shard_named(ckpt["params"], dims))
    if optimizer is not None and ckpt.get("opt_state") is not None:
        saved = (ckpt.get("chain") or {}).get("optimizer")
        kind = optimizer_chain(optimizer)["optimizer"]
        if saved is not None and saved != kind:
            raise ValueError(f"{path} holds {saved} state; the optimizer "
                             f"is {kind}")
        state = trained_state(ckpt["opt_state"], optimizer, model)
        optimizer.load_state_dict(_opt_state(
            state, lambda d: mesh.shard_named(d, dims)))
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
