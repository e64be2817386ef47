"""Weights from the JAX package (the inverse of ``tllod_tpu/zoo.py:50-72``).

A flax param tree, as nested dicts of numpy arrays or as a flat dict with
``/``-joined paths (an ``.npz`` of flattened params), becomes a PyTorch
``state_dict`` for the port's modules, whose parameter names follow the
flax tree:

  conv kernel  (kh, kw, I, O) → weight (O, I, kh, kw)
  dense kernel (I, O)         → weight (O, I)
  bias                        → bias

Reading an orbax checkpoint needs JAX, so weights cross as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params (nested or ``/``-flattened) → ``state_dict`` tensors."""
    sd: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(tree).items():
        *mods, leaf = path.split("/")
        if leaf == "kernel":
            if val.ndim == 4:
                val = val.transpose(3, 2, 0, 1)
            elif val.ndim == 2:
                val = val.T
            else:
                raise ValueError(f"unexpected kernel rank at {path}: "
                                 f"{val.shape}")
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"no counterpart for flax leaf {path}")
        sd[".".join(mods + [leaf])] = torch.from_numpy(np.array(val))
    return sd


def load_jax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Load flax params into ``model``, keeping only the model's own keys
    (method-only subtrees fall away, as the detector-only restore at eval
    does); a missing or mis-shaped key raises."""
    sd = from_jax_params(tree)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"JAX params lack {missing[:5]}"
                       f"{' …' if len(missing) > 5 else ''}")
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
    return model
