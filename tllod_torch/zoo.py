"""Weights from the JAX package (the inverse of ``tllod_tpu/zoo.py:50-72``).

A flax param tree, as nested dicts of numpy arrays or as a flat dict with
``/``-joined paths (an ``.npz`` of flattened params), becomes a PyTorch
``state_dict`` for the port's modules, whose parameter names follow the
flax tree:

  conv kernel  (kh, kw, I, O) → weight (O, I, kh, kw)
  dense kernel (I, O)         → weight (O, I)
  bias                        → bias

Reading an orbax checkpoint needs JAX, so weights cross as numpy arrays
(:mod:`tllod_torch.utils.checkpoint` has the ``.npz`` layout).
:func:`to_jax_params` is the inverse map, for the way back; both apply to
an optimizer's per-parameter state as well (a trace or moment of a
``kernel`` is laid out as the kernel is).
A method's tree (``detector/…``, ``img_da/…``, ``ins_da/…``; PA-ATF's
``img_da3/mask_conv1/…``, ``club3/fc/…``) maps onto the method module the
same way. A dense kernel is only transposed: the port's heads flatten in
the order flax does (fc6 (C, H, W) by the torchvision layout, as the JAX
backbone does; PA-ATF's CLUB fc (H, W, C), as flax's NHWC reshape).

A FrozenBN's ``scale``, ``bias``, ``mean`` and ``var`` leaves become the
buffers of the same names.

:func:`load_pretrained_backbone` fills the backbone and box head from the
caffe-pretrained file the reference trains from, by the JAX package's file
names (``tllod_tpu/zoo.py:58-107, 143-178``): ``vgg16_caffe.pth`` or
``resnet{50,101,152}_caffe.pth``, torchvision-layout state dicts. VGG16's
applies unchanged because the head flattens in (C, H, W) order; a ResNet's
goes through :func:`convert_resnet` (conv1..layer3 to the backbone, layer4
to the head).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from tllod_torch.models.backbones import RESNET_STAGES

# torchvision VGG16 feature indices → the backbone's conv names
_VGG_FEATURE_MAP = {
    0: "conv1_1", 2: "conv1_2",
    5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
    17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
    24: "conv5_1", 26: "conv5_2", 28: "conv5_3",
}


def pretrained_dir() -> str:
    return os.environ.get("TLLOD_PRETRAINED_DIR", "pretrained_model")


def convert_vgg16(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision VGG16 state dict → ``backbone.*`` and ``head.*`` entries
    of the detector's ``state_dict``."""
    out = {}
    for idx, name in _VGG_FEATURE_MAP.items():
        for leaf in ("weight", "bias"):
            out[f"backbone.{name}.{leaf}"] = sd[f"features.{idx}.{leaf}"]
    for fc, idx in (("fc6", 0), ("fc7", 3)):
        for leaf in ("weight", "bias"):
            out[f"head.{fc}.{leaf}"] = sd[f"classifier.{idx}.{leaf}"]
    return out


PRETRAINED_FILES = {"vgg16": "vgg16_caffe.pth",
                    "res50": "resnet50_caffe.pth",
                    "res101": "resnet101_caffe.pth",
                    "res152": "resnet152_caffe.pth"}


def _bn(sd, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {f"{dst}.scale": sd[f"{src}.weight"],
            f"{dst}.bias": sd[f"{src}.bias"],
            f"{dst}.mean": sd[f"{src}.running_mean"],
            f"{dst}.var": sd[f"{src}.running_var"]}


def convert_resnet(sd: Mapping[str, torch.Tensor], depth: int
                   ) -> Dict[str, torch.Tensor]:
    """torchvision ResNet state dict → ``backbone.*`` (conv1, bn1,
    layer1..layer3) and ``head.layer4_<i>.*`` entries of the detector's
    ``state_dict`` (``tllod_tpu/zoo.py:75-107``); the head's are left out
    when ``sd`` has no layer4."""
    out = {"backbone.conv1.weight": sd["conv1.weight"],
           **_bn(sd, "bn1", "backbone.bn1")}
    for stage, blocks in enumerate(RESNET_STAGES[depth], start=1):
        if stage == 4 and "layer4.0.conv1.weight" not in sd:
            break
        root = "head" if stage == 4 else "backbone"
        for i in range(blocks):
            src, dst = f"layer{stage}.{i}", f"{root}.layer{stage}_{i}"
            for c in (1, 2, 3):
                out[f"{dst}.conv{c}.weight"] = sd[f"{src}.conv{c}.weight"]
                out.update(_bn(sd, f"{src}.bn{c}", f"{dst}.bn{c}"))
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.downsample_conv.weight"] = \
                    sd[f"{src}.downsample.0.weight"]
                out.update(_bn(sd, f"{src}.downsample.1",
                               f"{dst}.downsample_bn"))
    return out


def load_pretrained_backbone(module: nn.Module, net: str,
                             path: Optional[str] = None,
                             head: Optional[nn.Module] = None) -> bool:
    """Fill a detector's backbone and head, or a bare backbone (ATF's
    ``backbone_anc``, as ``methods/da_runner.py:87-91`` does, IDF's
    ``backbone_b``) and, given ``head``, that box head (IDF's
    ``detector.head`` or ``head_aux``, as ``load_pretrained_backbone(...,
    head_subtree=)`` at ``tllod_tpu/zoo.py:143-178``), from the net's
    caffe-pretrained file (:data:`PRETRAINED_FILES`) under
    ``$TLLOD_PRETRAINED_DIR`` (default ``pretrained_model/``). A missing
    file, or a net with none (``vgg16_thin``, ``res14``), keeps the random
    init with a warning, as the JAX CLI does; returns whether weights were
    loaded."""
    fname = PRETRAINED_FILES.get(net)
    path = path or os.path.join(pretrained_dir(), fname or f"{net}_caffe.pth")
    if fname is None or not os.path.exists(path):
        print(f"WARNING: pretrained weights not found at {path}; keeping "
              f"random init")
        return False
    print(f"Loading pretrained weights from {path}")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = (convert_vgg16(raw) if net == "vgg16"
          else convert_resnet(raw, int(net[3:])))
    if any(k.startswith("backbone.") for k in module.state_dict()):
        parts = [(module, "")]                      # a detector
    else:                                           # a bare backbone
        parts = [(module, "backbone.")] + ([(head, "head.")] if head else [])
    for m, prefix in parts:
        own = m.state_dict()
        sub = {k[len(prefix):]: v for k, v in sd.items()
               if k.startswith(prefix)}
        for k, v in sub.items():
            if own[k].shape != v.shape:
                raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, "
                                 f"the model {tuple(own[k].shape)}")
        m.load_state_dict(sub, strict=False)
    return True


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def from_jax_params(tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """flax params (nested or ``/``-flattened) → ``state_dict`` tensors,
    on the CPU or ``device`` (where the transposes then run)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(tree).items():
        *mods, leaf = path.split("/")
        # a kernel's transpose copies it; any other leaf is copied here
        t = torch.from_numpy(
            val if leaf == "kernel" and val.flags.writeable
            and val.ndim in (2, 4) else np.array(val))
        if device is not None:
            t = t.to(device)
        if leaf == "kernel":
            if t.ndim == 4:
                t = t.permute(3, 2, 0, 1)
            elif t.ndim == 2:
                t = t.t()
            else:
                raise ValueError(f"unexpected kernel rank at {path}: "
                                 f"{tuple(t.shape)}")
            t, leaf = t.clone(memory_format=torch.contiguous_format), "weight"
        elif leaf not in ("bias", "scale", "mean", "var"):
            raise ValueError(f"no counterpart for flax leaf {path}")
        sd[".".join(mods + [leaf])] = t
    return sd


def to_jax_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``state_dict`` tensors → flax paths (``/``-joined) of numpy arrays in
    JAX's layout: the inverse of :func:`from_jax_params`, each transpose
    taken on the tensor's device. bfloat16 tensors come out as float32,
    which holds them exactly. An array that needs no transpose may share
    memory with a CPU tensor."""
    flat: Dict[str, np.ndarray] = {}
    for name, t in sd.items():
        *mods, leaf = name.split(".")
        t = t.detach()
        if leaf == "weight":
            if t.ndim == 4:
                t = t.permute(2, 3, 1, 0)
            elif t.ndim == 2:
                t = t.t()
            else:
                raise ValueError(f"unexpected weight rank at {name}: "
                                 f"{tuple(t.shape)}")
            leaf = "kernel"
        elif leaf not in ("bias", "scale", "mean", "var"):
            raise ValueError(f"no flax counterpart for {name}")
        if t.dtype == torch.bfloat16:
            t = t.float()
        flat["/".join(mods + [leaf])] = t.contiguous().cpu().numpy()
    return flat


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
