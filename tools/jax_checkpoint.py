#!/usr/bin/env python
"""Move train checkpoints between the JAX package's orbax directories
(``tllod_tpu/utils/checkpoint.py::save_checkpoint``) and the flat ``.npz``
interchange layout that the PyTorch port reads and writes (the layout is
documented in ``tllod_torch/utils/checkpoint.py`` and the README).

    python tools/jax_checkpoint.py to-npz ORBAX_DIR OUT.npz [--cfg F]
    python tools/jax_checkpoint.py to-orbax IN.npz ORBAX_DIR [--net N] \\
        [--o sgd|adam] [--bf16_momentum] [--cfg F]

``to-npz`` flattens ``params`` and finds the optimizer state by name, not
by its position in the optax chain (the clip, the decay and the bias
scaling each add an entry): SGD's ``trace``, Adam's ``mu`` and ``nu``, and
every ``count``, which must agree. A bfloat16 trace (``--bf16_momentum``)
is written as float32, which holds it exactly. ``meta/`` records what
rebuilds the chain: the net (read off the backbone's shapes), the
optimizer, the trace's dtype, the clip, the weight decay (the config's,
``--cfg`` or ``cfgs/<net>.yml``, where the chain decays) and the bias
doubling, beside the checkpoint's own meta.

``to-orbax`` rebuilds the chain with ``tllod_tpu.utils.optim.
build_optimizer`` and the shapes of its ``tx.init`` (the optimizer, the
dtype, the weight decay and the bias doubling from ``meta/`` unless given;
a flag that disagrees with ``meta/`` raises) and fills its leaves by name,
so that ``resume_train_state`` maps the state back onto a live optimizer
exactly.
A name, shape or state that does not match raises.

Runs where JAX is installed; imports no ``torch``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from types import SimpleNamespace
from typing import Any, Dict, Mapping, Optional

import jax
import numpy as np
from flax import serialization

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
from tllod_tpu.config import Config, cfg_from_file  # noqa: E402
from tllod_tpu.models.backbones import RESNET_STAGES  # noqa: E402
from tllod_tpu.utils.checkpoint import (load_checkpoint,  # noqa: E402
                                        save_checkpoint)
from tllod_tpu.utils.optim import build_optimizer  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STATE_KEYS = ("trace", "mu", "nu")
CLIP = 10.0                 # build_optimizer's clip, vgg16 only


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + str(k)] = v
    return out


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def infer_net(params: Mapping) -> str:
    """The ``--net`` of a params tree, from its backbone."""
    backbone = params.get("detector", params)["backbone"]
    if "conv1_1" in backbone:
        width = np.shape(backbone["conv1_1"]["kernel"])[-1]
        return "vgg16" if width == 64 else "vgg16_thin"
    blocks = sum(1 for k in backbone if k.startswith("layer3_"))
    depth = [d for d, s in RESNET_STAGES.items() if s[2] == blocks]
    if len(depth) != 1:
        raise ValueError(f"no ResNet has {blocks} layer3 blocks")
    return f"res{depth[0]}"


def load_cfg(net: str, cfg_file: Optional[str]) -> Config:
    """``--cfg``, else ``cfgs/<net>.yml`` where there is one, else the
    defaults (``vgg16_thin``, ``res14``)."""
    path = cfg_file or os.path.join(REPO, "cfgs", f"{net}.yml")
    if cfg_file or os.path.exists(path):
        return cfg_from_file(Config(), path)
    return Config()


def _meta_array(value) -> np.ndarray:
    a = np.asarray(value)
    return np.asarray(str(value)) if a.dtype.kind == "O" else a


def _float32(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype == np.float32 else a.astype(np.float32)


def chain_state(opt_state: Mapping) -> Dict[str, Any]:
    """The optimizer state of an optax chain's flax state dict, by name:
    ``{'trace' | 'mu' | 'nu': {path: array}, 'count': int}``, and what
    the chain's entries show of its make-up."""
    found: Dict[str, Any] = {}
    counts = []

    def walk(node, path):
        for k, v in node.items():
            if k in STATE_KEYS:
                if k in found:
                    raise ValueError(f"two {k} states in the chain")
                found[k] = flatten(v)
            elif k == "count":
                counts.append(int(np.asarray(v)))
            elif isinstance(v, Mapping):
                walk(v, path + [str(k)])
            else:
                raise ValueError(f"unknown optimizer state leaf "
                                 f"{'/'.join(path + [str(k)])}")

    walk(opt_state, [])
    if "trace" not in found and "mu" not in found:
        raise ValueError("the chain holds neither a trace nor Adam's moments")
    if len(set(counts)) != 1:
        raise ValueError(f"the chain's counts disagree: {counts}")
    entries = [opt_state[k] for k in sorted(opt_state, key=int)]
    core = next(i for i, e in enumerate(entries) if {"trace", "mu"} & set(e))
    masked = {"inner_state": {}}
    found.update(
        count=counts[0],
        optimizer="sgd" if "trace" in found else "adam",
        clip=CLIP if core >= 2 and entries[1] == {} else 0.0,
        decay=entries[core - 1] == masked,
        double_bias=core + 2 < len(entries) and entries[core + 2] == masked)
    return found


def to_npz(src: str, dst: str,
           cfg_file: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Write the orbax checkpoint ``src`` as the ``.npz`` ``dst``; returns
    the arrays written."""
    ckpt = load_checkpoint(src)
    params = flatten(ckpt["params"])
    net = infer_net(ckpt["params"])
    out = {f"params/{k}": np.asarray(v) for k, v in params.items()}
    meta = dict(ckpt.get("meta") or {}, net=net)
    if ckpt.get("opt_state") is not None:
        state = chain_state(ckpt["opt_state"])
        for key in STATE_KEYS:
            if key not in state:
                continue
            if set(state[key]) != set(params):
                bad = sorted(set(state[key]) ^ set(params))[0]
                raise KeyError(f"{src}: {key} and params differ at {bad}")
            if key == "trace":
                meta["momentum_dtype"] = str(
                    np.asarray(next(iter(state[key].values()))).dtype)
            out.update((f"opt/{key}/{k}", _float32(v))
                       for k, v in state[key].items())
        out["count"] = np.asarray(state["count"])
        cfg = load_cfg(net, cfg_file)
        meta.update(optimizer=state["optimizer"], clip=state["clip"],
                    weight_decay=(cfg.TRAIN.WEIGHT_DECAY if state["decay"]
                                  else 0.0),
                    double_bias=state["double_bias"])
        meta.setdefault("momentum_dtype", "float32")
    for key in ("step", "epoch", "session"):
        if key in ckpt:
            out[key] = np.asarray(int(np.asarray(ckpt[key])))
    out.update((f"meta/{k}", _meta_array(v)) for k, v in meta.items())
    tmp = f"{dst}.tmp"
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, dst)
    return out


def _agree(name, given, recorded):
    if given is not None and recorded is not None and given != recorded:
        raise ValueError(f"{name} {given!r} disagrees with the file's "
                         f"{recorded!r}")
    return given if given is not None else recorded


def _fill(node: Mapping, flat: Mapping[str, np.ndarray], count: int,
          used: set, path=()) -> Dict[str, Any]:
    """``node`` (a template's flax state dict) with every state leaf taken
    from ``flat`` in the template's dtype."""
    out: Dict[str, Any] = {}
    for k, v in node.items():
        if k in STATE_KEYS:
            leaves = {}
            for p, want in flatten(v).items():
                key = f"opt/{k}/{p}"
                if key not in flat:
                    raise KeyError(f"the file lacks {key}")
                got = flat[key]
                if got.shape != want.shape:
                    raise ValueError(f"{key} has shape {got.shape}, the "
                                     f"params {want.shape}")
                if got.dtype != want.dtype:
                    cast = got.astype(want.dtype)
                    if not np.array_equal(cast.astype(got.dtype), got):
                        raise ValueError(f"{key} holds values that "
                                         f"{want.dtype} does not")
                    got = cast
                leaves[p] = got
                used.add(key)
            out[k] = nest(leaves)
        elif k == "count":
            out[k] = np.asarray(count, v.dtype)
        elif isinstance(v, Mapping):
            out[k] = _fill(v, flat, count, used, path + (k,))
        else:
            raise ValueError(f"unknown template leaf {'/'.join(path)}/{k}")
    return out


def to_orbax(src: str, dst: str, net: Optional[str] = None,
             optimizer: Optional[str] = None,
             bf16_momentum: Optional[bool] = None,
             cfg_file: Optional[str] = None) -> None:
    """Write the ``.npz`` ``src`` as the orbax checkpoint ``dst``, its
    optimizer state laid out as ``build_optimizer``'s chain keeps it."""
    with np.load(src, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    params = nest({k[7:]: v for k, v in flat.items()
                   if k.startswith("params/")})
    if not params:
        raise ValueError(f"{src} holds no params/ entries (a params-only "
                         f".npz carries no train state)")
    meta = {k[5:]: v.item() for k, v in flat.items() if k.startswith("meta/")}
    net = _agree("--net", net, meta.get("net")) or infer_net(params)
    opt_state = None
    if any(k.startswith("opt/") for k in flat):
        optimizer = _agree("--o", optimizer, meta.get("optimizer")) or "sgd"
        dtype = meta.get("momentum_dtype")
        bf16 = _agree("--bf16_momentum", bf16_momentum,
                      None if dtype is None else dtype == "bfloat16")
        cfg = load_cfg(net, cfg_file)
        train = cfg.TRAIN
        wd = train.WEIGHT_DECAY if cfg_file else meta.get(
            "weight_decay", train.WEIGHT_DECAY)
        db = train.DOUBLE_BIAS if cfg_file else meta.get(
            "double_bias", train.DOUBLE_BIAS)
        _agree("weight decay", float(wd), meta.get("weight_decay"))
        _agree("double bias", bool(db), meta.get("double_bias"))
        _agree("clip", CLIP if net == "vgg16" else 0.0, meta.get("clip"))
        cfg = dataclasses.replace(cfg, TRAIN=dataclasses.replace(
            train, WEIGHT_DECAY=float(wd), DOUBLE_BIAS=bool(db)))
        args = SimpleNamespace(lr=0.0, lr_decay_step=0, lr_decay_gamma=1.0,
                               net=net, optimizer=optimizer,
                               bf16_momentum=bool(bf16))
        _, tx = build_optimizer(args, cfg, 1)
        template = jax.eval_shape(tx.init, params)
        used: set = set()
        filled = _fill(serialization.to_state_dict(template), flat,
                       int(flat["count"]), used)
        extra = sorted(k for k in flat if k.startswith("opt/")
                       and k not in used)
        if extra:
            raise KeyError(f"{src}: {extra[0]} has no place in the {optimizer}"
                           f" chain")
        opt_state = serialization.from_state_dict(template, filled)
        meta.update(net=net, optimizer=optimizer, weight_decay=float(wd),
                    double_bias=bool(db),
                    momentum_dtype="bfloat16" if bf16 else "float32")
    save_checkpoint(dst, params=params, opt_state=opt_state,
                    step=int(flat.get("step", 0)),
                    epoch=int(flat.get("epoch", 0)),
                    session=int(flat.get("session", 1)), meta=meta)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="command", required=True)
    a = sub.add_parser("to-npz", help="orbax directory -> .npz")
    a.add_argument("src")
    a.add_argument("dst")
    a.add_argument("--cfg", dest="cfg_file", default=None)
    b = sub.add_parser("to-orbax", help=".npz -> orbax directory")
    b.add_argument("src")
    b.add_argument("dst")
    b.add_argument("--net", default=None)
    b.add_argument("--o", dest="optimizer", default=None,
                   choices=("sgd", "adam"))
    b.add_argument("--bf16_momentum", action="store_true", default=None)
    b.add_argument("--cfg", dest="cfg_file", default=None)
    args = p.parse_args(argv)
    if args.command == "to-npz":
        to_npz(args.src, args.dst, args.cfg_file)
    else:
        to_orbax(args.src, args.dst, args.net, args.optimizer,
                 args.bf16_momentum, args.cfg_file)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
