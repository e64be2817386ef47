#!/usr/bin/env python
"""Vanilla Faster R-CNN evaluation on the port
(``methods/faster_rcnn/faster_rcnn_test.py``; reference
``methods/faster_rcnn/faster_rcnn_test.py``).

    python -m tllod_torch.cli.faster_rcnn_test --dataset cityscape \\
        --net vgg16 --load_name weights.pt [--eval_bs 4] [--device cpu]

``--load_name`` takes a port state dict (``torch.save(model.state_dict())``,
``.pt``) or an ``.npz`` of flattened JAX params whose keys are the flax paths
(``backbone/conv1_1/kernel``, ...); method-only subtrees are dropped.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tllod_torch.cli.common import DATASET_MAP, build_test_parser, resolve_config
from tllod_torch.data.roidb import combined_roidb
from tllod_torch.eval_engine import evaluate_model
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.zoo import load_jax_params


def load_weights(model: FasterRCNN, path: str) -> None:
    if path.endswith(".npz"):
        with np.load(path) as z:
            load_jax_params(model, {k: z[k] for k in z.files})
    else:
        sd = torch.load(path, map_location=model.device, weights_only=True)
        model.load_state_dict(sd, strict=True)


def main(argv=None):
    args = build_test_parser("Evaluate a Faster R-CNN network (PyTorch)"
                             ).parse_args(argv)
    if args.shard_eval or args.vis:
        raise NotImplementedError("--shard_eval and --vis are not ported yet")
    cfg = resolve_config(args)
    np.random.seed(cfg.RNG_SEED)

    ds = DATASET_MAP[args.dataset]
    split = {"test_s": "s_test", "test_t": "t_test"}.get(args.part, "t_test")
    dataset, roidb, _, _ = combined_roidb(ds[split], training=False,
                                          use_flipped=False)
    model = FasterRCNN(num_classes=dataset.num_classes, cfg=cfg,
                       net=args.net, class_agnostic=args.class_agnostic,
                       device=args.device)
    ckpt = args.load_name or args.model_dir
    assert ckpt, "--load_name weights path required"
    load_weights(model, ckpt)
    return evaluate_model(model, dataset, roidb, cfg,
                          os.path.join(args.output_dir, args.net,
                                       args.dataset),
                          max_per_image=args.max_per_image,
                          class_agnostic=args.class_agnostic,
                          eval_batch=args.eval_bs)


if __name__ == "__main__":
    main()
