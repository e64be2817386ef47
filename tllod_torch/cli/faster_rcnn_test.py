#!/usr/bin/env python
"""Vanilla Faster R-CNN evaluation on the port
(``methods/faster_rcnn/faster_rcnn_test.py``; reference
``methods/faster_rcnn/faster_rcnn_test.py``).

    python -m tllod_torch.cli.faster_rcnn_test --dataset cityscape \\
        --net vgg16 --load_name weights.pt [--eval_bs 4] [--device cpu]

``--load_name`` takes a port state dict (``torch.save(model.state_dict())``,
``.pt``), a train checkpoint of any of the port's train CLIs
(``faster_rcnn_train``, ``daf_train``, ``maf_train``, ``atf_train``,
``pt_maf_train``, ``pa_atf_train``, ``us_daf_train``; ``.pth``,
whose ``detector`` subset is loaded, as ``methods/da_runner.py:210-211``
does), a train checkpoint in the ``.npz`` interchange layout
(:mod:`tllod_torch.utils.checkpoint`; ``tools/jax_checkpoint.py to-npz``
writes one from a JAX checkpoint), whose ``detector`` subset is loaded
too, or an ``.npz`` of flattened JAX params whose keys are the flax paths
(``backbone/conv1_1/kernel``, ..., or ``detector/backbone/...``).
"""

from __future__ import annotations

import os

import numpy as np

from tllod_torch.cli.common import (DATASET_MAP, build_test_parser,
                                    resolve_config, setup_parallel)
from tllod_torch.data.roidb import combined_roidb
from tllod_torch.eval_engine import evaluate_model
from tllod_torch.models.faster_rcnn import FasterRCNN
from tllod_torch.utils.checkpoint import (detector_params, load_exact,
                                          load_params)


def load_weights(model: FasterRCNN, path: str) -> None:
    """Load the detector subset of ``path`` (any file the module docstring
    lists) into ``model``; a name or shape that does not match raises."""
    load_exact(model, detector_params(load_params(path, model.device)))


def evaluate_split(args, split: str) -> dict:
    """Evaluate the weights ``args.load_name`` on the dataset's ``split``
    (a key of ``DATASET_MAP[args.dataset]``: ``s_test``, ``t_test`` or
    ``all_test``); returns the AP dict. Under ``--shard_eval`` or the
    ``TLLOD_DIST_*`` launch each rank detects its roidb shard and every
    rank scores the gathered detections (:func:`tllod_torch.eval_engine.
    run_detection`)."""
    setup_parallel(args, args.shard_eval)
    cfg = resolve_config(args)
    np.random.seed(cfg.RNG_SEED)

    imdb = DATASET_MAP[args.dataset][split]
    dataset, roidb, _, _ = combined_roidb(imdb, training=False,
                                          use_flipped=False)
    print(f"{len(roidb)} roidb entries for {imdb}")
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
                          vis=args.vis, eval_batch=args.eval_bs)


def main(argv=None):
    args = build_test_parser("Evaluate a Faster R-CNN network (PyTorch)"
                             ).parse_args(argv)
    # test_all is t_test here, as in the JAX script (faster_rcnn_test.py:30);
    # the DA entries map it to all_test (da_runner.run_da_eval)
    split = {"test_s": "s_test", "test_t": "t_test"}.get(args.part, "t_test")
    return evaluate_split(args, split)


if __name__ == "__main__":
    main()
