#!/usr/bin/env python
"""IDF evaluation on the port (``methods/IDF/IDF_test.py``). Unlike every
other method, IDF tests with its own dual-branch model (``IDF_test.py:
157-164``): both branches run, and the detector's RPN and head take the
attended invariant map (:class:`tllod_torch.methods.idf.IDFInfer`).

    python -m tllod_torch.cli.idf_test --dataset cityscape --net vgg16 \\
        --part test_t --load_name idf_1_1_N.pth [--eval_bs 4] [--device cpu]

``--part test_s`` evaluates the dataset's ``s_test`` split and any other
part its ``t_test``: IDF's own map, which has no ``test_all``.
``--load_name`` takes an ``idf_train`` checkpoint (``.pth``), a port
state dict of the whole model (``.pt``), a checkpoint in the ``.npz``
interchange layout (:mod:`tllod_torch.utils.checkpoint`), or an ``.npz``
of the JAX model's flattened params (``detector/backbone/conv1_1/kernel``,
..., ``backbone_b/...``). ``--gamma`` and ``--eta`` are accepted as JAX's
script takes them; the eval forward reads neither.
"""

from __future__ import annotations

import os

import numpy as np

from tllod_torch.cli.common import (DATASET_MAP, build_test_parser,
                                    resolve_config, setup_parallel)
from tllod_torch.data.roidb import combined_roidb
from tllod_torch.eval_engine import evaluate_model
from tllod_torch.methods.idf import IDFInfer, IDFModel
from tllod_torch.utils.checkpoint import load_exact, load_params


def load_idf_weights(model: IDFModel, path: str) -> None:
    load_exact(model, load_params(path, model.device))


def main(argv=None) -> dict:
    """Evaluate; returns the AP dict."""
    parser = build_test_parser("Evaluate an IDF network (PyTorch)")
    parser.add_argument("--gamma", default=5.0, type=float)
    parser.add_argument("--eta", default=1.0, type=float)
    args = parser.parse_args(argv)
    setup_parallel(args, args.shard_eval)
    cfg = resolve_config(args)
    np.random.seed(cfg.RNG_SEED)

    split = {"test_s": "s_test", "test_t": "t_test"}.get(args.part, "t_test")
    imdb = DATASET_MAP[args.dataset][split]
    dataset, roidb, _, _ = combined_roidb(imdb, training=False,
                                          use_flipped=False)
    print(f"{len(roidb)} roidb entries for {imdb}")
    model = IDFModel(dataset.num_classes, cfg, args.net, args.class_agnostic,
                     eta=args.eta, gamma=args.gamma, device=args.device)
    ckpt = args.load_name or args.model_dir
    assert ckpt, "--load_name checkpoint path required"
    load_idf_weights(model, ckpt)
    return evaluate_model(IDFInfer(model), dataset, roidb, cfg,
                          os.path.join(args.output_dir, args.net,
                                       args.dataset),
                          max_per_image=args.max_per_image,
                          class_agnostic=args.class_agnostic,
                          vis=args.vis, eval_batch=args.eval_bs)


if __name__ == "__main__":
    main()
