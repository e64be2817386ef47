#!/usr/bin/env python
"""MAD training on the port (``methods/MAD/MAD_train.py``): domain
generalization on two supervised source views with multi-view adversarial
autoencoders and an epoch-ramped loss weight.

    python -m tllod_torch.cli.mad_train --dataset cityscape --net vgg16 \\
        [--max_steps N] [--device cpu]
    python -m tllod_torch.cli.mad_train --dataset dg_union \\
        --S1_Set cityscape --S2_Set kitti --T_Set foggy ...

``--dataset cityscape`` uses ``train_s`` for both views (two shuffle
streams); ``--dataset dg_union`` composes the reference's imdb names from
``--S1_Set/--S2_Set/--T_Set/--S*_Type/--S*_Part/--DataYear``
(``MAD_train.py:286-293``), which resolve through the DG union label space
(:mod:`tllod_torch.data.union`); ``--s1_imdb/--s2_imdb`` name the sets
outright. The s1 loader has domain 1 and seed ``RNG_SEED``, the s2 loader
domain 0 and seed ``RNG_SEED + 7``; each s1 batch carries the epoch as a
float32 ``(B,)`` array, the weight :func:`tllod_torch.methods.mad.mad_loss`
ramps on. Checkpoints are ``mad_<session>_<epoch>_<step>.pth``; ``--r``
resumes from ``--loadname`` under the output dir when it is given (a
``.pth``, or an ``.npz`` of the interchange layout that ``tools/
jax_checkpoint.py to-npz`` writes from a JAX checkpoint).
``--bf16`` is accepted and the model trains in float32: the JAX
script builds its model without a ``dtype`` (``MAD_train.py``).
"""

from __future__ import annotations

import numpy as np

from tllod_torch.cli.common import (DATASET_MAP, build_train_parser,
                                    check_train_args, resolve_config)
from tllod_torch.cli.da_runner import train_loop
from tllod_torch.data.loader import train_loader
from tllod_torch.data.roidb import combined_roidb
from tllod_torch.methods.mad import MADModel, mad_loss
from tllod_torch.zoo import load_pretrained_backbone


def build_parser():
    parser = build_train_parser("Train a MAD network (PyTorch)")
    parser.add_argument("--s1_imdb", default=None, type=str)
    parser.add_argument("--s2_imdb", default=None, type=str)
    # dg_union: two source sets and a held-out target, each named
    # {Set}_{other}_{other2}_{Type}_{Year}_{Part}
    for view, part in (("S1", "train"), ("S2", "train"), ("T", "test")):
        parser.add_argument(f"--{view}_Set", default="cityscape", type=str)
        parser.add_argument(f"--{view}_Part", default=part, type=str)
        parser.add_argument(f"--{view}_Type", default="s1", type=str)
    parser.add_argument("--DataYear", default="2007", type=str)
    parser.add_argument("--loadname", default=None, type=str,
                        help="with --r: the checkpoint's file name under "
                             "the output dir (.pth or .npz)")
    parser.add_argument("--log_flag", action="store_true",
                        help="alias of --use_tfb")
    parser.add_argument("--mode", default="train_model",
                        choices=("train_model", "test_model"))
    parser.add_argument("--DaraType", dest="DataType", default="s1",
                        type=str, help="parsed and unused, as upstream")
    return parser


def view_names(args):
    """The (s1, s2) imdb names the flags select."""
    if args.dataset == "dg_union":
        return ("_".join([args.S1_Set, args.T_Set, args.S2_Set, args.S1_Type,
                          args.DataYear, args.S1_Part]),
                "_".join([args.S2_Set, args.T_Set, args.S1_Set, args.S2_Type,
                          args.DataYear, args.S2_Part]))
    if args.s1_imdb and args.s2_imdb:
        return args.s1_imdb, args.s2_imdb
    name = DATASET_MAP[args.dataset]["s_imdb"]
    return name, name


def with_epoch(epoch, batches):
    """The epoch weight in each s1 batch, as ``MAD_train.py:149-157``."""
    s1, s2 = batches
    s1["epoch"] = np.full((s1["im_data"].shape[0],), epoch, np.float32)
    return s1, s2


def main(argv=None) -> int:
    """Train; returns the last step reached."""
    args = build_parser().parse_args(argv)
    if args.mode == "test_model":
        raise SystemExit("--mode test_model: use tllod_torch.cli.mad_test "
                         "(this repo splits upstream's single script)")
    if args.log_flag:
        args.use_tfboard = True
    check_train_args(args)
    print("Called with args:", args)
    cfg = resolve_config(args)
    np.random.seed(cfg.RNG_SEED)

    s1_name, s2_name = view_names(args)
    s1_ds, s1_roidb, _, _ = combined_roidb(s1_name)
    s2_ds, s2_roidb, _, _ = combined_roidb(s2_name)
    if s1_ds.classes != s2_ds.classes:
        raise ValueError(
            f"source views must share one label space; use the dg_union "
            f"naming for heterogeneous sets ({s1_ds.classes} vs "
            f"{s2_ds.classes})")
    print(f"s1 {len(s1_roidb)} s2 {len(s2_roidb)} roidb entries, "
          f"{s1_ds.num_classes} classes")
    l1 = train_loader(s1_roidb, cfg, batch_size=args.batch_size,
                      domain=1, seed=cfg.RNG_SEED,
                      num_workers=args.num_workers)
    l2 = train_loader(s2_roidb, cfg, batch_size=args.batch_size,
                      domain=0, seed=cfg.RNG_SEED + 7,
                      num_workers=args.num_workers)

    model = MADModel(s1_ds.num_classes, cfg, args.net, args.class_agnostic,
                     device=args.device, seed=cfg.RNG_SEED)
    load_pretrained_backbone(model.detector, args.net)
    return train_loop("mad", model, lambda out: mad_loss(out, out["epoch"]),
                      (l1, l2), lambda s1, s2: (s1, s2), args, cfg,
                      epoch_batches=with_epoch)


if __name__ == "__main__":
    main()
