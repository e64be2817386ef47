#!/usr/bin/env python
"""IDF stage-⑤ training on the port (``methods/IDF/IDF_train.py``): the
dual-branch model on the (CycleGAN-translated) source split and the
pseudo-labelled target split.

    python -m tllod_torch.cli.idf_train --dataset cityscape --net vgg16 \\
        [--t_annotations Annotations_pseudo] [--t_split train_t] \\
        [--sep_epoch 3] [--gamma 5] [--ef] [--eta 1] [--device cpu]

Without ``--t_imdb`` the target is ``<t_imdb>_pseudo``, registered here:
the Cityscapes ``--t_split`` images with their annotations read from
``--t_annotations`` under the same root (``IDF_train.py:61-74``; stage ③,
``tllod_torch.cli.generate_pseudo_labels``, writes them). The source
loader has domain 1 and seed ``RNG_SEED``, the target loader domain 0 and
seed ``RNG_SEED + 1``. Each source batch carries the epoch's
``separation``, 1 from ``--sep_epoch`` on and 0 before, which gates
``se_loss``. Both branches start from the caffe-pretrained VGG16 when the
file is there: ``detector.backbone`` and ``detector.head``, then
``backbone_b`` (with ``detector.head`` again), then ``backbone_b`` with
``head_aux`` (``IDF_train.py:100-107``). Every ``--disp_interval`` steps
the step's losses go to ``record_loss.txt`` and its six branch distances
to ``record_dist.txt`` in the output dir (``IDF_train.py:141-159``).
Checkpoints are ``idf_<session>_<epoch>_<step>.pth``; ``--r`` resumes.
``--bf16`` is accepted and the model trains in float32: the JAX
script builds its model without a ``dtype`` (``IDF_train.py``).
"""

from __future__ import annotations

import os

import numpy as np

from tllod_torch.cli.common import (DATASET_MAP, build_train_parser,
                                    check_train_args, resolve_config)
from tllod_torch.cli.da_runner import train_loop
from tllod_torch.data.factory import data_dir, register_dataset
from tllod_torch.data.loader import train_loader
from tllod_torch.data.roidb import combined_roidb
from tllod_torch.data.voc import CLASS_SETS, VOCDetection
from tllod_torch.methods.idf import IDFModel, idf_loss
from tllod_torch.parallel import dist
from tllod_torch.zoo import load_pretrained_backbone


def build_parser():
    parser = build_train_parser("Train an IDF network (PyTorch)")
    parser.add_argument("--gamma", default=5.0, type=float,
                        help="focal gamma (reference --gamma)")
    parser.add_argument("--ef", action="store_true",
                        help="use EFocalLoss instead of FocalLoss")
    parser.add_argument("--eta", default=1.0, type=float,
                        help="GRL strength")
    parser.add_argument("--s_imdb", default=None, type=str,
                        help="fake-source (CycleGAN) split name")
    parser.add_argument("--t_imdb", default=None, type=str,
                        help="pseudo-labeled target split name")
    parser.add_argument("--t_annotations", default="Annotations_pseudo",
                        type=str, help="target annotation subdir")
    parser.add_argument("--t_split", default="train_t", type=str,
                        help="target image-set name (e.g. train_t_aug = "
                             "pseudo-labeled images + stage-④ mosaics)")
    parser.add_argument("--sep_epoch", default=3, type=int,
                        help="epoch from which separation losses activate")
    return parser


def register_pseudo_split(name: str, split: str, annotations: str) -> None:
    """Register ``name``: the Cityscapes ``split`` images with annotations
    read from the ``annotations`` dir beside ``Annotations``."""
    def ctor():
        root = os.path.join(data_dir(), "cityscape", "VOC2007")
        ds = VOCDetection(name, root, split, CLASS_SETS["cityscape"])
        ds.annotation_path = lambda idx: os.path.join(root, annotations,
                                                      idx + ".xml")
        return ds
    register_dataset(name, ctor)


def with_separation(sep_epoch: int):
    """``epoch_batches`` that puts the epoch's ``separation`` in each
    source batch, as ``IDF_train.py:165-172``."""
    def add(epoch, batches):
        src, tgt = batches
        src["separation"] = np.full((src["im_data"].shape[0],),
                                    1.0 if epoch >= sep_epoch else 0.0,
                                    np.float32)
        return src, tgt
    return add


def record_writer(output_dir: str, session: int, steps_per_epoch: int,
                  interval: int):
    """``after_step`` that appends the step's losses to
    ``record_loss.txt`` and its ``dist*`` values to ``record_dist.txt``,
    every ``interval`` steps, in the JAX script's format; under a process
    group, global rank 0 alone (the metrics are the global batch's on every
    rank)."""
    def write(step, epoch, metrics):
        if step % max(1, interval) or dist.global_rank() != 0:
            return
        head = (f"[session {session}][epoch {epoch:2d}]"
                f"[iter {step:4d}/{steps_per_epoch:4d}] ")
        vals = {k: float(v) for k, v in metrics.items()}
        for fname, keep in (("record_loss.txt", False),
                            ("record_dist.txt", True)):
            row = {k: v for k, v in vals.items()
                   if k.startswith("dist") == keep}
            with open(os.path.join(output_dir, fname), "a") as f:
                f.write(head + ", ".join(f"{k}: {v:.4f}"
                                         for k, v in sorted(row.items()))
                        + "\n")
    return write


def main(argv=None) -> int:
    """Train; returns the last step reached."""
    args = build_parser().parse_args(argv)
    check_train_args(args)
    print("Called with args:", args)
    cfg = resolve_config(args)
    np.random.seed(cfg.RNG_SEED)

    ds = DATASET_MAP[args.dataset]
    s_name = args.s_imdb or ds["s_imdb"]
    t_name = args.t_imdb or ds["t_imdb"] + "_pseudo"
    if args.t_imdb is None:
        register_pseudo_split(t_name, args.t_split, args.t_annotations)
    s_ds, s_roidb, _, _ = combined_roidb(s_name)
    _, t_roidb, _, _ = combined_roidb(t_name)
    print(f"source {len(s_roidb)} target(pseudo) {len(t_roidb)} entries")
    s_loader = train_loader(s_roidb, cfg, batch_size=args.batch_size,
                            domain=1, seed=cfg.RNG_SEED,
                            num_workers=args.num_workers)
    t_loader = train_loader(t_roidb, cfg, batch_size=args.batch_size,
                            domain=0, seed=cfg.RNG_SEED + 1,
                            num_workers=args.num_workers)

    model = IDFModel(s_ds.num_classes, cfg, args.net, args.class_agnostic,
                     eta=args.eta, gamma=args.gamma, efocal=args.ef,
                     device=args.device, seed=cfg.RNG_SEED)
    # both branches start from the same pretrained weights
    load_pretrained_backbone(model.detector, args.net)
    load_pretrained_backbone(model.backbone_b, args.net,
                             head=model.detector.head)
    load_pretrained_backbone(model.backbone_b, args.net, head=model.head_aux)

    output_dir = os.path.join(args.save_dir, args.net, args.dataset)
    os.makedirs(output_dir, exist_ok=True)
    steps_per_epoch = min(len(s_loader), len(t_loader))
    return train_loop(
        "idf", model, idf_loss, (s_loader, t_loader),
        lambda src, tgt: (src, tgt), args, cfg,
        epoch_batches=with_separation(args.sep_epoch),
        after_step=record_writer(output_dir, args.session, steps_per_epoch,
                                 args.disp_interval))


if __name__ == "__main__":
    main()
