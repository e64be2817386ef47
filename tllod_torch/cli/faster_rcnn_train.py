#!/usr/bin/env python
"""Supervised (source-only) Faster R-CNN training on the port
(``methods/faster_rcnn/faster_rcnn_train.py``; reference
``methods/faster_rcnn/faster_rcnn_train.py``).

    python -m tllod_torch.cli.faster_rcnn_train --dataset cityscape \\
        --net vgg16 [--max_steps N] [--r True --checkepoch E --checkpoint S] \\
        [--device cpu]

One stream: each step trains the detector on a batch of the dataset's
source split (``s_imdb``) with ``detection_loss``, an epoch being one pass
of the loader, through the epoch loop of the DA CLIs
(:func:`tllod_torch.cli.da_runner.train_loop`): the loader's first batch is
dropped as JAX spends it on ``model.init``, the logged rate is the next
update's, and the flags that raise there raise here. The backbone and head
start from the net's caffe-pretrained file under ``$TLLOD_PRETRAINED_DIR``
when it is there, else from random weights seeded with ``cfg.RNG_SEED``.
Checkpoints go to ``<save_dir>/<net>/<dataset>/faster_rcnn_<session>_
<epoch>_<step>.pth``: ``faster_rcnn_test --load_name`` evaluates one, and
``pt_maf_train --teacher_ckpt`` takes one as its teacher.
``--bf16`` is accepted and the model trains in float32: the JAX
script builds its model without a ``dtype`` (``faster_rcnn_train.py``).
"""

from __future__ import annotations

import numpy as np

from tllod_torch.cli.common import (DATASET_MAP, build_train_parser,
                                    check_train_args, resolve_config)
from tllod_torch.cli.da_runner import train_loop
from tllod_torch.data.loader import train_loader
from tllod_torch.data.roidb import combined_roidb
from tllod_torch.models.faster_rcnn import FasterRCNN, detection_loss
from tllod_torch.zoo import load_pretrained_backbone


def main(argv=None) -> int:
    """Train; returns the last step reached."""
    args = build_train_parser("Train a Faster R-CNN network (PyTorch)"
                              ).parse_args(argv)
    check_train_args(args)
    print("Called with args:", args)
    cfg = resolve_config(args)
    np.random.seed(cfg.RNG_SEED)

    dataset, roidb, _, _ = combined_roidb(DATASET_MAP[args.dataset]["s_imdb"])
    print(f"{len(roidb)} roidb entries")
    loader = train_loader(roidb, cfg, batch_size=args.batch_size,
                          domain=1, seed=cfg.RNG_SEED,
                          num_workers=args.num_workers)
    model = FasterRCNN(dataset.num_classes, cfg, args.net,
                       args.class_agnostic, device=args.device,
                       seed=cfg.RNG_SEED)
    load_pretrained_backbone(model, args.net)
    return train_loop(
        "faster_rcnn", model, detection_loss, (loader,),
        lambda b: (b["im_data"], b["im_info"], b["gt_boxes"]), args, cfg)


if __name__ == "__main__":
    main()
