#!/usr/bin/env python
"""DAF training on the port (``methods/DAF/DAF_train.py`` through
``methods/da_runner.py:31`` ``run_da_training``; reference
``methods/DAF/DAF_train.py``).

    python -m tllod_torch.cli.daf_train --dataset cityscape --net vgg16 \\
        [--max_steps N] [--r True --checkepoch E --checkpoint S] \\
        [--device cpu]

Each step runs the source and target forwards, the six DA losses, the
backward and the SGD update on the card (``--device cpu`` runs the plain
versions of the kernels). The backbone and box head start from
``vgg16_caffe.pth`` under ``$TLLOD_PRETRAINED_DIR`` when the file is there,
else from random weights seeded with ``cfg.RNG_SEED``. Checkpoints go to
``<save_dir>/<net>/<dataset>/daf_<session>_<epoch>_<step>.pth``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tllod_torch.cli.common import (DATASET_MAP, MetricLogger,
                                    build_train_parser, check_train_args,
                                    resolve_config)
from tllod_torch.data.loader import DetectionLoader
from tllod_torch.data.roidb import combined_roidb
from tllod_torch.methods.daf import DAFModel, daf_loss
from tllod_torch.train import train_step
from tllod_torch.utils.checkpoint import resume_train_state, save_checkpoint
from tllod_torch.utils.optim import build_optimizer
from tllod_torch.zoo import load_pretrained_backbone


def _to_device(batch, device):
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def main(argv=None) -> int:
    """Train; returns the last step reached."""
    args = build_train_parser("Train a DAF network (PyTorch)").parse_args(argv)
    check_train_args(args)
    print("Called with args:", args)
    cfg = resolve_config(args)
    np.random.seed(cfg.RNG_SEED)

    ds = DATASET_MAP[args.dataset]
    s_ds, s_roidb, _, _ = combined_roidb(ds["s_imdb"])
    _, t_roidb, _, _ = combined_roidb(ds["t_imdb"])
    print(f"source {len(s_roidb)} target {len(t_roidb)} roidb entries")
    s_loader = DetectionLoader(s_roidb, cfg, batch_size=args.batch_size,
                               domain=1, seed=cfg.RNG_SEED,
                               num_workers=args.num_workers)
    t_loader = DetectionLoader(t_roidb, cfg, batch_size=args.batch_size,
                               domain=0, seed=cfg.RNG_SEED + 1,
                               num_workers=args.num_workers)

    model = DAFModel(s_ds.num_classes, cfg, args.net, args.class_agnostic,
                     device=args.device, seed=cfg.RNG_SEED)
    load_pretrained_backbone(model.detector, args.net)
    steps_per_epoch = min(len(s_loader), len(t_loader))
    schedule, opt = build_optimizer(args, cfg, model, steps_per_epoch)

    output_dir = os.path.join(args.save_dir, args.net, args.dataset)
    os.makedirs(output_dir, exist_ok=True)
    step = 0
    if args.resume:
        path = os.path.join(output_dir, f"daf_{args.checksession}_"
                            f"{args.checkepoch}_{args.checkpoint}.pth")
        ckpt_epoch, step = resume_train_state(model, opt, path)
        args.start_epoch = ckpt_epoch + 1
        print(f"resumed from {path} (epoch {ckpt_epoch}, step {step})")

    logger = MetricLogger(args.disp_interval, jsonl_path=(
        os.path.join(output_dir, "metrics.jsonl") if args.use_tfboard
        else None))
    s_it, t_it = iter(s_loader), iter(t_loader)
    try:
        for epoch in range(args.start_epoch, args.max_epochs + 1):
            todo = steps_per_epoch
            if args.max_steps:
                todo = min(todo, max(0, args.max_steps - step))
            for _ in range(todo):
                src = _to_device(next(s_it), model.device)
                tgt = _to_device(next(t_it), model.device)
                metrics = train_step(model, lambda out: daf_loss(
                    out, args.lamda), opt, (src, tgt), seed=cfg.RNG_SEED,
                    step=step)
                step += 1
                logger.update(step, epoch, schedule(step - 1), metrics)
            done = ((args.max_steps and step >= args.max_steps)
                    or epoch == args.max_epochs)
            if done or epoch % max(1, args.save_epoch_interval) == 0:
                path = os.path.join(output_dir, f"daf_{args.session}_"
                                    f"{epoch}_{step}.pth")
                save_checkpoint(path, model=model, optimizer=opt, step=step,
                                epoch=epoch, session=args.session,
                                meta={"pooling_mode": cfg.POOLING_MODE,
                                      "class_agnostic": args.class_agnostic,
                                      "net": args.net})
                print(f"saved checkpoint for epoch {epoch}: {path}")
            if done:
                break
    finally:
        logger.close()
    return step


if __name__ == "__main__":
    main()
