"""The generic two-stream (source + target) DA train loop and the DA eval
(``methods/da_runner.py:31-225``). Each method's train and test CLI is a
thin wrapper: the train CLI names its model, its loss and its extra flags;
every test CLI evaluates the checkpoint's detector (:func:`run_da_eval`).
:func:`train_loop` is the epoch loop itself, which the one-stream
``faster_rcnn_train`` runs too.

As in the JAX scripts, each loader's first batch is drawn and dropped before
the loop (JAX spends it on ``model.init``, ``da_runner.py:79-84``), so step
k trains on loader batch k + 1; and the learning rate logged after step k
is ``schedule(k)``, the rate of the next update (``:153-158``).

``--fuse_steps K`` runs K steps per host iteration through
:class:`tllod_torch.train.TrainStepMulti` (on the card, CUDA-graph replays
of the whole step) on K batches from each loader padded to one shape, and
the rest of an epoch step by step, as ``methods/da_runner.py:130-160``.
``--profile N`` traces steps [10, 10 + N) into ``<output dir>/profile``.

``--bf16`` builds the model with bfloat16 layers (``methods/da_runner.py:
75-76``, the only JAX runner that passes a ``dtype``); parameters, the
optimizer and checkpoints stay float32. PT-MAF's JAX script builds its
model itself without one, so its CLI passes ``honours_bf16=False`` and
trains in float32 under ``--bf16``, as do the MAD, IDF and supervised
CLIs, which run :func:`train_loop` directly.

Under a process group (``--mGPUs``, or the ``TLLOD_DIST_*`` launch, joined
in :func:`tllod_torch.cli.common.check_train_args` before the model and
the loaders), each rank streams its strided roidb shard at ``--bs /
world`` images (:func:`tllod_torch.data.loader.train_loader`), its padded
image shape agreed with the other ranks'
(:func:`tllod_torch.parallel.dist.sync_image_shapes`), and each step is
the single-process step of the global batch (:mod:`tllod_torch.train`).
Under ``--tp`` (and ``--sp``) the ranks form a ``(data, model)`` grid:
:func:`train_loop` cuts the model to this rank's shards
(:func:`tllod_torch.parallel.mesh.parallelize`) before the optimizer is
built, the ranks of a model group stream the same images, and the
checkpoint holds full tensors. Global rank 0 alone logs and writes
checkpoints; every rank resumes from the same file.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tllod_torch.cli.common import (DATASET_MAP, MetricLogger, StepProfiler,
                                    check_train_args, resolve_config,
                                    stack_batches)
from tllod_torch.cli.faster_rcnn_test import evaluate_split
from tllod_torch.data.loader import DetectionLoader, train_loader
from tllod_torch.data.roidb import combined_roidb
from tllod_torch.parallel import dist
from tllod_torch.parallel.mesh import parallelize
from tllod_torch.train import TrainStepMulti, train_step
from tllod_torch.utils.checkpoint import resume_train_state, save_checkpoint
from tllod_torch.utils.optim import build_optimizer
from tllod_torch.zoo import load_pretrained_backbone


def _to_device(batch, device):
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def run_da_training(method_name: str, model_ctor: Callable,
                    loss_builder: Callable, args, *,
                    extra_model_kwargs: Optional[dict] = None,
                    extra_backbone_subtrees: Sequence[str] = (),
                    step_inputs: Optional[Callable] = None,
                    meta: Optional[dict] = None,
                    honours_bf16: bool = True) -> int:
    """Train ``model_ctor(num_classes, cfg, net, class_agnostic, device=,
    seed=, **extra_model_kwargs)`` on the dataset's source and target
    loaders with ``loss_builder(args)(out)``; returns the last step reached.

    The detector's backbone and head start from the net's caffe-pretrained
    file when it is there (:func:`tllod_torch.zoo.load_pretrained_backbone`),
    and so do the bare backbones named in ``extra_backbone_subtrees``.
    ``step_inputs(model)``, called once after that, gives extra positional
    arguments passed to the model every step after ``(src, tgt)`` (PT-MAF's
    teacher). Checkpoints go to ``<save_dir>/<net>/<dataset>/<method_name>_
    <session>_<epoch>_<step>.pth``, with ``meta`` added to theirs. Under
    ``--bf16`` the model gets ``dtype=torch.bfloat16`` when
    ``honours_bf16``."""
    check_train_args(args)
    print("Called with args:", args)
    cfg = resolve_config(args)
    np.random.seed(cfg.RNG_SEED)

    ds = DATASET_MAP[args.dataset]
    s_ds, s_roidb, _, _ = combined_roidb(ds["s_imdb"])
    _, t_roidb, _, _ = combined_roidb(ds["t_imdb"])
    print(f"source {len(s_roidb)} target {len(t_roidb)} roidb entries")
    s_loader = train_loader(s_roidb, cfg, batch_size=args.batch_size,
                            domain=1, seed=cfg.RNG_SEED,
                            num_workers=args.num_workers)
    t_loader = train_loader(t_roidb, cfg, batch_size=args.batch_size,
                            domain=0, seed=cfg.RNG_SEED + 1,
                            num_workers=args.num_workers)

    kw = dict(extra_model_kwargs or {})
    if honours_bf16 and args.bf16:
        kw["dtype"] = torch.bfloat16
    model = model_ctor(s_ds.num_classes, cfg, args.net, args.class_agnostic,
                       device=args.device, seed=cfg.RNG_SEED, **kw)
    load_pretrained_backbone(model.detector, args.net)
    for sub in extra_backbone_subtrees:
        # ATF's ancillary branch starts as a copy of the pretrained
        # backbone (reference lib/ATF/vgg16.py:48 deepcopy)
        load_pretrained_backbone(getattr(model, sub), args.net)
    extra = tuple(step_inputs(model)) if step_inputs else ()
    return train_loop(method_name, model, loss_builder(args),
                      (s_loader, t_loader),
                      lambda src, tgt: (src, tgt, *extra), args, cfg,
                      meta=meta)


def resume_path(output_dir: str, name: str) -> str:
    """The checkpoint ``--r`` resumes from: ``name`` under ``output_dir``
    as given where it ends in ``.pth`` or ``.npz``, else ``name.pth``, or
    ``name.npz`` (the interchange layout, :mod:`tllod_torch.utils.
    checkpoint`) where there is no ``.pth``."""
    if name.endswith((".pth", ".npz")):
        return os.path.join(output_dir, name)
    paths = [os.path.join(output_dir, name + ext) for ext in (".pth", ".npz")]
    for path in paths:
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no checkpoint {paths[0]} nor {paths[1]}")


def train_loop(method_name: str, model, loss_fn: Callable,
               loaders: Sequence[DetectionLoader], step_args: Callable,
               args, cfg, *, meta: Optional[dict] = None,
               epoch_batches: Optional[Callable] = None,
               after_step: Optional[Callable] = None) -> int:
    """The epoch loop every train CLI runs: ``min(len(loader))`` steps an
    epoch, each ``train_step`` on ``step_args(*batches)``, one device batch
    from each loader; the reference SGD from ``args``; ``--r`` resume, from
    ``args.loadname`` under the output dir when it is given, else
    ``<method>_<checksession>_<checkepoch>_<checkpoint>``, a ``.pth`` or an
    ``.npz`` (:func:`resume_path`);
    a checkpoint every ``--save_epoch_interval`` epochs and at the end.
    ``epoch_batches(epoch, batches)``, called on each step's host batches
    before they go to the device, adds per-epoch fields to them (MAD's
    ``epoch``, IDF's ``separation``); ``after_step(step, epoch, metrics)``
    sees each step's metrics, still on the device (IDF's records).
    ``--fuse_steps K`` takes K steps at a time through
    :class:`TrainStepMulti` while K or more are left in the epoch, each
    loader's K batches padded to one shape (:func:`stack_batches`), and
    the rest one by one. Returns the last step reached."""
    steps_per_epoch = min(len(loader) for loader in loaders)
    parallelize(model, sp=getattr(args, "sp", False))
    schedule, opt = build_optimizer(args, cfg, model, steps_per_epoch)

    output_dir = os.path.join(args.save_dir, args.net, args.dataset)
    os.makedirs(output_dir, exist_ok=True)
    step = 0
    if args.resume:
        path = resume_path(output_dir, getattr(args, "loadname", None) or (
            f"{method_name}_{args.checksession}_{args.checkepoch}_"
            f"{args.checkpoint}"))
        ckpt_epoch, step = resume_train_state(model, opt, path)
        args.start_epoch = ckpt_epoch + 1
        print(f"resumed from {path} (epoch {ckpt_epoch}, step {step})")

    logger = MetricLogger(args.disp_interval, jsonl_path=(
        os.path.join(output_dir, "metrics.jsonl") if args.use_tfboard
        else None))
    fuse = max(1, args.fuse_steps)
    runner = (TrainStepMulti(model, loss_fn, opt, seed=cfg.RNG_SEED)
              if fuse > 1 else None)
    profiler = (StepProfiler(os.path.join(output_dir, "profile"),
                             args.profile) if args.profile > 0 else None)
    its = [iter(loader) for loader in loaders]
    for it in its:               # JAX's model.init batches, dropped
        next(it)

    def host_batches(epoch):
        batches = [dist.sync_image_shapes(next(it)) for it in its]
        if epoch_batches is not None:
            batches = epoch_batches(epoch, batches)
        return batches

    def finish(step, epoch, metrics):
        if profiler is not None:
            profiler.tick(step)
        if after_step is not None:
            after_step(step, epoch, metrics)

    try:
        for epoch in range(args.start_epoch, args.max_epochs + 1):
            todo = steps_per_epoch
            if args.max_steps:
                todo = min(todo, max(0, args.max_steps - step))
            while todo > 0:
                if runner is not None and todo >= fuse:
                    steps = [host_batches(epoch) for _ in range(fuse)]
                    padded = [stack_batches([s[i] for s in steps])
                              for i in range(len(its))]
                    metrics = runner(step, [
                        step_args(*[_to_device(p[k], model.device)
                                    for p in padded])
                        for k in range(fuse)])
                    logger.update_many(step + fuse, epoch, schedule, metrics)
                    for k in range(fuse):
                        finish(step + k + 1, epoch,
                               {key: v[k] for key, v in metrics.items()})
                    step += fuse
                    todo -= fuse
                    continue
                batches = [_to_device(b, model.device)
                           for b in host_batches(epoch)]
                metrics = train_step(model, loss_fn, opt,
                                     step_args(*batches),
                                     seed=cfg.RNG_SEED, step=step)
                step += 1
                todo -= 1
                logger.update(step, epoch, schedule(step), metrics)
                finish(step, epoch, metrics)
            done = ((args.max_steps and step >= args.max_steps)
                    or epoch == args.max_epochs)
            if done or epoch % max(1, args.save_epoch_interval) == 0:
                path = os.path.join(output_dir, f"{method_name}_"
                                    f"{args.session}_{epoch}_{step}.pth")
                if save_checkpoint(
                        path, model=model, optimizer=opt, step=step,
                        epoch=epoch, session=args.session,
                        meta={"pooling_mode": cfg.POOLING_MODE,
                              "class_agnostic": args.class_agnostic,
                              "net": args.net, **(meta or {})}):
                    print(f"saved checkpoint for epoch {epoch}: {path}")
            if done:
                break
    finally:
        logger.close()
        if profiler is not None:
            profiler.close()
    return step


def run_da_eval(args) -> dict:
    """Evaluate the detector subset of any DA checkpoint (the per-method
    ``*_test.py``, ``methods/da_runner.py:177-225``) on the split ``--part``
    names: ``test_s`` → ``s_test``, ``test_t`` → ``t_test``, ``test_all`` →
    ``all_test``, or ``t_test`` where the dataset registers no
    ``all_test``; returns the AP dict."""
    split = {"test_s": "s_test", "test_t": "t_test",
             "test_all": "all_test"}.get(args.part, "t_test")
    if split not in DATASET_MAP[args.dataset]:
        split = "t_test"
    return evaluate_split(args, split)
