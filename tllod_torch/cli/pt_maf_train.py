#!/usr/bin/env python
"""PT-MAF training on the port (``methods/PT_MAF/PT_MAF_train.py``):
foreground/background-split hierarchical DA and knowledge distillation
from a frozen source-only teacher.

    python -m tllod_torch.cli.pt_maf_train --dataset cityscape --net vgg16 \\
        --teacher_ckpt faster_rcnn.pth [--tmp 3 --high 0.7 --low 0.1] \\
        [--max_steps N] [--device cpu]

``--teacher_ckpt`` takes a port checkpoint (``.pth``, its ``detector``
subset), a port state dict (``.pt``) or an ``.npz`` of flattened JAX
params, as :mod:`tllod_torch.cli.faster_rcnn_test` does.
``--allow_untrained_teacher`` distils from a copy of the student's initial
detector instead; one of the two is required. ``--alpha/--beta/--gamma``
are parsed and, as in the JAX package, reach nothing: the level weights
are fixed at 1. The loop and the checkpoints (``pt_maf_<session>_<epoch>_
<step>.pth``) are those of :mod:`tllod_torch.cli.daf_train`. Under
``--fuse_steps`` the teacher rides among every step's arguments: its
weights are device tensors that each CUDA-graph replay reads in place, so
JAX's scan-invariant argument (``n_invariant``,
``methods/PT_MAF/PT_MAF_train.py:141-147``) needs no counterpart.
"""

from __future__ import annotations

from tllod_torch.cli.common import build_train_parser
from tllod_torch.cli.da_runner import run_da_training
from tllod_torch.cli.faster_rcnn_test import load_weights
from tllod_torch.methods.pt_maf import PTMAFModel, pt_maf_loss
from tllod_torch.models.faster_rcnn import FasterRCNN

NO_TEACHER = ("--teacher_ckpt is required (a trained source-only Faster "
              "R-CNN checkpoint); pass --allow_untrained_teacher to "
              "explicitly KD from the student's own init (tests only)")


def build_teacher(model: PTMAFModel, teacher_ckpt=None) -> FasterRCNN:
    """The frozen teacher beside ``model``: loaded from ``teacher_ckpt``, or
    a copy of the student's detector as it stands."""
    det = model.detector
    teacher = FasterRCNN(det.num_classes, det.cfg, det.net,
                         det.class_agnostic, device=det.device)
    if teacher_ckpt:
        load_weights(teacher, teacher_ckpt)
        print(f"loaded teacher from {teacher_ckpt}")
    else:
        print("WARNING: --allow_untrained_teacher: teacher = student's "
              "initial detector (KD term will be weak)")
        teacher.load_state_dict(det.state_dict())
    return teacher.requires_grad_(False).eval()


def main(argv=None) -> int:
    """Train; returns the last step reached."""
    parser = build_train_parser("Train a PT-MAF network (PyTorch)")
    parser.add_argument("--alpha", default=1.0, type=float)
    parser.add_argument("--beta", default=1.0, type=float)
    parser.add_argument("--gamma", default=1.0, type=float)
    parser.add_argument("--tmp", default=3.0, type=float,
                        help="KD temperature")
    parser.add_argument("--high", default=0.7, type=float)
    parser.add_argument("--low", default=0.1, type=float)
    parser.add_argument("--teacher_ckpt", default=None, type=str,
                        help="source-only Faster R-CNN checkpoint for KD")
    parser.add_argument("--allow_untrained_teacher", action="store_true",
                        help="explicitly allow KD from the student's own "
                             "random/pretrained init (tests only; the "
                             "reference requires a trained baseline, "
                             "PT_MAF_train.py:386-389)")
    args = parser.parse_args(argv)
    if not (args.teacher_ckpt or args.allow_untrained_teacher):
        raise SystemExit(NO_TEACHER)
    return run_da_training(
        "pt_maf", PTMAFModel,
        lambda a: (lambda out: pt_maf_loss(out, a.lamda, out["kd_loss"])),
        args, extra_model_kwargs={"temperature": args.tmp,
                                  "high": args.high, "low": args.low},
        step_inputs=lambda model: (build_teacher(model, args.teacher_ckpt),),
        meta={"teacher_ckpt": (args.teacher_ckpt
                               or "UNTRAINED (student init)")})


if __name__ == "__main__":
    main()
