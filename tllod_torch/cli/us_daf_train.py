#!/usr/bin/env python
"""US-DAF training on the port (``methods/US_DAF/US_DAF_train.py``):
universal DA with scale-aware, margin-filtered instance alignment, VOC →
Clipart1k on ResNet-101 by default.

    python -m tllod_torch.cli.us_daf_train [--net res101] \\
        [--dataset voc_clipart] [--max_steps N] [--device cpu]

The loop and the checkpoints (``us_daf_<session>_<epoch>_<step>.pth``) are
those of :mod:`tllod_torch.cli.daf_train`; the backbone and layer4 head
start from ``resnet101_caffe.pth`` when it is there.
"""

from __future__ import annotations

from tllod_torch.cli.common import build_train_parser
from tllod_torch.cli.da_runner import run_da_training
from tllod_torch.methods.us_daf import USDAFModel, us_daf_loss


def main(argv=None) -> int:
    """Train; returns the last step reached."""
    parser = build_train_parser("Train a US-DAF network (PyTorch)")
    parser.set_defaults(net="res101", dataset="voc_clipart")
    return run_da_training(
        "us_daf", USDAFModel,
        lambda a: (lambda out: us_daf_loss(out, a.lamda)),
        parser.parse_args(argv))


if __name__ == "__main__":
    main()
