#!/usr/bin/env python
"""ATF training on the port (``methods/ATF/ATF_train.py``): asymmetric
tri-way training with an ancillary backbone branch.

    python -m tllod_torch.cli.atf_train --dataset cityscape --net vgg16 \\
        [--max_steps N] [--device cpu]

The flags, the loop and the checkpoints (``atf_<session>_<epoch>_<step>
.pth``) are those of :mod:`tllod_torch.cli.daf_train`; the pretrained
backbone also fills ``backbone_anc``.
"""

from __future__ import annotations

from tllod_torch.cli.common import build_train_parser
from tllod_torch.cli.da_runner import run_da_training
from tllod_torch.methods.atf import ATFModel, atf_loss


def main(argv=None) -> int:
    """Train; returns the last step reached."""
    args = build_train_parser("Train an ATF network (PyTorch)").parse_args(
        argv)
    return run_da_training(
        "atf", ATFModel, lambda a: (lambda out: atf_loss(out, a.lamda)),
        args, extra_backbone_subtrees=("backbone_anc",))


if __name__ == "__main__":
    main()
