#!/usr/bin/env python
"""MAF training on the port (``methods/MAF/MAF_train.py``): hierarchical
image DA on the conv3/4/5 taps and confidence-weighted instance DA.

    python -m tllod_torch.cli.maf_train --dataset cityscape --net vgg16 \\
        [--alpha 1.0] [--max_steps N] [--device cpu]

The flags, the loop and the checkpoints (``maf_<session>_<epoch>_<step>
.pth``) are those of :mod:`tllod_torch.cli.daf_train`; ``--alpha`` weighs
the instance losses (reference ``MAF_train.py:108``).
"""

from __future__ import annotations

from tllod_torch.cli.common import build_train_parser
from tllod_torch.cli.da_runner import run_da_training
from tllod_torch.methods.maf import MAFModel, maf_loss


def main(argv=None) -> int:
    """Train; returns the last step reached."""
    parser = build_train_parser("Train a MAF network (PyTorch)")
    parser.add_argument("--alpha", default=1.0, type=float,
                        help="ins_DA loss param (reference MAF_train.py:108)")
    args = parser.parse_args(argv)
    return run_da_training(
        "maf", MAFModel,
        lambda a: (lambda out: maf_loss(out, a.lamda, a.alpha)), args)


if __name__ == "__main__":
    main()
