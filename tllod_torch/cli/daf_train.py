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
``<save_dir>/<net>/<dataset>/daf_<session>_<epoch>_<step>.pth``; ``--r``
resumes from that name as a ``.pth`` or, where there is none, as an
``.npz`` of the interchange layout (a JAX checkpoint through ``tools/
jax_checkpoint.py to-npz``).
"""

from __future__ import annotations

from tllod_torch.cli.common import build_train_parser
from tllod_torch.cli.da_runner import run_da_training
from tllod_torch.methods.daf import DAFModel, daf_loss


def main(argv=None) -> int:
    """Train; returns the last step reached."""
    args = build_train_parser("Train a DAF network (PyTorch)").parse_args(argv)
    return run_da_training(
        "daf", DAFModel, lambda a: (lambda out: daf_loss(out, a.lamda)), args)


if __name__ == "__main__":
    main()
