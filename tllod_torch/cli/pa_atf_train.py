#!/usr/bin/env python
"""PA-ATF training on the port (``methods/PA_ATF/PA_ATF_train.py``): ATF's
tri-way training with partial-alignment masks and the CLUB heads.

    python -m tllod_torch.cli.pa_atf_train --dataset cityscape --net vgg16 \\
        [--beta 0.1] [--source_intra] [--max_steps N] [--device cpu]

``--beta`` weighs the CLUB loss; ``--source_intra`` pools the CLUB gt-RoI
features from the main branch (``club_branch="main"``); ``--use_ins`` is
parsed and ignored, as upstream. The loop and the checkpoints
(``pa_atf_<session>_<epoch>_<step>.pth``, which ``pa_atf_test`` evaluates)
are those of :mod:`tllod_torch.cli.daf_train`; the pretrained backbone
also fills ``backbone_anc``.
"""

from __future__ import annotations

from tllod_torch.cli.common import build_train_parser
from tllod_torch.cli.da_runner import run_da_training
from tllod_torch.methods.pa_atf import PAATFModel, pa_atf_loss


def main(argv=None) -> int:
    """Train; returns the last step reached."""
    parser = build_train_parser("Train a PA-ATF network (PyTorch)")
    parser.add_argument("--beta", default=0.1, type=float,
                        help="pm (CLUB) loss weight")
    parser.add_argument("--source_intra", action="store_true",
                        help="vgg16_source_intra variant: CLUB pools gt-RoI "
                             "features from the main branch")
    parser.add_argument("--use_ins", dest="ins", action="store_true",
                        help="parsed but never consumed upstream; ignored")
    args = parser.parse_args(argv)
    return run_da_training(
        "pa_atf", PAATFModel,
        lambda a: (lambda out: pa_atf_loss(out, a.lamda, a.beta)), args,
        extra_model_kwargs={"club_branch": ("main" if args.source_intra
                                            else "ancillary")},
        extra_backbone_subtrees=("backbone_anc",))


if __name__ == "__main__":
    main()
