#!/usr/bin/env python
"""DAF evaluation on the port (``methods/DAF/DAF_test.py``): the
checkpoint's detector subset through the vanilla detector.

    python -m tllod_torch.cli.daf_test --dataset cityscape --net vgg16 \\
        --part test_t --load_name CKPT.pth [--eval_bs 4] [--device cpu]

``--part test_all`` evaluates the dataset's ``all_test`` split where it
has one (:func:`tllod_torch.cli.da_runner.run_da_eval`).
"""

from __future__ import annotations

from tllod_torch.cli.common import build_test_parser
from tllod_torch.cli.da_runner import run_da_eval


def main(argv=None) -> dict:
    """Evaluate; returns the AP dict."""
    args = build_test_parser("Evaluate a DAF network (PyTorch)"
                             ).parse_args(argv)
    return run_da_eval(args)


if __name__ == "__main__":
    main()
