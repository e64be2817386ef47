#!/usr/bin/env python
"""US-DAF evaluation on the port (``methods/US_DAF/US_DAF_test.py``): the
checkpoint's detector subset through the vanilla detector, ResNet-101 on
Clipart1k by default.

    python -m tllod_torch.cli.us_daf_test [--net res101] \\
        [--dataset voc_clipart] --load_name CKPT.pth [--device cpu]
"""

from __future__ import annotations

from tllod_torch.cli.common import build_test_parser
from tllod_torch.cli.da_runner import run_da_eval


def main(argv=None) -> dict:
    """Evaluate; returns the AP dict."""
    parser = build_test_parser("Evaluate a US-DAF network (PyTorch)")
    parser.set_defaults(net="res101", dataset="voc_clipart")
    return run_da_eval(parser.parse_args(argv))


if __name__ == "__main__":
    main()
