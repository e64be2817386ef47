#!/usr/bin/env python
"""MAD evaluation on the port (``methods/MAD/MAD_test.py``): the
checkpoint's detector subset through the vanilla detector on the held-out
split; domain generalization tests on the unseen domain.

    python -m tllod_torch.cli.mad_test --dataset cityscape --part test_t \\
        --load_name mad_1_1_N.pth [--device cpu]
"""

from __future__ import annotations

from tllod_torch.cli.common import build_test_parser
from tllod_torch.cli.da_runner import run_da_eval


def main(argv=None) -> dict:
    """Evaluate; returns the AP dict."""
    return run_da_eval(build_test_parser(
        "Evaluate a MAD network (PyTorch)").parse_args(argv))


if __name__ == "__main__":
    main()
