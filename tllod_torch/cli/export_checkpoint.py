#!/usr/bin/env python
"""Write a port train checkpoint in the ``.npz`` interchange layout
(:mod:`tllod_torch.utils.checkpoint`), the way back to the JAX package.

    python -m tllod_torch.cli.export_checkpoint IN.pth OUT.npz

``IN`` is a checkpoint of any of the port's train CLIs (params, optimizer
state, step, epoch, session, meta) or a bare ``state_dict`` (``.pt``).
Then, where JAX is installed, ``python tools/jax_checkpoint.py to-orbax
OUT.npz ORBAX_DIR --net ...`` writes the orbax directory that the JAX
train CLIs resume (``--r``) and the JAX test CLIs evaluate.
"""

from __future__ import annotations

import argparse

from tllod_torch.utils.checkpoint import load_checkpoint, write_npz


def main(argv=None) -> str:
    """Convert; returns the path written."""
    p = argparse.ArgumentParser(description="Export a port checkpoint as "
                                            "an .npz of the interchange "
                                            "layout")
    p.add_argument("src", help="a port .pth train checkpoint or .pt "
                               "state dict")
    p.add_argument("dst", help="the .npz to write")
    args = p.parse_args(argv)
    if not args.dst.endswith(".npz"):
        p.error("the output must end in .npz")
    ckpt = load_checkpoint(args.src)
    if "params" not in ckpt:
        ckpt = {"params": ckpt}
    write_npz(args.dst, ckpt)
    print(f"wrote {args.dst}")
    return args.dst


if __name__ == "__main__":
    main()
