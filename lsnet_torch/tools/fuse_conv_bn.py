"""Fuse the FrozenBatchNorm statistics of a checkpoint into its convs
(the port's ``tools/fuse_conv_bn.py``).

    python3 -m lsnet_torch.tools.fuse_conv_bn IN_FILE OUT_FILE

``IN_FILE`` is a runner checkpoint (``step_N.pt``); ``OUT_FILE`` gets the
same entries with the model's weights fused
(:func:`lsnet_torch.train.fuse.fuse_state_dict`, the rule of
``fuse_conv_bn`` read from the state dict's keys). The module tree keeps
its structure, so the same model class loads the output with
``strict=True`` and gives the unfused model's outputs. Host only: it
needs no device.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="fuse Conv and BN layers in a checkpoint")
    parser.add_argument("in_file", help="input checkpoint (step_N.pt)")
    parser.add_argument("out_file", help="output checkpoint")
    args = parser.parse_args(argv)

    import torch

    from ..train.checkpoint import load_checkpoint
    from ..train.fuse import fuse_state_dict

    ckpt = load_checkpoint(args.in_file)
    ckpt["model"], names = fuse_state_dict(ckpt["model"])
    out = os.path.abspath(args.out_file)
    torch.save(ckpt, out + ".tmp")
    os.replace(out + ".tmp", out)
    print(f"fused {len(names)} conv+bn pairs -> {args.out_file}")
    for n in names[:10]:
        print("  ", n)
    if len(names) > 10:
        print(f"   ... and {len(names) - 10} more")
    return names


if __name__ == "__main__":
    main()
