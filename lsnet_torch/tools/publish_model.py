"""Prepare a trained checkpoint for publication (the port's
``tools/publish_model.py``).

    python3 -m lsnet_torch.tools.publish_model IN_FILE OUT_FILE

``IN_FILE`` is a runner checkpoint (``step_N.pt``). The output keeps the
step, the model's weights and the train meta, drops the optimizer state,
and is named from its content: ``<OUT_FILE>-<sha256[:8]>.pth`` (a
trailing ``.pth`` of ``OUT_FILE`` is dropped first). It loads as a
checkpoint does: ``apis.init_detector(config, published)`` and
``lsnet_torch.tools.test CONFIG published``. Host only: it needs no
device.
"""

from __future__ import annotations

import argparse
import hashlib
import os


def process_checkpoint(in_file: str, out_file: str) -> str:
    """Write the slim copy of ``in_file`` and return its final path."""
    import torch

    from ..train.checkpoint import load_checkpoint

    ckpt = load_checkpoint(in_file)
    # keep only what inference needs: the reference deletes 'optimizer'
    slim = {k: ckpt[k] for k in ("step", "model", "meta") if k in ckpt}
    if out_file.endswith(".pth"):
        out_file = out_file[:-4]
    tmp = out_file + ".tmp.pth"
    torch.save(slim, tmp)
    with open(tmp, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    final = f"{out_file}-{sha[:8]}.pth"
    os.replace(tmp, final)
    return final


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Process a checkpoint to be published")
    parser.add_argument("in_file", help="input checkpoint (step_N.pt)")
    parser.add_argument("out_file", help="output filename (.pth)")
    args = parser.parse_args(argv)
    final = process_checkpoint(args.in_file, args.out_file)
    print(f"published: {final}")
    return final


if __name__ == "__main__":
    main()
