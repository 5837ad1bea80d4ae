"""Print a fully resolved config, after ``_base_`` inheritance and the
command-line overrides (the port's ``tools/print_config.py``).

    python3 -m lsnet_torch.tools.print_config CONFIG \
        [--options key.sub=value ...]

Host only: it needs no device.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from ..utils.config import Config, DictAction

    parser = argparse.ArgumentParser(description="Print the whole config")
    parser.add_argument("config", help="config file path")
    parser.add_argument("--options", nargs="+", action=DictAction,
                        help="override config keys, e.g. model.head.nv=36")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.options is not None:
        cfg.merge_from_dict(args.options)
    print(f"Config:\n{cfg.pretty_text}")
    return cfg


if __name__ == "__main__":
    main()
