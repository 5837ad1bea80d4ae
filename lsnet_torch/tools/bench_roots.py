"""The harness of the parent-vs-change tools (``bench_k1``, ``bench_probes``):
one process per checkout, so that several versions compare inside one call
on one card, and patched copies of this checkout for split readings.

A root is a directory holding ``lsnet_torch/``: this checkout, a patched
copy, or a parent unpacked with ``git archive <commit> lsnet_torch | tar -x
-C build/parent``. Its process imports the port from the root and the
measuring code (``chip_smoke.py``'s timing and input functions) from this
checkout, so that every root is timed the same way.

A tool gives its docstring, a ``time_root(root)`` that returns the rows of
one checkout as a JSON-able dict, its split table (name -> [(file under
``lsnet_torch/csrc/``, text, replacement)]) and the directory under
``build/`` that holds the patched copies. ``main`` takes ``--roots DIR
...`` (this checkout by default) and ``--split [NAME ...]`` (every
patched copy, or the ones named), prints one JSON line per
root, the card's name and power limit, and last one JSON line with every
root's rows.
"""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_split(splits, subdir, name):
    """A copy of this checkout's port, under build/<subdir>/<name>/, with
    the patches splits[name]."""
    root = os.path.join(REPO, "build", subdir, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "lsnet_torch"),
                    os.path.join(root, "lsnet_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in splits[name]:
        path = os.path.join(root, "lsnet_torch", "csrc", fname)
        with open(path) as f:
            src = f.read()
        if old not in src:
            raise ValueError(f"split {name}: {fname} no longer holds "
                             f"{old!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return root


def import_root(root):
    """In the process of a root: the port imported from root, and this
    checkout's chip_smoke module, returned. chip_smoke puts this checkout
    first on sys.path, but the package ``lsnet_torch`` is then the root's
    already, and every ``lsnet_torch.*`` it imports resolves under it."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import lsnet_torch
    if os.path.dirname(os.path.abspath(lsnet_torch.__file__)) != os.path.join(
            root, "lsnet_torch"):
        raise ImportError(f"lsnet_torch came from {lsnet_torch.__file__}, "
                          f"not from {root}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def main(tool_file, doc, time_root, splits, subdir, argv=None):
    """The command line of the tool at tool_file (see the module's
    docstring)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[REPO])
    ap.add_argument("--split", nargs="*", default=None,
                    help="time patched copies too: the ones named, or all")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.one:
        print(json.dumps(time_root(opts.one)), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in opts.roots]
    if opts.split is not None:
        for name in opts.split:
            if name not in splits:
                raise SystemExit(f"unknown split {name!r}: want one of "
                                 f"{sorted(splits)}")
        roots += [make_split(splits, subdir, name)
                  for name in opts.split or splits]
    tool = os.path.splitext(os.path.basename(tool_file))[0]
    results = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(tool_file),
                               "--one", root], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"{tool}: {root} failed")
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        label = os.path.relpath(root, REPO)
        print(json.dumps({"root": label, "rows": rows}), flush=True)
        results.append({"root": label, "rows": rows})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"card": card, "results": results}), flush=True)
    return 0
