#!/usr/bin/env python3
"""Phase 8d of ``chip_smoke.py`` (mamba2-1.3b and hymba-1.5b trained at
full width and depth on one card) on two or more source trees, one process
a tree: each step's loss and grad norm bit for bit, the step times and the
allocator's peak, tree against tree.

    python3 scripts/train_trees.py --trees build/parent .

A tree is a checkout, or an unpacked ``git archive``, whose ``src/`` holds
``repro_torch`` (unpack the parent under ``build/``, which ``.gitignore``
lists).  Each run is this checkout's ``chip_smoke.ssm_train_phase`` with
the tree's ``src`` first on ``sys.path``, so that the phase runs the
tree's code.  Prints the phase's record of each arch and tree, and one
JSON line an arch saying whether the trees gave the same bits; exits
non-zero when they differ, when a tree's phase fails, and without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAG = "[train] 8d "  # the prefix of ssm_train_phase's record lines


def one(tree: str) -> None:
    """Phase 8d on ``tree``'s ``repro_torch``; its lines go to stdout."""
    sys.path[:0] = [os.path.join(os.path.abspath(tree), "src"), ROOT]
    import chip_smoke
    import repro_torch

    chip_smoke.ssm_train_phase(argparse.Namespace(seed=0), chip_smoke.check)
    print(json.dumps({"package": os.path.dirname(repro_torch.__file__)}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.one)
        return
    if len(args.trees) < 2:
        ap.error("give two trees or more: one has nothing to be held to")
    import torch

    if not torch.cuda.is_available():
        sys.exit("train_trees.py needs an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    runs = {}
    for tree in args.trees:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--trees", tree,
             "--one", tree], capture_output=True, text=True, cwd=ROOT)
        lines = out.stdout.splitlines()
        if out.returncode:
            sys.exit(f"{tree}: phase 8d failed\n{out.stdout}{out.stderr}")
        pkg = json.loads(lines[-1])["package"]
        for line in lines:
            if line.startswith(TAG):
                rec = json.loads(line[len(TAG):])
                rec.update(tree=tree, package=pkg)
                runs.setdefault(rec["arch"], []).append(rec)
                print(json.dumps(rec), flush=True)
    same = True
    for arch, recs in runs.items():
        bits = {(tuple(r["losses_hex"]), tuple(r["grad_norms_hex"]))
                for r in recs}
        ok = len(recs) == len(args.trees) and len(bits) == 1
        print(json.dumps({"arch": arch, "trees": args.trees, "bit_equal": ok,
                          "peak_bytes": [r["peak_bytes"] for r in recs]}),
              flush=True)
        same &= ok
    if not same:
        sys.exit("the trees' losses or grad norms differ")


if __name__ == "__main__":
    main()
