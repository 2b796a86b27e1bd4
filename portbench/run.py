#!/usr/bin/env python3
"""Run one benchmark cell of the port's assembler and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line on standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit); the checks are also the last lines on standard error.
Exits non-zero, printing no result, without as many CUDA cards as the cell
asks for, if the port loaded JAX or the JAX package, or on any failure.

A cell on N > 1 cards runs N processes, rank r on card r, joined into one
process group over ``tcp://localhost:<free port>``; this process is rank 0
and the only one that prints a result.  ``--device cpu`` (with a tiny
configuration under ``--root``) rehearses a run on the CPU, over gloo;
``--set key=value ...`` runs the program with its configuration changed
(the control of ``correct``, judged against the configuration as stated);
``--check-all`` has the reference align every candidate pair, not a
sample (the readings of the whole check, PERF.md).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--set", nargs="*", default=[], help=argparse.SUPPRESS)
    p.add_argument("--check-all", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    import json

    from portbench import harness

    root = Path(args.root)
    _, cell, _, _ = harness.load_cell(args.workload, root)
    chips = int(cell["chips"])
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            harness.log("no CUDA device: the benchmark runs on the card only")
            return 3
        if torch.cuda.device_count() < chips:
            harness.log(f"the cell needs {chips} CUDA devices, "
                        f"{torch.cuda.device_count()} present")
            return 3
    port = args.port
    children = []
    if args.rank == 0 and chips > 1:
        port = harness.free_port()
        for r in range(1, chips):
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace),
                   "--device", args.device, "--root", str(root),
                   "--rank", str(r), "--port", str(port), "--set", *args.set]
            children.append(subprocess.Popen(cmd, stdout=subprocess.DEVNULL))
    elif chips == 1:
        port = harness.free_port()
    done = False
    try:
        line = harness.run_rank(
            args.workload, args.seed, args.seconds, bool(args.trace),
            t_start=T_START, device=args.device, rank=args.rank, world=chips,
            port=port, root=root, overrides=harness.parse_changes(args.set),
            check_all=args.check_all)
        done = True
    finally:
        bad = 0
        for ch in children:  # a rank 0 that failed leaves the others waiting
            try:
                bad += ch.wait(timeout=300 if done else 5) != 0
            except subprocess.TimeoutExpired:
                ch.kill()
                ch.wait()
                bad += 1
    if args.rank != 0:
        return 0
    if bad:
        harness.log(f"{bad} rank(s) failed")
        return 5
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"forbidden modules loaded: {', '.join(loaded)}")
        return 4
    for name, chk in line["checks"].items():
        harness.log(f"check {name} {chk['value']} limit {chk['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
