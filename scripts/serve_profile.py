#!/usr/bin/env python3
"""Where the time of the port's LM serving goes, on one NVIDIA card.

    python3 scripts/serve_profile.py                  # qwen3-4b, batch 8
    python3 scripts/serve_profile.py --arch yi-9b --batch 4

Builds the model of ``--arch`` at full size from ``--seed`` (as ``python
-m repro_torch.launch.serve`` does), serves a warm-up, then:

* times ``--reps`` prefills of ``--prompt-len`` tokens and ``--steps``
  decode steps at position ``--prompt-len`` with the host clock around
  work that ends in a device synchronise;
* traces one prefill and ``--steps`` decode steps with ``torch.profiler``
  (CPU and CUDA activity) and sums the device time of every kernel: busy
  time per call, the device's idle share (1 - busy / wall of the untraced
  call), kernels launched per call, and the kernels and torch ops that
  take most of it.

``--long-prefill`` instead runs ``chip_smoke.py``'s phase 9d with the
whole prompt: the LM dry run's measured ``prefill_32k`` step of qwen3-4b
(2 rows of 32,768 tokens, the production grid's rows a rank, on a 1×1
grid over a 1-rank NCCL group), its time, peak and bf16 FLOP bound, and
the causality check of the first 512 positions against a 512-token
prefill (``chip_smoke.py`` runs the same path at 16,384 tokens).

Prints the card's name and power limit, then one JSON line.  Exits
non-zero without a card, or when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--max-len", type=int, default=576)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--long-prefill", action="store_true",
                    help="phase 9d of chip_smoke.py at the whole 32,768 "
                         "tokens instead of the profile")
    return ap.parse_args()


def long_prefill(args) -> None:
    """``chip_smoke.long_prefill_phase`` at the whole ``prefill_32k``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from repro_torch.core.grid import ProcessGrid, release_grids

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        rec = CS.long_prefill_phase(args, CS.check, ProcessGrid(1, 1),
                                    torch.device("cuda"))
    finally:
        dist.destroy_process_group()
        release_grids()
    print(json.dumps({"long_prefill": rec}))


def main() -> None:
    args = parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("serve_profile.py needs an NVIDIA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve as SV
    from repro_torch.models import model as TM

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    if args.long_prefill:
        return long_prefill(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    sargs = SV.parse_args(["--arch", args.arch, "--batch", str(args.batch),
                           "--prompt-len", str(args.prompt_len),
                           "--seed", str(args.seed)])
    cfg, params, prompt = SV.setup(sargs)
    SV.serve(cfg, params, prompt, gen=4, max_len=args.max_len)  # warm-up
    prefill = TM.make_prefill_step(cfg)
    step = TM.make_serve_step(cfg)

    def run_prefill():
        caches = TM.init_cache(cfg, args.batch, args.max_len, device="cuda")
        logits, caches = prefill(params, caches, prompt)
        return logits, caches

    def run_steps(logits, caches):
        for i in range(args.steps):
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            logits, caches = step(params, caches, SV.step_input(cfg, params, tok),
                                  args.prompt_len + i)
        return logits

    walls = {"prefill_ms": [], "decode_step_ms": []}
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = run_prefill()
        torch.cuda.synchronize()
        walls["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        run_steps(logits, caches)
        torch.cuda.synchronize()
        walls["decode_step_ms"].append((time.perf_counter() - t0) * 1e3
                                       / args.steps)

    out = {"arch": args.arch, "batch": args.batch,
           "prompt_len": args.prompt_len, "max_len": args.max_len,
           "steps": args.steps, **walls}
    for phase in ("prefill", "decode"):
        logits, caches = run_prefill()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if phase == "prefill":
                run_prefill()
            else:
                run_steps(logits, caches)
            torch.cuda.synchronize()
        calls = 1 if phase == "prefill" else args.steps
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3 / calls
        n_kern = sum(e.count for e in kern) / calls
        ops = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.key.startswith("aten::")]
        wall = min(walls[f"{phase}_ms" if phase == "prefill"
                         else "decode_step_ms"])
        out[phase] = {
            "device_busy_ms": busy, "kernels_per_call": n_kern,
            "idle_share": 1 - busy / wall if wall else None,
            "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3 / calls
                               for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:args.top]},
            "top_ops_device_ms": {e.key: e.device_time_total / 1e3 / calls
                                  for e in sorted(ops, key=lambda e: -e.device_time_total)[:args.top]},
            "top_ops_calls": {e.key: e.count / calls
                              for e in sorted(ops, key=lambda e: -e.count)[:args.top]},
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
