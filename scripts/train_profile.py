#!/usr/bin/env python3
"""Where the time of the port's LM train step goes, on one NVIDIA card.

    python3 scripts/train_profile.py                  # qwen3-4b, 1 x 4096
    python3 scripts/train_profile.py --seq 2048 --reps 2

Builds the train state of ``--arch`` at full size from ``--seed`` (as
``python -m repro_torch.launch.train`` does: f32 master parameters and
moments, bf16 compute, AdamW), runs a warm-up step on
``SyntheticLMData(seed=0)`` batches of ``--batch`` × ``--seq`` tokens, then:

* times ``--reps`` steps with the host clock around work that ends in a
  device synchronise;
* traces one more step with ``torch.profiler`` (CPU and CUDA activity) and
  sums the device time of every kernel: busy time per step, the device's
  idle share (1 − busy / the fastest untraced step), kernels launched per
  step, the kernels and torch ops that take most of it, and the step's
  device time split into forward, recompute (a checkpointed group, CE
  chunk or attention KV block run again in the backward), backward and
  optimizer.  A kernel counts as recompute when its launching op runs
  inside a second call of a checkpointed function; otherwise it takes the
  phase whose host time range holds its launch.

Prints the card's name and power limit, then one JSON line.  Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("forward", "backward", "optimizer")


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    return ap.parse_args()


def tag_recompute(modules, record_function):
    """Wrap ``checkpoint`` in ``modules`` so that the second call of each
    checkpointed function (its recompute in the backward) runs inside a
    ``recompute`` range."""
    for mod in modules:
        orig = mod.checkpoint

        def tagged(fn, *args, _orig=orig, **kw):
            calls = [0]

            def run(*a):
                calls[0] += 1
                if calls[0] == 1:
                    return fn(*a)
                with record_function("recompute"):
                    return fn(*a)

            return _orig(run, *args, **kw)

        mod.checkpoint = tagged


def split_by_phase(events, ranges):
    """Device µs of each phase: kernels under a ``recompute`` range are
    recompute, the others go to the phase whose range holds their launching
    op's start."""
    out = dict.fromkeys(PHASES + ("recompute", "other"), 0.0)
    for e in events:
        if not e.kernels or e.is_user_annotation:
            continue
        dur = sum(k.duration for k in e.kernels)
        p, name = e.cpu_parent, None
        while p is not None:
            if p.name == "recompute":
                name = "recompute"
                break
            p = p.cpu_parent
        if name is None:
            t = e.time_range.start
            name = next((ph for ph, (a, b) in ranges.items() if a <= t <= b),
                        "other")
        out[name] += dur
    return out


def main() -> None:
    args = parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("train_profile.py needs an NVIDIA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData, as_tensors
    from repro_torch.launch import train as TT
    from repro_torch.models import attention as TA
    from repro_torch.models import model as TM
    from repro_torch.optim import AdamW, cosine_schedule, global_norm

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    n_steps = args.reps + 2
    opt = AdamW(learning_rate=cosine_schedule(3e-3, 1, n_steps))
    state = TT.make_state(cfg, opt, torch.Generator(device="cuda").manual_seed(
        args.seed))
    data = SyntheticLMData(vocab_size=cfg.vocab_size, batch_size=args.batch,
                           seq_len=args.seq, seed=0, frontend=cfg.frontend,
                           d_model=cfg.d_model)
    model, opt_state, _ = state
    params = dict(model.named_parameters())

    def step(i):
        """One train step (``make_train_step``'s work), its phases marked."""
        batch = as_tensors(data.batch_at(i), "cuda")
        for p in params.values():
            p.grad = None
        with record_function("phase:forward"):
            loss = TM.loss_fn(model, batch, cfg)
        with record_function("phase:backward"):
            loss.backward()
        with record_function("phase:optimizer"):
            grads = {n: p.grad for n, p in params.items()}
            global_norm(grads.values())
            opt.update_(grads, opt_state, params, i)
            for p in params.values():
                p.grad = None

    step(0)  # warm-up: lr 0
    torch.cuda.synchronize()
    walls = []
    for i in range(1, args.reps + 1):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    tag_recompute((TM, TA), record_function)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(args.reps + 1)
        torch.cuda.synchronize()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    ranges = {e.name[len("phase:"):]: (e.time_range.start, e.time_range.end)
              for e in events
              if e.name.startswith("phase:") and e.device_type == cpu}
    # the ranges' own device-side annotations are not kernels
    kern = [e for e in prof.key_averages()
            if e.device_type == cuda and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    n_kern = sum(e.count for e in kern)
    ops = [e for e in prof.key_averages()
           if e.device_type == cpu and e.key.startswith("aten::")]
    split = split_by_phase(events, ranges)
    wall = min(walls)
    out = {"arch": args.arch, "batch": args.batch, "seq": args.seq,
           "step_ms": walls, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall, "kernels_per_step": n_kern,
           "device_ms_by_phase": {k: v / 1e3 for k, v in split.items()},
           "share_by_phase": {k: v / 1e3 / busy for k, v in split.items()},
           "host_ms_by_phase": {k: (b - a) / 1e3 for k, (a, b) in
                                ranges.items()},
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                              for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:args.top]},
           "top_ops_device_ms": {e.key: e.device_time_total / 1e3
                                 for e in sorted(ops, key=lambda e: -e.device_time_total)[:args.top]},
           "top_ops_calls": {e.key: e.count
                             for e in sorted(ops, key=lambda e: -e.count)[:args.top]}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
