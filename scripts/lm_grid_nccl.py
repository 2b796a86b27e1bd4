#!/usr/bin/env python3
"""The language models' mesh paths on four cards, one rank a card, over
NCCL: qwen3-4b at full width and depth on a 2×2 ``("data", "model")`` grid
and a ``(2, 1, 2)`` ``("pod", "data", "model")`` grid.

    python3 scripts/lm_grid_nccl.py                 # needs 4 CUDA cards
    python3 scripts/lm_grid_nccl.py --backend gloo --device cpu --reduced

Starts 4 processes, joins them into one process group
(``tcp://localhost:<free port>``; rank ``r`` on ``cuda:r``), then:

1. one card's reference, on rank 0 while the others wait: the loss and
   grad norm of one training step's global batch (one 4096-token row per
   data-parallel rank, ``SyntheticLMData(seed=0).batch_at(0, shard=i,
   n_shards=2)``; the rows run one at a time and their gradients are
   accumulated by token count), f32 compute so that 1e-5 is a fair bound;
   and greedy serving of the bf16 model at batch 8 × 512, 64 tokens
   (``launch.serve``'s path, phase 7a of ``chip_smoke.py``), with each
   step's top-2 logit margin;
2. on each grid, every rank: one training step (``make_state(mesh=,
   fsdp=True)``, ``make_train_step(mesh=)``, the rank's row), whose loss
   and grad norm must be within 1e-5 relative of the reference, then a
   second step, timed, and a third with the collectives timed; and serving
   through ``serve(mesh=)`` (caches sequence-sharded over ``"model"``,
   split-KV decode) on the rank's rows, whose tokens must equal the
   reference's up to the first step whose reference top-2 margin is a
   near tie (≤ 0.3, as ``chip_smoke.py``'s 7b), and whose prefill logits
   must lie within 0.15 (rtol = atol) of the reference's; it runs once
   timed and once more with the collectives timed.

Rank 0 prints the cards' names and power limits, the reference, and one
JSON line per grid with every rank's wall ms, allocator peak, parameter
and moment bytes, collective bytes by op, and host time inside the grid's
collectives (each bracketed by a device synchronise: that run's wall time
is kept apart, as ``*_timed_collectives_ms``, since the synchronises slow
it).  Exits non-zero on any disagreement, and without four cards (unless
``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GRIDS = {"2x2": ((2, 2), ("data", "model")),
         "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
TRAIN_SEQ = 4096  # configs/shapes.py train_4k: one row a data-parallel rank
SERVE = dict(batch=8, prompt_len=512, gen=64)
N_DP = 2  # both grids have two data-parallel ranks
TIE = 0.3  # a top-2 margin at or below this is a near tie (chip_smoke 7b)
RTOL = 1e-5


def timed_collectives(grid, device):
    """Wrap ``grid``'s collectives to add their host time, each bracketed
    by a device synchronise, to the returned dict (seconds by op)."""
    import torch

    spent = {"all_reduce": 0.0, "all_gather": 0.0, "reduce_scatter": 0.0}

    def wrap(name, fn):
        def timed(*a, **kw):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            spent[name] += time.perf_counter() - t0
            return out
        return timed

    grid._all_reduce = wrap("all_reduce", grid._all_reduce)
    grid.all_gather = wrap("all_gather", grid.all_gather)
    grid.psum_scatter = wrap("reduce_scatter", grid.psum_scatter)
    return spent


def untimed_collectives(grid) -> None:
    """Drop ``timed_collectives``' wrappers (the class methods show again)."""
    for name in ("_all_reduce", "all_gather", "psum_scatter"):
        grid.__dict__.pop(name, None)


def configs(reduced: bool):
    from repro_torch.configs import get_config, reduced_config

    cfg = (reduced_config if reduced else get_config)("qwen3-4b")
    return cfg, dataclasses.replace(cfg, dtype="float32")


def reference(args, device):
    """One card's training-step loss and grad norm on the global batch
    (rows one at a time, gradients accumulated by token count) and its
    greedy serving tokens with each step's top-2 margin."""
    import torch

    from repro_torch.data import SyntheticLMData, as_tensors
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M
    from repro_torch.optim import global_norm

    cfg, cfg32 = configs(args.reduced)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = M.init_params(cfg32, gen, train=True)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, batch_size=N_DP,
                           seq_len=args.seq, seed=0)
    acc, tot, cnt = None, 0.0, 0.0
    for i in range(N_DP):
        batch = as_tensors(data.batch_at(0, shard=i, n_shards=N_DP), device)
        n = float((batch["labels"] >= 0).sum())
        loss, grads = M.loss_and_grads(model, batch, cfg32)
        tot += float(loss) * n
        cnt += n
        if acc is None:
            acc = {k: g.mul_(n) for k, g in grads.items()}
        else:
            for k, g in grads.items():
                acc[k].add_(g, alpha=n)
        del grads
    for g in acc.values():
        g.div_(cnt)
    ref = {"loss": tot / cnt, "grad_norm": float(global_norm(acc))}
    del model, acc

    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed))
    prompt = SV.make_prompt(cfg, SERVE["batch"], SERVE["prompt_len"],
                            args.seed, device)
    caches = M.init_cache(cfg, SERVE["batch"], SERVE["prompt_len"] + SERVE["gen"],
                          device=device)
    logits, caches = M.make_prefill_step(cfg)(params, caches, prompt)
    step = M.make_serve_step(cfg)
    toks, margins, first = [], [], logits.cpu()
    for i in range(SERVE["gen"]):
        top2 = torch.topk(logits, 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).cpu())
        toks.append(torch.argmax(logits, -1).to(torch.int32))
        if i + 1 < SERVE["gen"]:
            logits, caches = step(params, caches, SV.step_input(
                cfg, params, toks[-1][:, None]), SERVE["prompt_len"] + i)
    ref["tokens"] = torch.stack(toks, 1).cpu()
    ref["margins"] = torch.stack(margins, 1)
    ref["prefill_logits"] = first
    del params, caches
    return ref


def tokens_agree(got, ref):
    """Whether each row's greedy tokens equal the reference's up to its
    first difference, at which the reference's margin is a near tie."""
    for r in range(got.shape[0]):
        diff = (got[r] != ref["tokens"][r]).nonzero()
        if len(diff) and float(ref["margins"][r, int(diff[0])]) > TIE:
            return False
    return True


def run_grid(name, args, device, ref):
    """Training and serving on grid ``name``; returns this rank's records."""
    import torch

    from repro_torch.core.grid import ProcessGrid
    from repro_torch.data import SyntheticLMData, as_tensors
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime.sharding import dp_axes, shard_model

    cuda = device.type == "cuda"
    shape, axes = GRIDS[name]
    grid = ProcessGrid.of_shape(shape, axes)
    cfg, cfg32 = configs(args.reduced)
    out = {"rank": grid.rank, "coords": list(grid.coords)}

    # --- training: step 0 against the reference, step 1 timed ---
    opt = AdamW(learning_rate=cosine_schedule(3e-3, 1, 3))
    state = T.make_state(cfg32, opt, torch.Generator(device=device)
                         .manual_seed(args.seed), mesh=grid, fsdp=True)
    out["param_bytes"] = sum(p.numel() * 4 for p in state[0].parameters())
    out["moment_bytes"] = 2 * out["param_bytes"]
    step_fn = M.make_train_step(cfg32, opt, mesh=grid)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, batch_size=N_DP,
                           seq_len=args.seq, seed=0)
    state, m = step_fn(state, as_tensors(T.rank_batch(data, 0, grid), device))
    loss0, gnorm0 = float(m["loss"]), float(m["grad_norm"])
    times = []
    for step in (1, 2):
        batch = as_tensors(T.rank_batch(data, step, grid), device)
        if step == 1:
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            grid.reset_collective_bytes()
        else:
            spent = timed_collectives(grid, device)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        if cuda:
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
        if step == 1:
            peak = torch.cuda.max_memory_allocated(device) if cuda else None
            coll = grid.reset_collective_bytes()
    untimed_collectives(grid)
    out["train"] = {
        "loss": loss0, "grad_norm": gnorm0,
        "loss_rel_diff": abs(loss0 - ref["loss"]) / abs(ref["loss"]),
        "grad_norm_rel_diff": abs(gnorm0 - ref["grad_norm"]) / ref["grad_norm"],
        "step_ms": times[0], "step_timed_collectives_ms": times[1],
        "peak_bytes": peak, "collective_bytes": coll,
        "collective_s": dict(spent)}
    del state, step_fn, m, batch
    if cuda:
        torch.cuda.empty_cache()

    # --- serving: the rank's rows, split-KV decode ---
    params = shard_model(M.init_params(cfg, torch.Generator(device=device)
                                       .manual_seed(args.seed)), grid)
    prompt = SV.make_prompt(cfg, SERVE["batch"], SERVE["prompt_len"],
                            args.seed, device)
    rows = SERVE["batch"] // N_DP
    i = grid.axis_index(dp_axes(grid))
    mine = {k: v[i * rows:(i + 1) * rows] for k, v in prompt.items()}
    caches = M.init_cache(cfg, SERVE["batch"], SERVE["prompt_len"] + SERVE["gen"],
                          device=device, mesh=grid, seq_sharded=True)
    logits, _ = M.make_prefill_step(cfg, mesh=grid)(params, caches, mine)
    want = ref["prefill_logits"][i * rows:(i + 1) * rows]
    got = logits.cpu()
    prefill_ok = bool((got - want).abs().le(0.15 + 0.15 * want.abs()).all())
    del caches, logits
    SV.serve(cfg, params, mine, gen=4, mesh=grid)  # warm-up
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    grid.reset_collective_bytes()
    res = SV.serve(cfg, params, mine, gen=SERVE["gen"], mesh=grid)
    coll = grid.reset_collective_bytes()
    spent = timed_collectives(grid, device)
    timed = SV.serve(cfg, params, mine, gen=SERVE["gen"], mesh=grid)
    untimed_collectives(grid)
    toks = res.tokens
    sub = {"tokens": ref["tokens"][i * rows:(i + 1) * rows],
           "margins": ref["margins"][i * rows:(i + 1) * rows]}
    out["serve"] = {
        "prefill_logits_max_abs_diff": float((got - want).abs().max()),
        "prefill_logits_within_0.15": prefill_ok,
        "tokens_equal": bool(torch.equal(toks, sub["tokens"])),
        "tokens_agree_to_ties": tokens_agree(toks, sub),
        "prefill_ms": res.prefill_ms,
        "decode_step_ms": res.decode_ms / res.decode_steps,
        "tokens_per_s": res.tokens_per_s, "peak_bytes": res.peak_bytes,
        "collective_bytes": coll,
        "prefill_timed_collectives_ms": timed.prefill_ms,
        "decode_step_timed_collectives_ms": timed.decode_ms / timed.decode_steps,
        "collective_s": dict(spent)}
    del params, res, timed
    if cuda:
        torch.cuda.empty_cache()
    return out


def worker(rank, args, port):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.device == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 4) // WORLD))
        device = torch.device("cpu")
    dist.init_process_group(args.backend,
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        box = [None]
        if rank == 0:
            t0 = time.perf_counter()
            box[0] = reference(args, device)
            box[0]["seconds"] = time.perf_counter() - t0
            print(json.dumps({"reference": {
                k: box[0][k] for k in ("loss", "grad_norm", "seconds")},
                "tokens_row0": box[0]["tokens"][0, :16].tolist()}), flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        dist.broadcast_object_list(box, src=0)
        ref = box[0]
        bad = []
        for name in GRIDS:
            rec = run_grid(name, args, device, ref)
            recs = [None] * WORLD
            dist.all_gather_object(recs, rec)
            tr, sv = rec["train"], rec["serve"]
            if not (tr["loss_rel_diff"] <= RTOL
                    and tr["grad_norm_rel_diff"] <= RTOL):
                bad.append(f"{name} rank {rank}: train {tr}")
            if not (sv["prefill_logits_within_0.15"]
                    and sv["tokens_agree_to_ties"]):
                bad.append(f"{name} rank {rank}: serve {sv}")
            if rank == 0:
                print(json.dumps({"grid": name, "shape": list(GRIDS[name][0]),
                                  "axes": list(GRIDS[name][1]),
                                  "seq": args.seq, "ranks": recs}), flush=True)
        flags = [None] * WORLD
        dist.all_gather_object(flags, bad)
        errors = [e for f in flags for e in f]
        if errors:
            raise AssertionError("; ".join(errors))
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reduced", action="store_true",
                    help="qwen3-4b's reduced() config (a rehearsal)")
    ap.add_argument("--seq", type=int, default=TRAIN_SEQ)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < WORLD:
            sys.exit(f"lm_grid_nccl.py needs {WORLD} CUDA cards; found {n}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        print(" | ".join(smi.splitlines()), flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(worker, args=(args, port), nprocs=WORLD, join=True,
                       start_method="spawn")


if __name__ == "__main__":
    main()
