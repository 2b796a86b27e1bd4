#!/usr/bin/env python3
"""The language models' mesh paths on four cards, one rank a card, over
NCCL: each arch of ``--arch`` at full width (and depth, but where its plan
says otherwise) on its grids, held to one card, and (``--resume``) a
full-size train state saved on one grid and resumed on another.

    python3 scripts/lm_grid_nccl.py                 # qwen3-4b; 4 CUDA cards
    python3 scripts/lm_grid_nccl.py --arch granite-moe-1b-a400m \
        qwen2-moe-a2.7b mamba2-1.3b hymba-1.5b --resume qwen3-4b
    python3 scripts/lm_grid_nccl.py --checks-only --arch qwen2-moe-a2.7b
    python3 scripts/lm_grid_nccl.py --backend gloo --device cpu --reduced \
        --seq 64 --arch ALL --resume qwen3-4b       # a rehearsal

Starts 4 processes, joins them into one process group
(``tcp://localhost:<free port>``; rank ``r`` on ``cuda:r``), then for each
arch:

1. one card's reference, on rank 0 while the others wait: the loss and
   grad norm of one training step's global batch (``ROWS[arch]`` rows of
   ``--seq`` tokens a data-parallel rank, ``SyntheticLMData(seed=0)
   .batch_at(0, shard=i, n_shards=2)``; the rows run one at a time, each
   loss weighted by its token count into the same gradients), f32 compute so that
   1e-5 is a fair bound; greedy serving of the bf16 model at batch
   8 × 512, 64 tokens (``launch.serve``'s path, phase 7a of
   ``chip_smoke.py``), with each step's top-2 logit margin; and the
   prefill logits of the same weights in f32.  The MoE archs run
   ``moe_impl="shardmap"`` on the grid, whose capacity comes from each
   data-parallel rank's own tokens: their reference serves each such
   rank's rows as a batch of its own (training already runs one row, a
   rank's whole block, at a time), and logs every router call's top-k;
2. on each of the arch's grids (``RUNS``), every rank: one training step
   (``make_state(mesh=, fsdp=True)``, ``make_train_step(mesh=)``, the
   rank's rows), whose loss and grad norm must be within 1e-5 relative of
   the reference, then a second step, timed, and a third with the
   collectives timed; and serving through ``serve(mesh=)`` (caches
   sequence-sharded over ``"model"``, split-KV decode) on the rank's rows,
   whose tokens must equal the reference's up to the first step whose
   reference top-2 margin is a near tie (≤ 0.3, as ``chip_smoke.py``'s
   7b), whose f32 prefill logits must lie within 1e-4 (rtol = atol) of
   the reference's, and whose bf16 prefill logits may lie no more than
   0.15 further from one card's f32 logits than one card's own bf16
   logits do (``bf16_prefill_ok``: bf16 rounding alone, at 48 layers,
   takes one card's logits 0.29-0.33 from its f32 ones); it runs once
   timed and once more with the collectives timed.  An MoE arch's
   grid takes the reference's top-k (f32 and bf16 sums over ranks round
   otherwise, and a flipped expert moves a token by far more than the
   rounding) for step 0's loss and grad norm (computed once more, without
   an update), the prefill logits and the tokens; where the grid's own
   top-k differs from the reference's, every such token must be a router
   near tie, and then its own step 0 may miss 1e-5.
   ``batch_over_model`` acts only without caches, so its run trains only.
   ``--checks-only`` runs the comparisons alone (step 0, one serving run):
   no timed step or run, and no times in the lines.

``--resume ARCH`` (run first): ``ARCH`` at full size in f32 trains two
steps on 2×2
(``RESUME_ROWS`` rows a data-parallel rank) and is saved with
``checkpoint/`` (logical arrays, written by rank 0 to ``--ckpt-dir``); a
third step on 2×2 is the straight run.  A fresh 2×2 state restores the
checkpoint, ``runtime.elastic.reshard_state`` moves it onto 4×1, and the
third step there, on the same global batch, must equal the straight
step's loss and grad norm within 1e-5 relative.  Where the disk cannot
hold the saved state (f32 parameters, μ and ν) with a quarter to spare,
mamba2-1.3b (16 GB) takes its place, and the line says so.

Rank 0 prints the cards' names and power limits, each reference, and one
JSON line per arch and grid with every rank's wall ms, allocator peak,
parameter and moment bytes, collective bytes by op, and host time inside
the grid's collectives (each bracketed by a device synchronise: that
run's wall time is kept apart, as ``*_timed_collectives_ms``, since the
synchronises slow it).  A disagreement is reported and the run goes on
to the next arch; the script exits non-zero at the end if any was found,
and without four cards (unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GRIDS = {"2x2": ((2, 2), ("data", "model")),
         "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
         "4x1": ((4, 1), ("data", "model"))}
ARCHS = ("qwen3-4b", "granite-moe-1b-a400m", "qwen2-moe-a2.7b",
         "mamba2-1.3b", "hymba-1.5b")
MOE = {"granite-moe-1b-a400m", "qwen2-moe-a2.7b"}
SSM = {"mamba2-1.3b", "hymba-1.5b"}
# (label, grid, config overrides, serve too) of each arch
RUNS = {
    "qwen3-4b": [("2x2", "2x2", {}, True), ("2x1x2", "2x1x2", {}, True)],
    **{a: [("2x2", "2x2", {"moe_impl": "shardmap"}, True)] for a in MOE},
    **{a: [("2x2", "2x2", {}, True),
           ("2x2+batch_over_model", "2x2", {"batch_over_model": True}, False)]
       for a in SSM},
}
# training rows a data-parallel rank: batch_over_model splits a rank's
# rows over "model", so the SSM archs take two
ROWS = {a: 2 if a in SSM else 1 for a in ARCHS}
TRAIN_SEQ = 4096  # configs/shapes.py train_4k's sequence
SERVE = dict(batch=8, prompt_len=512, gen=64)
N_DP = 2  # every grid but 4x1 has two data-parallel ranks
RESUME_ROWS = 2  # 4 rows in all: one a rank on 4x1
TIE = 0.3  # a top-2 margin at or below this is a near tie (chip_smoke 7b)
RTOL = 1e-5
F32_LOGITS = 1e-4  # f32 prefill logits, rtol = atol (tests/_lm_parity.py)
# what a grid's bf16 prefill may add to one card's own bf16 error
BF16_EXTRA = 0.15
# the one-card training reference holds f32 parameters and gradients
# (8 B a parameter) beside its activations (reckoned at 8 GB at 4096
# tokens: a CE chunk's logits, the unembed operand and its gradient, one
# recomputed layer); it may fill this share of the card
REF_ACT_BYTES = 8e9
CARD_SHARE = 0.8


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


def stored_params(cfg) -> int:
    """Parameters ``cfg``'s model stores (padded experts and vocab)."""
    from repro_torch.models import model as M

    return sum(p.numel() for p in M.LanguageModel(cfg, device="meta")
               .parameters())


def train_depth(cfg, card_bytes):
    """The most layers (a multiple of the period, at most ``cfg``'s) whose
    one-card f32 training reference fits: 8 B a stored parameter beside
    ``REF_ACT_BYTES``, within ``CARD_SHARE`` of the card."""
    if card_bytes is None:
        return cfg.n_layers
    for n in range(cfg.n_layers, 0, -cfg.period):
        c = dataclasses.replace(cfg, n_layers=n)
        if 8 * stored_params(c) + REF_ACT_BYTES <= CARD_SHARE * card_bytes:
            return n
    raise SystemExit(f"{cfg.name}: no depth fits one card")


def card_bytes(device):
    import torch

    if device is None or device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


def configs(arch, reduced: bool, device, overrides=None):
    """(bf16 serving config, f32 training config) of ``arch`` with
    ``overrides``; the training config cut to ``train_depth``."""
    from repro_torch.configs import get_config, reduced_config

    cfg = dataclasses.replace((reduced_config if reduced else get_config)(arch),
                              **(overrides or {}))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    depth = train_depth(cfg32, card_bytes(device))
    return cfg, dataclasses.replace(cfg32, n_layers=depth)


def train_data(cfg, arch, seq):
    from repro_torch.data import SyntheticLMData

    return SyntheticLMData(vocab_size=cfg.vocab_size,
                           batch_size=N_DP * ROWS[arch], seq_len=seq, seed=0)


def logged(records):
    """A ``chip_smoke.RouteLog`` stand-in holding ``records`` (to force or
    compare another run's top-k)."""
    import types

    return types.SimpleNamespace(records=records)


def prefill(cfg, params, prompt, device, mesh=None, forced=None):
    """The prefill logits of ``prompt`` (on the host) with caches for
    ``SERVE``'s lengths, sequence-sharded on ``mesh``, and for an MoE arch
    its router calls' log; ``forced`` holds records whose top-k the
    router takes instead of its own."""
    import contextlib

    from chip_smoke import RouteLog
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE_MOD

    batch = SERVE["batch"] if mesh else next(iter(prompt.values())).shape[0]
    caches = M.init_cache(cfg, batch, SERVE["prompt_len"] + SERVE["gen"],
                          device=device, mesh=mesh, seq_sharded=bool(mesh))
    log = RouteLog(MOE_MOD, forced=forced) if cfg.n_experts else None
    with log or contextlib.nullcontext():
        logits, _ = M.make_prefill_step(cfg, mesh=mesh)(params, caches, prompt)
    return logits.cpu(), log and log.records


def greedy(cfg, params, prompt, device):
    """Prefill logits, greedy tokens and each step's top-2 margin of
    ``prompt`` on one card (``launch.serve``'s loop), and for an MoE arch
    every router call's top-k and logits (``chip_smoke.RouteLog``)."""
    import contextlib

    import torch

    from chip_smoke import RouteLog
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE_MOD

    batch = next(iter(prompt.values())).shape[0]
    caches = M.init_cache(cfg, batch, SERVE["prompt_len"] + SERVE["gen"],
                          device=device)
    log = RouteLog(MOE_MOD) if cfg.n_experts else None
    with log or contextlib.nullcontext():
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
    return (torch.stack(toks, 1).cpu(), torch.stack(margins, 1), first,
            log and log.records)


def reference(arch, args, device):
    """One card's training-step loss and grad norm on the global batch
    (rows one at a time, gradients accumulated by token count), for an MoE
    arch with each data-parallel rank's router calls; its greedy serving
    tokens with each step's top-2 margin (an MoE arch: each data-parallel
    rank's rows as a batch of their own); and the prefill logits of the
    same model in f32."""
    import contextlib

    import torch

    from chip_smoke import RouteLog
    from repro_torch.data import as_tensors
    from repro_torch.launch import serve as SV
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE_MOD
    from repro_torch.optim import global_norm

    cfg, cfg32 = configs(arch, args.reduced, device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = M.init_params(cfg32, gen, train=True)
    data = train_data(cfg, arch, args.seq)
    tot, cnt, train_routes = 0.0, 0.0, []
    for i in range(N_DP):
        shard = data.batch_at(0, shard=i, n_shards=N_DP)
        # an MoE arch has one row a data-parallel rank: its router calls
        # (forward, then the backward's recompute) are the grid rank's
        log = RouteLog(MOE_MOD) if cfg.n_experts else None
        with log or contextlib.nullcontext():
            for r in range(ROWS[arch]):
                batch = as_tensors({k: v[r:r + 1] for k, v in shard.items()},
                                   device)
                n = float((batch["labels"] >= 0).sum())
                loss = M.loss_fn(model, batch, cfg32)
                (loss * n).backward()  # summed into .grad: 8 B a parameter
                tot += float(loss.detach()) * n
                cnt += n
                del loss  # its graph holds the parameters
        # detached: a record's graph would keep every parameter (and its
        # gradient) alive past the model
        train_routes.append(log and [(k, lg.detach()) for k, lg in log.records])
    del log
    acc = {k: p.grad.div_(cnt) if p.grad is not None else torch.zeros_like(p)
           for k, p in model.named_parameters()}
    ref = {"loss": tot / cnt, "grad_norm": float(global_norm(acc)),
           "train_layers": cfg32.n_layers, "layers": cfg.n_layers,
           "train_stored_params": stored_params(cfg32),
           "train_routes": train_routes}
    del model, acc, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()

    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed))
    prompt = SV.make_prompt(cfg, SERVE["batch"], SERVE["prompt_len"],
                            args.seed, device)
    groups = N_DP if arch in MOE else 1
    per = SERVE["batch"] // groups
    parts = [greedy(cfg, params, {k: v[g * per:(g + 1) * per]
                                  for k, v in prompt.items()}, device)
             for g in range(groups)]
    ref["tokens"], ref["margins"], ref["prefill_logits"] = (
        torch.cat(x) for x in list(zip(*parts))[:3])
    ref["routes"] = [p[3] for p in parts]  # each data-parallel rank's

    # the same weights in f32 (converted in place, a leaf at a time): a
    # grid that equals it here rounds, in bf16, only where its sums split
    cfg_f = dataclasses.replace(cfg, dtype="float32")
    params.to(torch.float32)
    parts = [prefill(cfg_f, params, {k: v[g * per:(g + 1) * per]
                                     for k, v in prompt.items()}, device)
             for g in range(groups)]
    ref["prefill32_logits"] = torch.cat([p[0] for p in parts])
    ref["routes32"] = [p[1] for p in parts]
    del params
    return ref


def tokens_agree(got, ref):
    """Whether each row's greedy tokens equal the reference's up to its
    first difference, at which the reference's margin is a near tie."""
    for r in range(got.shape[0]):
        diff = (got[r] != ref["tokens"][r]).nonzero()
        if len(diff) and float(ref["margins"][r, int(diff[0])]) > TIE:
            return False
    return True


def run_grid(arch, grid_name, overrides, do_serve, args, device, ref):
    """Training (and serving, with ``do_serve``) of ``arch`` with
    ``overrides`` on grid ``grid_name``; returns this rank's records."""
    import contextlib

    import torch

    from chip_smoke import RouteLog, flips_are_ties
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.data import as_tensors
    from repro_torch.launch import serve as SV
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE_MOD
    from repro_torch.optim import AdamW, cosine_schedule, global_norm
    from repro_torch.runtime.sharding import dp_axes, shard_model

    cuda = device.type == "cuda"
    shape, axes = GRIDS[grid_name]
    grid = ProcessGrid.of_shape(shape, axes)
    cfg, cfg32 = configs(arch, args.reduced, device, overrides)
    out = {"rank": grid.rank, "coords": list(grid.coords)}
    i = grid.axis_index(dp_axes(grid))  # this rank's data-parallel block

    def rel(x, want):
        return abs(x - want) / abs(want)

    # --- training: step 0 against the reference, step 1 timed ---
    opt = AdamW(learning_rate=cosine_schedule(3e-3, 1, 3))
    state = T.make_state(cfg32, opt, torch.Generator(device=device)
                         .manual_seed(args.seed), mesh=grid, fsdp=True)
    out["param_bytes"] = sum(p.numel() * 4 for p in state[0].parameters())
    out["moment_bytes"] = 2 * out["param_bytes"]
    step_fn = M.make_train_step(cfg32, opt, mesh=grid)
    data = train_data(cfg, arch, args.seq)
    batch = as_tensors(T.rank_batch(data, 0, grid), device)
    routing, own = {}, None
    if cfg.n_experts:
        # step 0's loss and gradients (no update) with the reference's
        # top-k handed to the grid: f32 sums over ranks round otherwise,
        # and a flipped expert moves a token's loss by far more
        with RouteLog(MOE_MOD, forced=logged(ref["train_routes"][i])):
            loss, grads = M.loss_and_grads(state[0], batch, cfg32, mesh=grid)
            gnorm = global_norm(grads, grid=grid,
                                specs=M.param_specs(state[0]))
        routing["forced_reference_top_k"] = {
            "loss_rel_diff": rel(float(loss), ref["loss"]),
            "grad_norm_rel_diff": rel(float(gnorm), ref["grad_norm"])}
        del loss, grads, gnorm
        own = RouteLog(MOE_MOD)
    with own or contextlib.nullcontext():
        state, m = step_fn(state, batch)
    loss0, gnorm0 = float(m["loss"]), float(m["grad_norm"])
    if own is not None:  # the grid's own top-k against the reference's
        flips, ties = flips_are_ties(own, logged(ref["train_routes"][i]),
                                     cfg.top_k)
        routing.update(own_top_k_flips=len(flips), flips_are_router_ties=ties,
                       flip_gaps=sorted(g for g, _ in flips)[:8])
        del own
    times, timing = [], {}
    for step in () if args.checks_only else (1, 2):
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
            timing["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                    if cuda else None)
            timing["collective_bytes"] = grid.reset_collective_bytes()
        else:
            untimed_collectives(grid)
            timing.update(step_ms=times[0], step_timed_collectives_ms=times[1],
                          collective_s=dict(spent))
    out["train"] = {
        "loss": loss0, "grad_norm": gnorm0,
        "loss_rel_diff": rel(loss0, ref["loss"]),
        "grad_norm_rel_diff": rel(gnorm0, ref["grad_norm"]), **routing,
        **timing}
    del state, step_fn, m, batch
    if cuda:
        torch.cuda.empty_cache()
    if not do_serve:
        return out

    # --- serving: the rank's rows, split-KV decode ---
    params = shard_model(M.init_params(cfg, torch.Generator(device=device)
                                       .manual_seed(args.seed)), grid)
    prompt = SV.make_prompt(cfg, SERVE["batch"], SERVE["prompt_len"],
                            args.seed, device)
    rows = SERVE["batch"] // N_DP
    mine = {k: v[i * rows:(i + 1) * rows] for k, v in prompt.items()}
    moe = bool(cfg.n_experts)
    # an MoE arch's prefill with the reference's top-k (its first calls)
    got = prefill(cfg, params, mine, device, mesh=grid,
                  forced=logged(ref["routes"][i]) if moe else None)[0]
    want = ref["prefill_logits"][i * rows:(i + 1) * rows]
    if not args.checks_only:
        SV.serve(cfg, params, mine, gen=4, mesh=grid)  # warm-up
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    grid.reset_collective_bytes()
    res = SV.serve(cfg, params, mine, gen=SERVE["gen"], mesh=grid)
    timing = {}
    if not args.checks_only:
        timing = {"prefill_ms": res.prefill_ms,
                  "decode_step_ms": res.decode_ms / res.decode_steps,
                  "tokens_per_s": res.tokens_per_s,
                  "peak_bytes": res.peak_bytes,
                  "collective_bytes": grid.reset_collective_bytes()}
        spent = timed_collectives(grid, device)
        timed = SV.serve(cfg, params, mine, gen=SERVE["gen"], mesh=grid)
        untimed_collectives(grid)
        timing.update(
            prefill_timed_collectives_ms=timed.prefill_ms,
            decode_step_timed_collectives_ms=timed.decode_ms
            / timed.decode_steps, collective_s=dict(spent))
    toks = res.tokens
    sub = {"tokens": ref["tokens"][i * rows:(i + 1) * rows],
           "margins": ref["margins"][i * rows:(i + 1) * rows]}
    routing = {}
    if moe:
        # the reference's top-k handed to the grid (bf16 sums over ranks
        # round otherwise, and a flipped expert moves a token by far more
        # than rounding); the grid's own top-k must differ only at router
        # near ties (chip_smoke.py 7c's rule)
        ref_log = logged(ref["routes"][i])
        with RouteLog(MOE_MOD, forced=ref_log) as own:
            toks = SV.serve(cfg, params, mine, gen=SERVE["gen"],
                            mesh=grid).tokens
        flips, ties = flips_are_ties(own, ref_log, cfg.top_k)
        routing = {"forced_reference_top_k": True,
                   "own_top_k_flips": len(flips),
                   "flips_are_router_ties": ties}
    # the same prefill with the same weights in f32 against one card's
    # (F32_LOGITS), and the bf16 logits of both against that f32
    # reference: the share of the bf16 gap that rounding alone gives
    cfg_f = dataclasses.replace(cfg, dtype="float32")
    params.to(torch.float32)
    got32 = prefill(cfg_f, params, mine, device, mesh=grid,
                    forced=logged(ref["routes32"][i]) if moe else None)[0]
    want32 = ref["prefill32_logits"][i * rows:(i + 1) * rows]
    bf16_ok, card_err, grid_err = bf16_prefill_ok(got, want, want32)
    out["serve"] = {
        "prefill_logits_max_abs_diff": float((got - want).abs().max()),
        # the direct comparison, recorded; the check is the next key's
        "prefill_logits_within_0.15": bool(
            (got - want).abs().le(0.15 + 0.15 * want.abs()).all()),
        "prefill_bf16_within_card_error": bf16_ok,
        "prefill32_logits_max_abs_diff": float((got32 - want32).abs().max()),
        "prefill32_logits_within_1e-4": bool(
            (got32 - want32).abs().le(F32_LOGITS * (1 + want32.abs())).all()),
        "bf16_to_f32_max_abs_diff": {"one_card": card_err, "grid": grid_err},
        "tokens_equal": bool(torch.equal(toks, sub["tokens"])),
        "tokens_agree_to_ties": (tokens_agree(toks, sub)
                                 and routing.get("flips_are_router_ties",
                                                 True)),
        **routing, **timing}
    del params, res
    if cuda:
        torch.cuda.empty_cache()
    return out


def bf16_prefill_ok(got, want, want32):
    """The bf16 prefill check of one rank's rows: ``got`` the grid's bf16
    logits, ``want`` one card's, ``want32`` one card's f32 logits of the
    same weights.  Each bf16 side is measured against ``want32``; the
    grid may add at most ``BF16_EXTRA`` to one card's own bf16 error.
    Returns ``(ok, one card's error, the grid's error)``."""
    card_err = float((want - want32).abs().max())
    grid_err = float((got - want32).abs().max())
    return grid_err <= card_err + BF16_EXTRA, card_err, grid_err


def train_ok(tr) -> bool:
    """Loss and grad norm within ``RTOL`` of the reference; an MoE arch's
    with the reference's top-k handed to the grid, and its own within
    ``RTOL`` too unless every expert it picks otherwise is a router near
    tie (``chip_smoke.flips_are_ties``)."""
    own = tr["loss_rel_diff"] <= RTOL and tr["grad_norm_rel_diff"] <= RTOL
    forced = tr.get("forced_reference_top_k")
    if forced is None:
        return own
    return (forced["loss_rel_diff"] <= RTOL
            and forced["grad_norm_rel_diff"] <= RTOL
            and (own or tr["flips_are_router_ties"]))


def resume_run(arch, args, device):
    """``--resume`` (see the module docstring); returns this rank's record."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.data import SyntheticLMData, as_tensors
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import reshard_state
    from repro_torch.runtime.sharding import dp_axes

    cuda = device.type == "cuda"
    ckdir = args.ckpt_dir
    out = {"asked": arch}
    cfg = configs(arch, args.reduced, None)[1]
    need = 12 * stored_params(cfg)  # f32 parameters, μ and ν
    os.makedirs(ckdir, exist_ok=True)
    free = shutil.disk_usage(ckdir).free
    if free < 1.25 * need:
        out["why"] = (f"{free} bytes free in {ckdir}, {need} bytes of "
                      f"state: mamba2-1.3b instead")
        arch = "mamba2-1.3b"
        cfg = configs(arch, args.reduced, None)[1]
        need = 12 * stored_params(cfg)
    out.update(arch=arch, layers=cfg.n_layers, state_bytes=need,
               disk_free_bytes=free)
    opt = AdamW(learning_rate=cosine_schedule(3e-3, 1, 3))
    data = SyntheticLMData(vocab_size=cfg.vocab_size,
                           batch_size=N_DP * RESUME_ROWS, seq_len=args.seq,
                           seed=0)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def timed(fn):
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        sync()
        dist.barrier()
        return res, time.perf_counter() - t0

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    g22 = ProcessGrid.of_shape(*GRIDS["2x2"])
    g41 = ProcessGrid.of_shape(*GRIDS["4x1"])
    state = T.make_state(cfg, opt, gen(args.seed), mesh=g22, fsdp=True)
    step22 = M.make_train_step(cfg, opt, mesh=g22)
    for s in (0, 1):
        state, m = step22(state, as_tensors(T.rank_batch(data, s, g22), device))
    mgr = CheckpointManager(ckdir, keep=1, async_write=False)
    _, out["save_s"] = timed(lambda: mgr.save(2, state, meta={"arch": arch}))
    if g22.rank == 0:
        out["checkpoint_bytes"] = os.path.getsize(
            os.path.join(mgr._step_dir(2), "arrays.npz"))
    state, m = step22(state, as_tensors(T.rank_batch(data, 2, g22), device))
    straight = (float(m["loss"]), float(m["grad_norm"]))
    del state, step22, m
    if cuda:
        torch.cuda.empty_cache()

    # the checkpoint restored on 2x2, moved onto 4x1 (runtime/elastic.py)
    fresh = T.make_state(cfg, opt, gen(args.seed + 1), mesh=g22, fsdp=True)
    restored, out["restore_s"] = timed(lambda: mgr.restore(2, fresh))
    restored = (restored[0], restored[1], int(restored[2]))
    moved, out["reshard_s"] = timed(
        lambda: reshard_state(restored, g41, fsdp=True))
    del fresh, restored
    step41 = M.make_train_step(cfg, opt, mesh=g41)
    # the straight step's global batch (its two shards' rows, in order), a
    # row a rank: SyntheticLMData draws a shard's rows from its own seed
    whole = [data.batch_at(2, shard=i, n_shards=N_DP) for i in range(N_DP)]
    r = g41.axis_index(dp_axes(g41))
    mine = {k: np.concatenate([w[k] for w in whole])[r:r + 1]
            for k in whole[0]}
    moved, m = step41(moved, as_tensors(mine, device))
    resumed = (float(m["loss"]), float(m["grad_norm"]))
    out.update(
        step=int(moved[2]), straight=straight, resumed=resumed,
        loss_rel_diff=abs(resumed[0] - straight[0]) / abs(straight[0]),
        grad_norm_rel_diff=abs(resumed[1] - straight[1]) / straight[1],
        peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else None)
    del moved, step41, m
    dist.barrier()
    if g22.rank == 0:
        shutil.rmtree(ckdir, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    return out


def worker(rank, args, port):
    import torch
    import torch.distributed as dist

    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from repro_torch.core.grid import release_grids

    if args.device == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 4) // WORLD))
        device = torch.device("cpu")
    dist.init_process_group(args.backend,
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    bad = []
    if args.resume:
        rec = resume_run(args.resume, args, device)
        if rank == 0:
            print(json.dumps({"resume": rec}), flush=True)
        if not (rec["loss_rel_diff"] <= RTOL
                and rec["grad_norm_rel_diff"] <= RTOL):
            bad.append(f"resume rank {rank}: {rec}")
    for arch in args.arch:
        box = [None]
        if rank == 0:
            t0 = time.perf_counter()
            try:
                box[0] = reference(arch, args, device)
            except Exception:  # the others wait in the broadcast: tell them
                box[0] = {"error": traceback.format_exc()}
            box[0]["seconds"] = time.perf_counter() - t0
            if device.type == "cuda":
                torch.cuda.empty_cache()
        dist.broadcast_object_list(box, src=0)
        ref = box[0]
        if "error" in ref:
            raise RuntimeError(f"{arch}: the reference failed on rank 0:\n"
                               f"{ref['error']}")
        if rank == 0:
            print(json.dumps({"arch": arch, "reference": {
                k: ref[k] for k in ("loss", "grad_norm", "seconds", "layers",
                                    "train_layers", "train_stored_params")},
                "tokens_row0": ref["tokens"][0, :16].tolist()}), flush=True)
        for label, name, over, do_serve in RUNS[arch]:
            rec = run_grid(arch, name, over, do_serve, args, device, ref)
            recs = [None] * WORLD
            dist.all_gather_object(recs, rec)
            tr = rec["train"]
            if not train_ok(tr):
                bad.append(f"{arch} {label} rank {rank}: train {tr}")
            sv = rec.get("serve")
            if sv is not None and not (sv["prefill_bf16_within_card_error"]
                                       and sv["prefill32_logits_within_1e-4"]
                                       and sv["tokens_agree_to_ties"]):
                bad.append(f"{arch} {label} rank {rank}: serve {sv}")
            if rank == 0:
                print(json.dumps({"arch": arch, "grid": label,
                                  "shape": list(GRIDS[name][0]),
                                  "axes": list(GRIDS[name][1]),
                                  "overrides": over, "seq": args.seq,
                                  "rows_per_dp_rank": ROWS[arch],
                                  "ranks": recs}), flush=True)
    flags = [None] * WORLD
    dist.all_gather_object(flags, bad)
    # torn down only after a clean run: a rank that raised leaves its
    # peers inside a collective, and tearing down beside them can hang
    dist.destroy_process_group()
    release_grids()
    errors = [e for f in flags for e in f]
    if errors:
        raise AssertionError("; ".join(errors))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["qwen3-4b"],
                    help=f"archs to run, in order, or ALL: {', '.join(ARCHS)}")
    ap.add_argument("--resume", default=None, choices=ARCHS,
                    help="also save this arch on 2x2 and resume it on 4x1")
    ap.add_argument("--ckpt-dir", default=os.path.join(ROOT, "build",
                                                       "lm_grid_resume"),
                    help="--resume's checkpoint directory (removed after)")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced() configs (a rehearsal)")
    ap.add_argument("--seq", type=int, default=TRAIN_SEQ)
    ap.add_argument("--checks-only", action="store_true",
                    help="the comparisons alone: no timed training steps "
                         "or serving runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.arch == ["ALL"]:
        args.arch = list(ARCHS)
    unknown = set(args.arch) - set(ARCHS)
    if unknown:
        ap.error(f"unknown arch {sorted(unknown)}; one of {', '.join(ARCHS)}")
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
