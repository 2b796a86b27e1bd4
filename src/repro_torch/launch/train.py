"""End-to-end training entry point with fault tolerance (the port of
``repro.launch.train``, its single-device path).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --reduced --device cpu --steps 50 --ckpt-dir build/ckpt [--resume] \\
        [--compress int8]

Deterministic resume from the latest checkpoint (the data pipeline
regenerates exactly the batches ≥ the restored step), atomic asynchronous
checkpoints with a keep policy, straggler monitoring, and gradient
compression with error feedback.  It runs on the card (``--device cuda``,
the default) and raises at once without one.  Parameters come from a
``torch.Generator`` seeded with ``--seed`` (JAX's distributions, not JAX's
numbers); to start from JAX's state, write it as this package's checkpoint
(``convert.lm_train_state_from_numpy``, ``CheckpointManager.save``) and
pass ``--resume``.

``make_state(mesh=)`` and ``build_train_step(mesh=)`` run the step on a
``ProcessGrid`` (one rank a card): the parameters placed by the sharding
rules (FSDP by default), the moments beside them, and each rank fed its
data-parallel rows, ``SyntheticLMData.batch_at(step, shard=dp_index,
n_shards=n_dp)`` (``rank_batch``).  ``main`` stays JAX's single-device
entry point.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager, restore_latest
from ..configs import get_config, reduced_config
from ..core.backend import resolve_device
from ..data import SyntheticLMData, as_tensors
from ..models.model import init_params, loss_and_grads
from ..models.model import as_grid, param_specs
from ..optim import AdamW, cosine_schedule, global_norm
from ..runtime import CompressedAllReduce, StragglerMonitor
from ..runtime.sharding import batch_sharding, dp_axes, shard_model


def make_state(cfg, opt: AdamW, gen: torch.Generator, mesh=None,
               fsdp: bool = True):
    """``(model, opt_state, 0)``: a trainable f32 model drawn from ``gen``
    on its device and zero moments.  With ``mesh`` (a ``ProcessGrid``;
    every rank draws the same model from the same seed) each rank keeps
    its blocks by the sharding rules, and the moments follow them."""
    model = init_params(cfg, gen, train=True)
    if mesh is not None:
        model = shard_model(model, as_grid(mesh), fsdp=fsdp)
    return (model, opt.init(dict(model.named_parameters())), 0)


def rank_batch(data: SyntheticLMData, step: int, grid) -> dict:
    """This rank's rows of step ``step``'s batch on ``grid``: its
    data-parallel shard, or the whole batch where ``batch_sharding``
    replicates it."""
    dp = dp_axes(grid)
    if not dp or batch_sharding(grid, data.batch_size) == ():
        return data.batch_at(step)
    return data.batch_at(step, shard=grid.axis_index(dp),
                         n_shards=grid.size(dp))


def build_train_step(cfg, opt: AdamW, comp: CompressedAllReduce, mesh=None):
    """Returns ``train_step(state, batch, err) -> (state, err, metrics)``:
    the loss's gradients, compressed with error feedback unless
    ``comp.mode == "none"``, then one optimizer step in place.  With
    ``mesh`` the batch is the rank's rows and the state its blocks; the
    gradients are reduced over the data axes and the norm is global."""
    grid = None if mesh is None else as_grid(mesh)

    def train_step(state, batch, err):
        model, opt_state, step = state
        loss, grads = loss_and_grads(model, batch, cfg, mesh=grid)
        if comp.mode != "none":
            grads, err = comp.compress_ef(grads, err)
        specs = param_specs(model)
        gnorm = global_norm(grads, grid=grid, specs=specs)
        opt.update_(grads, opt_state, dict(model.named_parameters()), step,
                    grid=grid, specs=specs)
        return (model, opt_state, step + 1), err, {
            "loss": loss, "grad_norm": gnorm}

    return train_step


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """JAX train's flags plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", choices=["none", "bf16", "int8"],
                    default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Train as the flags say; returns the loss of every step run."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    opt = AdamW(learning_rate=cosine_schedule(args.lr, 10, args.steps))
    comp = CompressedAllReduce(mode=args.compress)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    state = make_state(cfg, opt, gen)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume:
            restored, step = restore_latest(args.ckpt_dir, state)
            if restored is not None:
                state = restored
                start_step = int(state[2])
                print(f"[resume] restored step {start_step}")
    err = (comp.init_error(dict(state[0].named_parameters()))
           if comp.mode != "none" else None)

    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, batch_size=args.batch, seq_len=args.seq,
        seed=args.seed, frontend=cfg.frontend, d_model=cfg.d_model,
    )
    step_fn = build_train_step(cfg, opt, comp)
    distributed = dist.is_available() and dist.is_initialized()
    monitor = StragglerMonitor(
        n_hosts=dist.get_world_size() if distributed else 1)
    host = dist.get_rank() if distributed else 0

    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = as_tensors(data.batch_at(step), device)
        state, err, metrics = step_fn(state, batch, err)
        loss = float(metrics["loss"])  # waits for the whole step's work
        losses.append(loss)
        dt = time.perf_counter() - t0
        monitor.report(host, dt)
        monitor.evaluate()
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):8.3f} {dt*1e3:7.1f} ms")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, meta={"arch": cfg.name})
    if mgr:
        mgr.save(args.steps, state, meta={"arch": cfg.name})
        mgr.wait()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
