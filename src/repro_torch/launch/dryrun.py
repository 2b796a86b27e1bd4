"""Dry run of a cell: ``python -m repro_torch.launch.dryrun --arch dibella
[--reduced] [--mesh single|multi] [--tr-variant fused|full] [--dibella-u
U]``, or for a language model ``--arch qwen3-4b --shape decode_32k [--batch
N] [--moe-impl ...] [--no-fsdp] ...`` (JAX's config flags).

The port's counterpart of ``repro.launch.dryrun.lower_cell``.  Torch
cannot lower a program of host loops and hand-called ops ahead of time, so
the port computes what needs no program and runs the rest.  The paper's
cell:

* on the grid the process group forms (1×1 without one, one rank a card
  under ``torchrun``), with inputs drawn from ``--seed``
  (``launch/dibella_cell.make_inputs``), it times the overlap SpGEMM and
  the transitive reduction and records, per stage, the argument bytes, the
  allocator's peak above them as ``temp``, the output bytes, the grid's
  collective bytes by op, the measured ``ms`` and (TR) ``tr_iterations``;
* the record's ``RooflineTerms`` take JAX's analytic operation count
  (``dibella_cell.model_ops``) on the H100's f32 add/min rate, the bytes
  of every stage argument read once and output written once, and the
  measured collective bytes;
* for the production grid of ``--mesh`` (256 or 512 ranks, which no single
  host forms) it gives only the per-rank argument bytes of each stage, from
  ``build_cells``' specs — the counterpart of JAX's
  ``memory_analysis().argument_size_in_bytes``; nothing is timed there.

A language-model cell (``lm_record``):

* ``production``: for the production grid of ``--mesh`` (never formed),
  without a process group, the per-rank argument bytes by the sharding
  rules on ``meta`` specs — for ``train`` the f32 parameters (FSDP unless
  ``--no-fsdp``) with both moments, for prefill and decode the bf16 serve
  parameters (no FSDP) with the ``cache_sharding(seq_sharded=True)``
  caches — plus the batch by ``batch_sharding``: the counterpart of
  ``memory_analysis().argument_size_in_bytes``; JAX's ``analytic_costs``
  per chip, ``model_flops`` and the roofline terms (collective bytes are
  not computed without a lowering); whether the arguments fit the card's
  80 GB; ``skipped`` where ``runs_cell`` is false;
* ``measured``: one step of the cell on the grid the process group forms
  (1×1 without one) at the per-rank batch of the production grid (the
  global batch ÷ its data-parallel size), cut by ``--batch`` (the cut is
  recorded): its wall ms (a second call, after one that warms up), the
  allocator's peak and the grid's collective bytes by op.

The record is written as JSON to ``--out`` (default
``build/dryrun/<arch>__[<shape>__]<mesh>[__reduced].json`` under the
working directory) and summarised on stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

import torch

from ..configs import SHAPES, get_config, reduced_config, runs_cell
from ..core.grid import ProcessGrid
from ..obs.trace import sync
from . import dibella_cell as DC
from .mesh import F32_ADD_MIN_OPS, PRODUCTION_SHAPES
from .roofline import (
    RooflineTerms,
    analytic_costs,
    model_flops,
    roofline_fraction,
)

#: the card's memory, the bound a cell's per-rank arguments must fit
CARD_BYTES = 80e9


def run_stage(fn, args, grid: ProcessGrid, device) -> Dict[str, Any]:
    """One call of a cell program: its outputs, wall time, memory and
    collective bytes."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    grid.reset_collective_bytes()
    t0 = time.perf_counter()
    out = sync(fn(*args))
    ms = (time.perf_counter() - t0) * 1e3
    coll = grid.reset_collective_bytes()
    arg_b, out_b = DC.tree_bytes(args), DC.tree_bytes(out)
    peak = torch.cuda.max_memory_allocated(dev) - base if cuda else None
    return {
        "out": out, "ms": ms,
        "collective_bytes_per_device": sum(coll.values()),
        "collective_by_op": coll,
        "memory": {"argument": arg_b, "output": out_b,
                   "temp": None if peak is None else max(0, peak - out_b),
                   "peak_above_arguments": peak},
    }


def run_cell(cfg, grid: ProcessGrid, *, fused_tr: bool = True,
             row_chunk: Optional[int] = 4096, seed: int = 0,
             device="cuda", inputs=None) -> Dict[str, Any]:
    """Draw the inputs (unless given), run both stages on ``grid`` and
    return ``{"record", "outputs", "inputs"}``: the dry-run record and each
    stage's outputs and inputs."""
    t0 = time.perf_counter()
    if inputs is None:
        inputs = DC.make_inputs(cfg, grid, seed=seed, device=device)
    sync(inputs)
    gen_s = time.perf_counter() - t0
    cells = DC.build_cells(cfg, grid, fused_tr=fused_tr, row_chunk=row_chunk)
    chips = grid.pr * grid.pc
    rec: Dict[str, Any] = {
        "arch": cfg.name, "n_reads": cfg.n_reads, "m_kmers": cfg.m_kmers,
        "grid": list(grid.sizes), "axes": list(grid.axis_names),
        "chips": chips, "row_chunk": row_chunk, "fused_tr": fused_tr,
        "seed": seed, "input_seconds": gen_s, "stages": {},
    }
    outputs = {}
    tot_bytes = tot_coll = peak_mem = 0
    for stage, (fn, _) in cells.items():
        st = run_stage(fn, inputs[stage], grid, device)
        outputs[stage] = st.pop("out")
        if stage == "tr":
            st["tr_iterations"] = int(outputs[stage][2])
            st["nnz"] = int(outputs[stage][3])
        else:
            st["overflow"] = int(outputs[stage][2])
        rec["stages"][stage] = st
        mem = st["memory"]
        reads = mem["argument"] * (st.get("tr_iterations", 1) or 1)
        tot_bytes += reads + mem["output"]
        tot_coll += st["collective_bytes_per_device"]
        peak_mem = max(peak_mem, mem["argument"] + (mem["peak_above_arguments"]
                                                     or mem["output"]))
    ops = DC.model_ops(cfg, grid.pc)
    terms = RooflineTerms(
        arch=cfg.name, shape="train_4k", mesh="x".join(map(str, grid.sizes)),
        chips=chips, flops_per_device=ops / chips,
        bytes_per_device=float(tot_bytes),
        collective_bytes_per_device=float(tot_coll),
        model_flops_global=float(ops), peak_memory_bytes=float(peak_mem),
    ).finalize(peak_flops=F32_ADD_MIN_OPS)
    rec["roofline"] = terms.to_dict()
    rec["roofline_fraction"] = roofline_fraction(terms)
    return {"record": rec, "outputs": outputs, "inputs": inputs}


def production_record(cfg, mesh: str) -> Dict[str, Any]:
    """Per-rank argument bytes of each stage on the production grid
    ``mesh`` (``"single"`` or ``"multi"``), from the cell's specs."""
    shape, axes = PRODUCTION_SHAPES[mesh]
    specs = DC.cell_specs(cfg, shape, axes)
    return {"mesh": mesh, "grid": list(shape), "axes": list(axes),
            "chips": int(torch.tensor(shape).prod()),
            "row_axes": list(DC.cell_row_axes(axes)),
            "argument_bytes_per_device": {
                stage: DC.tree_bytes(s) for stage, s in specs.items()}}


# ---------------------------------------------------------------------------
# Language-model cells
# ---------------------------------------------------------------------------


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def lm_argument_bytes(cfg, shape, grid, *, fsdp: bool) -> Dict[str, int]:
    """Per-rank argument bytes of one step of ``cfg`` at ``shape`` on
    ``grid`` (a ``ProcessGrid`` or a ``runtime.sharding.GridShape``), by
    part, from the sharding rules on ``meta`` specs (JAX's
    ``argument_size_in_bytes``)."""
    from ..configs import batch_specs, cache_specs
    from ..models.model import LanguageModel
    from ..runtime.sharding import (
        apply_sharding_rules,
        batch_sharding,
        cache_sharding,
        shard_shape,
        tree_map2,
    )

    meta = LanguageModel(cfg, device="meta")
    train = shape.kind == "train"
    specs = apply_sharding_rules(meta, grid, fsdp=fsdp if train else False)
    # JAX's train state is f32; its serve parameters are all bf16
    pdt = torch.float32 if train else torch.bfloat16
    params = sum(_nbytes(shard_shape(p.shape, specs[n], grid), pdt)
                 for n, p in meta.named_parameters())
    out = {"params": params}
    if train:
        out["moments"] = 2 * params
        out["step"] = 4
    else:
        caches = cache_specs(cfg, shape)
        cspecs = cache_sharding(grid, caches, seq_sharded=True)
        sizes = []
        tree_map2(lambda c, sp: sizes.append(
            _nbytes(shard_shape(c.shape, sp, grid), c.dtype)), caches, cspecs)
        out["caches"] = sum(sizes)
        if shape.kind == "decode":
            out["pos"] = 4
    out["batch"] = sum(
        _nbytes(shard_shape(t.shape, batch_sharding(grid, t.shape[0]), grid),
                t.dtype) for t in batch_specs(cfg, shape).values())
    return out


def lm_production_record(cfg, shape, mesh: str, *, fsdp: bool
                         ) -> Dict[str, Any]:
    """The production grid's record of an LM cell (see the module
    docstring); no process group is needed."""
    from ..runtime.sharding import GridShape

    sizes, axes = PRODUCTION_SHAPES[mesh]
    grid = GridShape(tuple(sizes), tuple(axes))
    chips = math.prod(sizes)
    args = lm_argument_bytes(cfg, shape, grid, fsdp=fsdp)
    total = sum(args.values())
    flops, hbm = analytic_costs(cfg, shape.kind, shape.seq_len,
                                shape.global_batch, chips)
    terms = RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh=mesh, chips=chips,
        flops_per_device=flops, bytes_per_device=hbm,
        collective_bytes_per_device=0.0,
        model_flops_global=model_flops(cfg, shape.kind, shape.seq_len,
                                       shape.global_batch),
        peak_memory_bytes=float(total),
    ).finalize()
    return {
        "mesh": mesh, "grid": list(sizes), "axes": list(axes), "chips": chips,
        "memory": {"argument_bytes_per_device": total,
                   "argument_by_part": args,
                   "fits_80GB": bool(total < CARD_BYTES)},
        "collective_bytes": None,  # needs a lowering; see "measured"
        "roofline": terms.to_dict(),
        "roofline_fraction": roofline_fraction(terms),
    }


def _rank_rows(batch, grid, n_rows: int):
    """This rank's rows of a batch of ``n_rows`` rows per data-parallel
    rank."""
    from ..runtime.sharding import dp_axes

    i = grid.axis_index(dp_axes(grid))
    return {k: v[i * n_rows:(i + 1) * n_rows] for k, v in batch.items()}


def lm_measured_record(cfg, shape, grid: ProcessGrid, *, rows: int, seed: int,
                       device, fsdp: bool, mixed_precision: bool
                       ) -> Dict[str, Any]:
    """One step of ``cfg`` at ``shape`` on ``grid`` with ``rows`` rows per
    data-parallel rank: wall ms of the second call, the allocator's peak,
    the grid's collective bytes by op, and the analytic roofline of the
    measured batch."""
    from ..data import SyntheticLMData, as_tensors
    from ..launch.serve import make_prompt
    from ..launch.train import make_state
    from ..models import model as M
    from ..optim import AdamW, cosine_schedule
    from ..runtime.sharding import dp_axes, shard_model

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gbatch = rows * grid.size(dp_axes(grid))
    gen = torch.Generator(device=dev).manual_seed(seed)
    if shape.kind == "train":
        opt = AdamW(learning_rate=cosine_schedule(3e-4, 100, 10000))
        state = make_state(cfg, opt, gen, mesh=grid, fsdp=fsdp)
        step = M.make_train_step(cfg, opt, mesh=grid,
                                 mixed_precision=mixed_precision)
        data = SyntheticLMData(vocab_size=cfg.vocab_size, batch_size=gbatch,
                               seq_len=shape.seq_len, seed=seed,
                               frontend=cfg.frontend, d_model=cfg.d_model)
        batch = as_tensors(_rank_rows(data.batch_at(0), grid, rows), dev)

        def call():
            nonlocal state
            state, metrics = step(state, batch)
            return metrics["loss"]
    else:
        params = shard_model(M.init_params(cfg, gen), grid, fsdp=False)
        prompt_len = shape.seq_len if shape.kind == "prefill" else 1
        batch = _rank_rows(make_prompt(cfg, gbatch, prompt_len, seed, dev),
                           grid, rows)
        caches = M.init_cache(cfg, gbatch, shape.seq_len, device=dev,
                              mesh=grid, seq_sharded=True)
        if shape.kind == "prefill":
            fn = M.make_prefill_step(cfg, mesh=grid)

            def call():
                return fn(params, caches, batch)[0]
        else:
            fn = M.make_serve_step(cfg, mesh=grid,
                                   seq_shards=grid.shape["model"])

            def call():
                return fn(params, caches, batch, shape.seq_len - 1)[0]
    sync(call())  # warm-up
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    grid.reset_collective_bytes()
    t0 = time.perf_counter()
    out = sync(call())
    ms = (time.perf_counter() - t0) * 1e3
    coll = grid.reset_collective_bytes()
    chips = grid.pr * grid.pc
    flops, hbm = analytic_costs(cfg, shape.kind, shape.seq_len, gbatch, chips)
    terms = RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh="x".join(map(str, grid.sizes)),
        chips=chips, flops_per_device=flops, bytes_per_device=hbm,
        collective_bytes_per_device=float(sum(coll.values())),
        model_flops_global=model_flops(cfg, shape.kind, shape.seq_len, gbatch),
    ).finalize()
    return {
        "grid": list(grid.sizes), "axes": list(grid.axis_names),
        "chips": chips, "rows_per_rank": rows, "global_batch": gbatch,
        "ms": ms, "finite": bool(torch.isfinite(out).all()),
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "collective_bytes_per_device": sum(coll.values()),
        "collective_by_op": coll,
        "roofline": terms.to_dict(),
        "roofline_fraction": roofline_fraction(terms),
    }


def lm_record(args) -> Dict[str, Any]:
    """The dry-run record of an LM cell from parsed flags."""
    cfg = (reduced_config if args.reduced else get_config)(args.arch)
    cfg = dataclasses.replace(cfg, **_overrides(args))
    shape = SHAPES[args.shape]
    rec: Dict[str, Any] = {"arch": args.arch, "shape": args.shape,
                           "mesh": args.mesh, "fsdp": args.fsdp,
                           "overrides": _overrides(args)}
    if not runs_cell(args.arch, args.shape):
        rec.update(skipped=True, reason="pure full-attention arch at 524k "
                   "decode")
        return rec
    rec["production"] = lm_production_record(cfg, shape, args.mesh,
                                             fsdp=args.fsdp)
    sizes, axes = PRODUCTION_SHAPES[args.mesh]
    prod_dp = math.prod(s for s, a in zip(sizes, axes) if a != "model")
    grid = ProcessGrid.square()
    rows = max(1, shape.global_batch // prod_dp)
    cut = {"rows_per_rank": rows}
    if args.batch and args.batch < rows:
        cut = {"rows_per_rank": rows, "cut_to": args.batch}
        rows = args.batch
    if args.seq and args.seq < shape.seq_len:
        cut.update(seq_len=shape.seq_len, seq_cut_to=args.seq)
        shape = dataclasses.replace(shape, seq_len=args.seq)
    rec["batch_cut"] = cut
    rec["measured"] = lm_measured_record(
        cfg, shape, grid, rows=rows, seed=args.seed, device=args.device,
        fsdp=args.fsdp, mixed_precision=args.mixed_precision)
    return rec


def _overrides(args) -> Dict[str, Any]:
    """JAX's config flags as ``ModelConfig`` overrides."""
    out: Dict[str, Any] = {}
    if args.moe_impl:
        out["moe_impl"] = args.moe_impl
    for flag, field in (("ssd_bf16", "ssd_bf16"),
                        ("batch_over_model", "batch_over_model"),
                        ("sharded_cache_update", "sharded_cache_update"),
                        ("bf16_grad_act", "bf16_grad_activations"),
                        ("decode_unroll", "decode_unroll")):
        if getattr(args, flag):
            out[field] = True
    if args.ce_chunk:
        out["ce_chunk"] = args.ce_chunk
    if args.ssd_chunk:
        out["ssd_chunk"] = args.ssd_chunk
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="dibella")
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--tr-variant", choices=["fused", "full"],
                    default="fused")
    ap.add_argument("--dibella-u", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="LM: cut the measured rows per rank to this")
    ap.add_argument("--seq", type=int, default=None,
                    help="LM: cut the measured step's sequence to this")
    ap.add_argument("--fsdp", action="store_true", default=True)
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--mixed-precision", action="store_true")
    ap.add_argument("--ssd-bf16", action="store_true")
    ap.add_argument("--batch-over-model", action="store_true")
    ap.add_argument("--sharded-cache-update", action="store_true")
    ap.add_argument("--ce-chunk", type=int, default=None)
    ap.add_argument("--bf16-grad-act", action="store_true")
    ap.add_argument("--decode-unroll", action="store_true")
    ap.add_argument("--ssd-chunk", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    cfg = (reduced_config if args.reduced else get_config)(args.arch)
    if cfg.family != "assembly":
        rec = lm_record(args)
        if args.device != "cpu":
            rec["device"] = torch.cuda.get_device_name(torch.device(args.device))
        path = args.out or os.path.join(
            "build", "dryrun", f"{args.arch}__{args.shape}__{args.mesh}"
            f"{'__reduced' if args.reduced else ''}.json")
        if ProcessGrid.square().rank == 0:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec.get("skipped"):
                print(f"SKIP {args.arch} {args.shape}: {rec['reason']}")
            else:
                prod, meas = rec["production"], rec["measured"]
                print(json.dumps({
                    "arch": rec["arch"], "shape": rec["shape"],
                    "production": {"chips": prod["chips"],
                                   "memory": prod["memory"],
                                   "roofline_fraction":
                                       prod["roofline_fraction"]},
                    "measured": {k: meas[k] for k in (
                        "grid", "rows_per_rank", "ms", "peak_bytes",
                        "collective_by_op")}}, indent=1))
        return rec
    if args.dibella_u:
        cfg = dataclasses.replace(cfg, kmer_capacity=args.dibella_u)
    grid = ProcessGrid.square()
    res = run_cell(cfg, grid, fused_tr=args.tr_variant == "fused",
                   seed=args.seed,
                   device=args.device)
    rec = res["record"]
    rec["production"] = production_record(cfg, args.mesh)
    if args.device != "cpu":
        rec["device"] = torch.cuda.get_device_name(torch.device(args.device))
    path = args.out or os.path.join(
        "build", "dryrun",
        f"{args.arch}__{args.mesh}{'__reduced' if args.reduced else ''}.json")
    if grid.rank == 0:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        rt = rec["roofline"]
        print(json.dumps({
            "arch": rec["arch"], "n_reads": rec["n_reads"],
            "grid": rec["grid"],
            "ms": {s: v["ms"] for s, v in rec["stages"].items()},
            "tr_iterations": rec["stages"]["tr"]["tr_iterations"],
            "memory": {s: v["memory"] for s, v in rec["stages"].items()},
            "production_argument_bytes":
                rec["production"]["argument_bytes_per_device"],
            "roofline_fraction": rec["roofline_fraction"]}, indent=1))
        print(f"terms: compute={rt['compute_s']:.4e}s "
              f"memory={rt['memory_s']:.4e}s "
              f"collective={rt['collective_s']:.4e}s -> {rt['bottleneck']}")
    return rec


if __name__ == "__main__":
    main()
