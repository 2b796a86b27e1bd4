"""Dry run of the paper's cell: ``python -m repro_torch.launch.dryrun
--arch dibella [--reduced] [--mesh single|multi] [--tr-variant fused|full]
[--dibella-u U]``.

The port's counterpart of the ``dibella`` branch of
``repro.launch.dryrun.lower_cell``.  Torch cannot lower a program of host
loops and hand-called ops ahead of time, so the port runs the cell:

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

The record is written as JSON to ``--out`` (default
``build/dryrun/dibella__<mesh>[__reduced].json`` under the working
directory) and summarised on stdout.  The language-model archs' configs,
serving and training paths are ported (``launch/serve.py``,
``launch/train.py``), but their dry run (JAX's LM branch of
``lower_cell``) is not: ``--arch`` of an LM raises ``NotImplementedError``
(ROADMAP.md queue 1, item 14b.4).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from ..configs import get_config, reduced_config
from ..core.grid import ProcessGrid
from ..obs.trace import sync
from . import dibella_cell as DC
from .mesh import F32_ADD_MIN_OPS, PRODUCTION_SHAPES
from .roofline import RooflineTerms, roofline_fraction


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


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="dibella")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--tr-variant", choices=["fused", "full"],
                    default="fused")
    ap.add_argument("--dibella-u", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cfg = (reduced_config if args.reduced else get_config)(args.arch)
    if cfg.family != "assembly":
        raise NotImplementedError(
            f"arch {args.arch!r}: the language-model dry run is not ported "
            "yet (ROADMAP.md queue 1, item 14b.4); python -m "
            "repro_torch.launch.serve serves it and python -m "
            "repro_torch.launch.train trains it")
    if args.dibella_u:
        cfg = dataclasses.replace(cfg, kmer_capacity=args.dibella_u)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
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
