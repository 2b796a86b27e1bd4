#!/usr/bin/env python3
"""Time variants of the port's x-drop kernel on one NVIDIA card.

    python3 scripts/xdrop_variants.py            # chip_smoke.py's 4000 reads
    python3 scripts/xdrop_variants.py --genome-kb 40 --reps 3

Runs ``assemble()`` (gspmd, ``device="cuda"``) on ``chip_smoke.py``'s
reads and configuration and captures every ``xdrop_extend`` call.  Two
inputs follow: the first chunk (4096 pairs x 2 directions, the launch
``chip_smoke.py`` times) and all live pairs of the run in one launch (the
shard_map path's launch), each flattened to one direction of 2E pairs.
Each runs through variants of ``csrc/xdrop.cu`` built from edited copies
of the source, in the launch's own order (its counting sort by
min(len_a, len_b), descending), and through ``given_order``, the source
without that sort, in three orders: as the pipeline gives the pairs; a
torch argsort of min(len_a, len_b), descending; and by the steps each
pair really runs, descending (known only after the run).  Every output
must equal the wrapper's; the CUDA-event time of each (input, order,
variant) is printed as one JSON line, after the wrapper's own time on the
first chunk and that of a torch argsort of its order alone.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, [(text in csrc/xdrop.cu, replacement), ...])
SORT_LAUNCH = """  order_kernel<<<1, ORDER_THREADS, 0, st>>>(
      (const int*)len_a, (const int*)len_b, pairs, (int*)order);
"""
VARIANTS = [
    ("as_is", []),
    # the order argument taken as given instead of the launch's own sort
    ("given_order", [(SORT_LAUNCH, "")]),
    ("min_blocks_16", [("__launch_bounds__(32 * WARPS)",
                        "__launch_bounds__(32 * WARPS, 16)")]),
    ("min_blocks_12", [("__launch_bounds__(32 * WARPS)",
                        "__launch_bounds__(32 * WARPS, 12)")]),
    ("warps_8", [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")]),
    ("signed_range", [("hd[r] = ((unsigned)(q - qlo) < span && h >= thr)",
                       "hd[r] = (q >= qlo && q - qlo < (int)span && h >= thr)")]),
]


def build_variants(out_dir):
    """Compile each variant's edited source with the port's nvcc flags,
    all at once; returns {name: (ctypes function, ptxas lines)}."""
    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, find_nvcc
    from repro_torch.kernels.xdrop.ops import KERNEL

    os.makedirs(out_dir, exist_ok=True)
    src = open(CSRC / "xdrop.cu").read()
    procs = []
    for name, edits in VARIANTS:
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in xdrop.cu")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        so = os.path.join(out_dir, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs.append((name, so, subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, so, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        fn = ctypes.CDLL(so).xdrop_launch
        fn.argtypes, fn.restype = KERNEL.argtypes, ctypes.c_int
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "registers" in ln]
        fns[name] = (fn, regs)
    return fns


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-kb", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch.assembly import simulate as sim
    from repro_torch.assembly.pipeline import PipelineConfig, assemble
    from repro_torch.core import backend as B
    from repro_torch.kernels.build import stream_handle

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    fns = build_variants(os.path.join(ROOT, "build", "xdrop_variants"))
    print(f"[build] {len(fns)} variants in {time.perf_counter() - t0:.1f} s")
    for name, (_, regs) in fns.items():
        print(f"[build] {name}: {regs}")

    reads = chip_smoke.simulate(sim, args.genome_kb, args.seed)
    cfg = PipelineConfig(
        m_capacity=1 << 20, upper=56, read_capacity=160, overlap_capacity=64,
        r_capacity=40, band=65, max_steps=4096, xdrop=30, align_chunk=4096,
        device="cuda")
    calls = []

    def capture(*a, **kw):
        calls.append((a, kw))
        return K.xdrop_extend_batch(*a, **kw)

    B.register_op("xdrop_extend", "cuda", capture)
    assemble(reads.codes, reads.lengths, cfg)
    B.register_op("xdrop_extend", "cuda", K.xdrop_extend_batch)
    kw = calls[0][1]

    def flat(call_list):
        """One direction of 2E pairs: rows repeated per direction."""
        a = torch.cat([c[0][0] for c in call_list])
        b = torch.cat([c[0][4] for c in call_list])
        walks = [torch.cat([c[0][t] for c in call_list], dim=1)
                 for t in (1, 2, 3, 5, 6, 7)]
        d = walks[0].shape[0]
        return (a.repeat(d, 1), b.repeat(d, 1),
                [w.reshape(-1).contiguous() for w in walks])

    # the wrapper on the first captured call, and a torch argsort of the
    # same order alone (what the launch's own counting sort replaces)
    (ca, ckw) = calls[0]
    lens = (ca[3], ca[7])
    for name, fn in (
            ("wrapper", lambda: K.xdrop_extend_batch(*ca, **ckw)),
            ("torch_argsort_only", lambda: torch.argsort(
                torch.minimum(*lens).reshape(-1),
                descending=True).to(torch.int32))):
        print(json.dumps({"input": "chunk0", "pairs": ca[1].numel(),
                          "order": "min_len_desc", "variant": name,
                          "ms": chip_smoke.time_ms(fn, args.reps)}),
              flush=True)

    inputs = {"chunk0": flat(calls[:1]), "all_live": flat(calls)}
    for label, (a, b, w) in inputs.items():
        e = a.shape[0]
        *_, steps = K.xdrop_extend_batch_ref(a, w[0], w[1], w[2], b, w[3],
                                             w[4], w[5], **kw,
                                             with_steps=True)
        want = K.xdrop_extend_batch(a, *w[:3], b, *w[3:], **kw)
        orders = {
            "pipeline": torch.arange(e, device=a.device),
            "min_len_desc": torch.argsort(-torch.minimum(w[2], w[5]),
                                          stable=True),
            "steps_desc": torch.argsort(-steps, stable=True),
        }
        runs = [("counting_sort", vname) for vname in fns
                if vname != "given_order"]
        runs += [(oname, "given_order") for oname in orders]
        for oname, vname in runs:
            fn = fns[vname][0]
            order = (orders[oname].to(torch.int32) if oname in orders
                     else torch.empty(e, dtype=torch.int32, device=a.device))
            out = [torch.empty(e, dtype=torch.int32, device=a.device)
                   for _ in range(3)]

            def launch():
                code = fn(a.data_ptr(), a.shape[1], w[0].data_ptr(),
                          w[1].data_ptr(), w[2].data_ptr(), b.data_ptr(),
                          b.shape[1], w[3].data_ptr(), w[4].data_ptr(),
                          w[5].data_ptr(), order.data_ptr(), e, e,
                          kw["band"], kw["max_steps"], kw["xdrop"],
                          kw["match"], kw["mismatch"], kw["gap"],
                          *(o.data_ptr() for o in out), stream_handle(a))
                if code:
                    raise SystemExit(f"{vname}: launch failed ({code})")
            ms = chip_smoke.time_ms(launch, args.reps)
            if not all(torch.equal(o, x) for o, x in zip(out, want)):
                raise SystemExit(f"{label}/{oname}/{vname}: output differs")
            print(json.dumps({"input": label, "pairs": e, "order": oname,
                              "variant": vname, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
