"""Distributed x-drop extension along the candidate-pair axis, on a
``torch.distributed`` process grid.

The PyTorch counterpart of ``repro.core.align_dist``.  The alignment
stage's compacted candidate bucket is parallel per pair, so the bucket is
block-split over the grid rows (axis ``"data"``; the ranks of one grid row
do the same work, as ``shard_map`` replicates over the column axis), with
every exchanged word counted where it is issued:

1. **gather_reads** — each rank starts from its ``n/P`` row shard of the
   read codes; a ring all-gather of ``P − 1`` ``ppermute`` hops
   (``(n/P) · L`` words each) replicates the full matrix.
2. **extend** — the rank's ``bucket/P`` candidates below ``n_live`` (the
   pad slots repeat pair 0 and are not extended) gather their read rows,
   orient strand-1 partners with ``revcomp`` and run
   ``assembly.alignment.batch_extend`` (one ``xdrop_extend`` op call).
3. **scatter_scores** — the five ``PairAlignment`` int32 outputs stack into
   one ``(5, bucket)`` buffer; each rank writes only its own block and one
   ``psum`` replicates the result (``2 · (5 · bucket/P) · (P − 1)`` words
   per rank, a ring allreduce).

``exchange_words_align`` equals ``bench_comm_model.words_align``.  Every
pair sees the inputs of the single-device path, so the results are the
same bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .grid import ProcessGrid, resolve_grid
from .spmat import fill_pad_rows
from ..obs import span, validated

#: arrays of a PairAlignment result (score, bi, ei, bj, ej)
ALIGN_OUTPUTS = 5

#: cand dict keys, in the order the JAX program takes them
_CAND_KEYS = ("i", "j", "li", "lj", "pa", "pb", "strand")


def _pad_multiple(x: int, p: int) -> int:
    """Smallest multiple of ``p`` that is ≥ ``x``."""
    return -(-x // p) * p


def _counted_gather(grid: ProcessGrid, x: torch.Tensor, acct: Dict[str, int]
                    ) -> torch.Tensor:
    """Ring all-gather of the row shard ``x`` over the grid rows, counting
    the words of each hop: index ``t`` sends to ``t + 1``, so hop ``s``
    brings shard ``(t − s) mod P``."""
    p = grid.pr
    if p == 1:
        return x
    perm = [(t, (t + 1) % p) for t in range(p)]
    parts, cur = [x], x
    for _ in range(p - 1):
        acct["words"] += x.numel()
        acct["rounds"] += 1
        cur = grid.ppermute(cur, "data", perm)
        parts.append(cur)
    t = grid.i
    return torch.cat([parts[(t - q) % p] for q in range(p)], dim=0)


def align_bucket_shard_map(codes, cand: Dict[str, Any], *, k: int,
                           mesh: Optional[ProcessGrid] = None,
                           backend: str = "reference", xdrop: int = 15,
                           match: int = 1, mismatch: int = -1, gap: int = -1,
                           band: int = 33, max_steps: int = 512,
                           n_live: Optional[int] = None):
    """Run the compacted candidate bucket through the distributed x-drop
    extension (module docstring); returns ``(PairAlignment, stats)`` on
    every rank.

    ``codes`` is the full (n, L) uint8 read matrix, ``cand`` the pipeline's
    compaction dict (keys ``i, j, li, lj, pa, pb, strand``, each (bucket,)
    int32); every rank holds both.  Reads pad to a multiple of P with zero
    rows and the bucket with zero pairs, whose results are sliced off.
    ``mesh`` defaults to the P×1 grid (:meth:`ProcessGrid.rows`).

    ``n_live`` (default: the whole bucket) is the count of live pairs; the
    pairs from ``n_live`` on are pad slots that repeat pair 0's inputs.
    Each rank extends only its block's rows below ``max(n_live, 1)``, and
    after the ``psum`` the pad columns take column 0's result.  The
    exchanged buffer, and so the exchange counts, stay those of the whole
    bucket."""
    from ..assembly import alignment as al  # core never imports assembly
    from ..assembly.kmers import revcomp  # at module load

    grid = resolve_grid(mesh, "rows")
    p = grid.pr
    codes = torch.as_tensor(codes).to(torch.uint8)
    dev = codes.device
    n, row_width = codes.shape
    bucket = int(cand["i"].shape[0])
    n_rows = bucket if n_live is None else max(min(int(n_live), bucket), 1)
    n_pad, bucket_pad = _pad_multiple(n, p), _pad_multiple(bucket, p)
    if n_pad != n:
        codes = torch.cat([codes, torch.zeros((n_pad - n, row_width),
                                              dtype=torch.uint8, device=dev)])
    n_loc, blk = n_pad // p, bucket_pad // p
    lo = grid.i * blk

    def local(x):
        x = x.to(torch.int32)
        if bucket_pad != bucket:
            x = torch.cat([x, torch.zeros(bucket_pad - bucket,
                                          dtype=torch.int32, device=dev)])
        return x[lo:lo + blk]

    c = {key: local(cand[key]) for key in _CAND_KEYS}
    n_ext = max(0, min(blk, n_rows - lo))  # rows of the block to extend
    acct = {"words": 0, "rounds": 0}
    with span("Alignment", kind="phase", phase="pair_exchange", p=p,
              bucket=bucket_pad) as sp:
        with span("Alignment", kind="phase", phase="gather_reads"):
            codes_full = _counted_gather(
                grid, codes[grid.i * n_loc:(grid.i + 1) * n_loc].contiguous(),
                acct)

        with span("Alignment", kind="phase", phase="extend"):
            if n_ext:
                c = {key: x[:n_ext] for key, x in c.items()}
                ai = codes_full[c["i"].to(torch.int64)]
                bj = codes_full[c["j"].to(torch.int64)]
                bj = torch.where((c["strand"] == 1)[:, None],
                                 revcomp(bj, c["lj"]), bj)
                out = al.batch_extend(ai, c["li"], bj, c["lj"], c["pa"],
                                      c["pb"], k=k, backend=backend,
                                      xdrop=xdrop, match=match,
                                      mismatch=mismatch, gap=gap, band=band,
                                      max_steps=max_steps)

        with span("Alignment", kind="phase", phase="scatter_scores"):
            buf = torch.zeros((ALIGN_OUTPUTS, bucket_pad), dtype=torch.int32,
                              device=dev)
            if n_ext:
                buf[:, lo:lo + n_ext] = torch.stack(tuple(out)).to(torch.int32)
            if p > 1:
                acct["words"] += 2 * (ALIGN_OUTPUTS * bucket_pad // p) * (p - 1)
                acct["rounds"] += 1
            full = grid.psum(buf, "data")
        sp.set_output(full)

    res = al.PairAlignment(*(fill_pad_rows(full[t], n_rows, bucket)
                             for t in range(ALIGN_OUTPUTS)))
    stats = validated({
        "exchange_words_align": acct["words"],
        "exchange_rounds_align": acct["rounds"],
    }, context="align_bucket_shard_map", require_groups=("align_exchange",))
    return res, stats
