"""Distributed x-drop extension along the candidate-pair axis, on a
``torch.distributed`` process grid.

The PyTorch counterpart of ``repro.core.align_dist``.  The alignment
stage's compacted candidate bucket is parallel per pair, so the bucket is
block-split over the grid rows — the grid axes ``row_axes``, by default
``("pod", "data")`` where the grid has both (JAX's ``infer_row_axes``); the
ranks of one grid row do the same work, as ``shard_map`` replicates over
the column axis — with every exchanged word counted where it is issued:

1. **gather_reads** — each rank starts from its ``n/P`` row shard of the
   read codes; a ring all-gather of ``ppermute`` hops over each row axis,
   innermost first (``s − 1`` hops on an axis of size ``s``, each the words
   gathered so far), replicates the full matrix.
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

from typing import Any, Dict, Optional, Sequence

import torch

from .components_dist import ring_all_gather
from .grid import resolve_grid, resolve_row_axes
from .spmat import fill_pad_rows
from ..obs import span, validated

#: arrays of a PairAlignment result (score, bi, ei, bj, ej)
ALIGN_OUTPUTS = 5

#: cand dict keys, in the order the JAX program takes them
_CAND_KEYS = ("i", "j", "li", "lj", "pa", "pb", "strand")


def _pad_multiple(x: int, p: int) -> int:
    """Smallest multiple of ``p`` that is ≥ ``x``."""
    return -(-x // p) * p


def align_bucket_shard_map(codes, cand: Dict[str, Any], *, k: int,
                           mesh=None, row_axes: Optional[Sequence[str]] = None,
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
    ``mesh`` defaults to the P×1 grid (:meth:`ProcessGrid.rows`),
    ``row_axes`` to its ``("pod", "data")`` axes.

    ``n_live`` (default: the whole bucket) is the count of live pairs; the
    pairs from ``n_live`` on are pad slots that repeat pair 0's inputs.
    Each rank extends only its block's rows below ``max(n_live, 1)``, and
    after the ``psum`` the pad columns take column 0's result.  The
    exchanged buffer, and so the exchange counts, stay those of the whole
    bucket."""
    from ..assembly import alignment as al  # core never imports assembly
    from ..assembly.kmers import revcomp  # at module load

    grid = resolve_grid(mesh, "rows")
    row_axes = resolve_row_axes(grid, row_axes)
    p, i = grid.size(row_axes), grid.axis_index(row_axes)
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
    lo = i * blk

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
            codes_full = ring_all_gather(
                grid, codes[i * n_loc:(i + 1) * n_loc].contiguous(),
                row_axes, acct)

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
            full = grid.psum(buf, row_axes)
        sp.set_output(full)

    res = al.PairAlignment(*(fill_pad_rows(full[t], n_rows, bucket)
                             for t in range(ALIGN_OUTPUTS)))
    stats = validated({
        "exchange_words_align": acct["words"],
        "exchange_rounds_align": acct["rounds"],
    }, context="align_bucket_shard_map", require_groups=("align_exchange",))
    return res, stats
