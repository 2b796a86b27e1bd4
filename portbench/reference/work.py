"""Frozen work counts of the stages that the roofline shares measure, and
the card's peaks.

The work is what the algorithm needs on these reads, counted from the
reference's own intermediates (``reference.judge``), never from a launch's
shapes, padding or chunking, so any implementation of a stage is judged
on the same yardstick:

* Alignment — the x-drop band cells each candidate pair evaluates, both
  directions (8 int32 operations a cell: a compare, a select, three adds,
  two maxima and the x-drop test); the reference aligns only a sample of
  the pairs, so the cells are the sample's mean times the pairs aligned.
  Bytes: both reads of every pair, and each walk's six inputs and three
  outputs (int32).
* SpGEMM — the overlap semiring's products of A·Aᵀ (a ⊗ and a ⊕ each, int32)
  and the bytes of A and Aᵀ (a column and a position each, int32) and of C
  (column, count and two position pairs).
* TrReduction — the two-hop min-plus products at R's pattern, each
  iteration (a 2×2 min-plus product and its fold: 16 float32 additions and
  minima), and the bytes of R as each iteration reads it and of S
  (a column and four float32 values an edge).
* Consensus — the (column, piece) positions tested for a vote (8 window
  comparisons, 8 additions and the vote: 17 int32 operations) and their
  bytes: each piece base read once, and per contig column the draft and
  polished bases (uint8) and the depth and agreement counts (int32).

A stage's least time is the larger of its operations over the peak rate of
their type and its bytes over the memory bandwidth.
"""

from __future__ import annotations

#: NVIDIA H100 SXM (data sheet; dense rates): float32 outside the tensor
#: cores 67 TFLOP/s counting an FMA as two, so 33.5 T additions or minima a
#: second; int32 at half the float32 issue rate; HBM3 3.35 TB/s
PEAKS = {"f32": 33.5e12, "int32": 16.75e12, "bytes": 3.35e12}

XDROP_OPS_PER_CELL = 8
SPGEMM_OPS_PER_PRODUCT = 2
MINPLUS_OPS_PER_PRODUCT = 16
VOTE_OPS = 17


def stage_work(*, n_aligned, sampled_cells, sampled_pairs, pair_read_bytes,
               nnz_a, nnz_at, nnz_c, products, tr_products, tr_sizes, nnz_s,
               votes, columns) -> dict:
    """Operations (with their type) and bytes of each measured stage."""
    mean_cells = (float(sampled_cells.sum()) / sampled_pairs
                  if sampled_pairs else 0.0)
    return {
        "Alignment": {
            "ops": XDROP_OPS_PER_CELL * mean_cells * n_aligned,
            "op_type": "int32",
            "bytes": pair_read_bytes + 2 * n_aligned * (6 + 3) * 4,
        },
        "SpGEMM": {
            "ops": SPGEMM_OPS_PER_PRODUCT * products,
            "op_type": "int32",
            "bytes": 8 * nnz_a + 8 * nnz_at + 24 * nnz_c,
        },
        "TrReduction": {
            "ops": MINPLUS_OPS_PER_PRODUCT * sum(tr_products),
            "op_type": "f32",
            "bytes": 20 * sum(tr_sizes) + 20 * nnz_s,
        },
        "Consensus": {
            "ops": VOTE_OPS * votes,
            "op_type": "int32",
            "bytes": votes + 10 * columns,
        },
    }


def least_time(w: dict):
    """``(seconds, bound)``: the stage's least time on the card and whether
    its operations or its bytes set it."""
    t_ops = w["ops"] / PEAKS[w["op_type"]]
    t_bytes = w["bytes"] / PEAKS["bytes"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
