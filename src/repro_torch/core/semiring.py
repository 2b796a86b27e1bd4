"""Semirings of the diBELLA 2D sparse algebra, on dicts of torch tensors.

The PyTorch counterpart of ``repro.core.semiring``.  A value is a dict of
tensors whose leading dimensions are broadcast dimensions (the JAX package
uses a bare array for the min-plus value; here it is the single entry
``{MP: array}``, so every ELL value is a dict).

Besides ``mul``/``add``/``zero``/``is_zero`` each semiring carries
``reduce_runs``: the ⊕-total of each run of a run-sorted stream.  The JAX
package computes those totals with a segmented ``associative_scan`` and
reads only the last element of each run; here each total is computed
directly — an ``amin`` for min-plus, a sum for counts, the first element
for ``first``, and for the overlap semiring the first ``NUM_POS_PAIRS``
valid position pairs by rank in the run.  ``tests/test_torch_foundation.py``
holds every ``reduce_runs`` equal to the left fold of its ``add``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

INF = float("inf")
#: shared k-mer position pairs kept per read pair (paper §IV-D)
NUM_POS_PAIRS = 2
#: dict key of the min-plus 4-vector value
MP = "v"
_NOPOS = -1

Vals = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (⊕, ⊗) pair over dict values.

    Attributes:
      name: identifier.
      mul: ``(a_vals, b_vals) -> vals``, elementwise over broadcast dims.
      add: ``(x, y) -> vals``, the associative combine.
      zero: ``(prefix_shape, device) -> vals``, the additive identity.
      is_zero: ``vals -> bool tensor`` of the broadcast shape.
      reduce_runs: ``(vals, run_id, run_start) -> vals`` — the ⊕-total of
        each run of a stream whose runs are contiguous (``run_id`` (E,)
        non-decreasing int64, ``run_start`` (R,) the first index of each
        run); the result has leading dim R.
    """

    name: str
    mul: Callable
    add: Callable
    zero: Callable
    is_zero: Callable
    reduce_runs: Callable


# ---------------------------------------------------------------------------
# MinPlus semiring with bidirected-walk validity (paper Algorithm 3).
# ---------------------------------------------------------------------------


def _mp_mul(a: Vals, b: Vals) -> Vals:
    """2×2 min-plus product over the trailing orientation axis:
    ``out[2x+y] = min_c a[2x+c] + b[2c+y]``."""
    x, y = a[MP], b[MP]
    prefix = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    am = x.reshape(x.shape[:-1] + (2, 2))
    bm = y.reshape(y.shape[:-1] + (2, 2))
    s = am[..., :, :, None] + bm[..., None, :, :]
    return {MP: torch.amin(s, dim=-2).reshape(prefix + (4,))}


def _mp_add(x: Vals, y: Vals) -> Vals:
    return {MP: torch.minimum(x[MP], y[MP])}


def _mp_zero(prefix_shape, device=None) -> Vals:
    return {MP: torch.full(tuple(prefix_shape) + (4,), INF,
                           dtype=torch.float32, device=device)}


def _mp_is_zero(v: Vals) -> torch.Tensor:
    return torch.all(~torch.isfinite(v[MP]), dim=-1)


def _mp_reduce_runs(vals: Vals, run_id, run_start) -> Vals:
    v = vals[MP]
    out = torch.full((run_start.numel(),) + v.shape[1:], INF,
                     dtype=v.dtype, device=v.device)
    idx = run_id.reshape((-1,) + (1,) * (v.dim() - 1)).expand(v.shape)
    return {MP: out.scatter_reduce_(0, idx, v, "amin", include_self=True)}


minplus_orient_semiring = Semiring(
    name="minplus_orient",
    mul=_mp_mul,
    add=_mp_add,
    zero=_mp_zero,
    is_zero=_mp_is_zero,
    reduce_runs=_mp_reduce_runs,
)


# ---------------------------------------------------------------------------
# Overlap-detection semiring for C = A·Aᵀ (paper §IV-D).
# A-values {"pos": int32}; C-values {"cnt": int32, "apos"/"bpos":
# (NUM_POS_PAIRS,) int32}.  ⊗ turns one shared k-mer into (cnt=1, its
# position pair); ⊕ sums counts and keeps the first NUM_POS_PAIRS pairs.
# ---------------------------------------------------------------------------


def _ov_mul(a: Vals, b: Vals) -> Vals:
    apos = a["pos"].to(torch.int32)
    bpos = b["pos"].to(torch.int32)
    shape = torch.broadcast_shapes(apos.shape, bpos.shape)
    apos = apos.expand(shape)
    bpos = bpos.expand(shape)
    pad = torch.full(tuple(shape) + (NUM_POS_PAIRS - 1,), _NOPOS,
                     dtype=torch.int32, device=apos.device)
    return {
        "cnt": torch.ones(shape, dtype=torch.int32, device=apos.device),
        "apos": torch.cat([apos[..., None], pad], dim=-1),
        "bpos": torch.cat([bpos[..., None], pad], dim=-1),
    }


def _take_first_pairs(xa, xb, xn, ya, yb):
    """Concatenate y's pairs after x's xn valid pairs, truncate."""
    s = torch.arange(NUM_POS_PAIRS, device=xa.device)
    xn_b = xn[..., None]
    from_x = s < xn_b
    yidx = torch.clamp(s - xn_b, 0, NUM_POS_PAIRS - 1).to(torch.int64)
    yidx = yidx.expand(ya.shape)
    out_a = torch.where(from_x, xa, torch.gather(ya, -1, yidx))
    out_b = torch.where(from_x, xb, torch.gather(yb, -1, yidx))
    return out_a, out_b


def _ov_add(x: Vals, y: Vals) -> Vals:
    xn = torch.clamp(x["cnt"], max=NUM_POS_PAIRS)
    out_a, out_b = _take_first_pairs(x["apos"], x["bpos"], xn, y["apos"],
                                     y["bpos"])
    return {"cnt": x["cnt"] + y["cnt"], "apos": out_a, "bpos": out_b}


def _ov_zero(prefix_shape, device=None) -> Vals:
    shape = tuple(prefix_shape)
    return {
        "cnt": torch.zeros(shape, dtype=torch.int32, device=device),
        "apos": torch.full(shape + (NUM_POS_PAIRS,), _NOPOS, dtype=torch.int32,
                           device=device),
        "bpos": torch.full(shape + (NUM_POS_PAIRS,), _NOPOS, dtype=torch.int32,
                           device=device),
    }


def _ov_is_zero(v: Vals) -> torch.Tensor:
    return v["cnt"] == 0


def _ov_reduce_runs(vals: Vals, run_id, run_start) -> Vals:
    # each element holds min(cnt, P) valid pairs in its first slots; the
    # run total keeps the first P valid pairs in run order: element e's pair
    # t lands in output slot off_e + t, where off_e counts the valid pairs
    # of the run's earlier elements
    cnt = vals["cnt"]
    r = run_start.numel()
    total = torch.zeros(r, dtype=torch.int32, device=cnt.device)
    total.index_add_(0, run_id, cnt)
    nv = torch.clamp(cnt, 0, NUM_POS_PAIRS).to(torch.int64)
    excl = torch.cumsum(nv, 0) - nv
    off = excl - excl[run_start][run_id]
    out = _ov_zero((r,), cnt.device)
    out["cnt"] = total
    for s in range(NUM_POS_PAIRS):
        t = s - off
        sel = (t >= 0) & (t < nv)
        tt = torch.clamp(t, 0, NUM_POS_PAIRS - 1)[:, None]
        dst = run_id[sel]
        for key in ("apos", "bpos"):
            src = torch.gather(vals[key], 1, tt)[:, 0]
            out[key][dst, s] = src[sel]
    return out


overlap_semiring = Semiring(
    name="overlap_pospair",
    mul=_ov_mul,
    add=_ov_add,
    zero=_ov_zero,
    is_zero=_ov_is_zero,
    reduce_runs=_ov_reduce_runs,
)


# ---------------------------------------------------------------------------
# Utility semirings (single-leaf values under the key "x").
# ---------------------------------------------------------------------------


def _sum_runs(vals: Vals, run_id, run_start) -> Vals:
    x = vals["x"]
    out = torch.zeros((run_start.numel(),) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    return {"x": out.index_add_(0, run_id, x)}


def _any_runs(vals: Vals, run_id, run_start) -> Vals:
    x = vals["x"].to(torch.int32)
    out = torch.zeros((run_start.numel(),) + x.shape[1:], dtype=torch.int32,
                      device=x.device)
    return {"x": out.index_add_(0, run_id, x) > 0}


bool_semiring = Semiring(
    name="bool",
    mul=lambda a, b: {"x": torch.logical_and(a["x"], b["x"])},
    add=lambda a, b: {"x": torch.logical_or(a["x"], b["x"])},
    zero=lambda s, device=None: {"x": torch.zeros(tuple(s), dtype=torch.bool,
                                                  device=device)},
    is_zero=lambda v: ~v["x"],
    reduce_runs=_any_runs,
)

count_semiring = Semiring(
    name="count",
    mul=lambda a, b: {"x": a["x"].to(torch.int32) * b["x"].to(torch.int32)},
    add=lambda a, b: {"x": a["x"] + b["x"]},
    zero=lambda s, device=None: {"x": torch.zeros(tuple(s), dtype=torch.int32,
                                                  device=device)},
    is_zero=lambda v: v["x"] == 0,
    reduce_runs=_sum_runs,
)


def tree_where(mask: torch.Tensor, a: Vals, b: Vals) -> Vals:
    """``torch.where`` over dict values; ``mask`` broadcasts on leading dims."""
    out = {}
    for key, x in a.items():
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        out[key] = torch.where(m, x, b[key])
    return out


def tree_take(vals: Vals, idx: torch.Tensor, axis: int = 0) -> Vals:
    """``index_select`` of every leaf along ``axis`` (``idx`` any shape)."""
    idx = idx.to(torch.int64)
    out = {}
    for key, x in vals.items():
        taken = torch.index_select(x, axis, idx.reshape(-1))
        shape = x.shape[:axis] + idx.shape + x.shape[axis + 1:]
        out[key] = taken.reshape(shape)
    return out


def tree_map(fn, vals: Vals) -> Vals:
    """Apply ``fn`` to every leaf of a dict value."""
    return {key: fn(x) for key, x in vals.items()}


def reduce_rows(semiring: Semiring, vals: Vals) -> Vals:
    """⊕-reduce leaves of leading shape ``(n, q, ...)`` along axis 1 (the
    left fold over q, as a run per row)."""
    leaf = next(iter(vals.values()))
    n, q = leaf.shape[0], leaf.shape[1]
    dev = leaf.device
    flat = {k: x.reshape((n * q,) + x.shape[2:]) for k, x in vals.items()}
    run_id = torch.arange(n, device=dev).repeat_interleave(q)
    run_start = torch.arange(n, device=dev) * q
    return semiring.reduce_runs(flat, run_id, run_start)
