"""Distributed contig chain stage — branch cut, pointer doubling, chain
ordering — on a ``torch.distributed`` process grid.

The PyTorch counterpart of ``repro.core.components_dist``.  The (2n,)
state arrays are block-split over the grid rows — the grid axes
``row_axes``, by default ``("pod", "data")`` where the grid has both (JAX's
``infer_row_axes``), with row index ``p · n_data + d``; the ranks of one
grid row repeat the same work — and every exchange is
explicit: ``ppermute`` ring all-gathers for the doubling jumps,
``ppermute`` partner exchanges for the sort network, ``psum`` / ``pmax``
for degree tallies, convergence tests and counts.

* :func:`doubling_shard_map` — the doubling middle ``break_cycles`` →
  ``path_components`` → ``chain_rank``.
* :func:`contig_stage_shard_map` — the whole chain stage: the distributed
  branch cut (per-shard degree tallies, one ``psum`` round), the doubling
  middle and the chain ordering by a ring-bitonic merge-split sort.

All ranks run the same loops: the convergence flags are ``psum``'d, so
every rank leaves a loop at the same round.  The arithmetic is the int32
doubling and sort-key math of ``core/components.py`` and
``assembly/contig_gen.py``, so the chain state and the ``path_components``
iteration count equal the single-device path's.  The exchange volume is
the analytic count of :func:`exchange_words` / :func:`exchange_words_sort`
/ :func:`exchange_words_cut` (twins of ``bench_comm_model``'s models), as
in the JAX module.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .components import _log2_ceil, expand_state_rows
from .grid import ProcessGrid, resolve_grid, resolve_row_axes
from ..obs import span

_I32 = torch.int32

# ring all-gathers issued per doubling round, by phase.  chain_rank reuses
# the convergence probe's gathered parent vector as the next round's jump
# table, so it pays 2 gathers per round (d + updated par) plus one initial
# parent gather.
GATHERS_PER_ROUND = {"break_cycles": 2, "path_components": 4, "chain_rank": 2}

# full-vector allreduces of the distributed branch cut: the in-degree tally
# (psum), the pred scatter (pmax over a −1-initialized buffer; in-degree 1
# makes it single-writer) and the in-suffix scatter (psum, single-writer).
# One ring allreduce ≙ reduce-scatter + all-gather = 2 ring gathers.
CUT_ALLREDUCES = 3

# words per element shipped by one merge-split hop of the chain sort: the
# (labkey, rank, idx) triple
SORT_WORDS = 3

# ineligible-chain sort key of assembly/contig_gen; padded states get +1 so
# they sort strictly last
_SORT_BIG = 2**30


def ring_all_gather(grid: ProcessGrid, x: torch.Tensor, row_axes,
                    acct: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """``ppermute`` ring all-gather of the row shard ``x`` over each of
    ``row_axes``, innermost first (JAX's nested per-axis rings): an axis of
    size ``s`` takes ``s − 1`` hops; index ``t`` receives shard ``(t − q)
    mod s`` on hop ``q``.  The result is in row order (``p · n_data + d``).
    ``acct`` (optional) counts each hop's words and one round per hop."""
    for ax in reversed(tuple(row_axes)):
        s = grid.size(ax)
        if s == 1:
            continue
        perm = [(t, (t + 1) % s) for t in range(s)]
        parts, cur = [x], x
        for _ in range(s - 1):
            if acct is not None:
                acct["words"] += x.numel()
                acct["rounds"] += 1
            cur = grid.ppermute(cur, ax, perm)
            parts.append(cur)
        t = grid.axis_index(ax)
        x = torch.cat([parts[(t - q) % s] for q in range(s)], dim=0)
    return x


def _closures(grid: ProcessGrid, row_axes):
    def gather(x):
        return ring_all_gather(grid, x, row_axes)

    def psum_all(x):
        return grid.psum(x.reshape(-1), row_axes).reshape(x.shape)

    return gather, psum_all


def _jump(t, m, t_g, m_g):
    safe = torch.where(t >= 0, t, 0).to(torch.int64)
    m2 = torch.where(t >= 0, torch.minimum(m, m_g[safe]), m)
    t2 = torch.where(t >= 0, t_g[safe], -1)
    return t2, m2


def _any(x: torch.Tensor) -> torch.Tensor:
    return torch.any(x).to(_I32).reshape(1)


def _doubling_phases(succ_l, pred_l, ids_l, gather, psum_all,
                     max_rounds: int):
    """The rank-local body of the doubling middle: ``break_cycles`` →
    ``path_components`` → ``chain_rank`` over ``gather`` / ``psum_all``.
    Returns ``(succ2, pred2, labels, head, rank, n_cut, pc_iters,
    cr_iters)``."""
    # --- break_cycles: fixed doubling rounds, cut each cycle at its minimum
    t, m = succ_l, ids_l
    for _ in range(max_rounds):
        t, m = _jump(t, m, gather(t), gather(m))
    on_cycle = t >= 0
    cut = on_cycle & (succ_l == m)
    n_cut = int(psum_all(torch.sum(cut).to(_I32).reshape(1))[0])
    succ2 = torch.where(cut, -1, succ_l)
    pred2 = torch.where(on_cycle & (ids_l == m), -1, pred_l)

    # --- path_components: doubling with running minima both ways; the
    # psum'd flag replicates the single-device convergence test
    tf, tb, mf, mb = succ2, pred2, ids_l, ids_l
    cont = bool(psum_all(_any(succ2 >= 0) | _any(pred2 >= 0))[0] > 0)
    pc_iters = 0
    while cont and pc_iters < max_rounds:
        tf_g, mf_g, tb_g, mb_g = gather(tf), gather(mf), gather(tb), gather(mb)
        tf, mf = _jump(tf, mf, tf_g, mf_g)
        tb, mb = _jump(tb, mb, tb_g, mb_g)
        pc_iters += 1
        cont = bool(psum_all(_any(tf >= 0) | _any(tb >= 0))[0] > 0)
    labels = torch.minimum(mf, mb)

    # --- chain_rank: parent jumping with distance accumulation; the
    # probe's gathered parent vector is the next round's jump table
    par = torch.where(pred2 >= 0, pred2, ids_l)
    d = (pred2 >= 0).to(_I32)
    par_g = gather(par)
    cont = bool(psum_all(_any(par_g[par.to(torch.int64)] != par))[0] > 0)
    cr_iters = 0
    while cont and cr_iters < max_rounds:
        d_g = gather(d)
        p64 = par.to(torch.int64)
        par, d = par_g[p64], d + d_g[p64]
        par_g = gather(par)
        cr_iters += 1
        cont = bool(psum_all(_any(par_g[par.to(torch.int64)] != par))[0] > 0)
    return succ2, pred2, labels, par, d, n_cut, pc_iters, cr_iters


def exchange_words(n_pad: int, p: int, bc_rounds: int, pc_iters: int,
                   cr_iters: int) -> int:
    """Words per rank of one doubling middle: each ring all-gather ships
    ``n·(P−1)/P``; break_cycles / path_components / chain_rank issue 2 / 4
    / 2 gathers a round, plus chain_rank's initial parent gather."""
    per_gather = n_pad * (p - 1) // p
    gathers = (GATHERS_PER_ROUND["break_cycles"] * bc_rounds
               + GATHERS_PER_ROUND["path_components"] * pc_iters
               + GATHERS_PER_ROUND["chain_rank"] * cr_iters + 1)
    return gathers * per_gather


def doubling_shard_map(succ: torch.Tensor, pred: torch.Tensor, *,
                       mesh: Optional[ProcessGrid] = None,
                       row_axes: Optional[Sequence[str]] = None
                       ) -> Dict[str, Any]:
    """The doubling middle over the grid rows (``row_axes``, default JAX's
    ``infer_row_axes``), for ``(n,)`` int32 succ / pred pointers every rank
    holds.  Returns the single-device arrays (``succ``, ``pred``
    cycle-cut, ``labels``, ``head``, ``rank``, global) plus ``n_cut``,
    ``cc_iterations``, ``cr_iterations``, ``bc_rounds`` and
    ``exchange_words``."""
    grid = resolve_grid(mesh, "rows")
    row_axes = resolve_row_axes(grid, row_axes)
    p = grid.size(row_axes)
    n = succ.shape[0]
    n_pad = -(-n // p) * p
    dev = succ.device
    if n_pad != n:
        fill = torch.full((n_pad - n,), -1, dtype=_I32, device=dev)
        succ, pred = torch.cat([succ, fill]), torch.cat([pred, fill])
    n_loc = n_pad // p
    lo = grid.axis_index(row_axes) * n_loc
    ids_l = lo + torch.arange(n_loc, dtype=_I32, device=dev)
    gather, psum_all = _closures(grid, row_axes)
    max_rounds = _log2_ceil(n_pad) + 1
    s2, p2, labels, head, rank, n_cut, pc_iters, cr_iters = _doubling_phases(
        succ[lo:lo + n_loc], pred[lo:lo + n_loc], ids_l, gather, psum_all,
        max_rounds)
    full = {k: gather(v)[:n] for k, v in (("succ", s2), ("pred", p2),
                                         ("labels", labels), ("head", head),
                                         ("rank", rank))}
    return {**full, "n_cut": n_cut, "cc_iterations": pc_iters,
            "cr_iterations": cr_iters, "bc_rounds": max_rounds,
            "exchange_words": exchange_words(n_pad, p, max_rounds, pc_iters,
                                             cr_iters)}


# ---------------------------------------------------------------------------
# Ring-bitonic chain ordering + the whole chain stage.
# ---------------------------------------------------------------------------


def n_sort_stages(p: int) -> int:
    """Comparator stages of the cross-shard sort network over ``p`` shards:
    ``log₂P·(log₂P+1)/2`` (bitonic) when ``p`` is a power of two, else
    ``p`` (odd-even transposition); none for ``p ≤ 1``."""
    if p <= 1:
        return 0
    if p & (p - 1) == 0:
        lg = p.bit_length() - 1
        return lg * (lg + 1) // 2
    return p


def sort_network(p: int) -> List[List[Tuple[int, int]]]:
    """Comparator schedule sorting ``p`` shard-resident blocks ascending by
    shard rank: a list of stages, each a list of ``(lo, hi)`` pairs that
    exchange blocks, merge, and keep the lower (``lo``) and upper (``hi``)
    half — a merge-split.  Replacing each compare-exchange of a sorting
    network by a merge-split of sorted blocks sorts the blocks (Knuth TAOCP
    5.3.4).  Batcher's bitonic network for a power of two (every stage
    pairs ``i`` with ``i ^ j``), else odd-even transposition (``p`` stages,
    one shard idle per stage when ``p`` is odd)."""
    if p <= 1:
        return []
    stages: List[List[Tuple[int, int]]] = []
    if p & (p - 1) == 0:
        k = 2
        while k <= p:
            j = k // 2
            while j >= 1:
                st = []
                for i in range(p):
                    partner = i ^ j
                    if partner > i:
                        st.append((i, partner) if (i & k) == 0
                                  else (partner, i))
                stages.append(st)
                j //= 2
            k *= 2
    else:
        for r in range(p):
            stages.append([(i, i + 1) for i in range(r % 2, p - 1, 2)])
    return stages


def exchange_words_sort(n_pad: int, p: int) -> int:
    """Words per rank of the distributed chain ordering: one eligibility
    ring all-gather of out-degrees (``n·(P−1)/P``) plus
    ``n_sort_stages(P)`` merge-split hops of the ``(labkey, rank, idx)``
    block (``SORT_WORDS·n/P`` each); the twin of
    ``bench_comm_model.words_chain_sort``."""
    if p <= 1:
        return 0
    return n_pad * (p - 1) // p + SORT_WORDS * (n_pad // p) * n_sort_stages(p)


def exchange_words_cut(n_pad: int, p: int) -> int:
    """Words per rank of the distributed branch cut: ``CUT_ALLREDUCES``
    full-vector ring allreduces of ``2·n·(P−1)/P`` each."""
    if p <= 1:
        return 0
    return CUT_ALLREDUCES * 2 * (n_pad * (p - 1) // p)


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort``: the order sorting by the LAST key, ties by the one
    before, and so on (stable sorts, least significant key first)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _chain_stage_local(grid: ProcessGrid, row_axes, cols_l, vals_l,
                       n_read_pad: int, n_reads: int):
    """The rank-local body of :func:`contig_stage_shard_map`."""
    gather, psum_all = _closures(grid, row_axes)
    p = grid.size(row_axes)
    idx = grid.axis_index(row_axes)
    n_states = 2 * n_read_pad
    n_loc = n_states // p  # even by construction
    dev = cols_l.device
    ids_l = idx * n_loc + torch.arange(n_loc, dtype=_I32, device=dev)
    max_rounds = _log2_ceil(n_states) + 1

    # --- branch cut: local state rows, per-shard degree tally, one psum
    # round ---
    with span("Contigs", kind="phase", phase="cut"):
        g_cols, g_vals = expand_state_rows(cols_l, vals_l)
        mask = g_cols >= 0
        out_deg_l = torch.sum(mask, dim=1).to(_I32)
        tally_to = torch.where(mask, g_cols, n_states).reshape(-1).to(torch.int64)
        tally = torch.zeros(n_states + 1, dtype=_I32, device=dev)
        tally.index_add_(0, tally_to, torch.ones_like(tally_to, dtype=_I32))
        in_deg = psum_all(tally[:n_states])  # global in-degree, replicated

        tgt = torch.amax(torch.where(mask, g_cols, -1), dim=1)
        suf = torch.sum(torch.where(mask, g_vals, 0.0), dim=1)
        tgt_safe = torch.where(tgt >= 0, tgt, 0).to(torch.int64)
        kept = (out_deg_l == 1) & (tgt >= 0) & (in_deg[tgt_safe] == 1)
        succ_l = torch.where(kept, tgt, -1).to(_I32)
        n_branch_cut = psum_all(
            (torch.sum(out_deg_l) - torch.sum(kept)).to(_I32).reshape(1))[0]

        # pred / in-suffix: in-degree 1 at the target makes both scatters
        # single-writer, so a −1-initialised pmax (resp. 0-initialised psum)
        # equals the single-device scatter; each rank slices its own chunk
        scat = torch.where(kept, succ_l, n_states).to(torch.int64)
        pred_buf = torch.full((n_states + 1,), -1, dtype=_I32, device=dev)
        pred_buf.scatter_reduce_(0, scat, ids_l, "amax", include_self=True)
        chunk = slice(idx * n_loc, (idx + 1) * n_loc)
        pred_l = grid.pmax(pred_buf[:n_states], row_axes)[chunk]
        insuf_buf = torch.zeros(n_states + 1, dtype=torch.float32, device=dev)
        insuf_buf[scat[kept]] = suf[kept]
        insuf_l = psum_all(insuf_buf[:n_states])[chunk]
        in_deg_l = in_deg[chunk]
        has_edge_l = (out_deg_l + in_deg_l).reshape(-1, 2).sum(dim=1) > 0
    n_branch_cut = int(n_branch_cut)

    # --- doubling middle (its convergence tests read a flag on the host
    # each round, as the loop needs them) ---
    with span("Contigs", kind="phase", phase="doubling"):
        _, _, labels, head, rank, _, pc_iters, cr_iters = _doubling_phases(
            succ_l, pred_l, ids_l, gather, psum_all, max_rounds)

    # --- chain ordering: ring-bitonic merge-split sort of the (labkey,
    # rank, idx) triples; idx makes keys unique, so the sorted order equals
    # the single-device stable sort by (labkey, rank) ---
    stages = sort_network(p)
    with span("Contigs", kind="phase", phase="sort",
              sort_stages=len(stages)):
        out_deg_g = gather(out_deg_l)  # eligibility: out_deg[head]
        elig_l = out_deg_g[head.to(torch.int64)] > 0
        labkey = torch.where(elig_l, labels, _SORT_BIG)
        labkey = torch.where(ids_l >= 2 * n_reads, _SORT_BIG + 1, labkey).to(_I32)
        order = _lexsort(ids_l, rank, labkey)
        k1, k2, k3 = labkey[order], rank[order], ids_l[order]
        for pairs in stages:
            perm = [pq for ab in pairs for pq in (ab, ab[::-1])]
            role = 0
            for lo, hi in pairs:
                role = 1 if idx == lo else (-1 if idx == hi else role)
            r1 = grid.ppermute(k1, row_axes, perm)
            r2 = grid.ppermute(k2, row_axes, perm)
            r3 = grid.ppermute(k3, row_axes, perm)
            if role == 0:
                continue  # an idle shard (odd-P transposition) keeps its block
            c1, c2, c3 = (torch.cat([k1, r1]), torch.cat([k2, r2]),
                          torch.cat([k3, r3]))
            o = _lexsort(c3, c2, c1)
            sel = o[:n_loc] if role > 0 else o[n_loc:]
            k1, k2, k3 = c1[sel], c2[sel], c3[sel]

    # chain boundaries: the previous element's labkey, shipped across the
    # shard seam by a one-hop ring shift
    prev_last = (grid.ppermute(k1[-1:], row_axes,
                               [(t, (t + 1) % p) for t in range(p)])
                 if p > 1 else k1[-1:])
    prev = torch.cat([prev_last, k1[:-1]])
    if idx == 0:
        prev[0] = -1
    elig_s = k1 < _SORT_BIG
    new_chain = elig_s & (k1 != prev)

    # global chain index: local cumsum + exclusive shard prefix (one psum
    # of a P-word one-hot vector)
    sums = torch.zeros(p, dtype=_I32, device=dev)
    sums[idx] = torch.sum(new_chain).to(_I32)
    sums = psum_all(sums)
    prefix = torch.sum(sums[:idx]).to(_I32)
    chain_idx = (prefix + torch.cumsum(new_chain.to(torch.int64), 0)
                 .to(_I32) - 1)
    n_chains = int(torch.sum(sums))
    max_chain = int(grid.pmax(torch.amax(torch.where(elig_s, k2, -1))
                              .reshape(1), row_axes)[0]) + 1
    shards = (k3, elig_s, k2, chain_idx, new_chain, insuf_l, has_edge_l)
    return shards, (n_chains, max_chain, n_branch_cut, pc_iters, cr_iters)


def contig_stage_shard_map(s, *, mesh: Optional[ProcessGrid] = None,
                           row_axes: Optional[Sequence[str]] = None
                           ) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """The contig chain stage distributed over the grid rows (``row_axes``,
    default JAX's ``infer_row_axes``): branch cut → doubling middle →
    ring-bitonic chain ordering, for a string matrix S (``EllMatrix``,
    min-plus values) every rank holds.

    Returns ``(st, stats)`` on every rank: ``st`` has the keys of
    ``assembly/contig_gen._order_chains``, global and equal to the
    single-device values (the rank shards are gathered at the end, as
    ``shard_map``'s output spec does); ``stats`` the per-rank exchange
    accounting split by phase."""
    from .semiring import MP

    grid = resolve_grid(mesh, "rows")
    row_axes = resolve_row_axes(grid, row_axes)
    p = grid.size(row_axes)
    n, k = s.cols.shape
    n_read_pad = -(-n // p) * p
    cols, vals = s.cols, s.vals[MP]
    dev = cols.device
    if n_read_pad != n:
        pad = n_read_pad - n
        cols = torch.cat([cols, torch.full((pad, k), -1, dtype=_I32,
                                           device=dev)])
        vals = torch.cat([vals, torch.full((pad,) + tuple(vals.shape[1:]),
                                           float("inf"), dtype=vals.dtype,
                                           device=dev)])
    i = grid.axis_index(row_axes)
    rows = slice(i * (n_read_pad // p), (i + 1) * (n_read_pad // p))
    with span("Contigs", kind="phase", phase="chain_stage", p=p) as sp:
        shards, (n_chains, max_chain, n_branch_cut, pc_iters, cr_iters) = (
            _chain_stage_local(grid, row_axes, cols[rows], vals[rows],
                               n_read_pad, n))
        state_s, elig_s, rank_s, chain_idx_s, new_chain, insuf, has_edge = (
            sp.set_output([grid.all_gather(x, row_axes) for x in shards]))
    n2, n_pad = 2 * n, 2 * n_read_pad
    st = {
        "state_s": state_s[:n2],
        "elig_s": elig_s[:n2],
        "rank_s": rank_s[:n2],
        "chain_idx_s": chain_idx_s[:n2],
        "new_chain": new_chain[:n2],
        "insuf": insuf[:n2],
        "has_edge": has_edge[:n],
        "n_chains": torch.tensor(n_chains, dtype=_I32, device=dev),
        "max_chain": torch.tensor(max_chain, dtype=_I32, device=dev),
        "n_branch_cut": torch.tensor(n_branch_cut, dtype=_I32, device=dev),
        "cc_iterations": pc_iters,
    }
    bc_rounds = _log2_ceil(n_pad) + 1
    w_cut = exchange_words_cut(n_pad, p)
    w_dbl = exchange_words(n_pad, p, bc_rounds, pc_iters, cr_iters)
    w_sort = exchange_words_sort(n_pad, p)
    r_dbl = bc_rounds + pc_iters + cr_iters
    r_sort = n_sort_stages(p) + 1  # merge-split stages + eligibility gather
    stats = {
        "exchange_words": w_cut + w_dbl + w_sort,
        "exchange_rounds": 1 + r_dbl + r_sort,
        "exchange_words_cut": w_cut,
        "exchange_words_doubling": w_dbl,
        "exchange_words_sort": w_sort,
        "exchange_rounds_doubling": r_dbl,
        "exchange_rounds_sort": r_sort,
    }
    return st, stats
