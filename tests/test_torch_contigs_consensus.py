"""Contigs and Consensus of the port vs the JAX package: the graph
primitives, the device contig path (against JAX's ``_device_contig_gen`` on
the same S) and the host walk, the pileup kernel module (the port's
``pileup_vote`` on CPU tensors against the JAX Pallas kernel in interpret
mode and the JAX oracle), junction refinement and the whole polish.
Integer outputs compare exactly; the f32 quality means to rel 1e-6."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.assembly import consensus as jcons
from repro.assembly.contig_gen import (
    _device_contig_gen as j_device_contigs,
    _reference_contig_gen as j_host_contigs,
    consistent_chain_graph,
    string_matrix_from_edges,
)
from repro.kernels.pileup.pileup import pileup_pallas
from repro.kernels.pileup.ref import pileup_vote_ref as j_pileup_ref
from repro_torch.assembly import consensus as tcons
from repro_torch.assembly import contig_gen as tcg
from repro_torch.assembly.contigs import contig_stats, pad_rows
from repro_torch.convert import ell_from_numpy
from repro_torch.core import components as tcomp
from repro_torch.kernels import pileup_vote, pileup_vote_ref
from repro_torch.kernels.pileup.ref import from_padded, to_padded

jcomp = importlib.import_module("repro.core.components")


def _port(m):
    return ell_from_numpy(np.asarray(m.cols), np.asarray(m.vals), m.n_cols)


def _t(x):
    return torch.from_numpy(np.array(x))


def _sym(edges):
    out = list(edges)
    for (i, j, a, b, suf) in edges:
        out.append((j, i, 1 - b, 1 - a, suf + 7))
    return out


def _random_graph(seed, n=16, e=40):
    rng = np.random.default_rng(seed)
    edges = [
        (int(i), int(j), int(a), int(b), int(s))
        for i, j, a, b, s in zip(
            rng.integers(0, n, e), rng.integers(0, n, e),
            rng.integers(0, 2, e), rng.integers(0, 2, e),
            rng.integers(1, 60, e))
        if i != j
    ]
    codes = rng.integers(0, 4, (n, 150)).astype(np.uint8)
    lengths = rng.integers(80, 140, n).astype(np.int32)
    contained = rng.random(n) < 0.15
    return string_matrix_from_edges(n, edges), codes, lengths, contained


def _graphs():
    cyc = string_matrix_from_edges(6, _sym([(0, 1, 0, 0, 30), (1, 2, 0, 0, 25),
                                            (2, 0, 0, 0, 20), (3, 4, 0, 1, 40)]))
    rng = np.random.default_rng(8)
    yield ("cycle", cyc, rng.integers(0, 4, (6, 120)).astype(np.uint8),
           np.full(6, 100, np.int32), np.zeros(6, bool))
    for seed in range(3):
        yield (f"random{seed}",) + _random_graph(seed)
    s, codes, lengths, _ = consistent_chain_graph(40, 5, err=0.02, break_every=13)
    yield "chains", s, codes, lengths, np.zeros(40, bool)


GRAPHS = list(_graphs())


def _cset_arrays(cs):
    return [np.asarray(cs.codes), np.asarray(cs.lengths), np.asarray(cs.states),
            np.asarray(cs.offsets), np.asarray(cs.widths)]


def _padded_like(t, j):
    """The port's packed set in the padded layout of JAX's ``j``."""
    return [x.numpy() for x in t.padded(rows=j.codes.shape[0],
                                        cols=j.codes.shape[1],
                                        slots=j.states.shape[1])]


@pytest.mark.parametrize("case", GRAPHS, ids=[g[0] for g in GRAPHS])
def test_graph_primitives_match_jax(case):
    _, s, *_ = case
    jg = jcomp.expand_states(s)
    tg = tcomp.expand_states(_port(s))
    np.testing.assert_array_equal(tg.cols.numpy(), np.asarray(jg.cols))
    np.testing.assert_array_equal(tg.vals["v"].numpy(), np.asarray(jg.vals))
    for a, b in zip(tcomp.degrees(tg), jcomp.degrees(jg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", range(3))
def test_pointer_doubling_matches_jax(seed):
    """Random functional graphs: disjoint paths and cycles under a random
    vertex permutation."""
    rng = np.random.default_rng(seed)
    n = 40
    perm = rng.permutation(n)
    succ = np.full(n, -1, np.int32)
    i = 0
    while i < n:
        ln = int(rng.integers(1, 9))
        seg = perm[i:i + ln]
        succ[seg[:-1]] = seg[1:]
        if len(seg) > 2 and rng.random() < 0.4:
            succ[seg[-1]] = seg[0]  # close a cycle
        i += ln
    pred = np.full(n, -1, np.int32)
    pred[succ[succ >= 0]] = np.flatnonzero(succ >= 0)
    jb = jcomp.break_cycles(jnp.asarray(succ), jnp.asarray(pred))
    tb = tcomp.break_cycles(_t(succ), _t(pred))
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    js, jp = jb[0], jb[1]
    jl, jit = jcomp.path_components(js, jp)
    tl, tit = tcomp.path_components(tb[0], tb[1])
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tit == int(jit)
    jh, jr, jrit = jcomp.chain_rank(jp)
    th, tr, trit = tcomp.chain_rank(tb[1])
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert trit == int(jrit)


@pytest.mark.parametrize("case", GRAPHS, ids=[g[0] for g in GRAPHS])
def test_device_contig_path_matches_jax(case):
    _, s, codes, lengths, contained = case
    j = j_device_contigs(s, codes, lengths, contained)
    t = tcg._device_contig_gen(_port(s), _t(codes), _t(lengths), _t(contained))
    assert t.n_contigs == j.n_contigs
    assert t.stats == j.stats
    for a, b in zip(_padded_like(t, j), _cset_arrays(j)):
        np.testing.assert_array_equal(a, b)
    # and the host walk, through the dispatch seam
    jh = j_host_contigs(s, codes, lengths, contained)
    th = tcg.generate_contigs(_port(s), _t(codes), _t(lengths), _t(contained),
                              backend="reference")
    assert th.stats == jh.stats and th.n_contigs == jh.n_contigs
    for a, b in zip(_padded_like(th, jh), _cset_arrays(jh)):
        np.testing.assert_array_equal(a, b)
    tc, hc = t.to_contigs(), th.to_contigs()
    assert [c.reads for c in tc] == [c.reads for c in hc]
    assert all(np.array_equal(a.codes, b.codes) for a, b in zip(tc, hc))
    assert contig_stats(tc) == contig_stats(hc)


def _pileup_inputs(seed, c=3, m=6, l=300, err=0.06):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 4, (c, l)).astype(np.uint8)
    start = rng.integers(-40, l - 60, (c, m)).astype(np.int32)
    plen = rng.integers(0, 160, (c, m)).astype(np.int32)
    lr = 170
    pieces = np.zeros((c, m, lr), np.uint8)
    for i in range(c):
        for t in range(m):
            for b in range(plen[i, t]):
                col = start[i, t] + b
                pieces[i, t, b] = truth[i, col] if 0 <= col < l else rng.integers(4)
    flip = rng.random(pieces.shape) < err
    pieces = np.where(flip, (pieces + 1) % 4, pieces).astype(np.uint8)
    draft = np.where(rng.random((c, l)) < err, (truth + 2) % 4, truth).astype(np.uint8)
    return draft, pieces, start, plen


@pytest.mark.parametrize("seed,min_depth", [(0, 2), (1, 1), (2, 3)])
def test_pileup_module_matches_pallas_and_oracle(seed, min_depth):
    args = _pileup_inputs(seed)
    pal = pileup_pallas(*map(jnp.asarray, args), min_depth=min_depth, band=128,
                        interpret=True)
    orc = j_pileup_ref(*map(jnp.asarray, args), min_depth=min_depth)
    packed, kw = from_padded(*map(_t, args))
    got = to_padded(pileup_vote(*packed, **kw, min_depth=min_depth),
                    packed[1], kw["l"])
    ref = to_padded(pileup_vote_ref(*packed, **kw, min_depth=min_depth),
                    packed[1], kw["l"])
    for p, o, g, r in zip(pal, orc, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
        np.testing.assert_array_equal(g.numpy(), np.asarray(o))
        np.testing.assert_array_equal(r.numpy(), np.asarray(o))


def _chain_cset(seed, err):
    s, codes, lengths, _ = consistent_chain_graph(30, seed, err=err,
                                                  break_every=11)
    return s, codes, lengths, j_device_contigs(s, codes, lengths)


def _pad_pieces(x, n_pieces, c, m):
    """Per-piece values (any trailing shape) in JAX's padded (C, M) slots."""
    contig, slot = tcons._piece_slots(n_pieces, x.shape[0])
    out = torch.zeros((c, m) + tuple(x.shape[1:]), dtype=x.dtype)
    out[contig, slot] = x
    return out.numpy()


def _refine_matches_jax(s, codes, lengths, cs, rng):
    """The port's packed gathers, junction refinement and re-laid draft on
    the port's own contig set, against JAX's padded ones on JAX's, with the
    same nominal placements perturbed by a few bases (junctions to
    re-anchor).  Returns the shifted junction count."""
    tcs = tcg._device_contig_gen(_port(s), _t(codes), _t(lengths))
    c, m = cs.states.shape
    jp = jcons._gather_pieces(jnp.asarray(cs.states), jnp.asarray(cs.offsets),
                              jnp.asarray(cs.widths), jnp.asarray(codes),
                              jnp.asarray(lengths))
    tp = tcons._gather_pieces(tcs.states, tcs.offsets, tcs.widths,
                              _t(codes), _t(lengths))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(_pad_pieces(a, tcs.n_pieces, c, m),
                                      np.asarray(b))
    start = np.asarray(jp[1]) + rng.integers(-4, 5, jp[1].shape).astype(np.int32)
    start = np.where(np.asarray(jp[2]) > 0, start, 0).astype(np.int32)
    contig, slot = tcons._piece_slots(tcs.n_pieces, tcs.states.numel())
    jr = jcons._refine_layout(jp[0], jnp.asarray(start), jp[2], radius=6)
    tr = tcons._refine_layout(tp[0], _t(start)[contig, slot], tp[2],
                              tcs.n_pieces, radius=6)
    # JAX's running sum of starts carries on through a row's empty slots
    live = np.asarray(cs.states) >= 0
    for a, b in zip(tr[:3], jr[:3]):
        np.testing.assert_array_equal(_pad_pieces(a, tcs.n_pieces, c, m)[live],
                                      np.asarray(b)[live])
    n = tcs.n_contigs
    np.testing.assert_array_equal(tr[3].numpy(), np.asarray(jr[3])[:n])
    assert not np.asarray(jr[3])[n:].any()
    assert int(tr[4]) == int(jr[4])
    l = max(int(tr[3].max()), 1)
    draft = tcons._rescatter_draft(tp[0], tr[1], tr[2], tp[2], tcs.n_pieces,
                                   tr[3], total=int(tr[3].sum()))
    np.testing.assert_array_equal(
        pad_rows(draft, tr[3], rows=c, cols=l).numpy(),
        np.asarray(jcons._rescatter_draft(jp[0], jr[1], jr[2], jp[2], l=l)))
    return int(tr[4])


def _polish_matches_jax(t, j, *, means=False):
    """The port's packed ``ConsensusResult`` against JAX's padded one."""
    assert t.n_contigs == j.n_contigs
    got = t.padded(rows=j.codes.shape[0], cols=j.codes.shape[1],
                   slots=j.states.shape[1])
    for f, g in zip(("codes", "lengths", "states", "depth", "agree"), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(j, f)), f)
    for f in ("depth_mean", "identity", "qv") if means else ():
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f))[:t.n_contigs],
                                   rtol=1e-6)


def test_junction_refinement_matches_jax():
    """Nominal placements perturbed by a few bases, so the shift search
    has junctions to re-anchor."""
    s, codes, lengths, cs = _chain_cset(3, 0.0)
    assert _refine_matches_jax(s, codes, lengths, cs,
                               np.random.default_rng(0)) > 0


@pytest.mark.parametrize("block", [1, 4, 7, 64])
def test_consensus_gathers_in_piece_blocks_match_jax(monkeypatch, block):
    """The gathers over the live pieces (reads for the pieces and the
    draft, junctions for the scores), in blocks of ``PIECE_BLOCK`` that do
    not divide their counts: every output equals JAX's (C, M, LR) gathers,
    and the polished set too."""
    monkeypatch.setattr(tcons, "PIECE_BLOCK", block)
    s, codes, lengths, cs = _chain_cset(5, 0.04)
    assert int((np.asarray(cs.states) >= 0).sum()) % block or block == 1
    _refine_matches_jax(s, codes, lengths, cs, np.random.default_rng(block))
    j = jcons.polish_contig_set(cs, codes, lengths, backend="reference",
                                junction_radius=12)
    tcs = tcg._device_contig_gen(_port(s), _t(codes), _t(lengths))
    t = tcons.polish_contig_set(tcs, _t(codes), _t(lengths),
                                backend="reference", junction_radius=12)
    _polish_matches_jax(t, j)
    assert t.stats["n_junction_shifted"] == j.stats["n_junction_shifted"]


@pytest.mark.parametrize("backend,jbackend", [("reference", "reference"),
                                              ("cuda", "pallas")])
@pytest.mark.parametrize("radius", [0, 12])
def test_polish_contig_set_matches_jax(backend, jbackend, radius):
    s, codes, lengths, cs = _chain_cset(7, 0.04)
    j = jcons.polish_contig_set(cs, codes, lengths, backend=jbackend,
                                junction_radius=radius)
    tcs = tcg._device_contig_gen(_port(s), _t(codes), _t(lengths))
    t = tcons.polish_contig_set(tcs, _t(codes), _t(lengths), backend=backend,
                                junction_radius=radius)
    _polish_matches_jax(t, j, means=True)
    for key in ("n_changed", "n_junction_shifted"):
        assert t.stats[key] == j.stats[key]
    for key in ("consensus_depth_mean", "identity_estimate", "qv_estimate"):
        assert t.stats[key] == pytest.approx(j.stats[key], rel=1e-6)
    assert t.stats["n_changed"] > 0
