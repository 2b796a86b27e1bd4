"""Alignment and BuildR of the port vs the JAX package, and the x-drop
kernel module: the port's ``xdrop_extend_batch`` (its plain version on CPU
tensors) against the JAX Pallas kernel in interpret mode and the JAX
oracle, over shapes, bands, walk directions and scorings.  Then
``batch_extend`` and the string-graph construction on the same pairs.
Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.assembly import alignment as jal
from repro.core import string_graph as jsg
from repro.kernels.xdrop.ref import xdrop_extend_batch_ref as j_xdrop_ref
from repro.kernels.xdrop.xdrop import xdrop_pallas
from repro_torch.assembly import alignment as tal
from repro_torch.convert import ell_from_numpy
from repro_torch.core import spmat as tsp
from repro_torch.core import string_graph as tsg
from repro_torch.kernels import xdrop_extend_batch, xdrop_extend_batch_ref


def _pairs(rng, e, la, lb, err):
    a = rng.integers(0, 4, (e, la)).astype(np.uint8)
    b = np.zeros((e, lb), np.uint8)
    n = min(la, lb)
    b[:, :n] = a[:, :n]
    noise = rng.random((e, lb)) < err
    return a, np.where(noise, (b + 1) % 4, b).astype(np.uint8)


@pytest.mark.parametrize("e,la,lb,band", [(4, 40, 40, 9), (17, 64, 80, 17),
                                          (9, 100, 60, 33), (6, 90, 90, 65)])
@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("scoring", [(1, -1, -1, 15), (2, -3, -2, 40)])
def test_xdrop_module_matches_pallas_and_oracle(e, la, lb, band, direction,
                                                scoring):
    match, mismatch, gap, xd = scoring
    rng = np.random.default_rng(e * 100 + la + direction + match)
    a, b = _pairs(rng, e, la, lb, 0.08)
    lens_a = rng.integers(la // 2, la + 1, e).astype(np.int32)
    lens_b = rng.integers(lb // 2, lb + 1, e).astype(np.int32)
    if direction == 1:
        base_a = np.zeros(e, np.int32)
        base_b = np.zeros(e, np.int32)
    else:
        base_a, base_b = lens_a - 1, lens_b - 1
    step = np.full(e, direction, np.int32)
    np_args = (a, base_a, step, lens_a, b, base_b, step, lens_b)
    kw = dict(band=band, max_steps=la + lb, xdrop=xd, match=match,
              mismatch=mismatch, gap=gap)
    pal = xdrop_pallas(*map(jnp.asarray, np_args), pairs_per_block=e,
                       interpret=True, **kw)
    orc = j_xdrop_ref(*map(jnp.asarray, np_args), **kw)
    t_args = [torch.from_numpy(x) for x in np_args]
    got = xdrop_extend_batch(*t_args, **kw)
    ref = xdrop_extend_batch_ref(*t_args, **kw)
    for p, o, g, r in zip(pal, orc, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
        np.testing.assert_array_equal(g.numpy(), np.asarray(o))
        np.testing.assert_array_equal(r.numpy(), np.asarray(o))


@pytest.mark.parametrize("band", [257, 300, 513])
@pytest.mark.parametrize("direction", [1, -1])
def test_xdrop_wide_bands_match_pallas_and_oracle(band, direction):
    """Bands past the card's one-warp instance (256): the plain version
    equals JAX's Pallas kernel (interpret) and oracle, on pairs whose
    result depends on cells far off the diagonal (unequal lengths, free
    gaps, an x-drop that keeps the whole band alive)."""
    rng = np.random.default_rng(band + direction)
    e, la, lb = 5, 260, 150
    a, b = _pairs(rng, e, la, lb, 0.1)
    b[:2] = rng.integers(0, 4, (2, lb))  # unrelated pairs
    lens_a = rng.integers(la // 2, la + 1, e).astype(np.int32)
    lens_b = rng.integers(lb // 2, lb + 1, e).astype(np.int32)
    if direction == 1:
        base_a, base_b = np.zeros(e, np.int32), np.zeros(e, np.int32)
    else:
        base_a, base_b = lens_a - 1, lens_b - 1
    step = np.full(e, direction, np.int32)
    np_args = (a, base_a, step, lens_a, b, base_b, step, lens_b)
    kw = dict(band=band, max_steps=la + lb, xdrop=400, match=2, mismatch=-1,
              gap=0)
    pal = xdrop_pallas(*map(jnp.asarray, np_args), pairs_per_block=e,
                       interpret=True, **kw)
    orc = j_xdrop_ref(*map(jnp.asarray, np_args), **kw)
    got = xdrop_extend_batch(*[torch.from_numpy(x) for x in np_args], **kw)
    for p, o, g in zip(pal, orc, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))
        np.testing.assert_array_equal(g.numpy(), np.asarray(o))
    # the band's width decides the result: the main path's band gives
    # another
    narrow = xdrop_extend_batch(*[torch.from_numpy(x) for x in np_args],
                                **{**kw, "band": 65})
    assert any(not torch.equal(g, n) for g, n in zip(got, narrow))


def test_xdrop_max_steps_cap_and_single_pair():
    rng = np.random.default_rng(9)
    a, b = _pairs(rng, 3, 120, 120, 0.02)
    args = (a, np.zeros(3, np.int32), np.ones(3, np.int32),
            np.full(3, 120, np.int32), b, np.zeros(3, np.int32),
            np.ones(3, np.int32), np.full(3, 120, np.int32))
    kw = dict(band=17, max_steps=37, xdrop=20)
    orc = j_xdrop_ref(*map(jnp.asarray, args), **kw)
    got = xdrop_extend_batch(*[torch.from_numpy(x) for x in args], **kw)
    for o, g in zip(orc, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(o))
    one = tal.xdrop_extend(torch.from_numpy(a[0]), 0, 1, 120,
                           torch.from_numpy(b[0]), 0, 1, 120, **kw)
    jone = jal.xdrop_extend(jnp.asarray(a[0]), 0, 1, 120, jnp.asarray(b[0]), 0,
                            1, 120, **kw)
    assert (int(one.score), int(one.ai), int(one.bj)) == (
        int(jone.score), int(jone.ai), int(jone.bj))


@pytest.mark.parametrize("band", [9, 65])
def test_xdrop_ref_counts_existing_band_cells(band):
    # with an x-drop that never retires a cell, the cells computed are the
    # (i, j) inside both sequences with |i - j| <= band // 2
    rng = np.random.default_rng(band)
    e, la_max, lb_max = 5, 70, 90
    a, b = _pairs(rng, e, la_max, lb_max, 0.1)
    la = rng.integers(10, la_max + 1, e).astype(np.int32)
    lb = rng.integers(10, lb_max + 1, e).astype(np.int32)
    zeros, ones = np.zeros(e, np.int32), np.ones(e, np.int32)
    args = [torch.from_numpy(x) for x in (a, zeros, ones, la, b, zeros, ones, lb)]
    kw = dict(band=band, max_steps=la_max + lb_max, xdrop=10**6)
    *out, cells = xdrop_extend_batch_ref(*args, **kw, with_cells=True)
    for o, r in zip(out, xdrop_extend_batch_ref(*args, **kw)):
        assert torch.equal(o, r)
    c = band // 2
    want = [sum(1 for i in range(x) for j in range(y) if abs(i - j) <= c)
            for x, y in zip(la, lb)]
    np.testing.assert_array_equal(cells.numpy(), want)


def _seeded_pairs(seed, e=24, l=160, k=15):
    rng = np.random.default_rng(seed)
    a, b = _pairs(rng, e, l, l, 0.04)
    la = rng.integers(k + 10, l + 1, e).astype(np.int32)
    lb = rng.integers(k + 10, l + 1, e).astype(np.int32)
    pa = rng.integers(0, la - k).astype(np.int32)
    pb = rng.integers(0, lb - k).astype(np.int32)
    return a, la, b, lb, pa, pb


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_extend_and_string_graph_match_jax(seed):
    a, la, b, lb, pa, pb = _seeded_pairs(seed)
    kw = dict(k=15, xdrop=20, band=33, max_steps=400)
    j = jal.batch_extend(*map(jnp.asarray, (a, la, b, lb, pa, pb)),
                         backend="reference", **kw)
    t = tal.batch_extend(*[torch.from_numpy(x) for x in (a, la, b, lb, pa, pb)],
                         backend="cuda", **kw)
    for f in jal.PairAlignment._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), f)

    rng = np.random.default_rng(seed + 50)
    n = 10
    e = len(a)
    ri = rng.integers(0, n, e).astype(np.int32)
    rj = rng.integers(0, n, e).astype(np.int32)
    strand = rng.integers(0, 2, e).astype(np.int32)
    valid = (ri != rj) & (rng.random(e) < 0.9)
    jargs = [np.array(x) for x in (j.bi, j.ei, la, j.bj, j.ej, lb, strand)]
    jc = jsg.classify_overlaps(*map(jnp.asarray, jargs), end_fuzz=30)
    tc = tsg.classify_overlaps(*[torch.from_numpy(x) for x in jargs], end_fuzz=30)
    for f in jsg.OverlapClass._fields:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), f)
    jr, jcont, jovf = jsg.build_overlap_graph(
        jnp.asarray(ri), jnp.asarray(rj), jc, jnp.asarray(valid), n_reads=n,
        capacity=6)
    tr, tcont, tovf = tsg.build_overlap_graph(
        torch.from_numpy(ri), torch.from_numpy(rj), tc, torch.from_numpy(valid),
        n_reads=n, capacity=6)
    jr_p = ell_from_numpy(np.asarray(jr.cols), np.asarray(jr.vals), jr.n_cols)
    assert tsp.ell_equal(jr_p, tr)
    np.testing.assert_array_equal(tcont.numpy(), np.asarray(jcont))
    assert int(tovf) == int(jovf)
    jd = jsg.drop_contained(jr, jcont)
    td = tsg.drop_contained(tr, tcont)
    assert tsp.ell_equal(
        ell_from_numpy(np.asarray(jd.cols), np.asarray(jd.vals), jd.n_cols), td)
    assert tsg.edge_list(td) == jsg.edge_list(jd)


# --- (D, E) walks: both directions in one op call -----------------------------


def _two_direction_walks(rng, e, la, lb):
    """Forward walks from 0 and backward walks from a random base over the
    same rows, stacked (2, E); numpy."""
    lens_a = rng.integers(la // 2, la + 1, e).astype(np.int32)
    lens_b = rng.integers(lb // 2, lb + 1, e).astype(np.int32)
    back_a = rng.integers(0, la, e).astype(np.int32)
    back_b = rng.integers(0, lb, e).astype(np.int32)
    one = np.ones(e, np.int32)
    return (np.stack([np.zeros(e, np.int32), back_a]), np.stack([one, -one]),
            np.stack([lens_a, back_a + 1]),
            np.stack([np.zeros(e, np.int32), back_b]), np.stack([one, -one]),
            np.stack([lens_b, back_b + 1]))


@pytest.mark.parametrize("e,la,lb,band", [(7, 60, 50, 1), (11, 90, 80, 16),
                                          (9, 120, 100, 65)])
def test_xdrop_two_directions_match_single_calls_and_pallas(e, la, lb, band):
    rng = np.random.default_rng(e + band)
    a, b = _pairs(rng, e, la, lb, 0.08)
    ba, sa, lna, bb, sb, lnb = _two_direction_walks(rng, e, la, lb)
    kw = dict(band=band, max_steps=la + lb, xdrop=18)
    t = torch.from_numpy
    both = xdrop_extend_batch(t(a), t(ba), t(sa), t(lna), t(b), t(bb), t(sb),
                              t(lnb), **kw)
    assert all(x.shape == (2, e) for x in both)
    for d in range(2):
        walks = [x[d] for x in (ba, sa, lna, bb, sb, lnb)]
        one = xdrop_extend_batch(t(a), *map(t, walks[:3]), t(b),
                                 *map(t, walks[3:]), **kw)
        pal = xdrop_pallas(jnp.asarray(a), *map(jnp.asarray, walks[:3]),
                           jnp.asarray(b), *map(jnp.asarray, walks[3:]),
                           pairs_per_block=e, interpret=True, **kw)
        for x, o, p in zip(both, one, pal):
            np.testing.assert_array_equal(x[d].numpy(), o.numpy())
            np.testing.assert_array_equal(x[d].numpy(), np.asarray(p))


def test_xdrop_steps_per_pair():
    """``with_steps``: per pair, the steps it ran; with a band wider than
    both sequences and no retirement every pair runs to la + lb − 1 (or
    max_steps); a (2, E) call counts each direction as its single call."""
    rng = np.random.default_rng(5)
    e = 6
    a, b = _pairs(rng, e, 40, 30, 0.1)
    ba, sa, lna, bb, sb, lnb = (torch.from_numpy(x) for x in
                                _two_direction_walks(rng, e, 40, 30))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for ms in (300, 25):
        *_, steps = xdrop_extend_batch_ref(ta, ba, sa, lna, tb, bb, sb, lnb,
                                           band=161, max_steps=ms,
                                           xdrop=10**6, with_steps=True)
        want = torch.clamp(lna + lnb - 1, min=0, max=ms)
        assert torch.equal(steps, want)
    *_, cells, steps = xdrop_extend_batch_ref(ta, ba, sa, lna, tb, bb, sb, lnb,
                                              band=9, xdrop=3,
                                              with_cells=True, with_steps=True)
    for d in range(2):
        *_, c1, s1 = xdrop_extend_batch_ref(
            ta, ba[d], sa[d], lna[d], tb, bb[d], sb[d], lnb[d], band=9,
            xdrop=3, with_cells=True, with_steps=True)
        assert torch.equal(steps[d], s1) and torch.equal(cells[d], c1)


@pytest.mark.parametrize("bad", ["mixed", "rows", "three_dims", "flat_a"])
def test_xdrop_malformed_walks_raise(bad):
    rng = np.random.default_rng(1)
    a, b = _pairs(rng, 5, 30, 30, 0.1)
    walks = [torch.from_numpy(x) for x in _two_direction_walks(rng, 5, 30, 30)]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if bad == "mixed":  # base_a (2, E), the rest (E,)
        walks = [walks[0]] + [w[0] for w in walks[1:]]
    elif bad == "rows":  # (2, E + 1) walks for E rows
        walks = [torch.cat([w, w[:, :1]], 1) for w in walks]
    elif bad == "three_dims":
        walks = [w[None] for w in walks]
    else:
        ta = ta.reshape(-1)
    with pytest.raises(ValueError, match="xdrop"):
        xdrop_extend_batch(ta, *walks[:3], tb, *walks[3:], band=9)
    with pytest.raises(ValueError, match="xdrop"):
        xdrop_extend_batch_ref(ta, *walks[:3], tb, *walks[3:], band=9)


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_extend_makes_one_op_call(seed):
    """A dispatch spy: ``batch_extend`` calls the ``xdrop_extend`` op once,
    with (2, E) walks, and equals JAX's ``batch_extend``."""
    from repro_torch.core.backend import register_op

    calls = []

    def spy(*args, **kw):
        calls.append(tuple(args[1].shape))
        return xdrop_extend_batch(*args, **kw)

    a, la, b, lb, pa, pb = _seeded_pairs(seed, e=13)
    kw = dict(k=15, xdrop=20, band=65, max_steps=400)
    register_op("xdrop_extend", "cuda", spy)
    try:
        t = tal.batch_extend(*[torch.from_numpy(x)
                               for x in (a, la, b, lb, pa, pb)],
                             backend="cuda", **kw)
    finally:
        register_op("xdrop_extend", "cuda", xdrop_extend_batch)
    assert calls == [(2, 13)]
    j = jal.batch_extend(*map(jnp.asarray, (a, la, b, lb, pa, pb)),
                         backend="reference", **kw)
    for f in jal.PairAlignment._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), f)
