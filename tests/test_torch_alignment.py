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
