"""Port foundation vs the JAX package: stats schema and metrics, the
dispatch seam, semirings (run totals equal the left fold of ⊕), ELL
construction/merge/prune/lookup/densify, row-block mapping and the
conversion helpers.  Inputs are made with numpy from a seed and go through
both packages; every comparison is exact."""

import dataclasses
from functools import reduce

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.assembly.counter import first_semiring as j_first
from repro.assembly.pipeline import PipelineConfig as JConfig
from repro.core import semiring as jsr
from repro.core import spmat as jsp
from repro.obs import schema as jschema
from repro_torch.assembly.counter import first_semiring as t_first
from repro_torch.convert import config_from_dict, ell_from_numpy, ell_to_numpy
from repro_torch.core import backend as tb
from repro_torch.core import semiring as tsr
from repro_torch.core import spmat as tsp
from repro_torch.core.semiring import MP
from repro_torch.obs import Metrics, MetricsError, schema as tschema


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _jell_to_port(m):
    vals = (jax.tree.map(np.asarray, m.vals) if isinstance(m.vals, dict)
            else np.asarray(m.vals))
    return ell_from_numpy(np.asarray(m.cols), vals, m.n_cols)


def _assert_vals_equal(jvals, tvals):
    if not isinstance(jvals, dict):
        jvals = {MP: jvals}
    assert sorted(jvals) == sorted(tvals)
    for k in jvals:
        np.testing.assert_array_equal(np.asarray(jvals[k]), tvals[k].numpy())


# --- obs -------------------------------------------------------------------


def test_schema_registry_matches_jax():
    assert [k for k in tschema.SCHEMA
            if k not in tschema.PORT_ONLY] == list(jschema.SCHEMA)
    assert set(tschema.PORT_ONLY) <= set(tschema.SCHEMA)
    assert not set(tschema.PORT_ONLY) & set(jschema.SCHEMA)
    for name in tschema.PORT_ONLY:
        assert tschema.SCHEMA[name].zero_group is None
    for name, spec in jschema.SCHEMA.items():
        t = tschema.SCHEMA[name]
        assert (t.kind, t.unit, t.zero_group) == (spec.kind, spec.unit,
                                                  spec.zero_group)
    assert tschema.ZERO_GROUPS == jschema.ZERO_GROUPS
    for g in jschema.ZERO_GROUPS:
        assert tschema.zero_defaults(g) == jschema.zero_defaults(g)


def test_metrics_validates_and_seeds():
    m = Metrics(context="t")
    m.emit("n_reads", 3)
    m.emit("backend", "cuda")
    with pytest.raises(MetricsError):
        m.emit("no_such_key", 1)
    with pytest.raises(MetricsError):
        m.emit("n_reads", 1.5)
    m.seed_zero("contig_exchange")
    assert m["exchange_words"] == 0 and "n_reads" in m
    lax = Metrics(strict=False)
    lax.emit("bogus", 1)
    assert len(lax.violations) == 1


# --- dispatch seam -----------------------------------------------------------


def test_backend_resolution_and_registry():
    assert tb.resolve_backend("auto", "cpu") == "reference"
    assert tb.resolve_backend("auto", "cuda") == "cuda"
    assert tb.resolve_backend("reference", "cuda") == "reference"
    with pytest.raises(ValueError):
        tb.resolve_backend("pallas")
    with pytest.raises(ValueError):
        tb.resolve_distribution("pjit")
    assert tb.resolve_distribution("shard_map") == "shard_map"
    assert tb.resolve_distribution("gspmd") == "gspmd"
    for op in ("xdrop_extend", "minplus_dense", "spgemm_ring_stages",
               "cc_labels", "contig_gen", "consensus"):
        assert tb.available_backends(op) == ("cuda", "reference")
        assert callable(tb.dispatch(op, "cuda"))
    with pytest.raises(KeyError):
        tb.dispatch("no_such_op", "reference")


# --- semirings ---------------------------------------------------------------


def _ov_values(rng, e):
    """Overlap values as ⊗ makes them (cnt 1) mixed with partial sums
    (cnt 2..4) that keep the first-valid-pairs invariant."""
    cnt = rng.integers(1, 5, e).astype(np.int32)
    apos = rng.integers(0, 500, (e, 2)).astype(np.int32)
    bpos = rng.integers(0, 500, (e, 2)).astype(np.int32)
    apos[cnt == 1, 1] = -1
    bpos[cnt == 1, 1] = -1
    return {"cnt": cnt, "apos": apos, "bpos": bpos}


def _mp_values(rng, e):
    v = rng.integers(0, 300, (e, 4)).astype(np.float32)
    return {MP: np.where(rng.random((e, 4)) < 0.5, v, np.inf).astype(np.float32)}


@pytest.mark.parametrize("name", ["overlap", "minplus", "first", "count", "bool"])
def test_reduce_runs_equals_left_fold(name):
    rng = np.random.default_rng(7)
    e = 60
    sr, vals = {
        "overlap": (tsr.overlap_semiring, _ov_values(rng, e)),
        "minplus": (tsr.minplus_orient_semiring, _mp_values(rng, e)),
        "first": (t_first, {"pos": rng.integers(0, 99, e).astype(np.int32)}),
        "count": (tsr.count_semiring, {"x": rng.integers(0, 9, e).astype(np.int32)}),
        "bool": (tsr.bool_semiring, {"x": rng.random(e) < 0.2}),
    }[name]
    run_len = rng.integers(1, 6, 30)
    run_id = np.repeat(np.arange(len(run_len)), run_len)[:e]
    run_start = np.flatnonzero(np.r_[True, run_id[1:] != run_id[:-1]])
    tv = {k: _t(v) for k, v in vals.items()}
    got = sr.reduce_runs(tv, _t(run_id, np.int64), _t(run_start, np.int64))
    for r, s0 in enumerate(run_start):
        s1 = run_start[r + 1] if r + 1 < len(run_start) else e
        elems = [{k: v[i:i + 1] for k, v in tv.items()} for i in range(s0, s1)]
        fold = reduce(sr.add, elems)
        for k in tv:
            assert torch.equal(got[k][r:r + 1], fold[k]), (name, r, k)


def test_semiring_ops_match_jax():
    rng = np.random.default_rng(1)
    a = _mp_values(rng, 32)[MP].reshape(8, 4, 4)
    b = _mp_values(rng, 32)[MP].reshape(8, 4, 4)
    np.testing.assert_array_equal(
        np.asarray(jsr.minplus_orient_semiring.mul(jnp.asarray(a), jnp.asarray(b))),
        tsr.minplus_orient_semiring.mul({MP: _t(a)}, {MP: _t(b)})[MP].numpy())
    x, y = _ov_values(rng, 16), _ov_values(rng, 16)
    j = jsr.overlap_semiring.add(jax.tree.map(jnp.asarray, x),
                                 jax.tree.map(jnp.asarray, y))
    t = tsr.overlap_semiring.add({k: _t(v) for k, v in x.items()},
                                 {k: _t(v) for k, v in y.items()})
    _assert_vals_equal(j, t)
    pos = rng.integers(0, 50, (5, 3)).astype(np.int32)
    _assert_vals_equal(
        jsr.overlap_semiring.mul({"pos": jnp.asarray(pos)}, {"pos": jnp.asarray(pos + 1)}),
        tsr.overlap_semiring.mul({"pos": _t(pos)}, {"pos": _t(pos + 1)}))
    m = _t([True, False])
    w = tsr.tree_where(m, {"x": _t([[1, 2], [3, 4]])}, {"x": _t([[0, 0], [0, 0]])})
    assert w["x"].tolist() == [[1, 2], [0, 0]]
    tk = tsr.tree_take({"x": _t([[1, 2], [3, 4]])}, _t([1, 1]), axis=0)
    assert tk["x"].tolist() == [[3, 4], [3, 4]]


# --- ELL -----------------------------------------------------------------------


def _coo(rng, e, n_rows, n_cols, kind):
    rows = rng.integers(0, n_rows, e).astype(np.int32)
    cols = rng.integers(0, n_cols, e).astype(np.int32)
    valid = rng.random(e) < 0.85
    if kind == "overlap":
        pos = {"pos": rng.integers(0, 300, e).astype(np.int32)}
        vals = jsr.overlap_semiring.mul(pos, {"pos": pos["pos"] + 7})
        vals = jax.tree.map(np.asarray, vals)
        return rows, cols, vals, valid, jsr.overlap_semiring, tsr.overlap_semiring
    if kind == "first":
        return (rows, cols, {"pos": rng.integers(0, 300, e).astype(np.int32)},
                valid, j_first, t_first)
    return (rows, cols, _mp_values(rng, e)[MP], valid,
            jsr.minplus_orient_semiring, tsr.minplus_orient_semiring)


@pytest.mark.parametrize("kind", ["overlap", "first", "minplus"])
@pytest.mark.parametrize("capacity", [3, 8])
def test_from_coo_matches_jax(kind, capacity):
    rng = np.random.default_rng(capacity * 10 + len(kind))
    rows, cols, vals, valid, jsem, tsem = _coo(rng, 200, 12, 20, kind)
    jm, jo = jsp.from_coo(jnp.asarray(rows), jnp.asarray(cols),
                          jax.tree.map(jnp.asarray, vals), jnp.asarray(valid),
                          n_rows=12, n_cols=20, capacity=capacity, semiring=jsem)
    tvals = ({k: _t(v) for k, v in vals.items()} if isinstance(vals, dict)
             else {MP: _t(vals)})
    tm, to = tsp.from_coo(_t(rows), _t(cols), tvals, _t(valid), n_rows=12,
                          n_cols=20, capacity=capacity, semiring=tsem)
    np.testing.assert_array_equal(np.asarray(jm.cols), tm.cols.numpy())
    _assert_vals_equal(jm.vals, tm.vals)
    assert int(jo) == int(to)
    assert tsp.ell_equal(_jell_to_port(jm), tm)


@pytest.mark.parametrize("capacity", [2, 5, 16])
def test_merge_sorted_rows_matches_jax(capacity):
    rng = np.random.default_rng(capacity)
    n, q = 9, 24
    cc = rng.integers(-1, 10, (n, q)).astype(np.int32)
    pos = rng.integers(0, 300, (n, q)).astype(np.int32)
    jv = jsr.overlap_semiring.mul({"pos": jnp.asarray(pos)}, {"pos": jnp.asarray(pos * 2)})
    tv = tsr.overlap_semiring.mul({"pos": _t(pos)}, {"pos": _t(pos * 2)})
    jc, jvv, jo = jsp.merge_sorted_rows(jnp.asarray(cc), jv, capacity=capacity,
                                        semiring=jsr.overlap_semiring)
    tc, tvv, to = tsp.merge_sorted_rows(_t(cc), tv, capacity=capacity,
                                        semiring=tsr.overlap_semiring)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    _assert_vals_equal(jvv, tvv)
    assert int(jo) == int(to)


def test_prune_lookup_dense_match_jax():
    rng = np.random.default_rng(5)
    rows, cols, vals, valid, jsem, tsem = _coo(rng, 120, 10, 10, "minplus")
    jm, _ = jsp.from_coo(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                         jnp.asarray(valid), n_rows=10, n_cols=10, capacity=6,
                         semiring=jsem)
    tm = _jell_to_port(jm)
    drop = rng.random(jm.cols.shape) < 0.3
    jp = jsp.prune(jm, jnp.asarray(drop), jsem)
    tp = tsp.prune(tm, _t(drop), tsem)
    assert tsp.ell_equal(_jell_to_port(jp), tp)
    q = rng.integers(-1, 10, (10, 4)).astype(np.int32)
    (jg, jf), (tg, tf) = jm.lookup(jsem, jnp.asarray(q)), tm.lookup(tsem, _t(q))
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jg), tg[MP].numpy())
    np.testing.assert_array_equal(np.asarray(jm.to_dense(jsem)),
                                  tm.to_dense(tsem)[MP].numpy())
    assert int(jm.nnz()) == int(tm.nnz())
    np.testing.assert_array_equal(np.asarray(jm.row_nnz()), tm.row_nnz().numpy())


@pytest.mark.parametrize("n_rows,chunk", [(10, 4), (8, 8), (5, 16)])
def test_map_row_blocks_and_next_pow2(n_rows, chunk):
    x = {"a": torch.arange(n_rows, dtype=torch.int32),
         "b": torch.arange(2 * n_rows).reshape(n_rows, 2)}
    seen = []

    def fn(blk):
        seen.append(blk["a"].shape[0])
        return (blk["a"] * 2, blk["b"] + 1), int(blk["a"].sum())

    (a2, b2), aux = tsp.map_row_blocks(fn, x, n_rows=n_rows, row_chunk=chunk,
                                       fills={"a": -1, "b": 0})
    assert torch.equal(a2, x["a"] * 2) and torch.equal(b2, x["b"] + 1)
    assert seen == [chunk] * len(aux) and len(aux) == -(-n_rows // chunk)
    for v in (0, 1, 2, 3, 5, 64, 65, 1000):
        assert tsp.next_pow2(v) == jsp.next_pow2(v)


def test_convert_round_trip_and_config():
    rng = np.random.default_rng(2)
    cols = np.sort(rng.integers(-1, 9, (4, 3)), axis=1).astype(np.int32)
    vals = rng.random((4, 3, 4)).astype(np.float32)
    m = ell_from_numpy(cols, vals, 9)
    c2, v2, n2 = ell_to_numpy(m)
    assert np.array_equal(c2, cols) and np.array_equal(v2[MP], vals) and n2 == 9
    cfg = config_from_dict(dataclasses.asdict(JConfig(backend="pallas", k=17)),
                           device="cpu")
    assert cfg.backend == "cuda" and cfg.k == 17 and cfg.device == "cpu"
    assert not hasattr(cfg, "pileup_band")
    assert not hasattr(cfg, "summa_stages_per_call")
    with pytest.raises(ValueError):
        config_from_dict({"no_such_field": 1})
    for key in ("pileup_band", "summa_stages_per_call"):
        with pytest.raises(ValueError, match=key):
            config_from_dict(dataclasses.asdict(JConfig(**{key: 8})))
