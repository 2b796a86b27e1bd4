"""SpGEMM and transitive reduction of the port vs the JAX package, and the
min-plus kernel module: the port's ``minplus_matmul`` (its plain version
on CPU tensors) against the JAX Pallas kernel in interpret mode and the
JAX oracle.  Inputs from numpy seeds; every comparison is exact."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro.core import spmat as jsp
from repro.kernels.minplus.minplus import minplus_pallas
from repro.kernels.minplus.ref import minplus_matmul_ref as j_minplus_ref
from repro_torch.convert import ell_from_numpy
from repro_torch.core import semiring as tsr
from repro_torch.core import spgemm as tsg
from repro_torch.core import spmat as tsp
from repro_torch.core import transitive_reduction as ttr
from repro_torch.core.semiring import MP
from repro_torch.core.backend import dispatch, register_op
from repro_torch.obs import Tracer, tracing
from repro_torch.kernels import (
    minplus_matmul,
    minplus_matmul_ref,
    spgemm_masked_minplus,
    spgemm_masked_minplus_ref,
)

import _masked_cases

# repro.core re-exports functions under these module names
jsg = importlib.import_module("repro.core.spgemm")
jtr = importlib.import_module("repro.core.transitive_reduction")


def _port(m):
    vals = (jax.tree.map(np.asarray, m.vals) if isinstance(m.vals, dict)
            else np.asarray(m.vals))
    return ell_from_numpy(np.asarray(m.cols), vals, m.n_cols)


def _a_matrix(seed, n=14, m=40, cap=6):
    rng = np.random.default_rng(seed)
    e = n * cap * 2
    rows = rng.integers(0, n, e).astype(np.int32)
    cols = rng.integers(0, m, e).astype(np.int32)
    pos = {"pos": jnp.asarray(rng.integers(0, 400, e).astype(np.int32))}
    from repro.assembly.counter import first_semiring
    a, _ = jsp.from_coo(jnp.asarray(rows), jnp.asarray(cols), pos,
                        jnp.ones(e, bool), n_rows=n, n_cols=m, capacity=cap,
                        semiring=first_semiring)
    at, _ = jsp.from_coo(jnp.asarray(cols), jnp.asarray(rows), pos,
                         jnp.ones(e, bool), n_rows=m, n_cols=n, capacity=cap,
                         semiring=first_semiring)
    return a, at


def _string_graph(seed, n=24, e=90, cap=12):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, n, e)
    ok = rows != cols
    combos = rng.integers(0, 4, e)
    vals = np.full((e, 4), np.inf, np.float32)
    vals[np.arange(e), combos] = rng.integers(1, 120, e)
    r, _ = jsp.from_coo(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                        jnp.asarray(ok), n_rows=n, n_cols=n, capacity=cap,
                        semiring=jsr.minplus_orient_semiring)
    return r


@pytest.mark.parametrize("seed,capacity,row_chunk", [(0, 8, None), (1, 4, None),
                                                     (2, 16, 5), (3, 4, 3)])
def test_overlap_spgemm_matches_jax(seed, capacity, row_chunk):
    a, at = _a_matrix(seed)
    jc, jo = jsg.spgemm(a, at, semiring=jsr.overlap_semiring, capacity=capacity,
                        row_chunk=row_chunk)
    tc, to = tsg.spgemm(_port(a), _port(at), semiring=tsr.overlap_semiring,
                        capacity=capacity, row_chunk=row_chunk)
    assert tsp.ell_equal(_port(jc), tc)
    assert int(jo) == int(to)
    # row blocks (a chunk that does not divide n = 14) equal one block
    whole, wo = tsg.spgemm(_port(a), _port(at), semiring=tsr.overlap_semiring,
                           capacity=capacity)
    assert tsp.ell_equal(whole, tc) and int(wo) == int(to)


@pytest.mark.parametrize("row_chunk", [None, 7])
def test_masked_spgemm_and_transpose_match_jax(row_chunk):
    r = _string_graph(3)
    sr_j, sr_t = jsr.minplus_orient_semiring, tsr.minplus_orient_semiring
    jn = jsg.spgemm_masked(r, r, r, semiring=sr_j, row_chunk=row_chunk)
    tn = tsg.spgemm_masked(_port(r), _port(r), _port(r), semiring=sr_t,
                           row_chunk=row_chunk)
    assert tsp.ell_equal(_port(jn), tn)
    jt, jo = jsg.transpose(r, capacity=10, semiring=sr_j)
    tt, to = tsg.transpose(_port(r), capacity=10, semiring=sr_t)
    assert tsp.ell_equal(_port(jt), tt) and int(jo) == int(to)


def _traced_tr(fn, *args, **kwargs):
    """``fn``'s result and its step spans: (label, iter, path, nnz)."""
    with tracing(Tracer(memory=False)) as tr:
        out = fn(*args, **kwargs)
    return out, [(sp.label, sp.attrs["iter"], sp.attrs["path"],
                  sp.attrs["nnz"]) for sp in tr.spans()
                 if sp.attrs.get("kind") == "step"]


def _one_loop_runs(rp, monkeypatch):
    """Algorithm 2 on R through each square the one loop is handed: the
    four one-card squares (the kernels' plain versions on CPU tensors) and
    the all-gather square of a 1x1 grid, unfused and fused.  Gives
    {path: (S, (iterations, nnz_initial, nnz_final, n_overflow), backend,
    step spans)}."""
    from repro_torch.core.grid import ProcessGrid
    from repro_torch.core.summa import DistEll, dist_transitive_reduction

    runs = {}
    for path, fn, kw in [
            ("minplus", ttr.transitive_reduction_fused, {"backend": "cuda"}),
            ("masked", ttr.transitive_reduction_fused, {"backend": "cuda"}),
            ("sampled", ttr.transitive_reduction_fused,
             {"backend": "reference"}),
            ("faithful", ttr.transitive_reduction, {})]:
        if path == "masked":
            monkeypatch.setattr(ttr, "TR_DENSE_MAX_ROWS", rp.n_rows - 1)
        (s, st), steps = _traced_tr(fn, rp, fuzz=60.0, **kw)
        monkeypatch.undo()
        runs[path] = (s, (st.iterations, st.nnz_initial, st.nnz_final,
                          st.n_overflow), st.backend, steps)
    d = DistEll(mat=rp, grid=ProcessGrid(1, 1))
    for path, fused in (("allgather", False), ("allgather_fused", True)):
        (s, it, nnz), steps = _traced_tr(dist_transitive_reduction, d, 60.0,
                                         fused=fused)
        runs[path] = (s.mat, (it, int(rp.nnz()), nnz, 0), None, steps)
    return runs


@pytest.mark.parametrize("seed", [11, 12, 13, 5, 9])
def test_transitive_reduction_matches_jax(monkeypatch, seed):
    """The port's fused and faithful TR give JAX's; Algorithm 2's one loop
    gives the same S, counters and steps whichever square it is handed."""
    r = _string_graph(seed)
    rp = _port(r)
    # one loop, six squares: the same S, counters and steps; each step
    # names its square
    runs = _one_loop_runs(rp, monkeypatch)
    s0, st0, _, steps0 = runs["faithful"]
    assert st0[0] >= 2 and len(steps0) == 2 * st0[0]
    want_path = {"minplus": "minplus", "masked": "masked", "sampled": "ell",
                 "faithful": "ell", "allgather": "allgather",
                 "allgather_fused": "allgather"}
    for path, (s, st, backend, steps) in runs.items():
        assert tsp.ell_equal(s, s0) and st == st0, path
        assert [(lb, i, n) for lb, i, _, n in steps] == [
            (lb, i, n) for lb, i, _, n in steps0], path
        assert {p for _, _, p, _ in steps} == {want_path[path]}
    assert [steps0[k][0] for k in range(2)] == ["TrReduction.square",
                                                "TrReduction.prune"]
    assert {p: b for p, (_, _, b, _) in runs.items() if b} == {
        "minplus": "cuda", "masked": "cuda_masked", "sampled": "reference",
        "faithful": "reference"}
    js, jst = jtr.transitive_reduction_fused(r, fuzz=60.0, backend="reference")
    for backend in ("reference", "cuda"):
        ts, tst = ttr.transitive_reduction_fused(rp, fuzz=60.0, backend=backend)
        assert tsp.ell_equal(_port(js), ts), backend
        assert (tst.iterations, tst.nnz_initial, tst.nnz_final) == (
            int(jst.iterations), int(jst.nnz_initial), int(jst.nnz_final))
        assert tst.backend == backend
    jf, jfs = jtr.transitive_reduction(r, fuzz=60.0)
    tf, tfs = ttr.transitive_reduction(rp, fuzz=60.0)
    assert tsp.ell_equal(_port(jf), tf)
    assert (tfs.iterations, tfs.n_overflow, tfs.backend) == (
        int(jfs.iterations), int(jfs.n_overflow), "reference")


def test_tr_dense_cap_downgrade(monkeypatch):
    """Above TR_DENSE_MAX_ROWS the cuda backend leaves the dense square for
    the sampled min-plus kernel and says so in TRStats.backend; S is the
    reference backend's."""
    rp = _port(_string_graph(5))
    monkeypatch.setattr(ttr, "TR_DENSE_MAX_ROWS", 8)
    s, st = ttr.transitive_reduction_fused(rp, fuzz=60.0, backend="cuda")
    ref, _ = ttr.transitive_reduction_fused(rp, fuzz=60.0, backend="reference")
    assert st.backend == "cuda_masked" and tsp.ell_equal(s, ref)


def _jax(m):
    """The port's min-plus ELL matrix as JAX's."""
    return jsp.EllMatrix(cols=jnp.asarray(m.cols.numpy()),
                         vals=jnp.asarray(m.vals[MP].numpy()), n_cols=m.n_cols)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", _masked_cases.CPU_CASES)
def test_spgemm_masked_op_plain_matches_core_and_jax(case, seed):
    """The ``spgemm_masked`` op's plain version (what the kernel is held to
    on the card) equals the port's torch ``spgemm_masked`` and JAX's, bit
    for bit, through both registrations of the dispatch seam."""
    ap, bp, mp = _masked_cases.operands(case, seed)
    if case == "wide_k_rows":
        assert int(bp.row_nnz().max()) > 32
    if case == "full_rows":
        assert bool(ap.mask[[1, 5, 35]].all())
    args = (ap.cols, ap.vals[MP], bp.cols, bp.vals[MP], mp.cols)
    got = spgemm_masked_minplus_ref(*args)
    core = tsg.spgemm_masked(ap, bp, mp, semiring=tsr.minplus_orient_semiring)
    jn = jsg.spgemm_masked(_jax(ap), _jax(bp), _jax(mp),
                           semiring=jsr.minplus_orient_semiring)
    assert got.shape == (mp.n_rows, mp.capacity, 4)
    assert torch.equal(got, core.vals[MP])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jn.vals))
    assert torch.isinf(got[~mp.mask]).all()
    for backend in ("cuda", "reference"):
        assert torch.equal(dispatch("spgemm_masked", backend)(*args), got)
    assert torch.equal(spgemm_masked_minplus(*args), got)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_tr_through_masked_op_matches_jax(monkeypatch, seed):
    """The fused TR above TR_DENSE_MAX_ROWS on the cuda backend squares once
    an iteration through the ``spgemm_masked`` op (its plain version on CPU
    tensors) and gives JAX's fused TR: S, iterations and nnz."""
    r = _string_graph(seed)
    rp = _port(r)
    js, jst = jtr.transitive_reduction_fused(r, fuzz=60.0, backend="reference")
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return spgemm_masked_minplus(*args)

    monkeypatch.setattr(ttr, "TR_DENSE_MAX_ROWS", 8)
    register_op("spgemm_masked", "cuda", spy)
    try:
        ts, tst = ttr.transitive_reduction_fused(rp, fuzz=60.0, backend="cuda")
    finally:
        register_op("spgemm_masked", "cuda", spgemm_masked_minplus)
    assert tst.backend == "cuda_masked"
    assert len(calls) == tst.iterations
    assert tsp.ell_equal(_port(js), ts)
    assert (tst.iterations, tst.nnz_initial, tst.nnz_final) == (
        int(jst.iterations), int(jst.nnz_initial), int(jst.nnz_final))


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (33, 17, 20), (65, 33, 47)])
def test_minplus_module_matches_pallas_and_oracle(m, k, n):
    rng = np.random.default_rng(m * 100 + n)
    a = np.where(rng.random((m, k, 4)) < 0.35,
                 rng.integers(1, 500, (m, k, 4)).astype(np.float32), np.inf)
    b = np.where(rng.random((k, n, 4)) < 0.35,
                 rng.integers(1, 500, (k, n, 4)).astype(np.float32), np.inf)
    a, b = a.astype(np.float32), b.astype(np.float32)
    pal = np.asarray(minplus_pallas(jnp.asarray(a), jnp.asarray(b), block_m=32,
                                    block_n=32, block_k=16, interpret=True))
    orc = np.asarray(j_minplus_ref(jnp.asarray(a), jnp.asarray(b)))
    got = minplus_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, orc)
    np.testing.assert_array_equal(
        minplus_matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(), orc)


def test_dense_square_sampled_equals_masked_square():
    """What the cuda TR path relies on: the dense square sampled at R's
    pattern equals the sampled ELL square."""
    rp = _port(_string_graph(9))
    sr = tsr.minplus_orient_semiring
    dense = rp.to_dense(sr)[MP]
    nd = minplus_matmul(dense, dense)
    safe = torch.where(rp.mask, rp.cols, 0).long()
    at_r = nd[torch.arange(rp.n_rows)[:, None], safe]
    masked = tsg.spgemm_masked(rp, rp, rp, semiring=sr).vals[MP]
    m = rp.mask[:, :, None].expand_as(at_r)
    assert torch.equal(at_r[m], masked[m])
