"""Multi-row-axis grids: JAX's multipod cases replayed on 8 gloo ranks.

The port's ``(2, 2, 2)`` ``("pod", "data", "model")`` grid against JAX's
``make_test_mesh((2, 2, 2), ("pod", "data", "model"))`` on the same numpy
inputs (JAX in a subprocess with 8 host devices, as
``tests/test_distributed.py`` runs it): the cases of
``tests/test_distributed.py`` (``test_multipod_row_axes``,
``test_doubling_shard_map_matches_local_on_multipod_axes``,
``test_contig_stage_matches_doubling_composition_on_multipod``) and
``tests/test_summa_dist.py::test_multipod_mesh_ring_and_fallback`` — the
ring runs with grid rows on ``("data",)`` and the recorded all-gather
fallback, with zero exchange words, on ``("pod", "data")`` — plus both
distributed transitive reductions on both row choices.  The distributed
x-drop on the same grid is held against the local ``batch_extend`` (JAX's
own multipod alignment test is the known reference fault)."""

import os
import pickle
import sys

import numpy as np
import pytest

from repro.assembly.contig_gen import string_matrix_from_edges

from _dist_helpers import run_with_devices
from _torch_dist import run_ranks
from test_torch_align_dist import KW, K, _bucket, _jax_reference

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks.bench_comm_model import (  # noqa: E402
    words_align,
    words_chain_sort,
    words_graph_cut,
)

pytestmark = pytest.mark.dist

JAX_CASES = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from repro.core.semiring import minplus_orient_semiring as SR
from repro.core.spmat import EllMatrix
from repro.core.summa import (
    collect, distribute_ell, dist_transitive_reduction,
    dist_transitive_reduction_ring, summa_allgather, summa_ring,
)
from repro.core.components_dist import (
    contig_stage_shard_map, doubling_shard_map, infer_row_axes,
)
from repro.launch.mesh import make_test_mesh

inp = pickle.load(open(sys.argv[1], "rb"))
mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
assert infer_row_axes(mesh) == ("pod", "data")
out = {}

def ell(m):
    return {"cols": np.asarray(m.cols), "vals": np.asarray(m.vals)}

def dist_of(coo, row_axes):
    args = tuple(jnp.asarray(coo[k]) for k in ("rows", "cols", "vals", "ok"))
    d, ovf = distribute_ell(*args, n_rows=16, n_cols=16, block_capacity=8,
                            semiring=SR, mesh=mesh, row_axes=row_axes)
    assert int(ovf) == 0
    return d

rd = dist_of(inp["ag"], ("pod", "data"))
c, ovf = summa_allgather(rd, rd, semiring=SR, out_block_capacity=16)
out["allgather"] = (ell(collect(c)), int(ovf))
for name, row_axes in (("ring_data", ("data",)),
                       ("ring_pod_data", ("pod", "data"))):
    rd = dist_of(inp["ring"], row_axes)
    c, ovf, st = summa_ring(rd, rd, semiring=SR, out_block_capacity=16)
    out[name] = (ell(collect(c)), int(ovf), st)
    for fused in (False, True):
        s, it, nnz = dist_transitive_reduction(rd, 50.0, fused=fused)
        out[f"tr_{name}_{fused}"] = (ell(collect(s)), int(it), int(nnz))
    s, it, nnz, st = dist_transitive_reduction_ring(rd, 50.0)
    out[f"trring_{name}"] = (ell(collect(s)), int(it), int(nnz), st)

d = doubling_shard_map(jnp.asarray(inp["succ"]), jnp.asarray(inp["pred"]),
                       mesh=mesh)
out["doubling"] = {k: (np.asarray(v) if hasattr(v, "shape") else v)
                   for k, v in d.items()}
S = EllMatrix(cols=jnp.asarray(inp["S"]["cols"]),
              vals=jnp.asarray(inp["S"]["vals"]), n_cols=inp["S"]["n_cols"])
st, xstats = contig_stage_shard_map(S, mesh=mesh)
out["contig_stage"] = ({k: np.asarray(v) for k, v in st.items()}, xstats)
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


def _mpsr_coo(seed, e, drop_diagonal):
    """The COO triplets of the JAX tests' min-plus matrices: 16 × 16, one
    finite orientation an entry."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 16, e)
    cols = rng.integers(0, 16, e)
    ok = rows != cols if drop_diagonal else np.ones(e, bool)
    combos = rng.integers(0, 4, e)
    suf = rng.integers(1, 100, e).astype(np.float32)
    vals = np.full((e, 4), np.inf, np.float32)
    vals[np.arange(e), combos] = suf
    return {"rows": rows.astype(np.int32), "cols": cols.astype(np.int32),
            "vals": vals, "ok": ok}


def _chains(n=53, seed=3):
    """``test_doubling_shard_map_matches_local_on_multipod_axes``' pointers:
    chains of a permutation, broken every 11, the last closed into a cycle."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    succ = np.full(n, -1, np.int32)
    pred = np.full(n, -1, np.int32)
    for i in range(n - 1):
        if i % 11 == 10:
            continue
        succ[perm[i]] = perm[i + 1]
        pred[perm[i + 1]] = perm[i]
    succ[perm[n - 1]] = perm[44]
    pred[perm[44]] = perm[n - 1]
    return succ, pred


def _string_matrix(n=53):
    """``test_contig_stage_matches_doubling_composition_on_multipod``' S."""
    edges = []
    for i in range(n - 1):
        if i % 11 != 10:
            edges.append((i, i + 1, 0, 0, 25))
            edges.append((i + 1, i, 1, 1, 25))
    edges += [(5, 20, 0, 0, 9), (33, 12, 1, 0, 8)]
    edges += [(50, 44, 0, 0, 6), (44, 50, 1, 1, 6)]
    s = string_matrix_from_edges(n, edges)
    return {"cols": np.asarray(s.cols), "vals": np.asarray(s.vals),
            "n_cols": s.n_cols}


@pytest.fixture(scope="module")
def inputs():
    succ, pred = _chains()
    codes, cand = _bucket()
    return {"ag": _mpsr_coo(1, 50, True), "ring": _mpsr_coo(1, 50, False),
            "succ": succ, "pred": pred, "S": _string_matrix(),
            "codes": codes, "cand": cand, "k": K, "kw": KW}


@pytest.fixture(scope="module")
def jax8(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax8")
    src, dst = tmp / "in.pkl", tmp / "out.pkl"
    with open(src, "wb") as f:
        pickle.dump(inputs, f)
    run_with_devices(JAX_CASES.replace("sys.argv[1]", repr(str(src)))
                     .replace("sys.argv[2]", repr(str(dst))), n_devices=8)
    with open(dst, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port8(inputs, tmp_path_factory):
    return run_ranks(8, "job_multipod", inputs,
                     tmp_path_factory.mktemp("port8"))


def _same_ell(got, want):
    np.testing.assert_array_equal(got["cols"], want["cols"])
    np.testing.assert_array_equal(got["vals"]["v"], want["vals"])


def test_allgather_summa_on_pod_data_rows(jax8, port8):
    for out in port8:
        _same_ell(out["allgather"][0], jax8["allgather"][0])
        assert out["allgather"][1] == jax8["allgather"][1]


@pytest.mark.parametrize("name", ["ring_data", "ring_pod_data"])
def test_ring_and_fallback_match_jax(jax8, port8, name):
    want_ell, want_ovf, want_st = jax8[name]
    for out in port8:
        got_ell, got_ovf, got_st = out[name]
        _same_ell(got_ell, want_ell)
        assert got_ovf == want_ovf
        for key in ("summa_algorithm", "summa_fallback_reason",
                    "exchange_words_summa", "exchange_rounds_summa",
                    "summa_stages"):
            assert got_st.get(key) == want_st.get(key), key
    st = port8[0][name][2]
    if name == "ring_data":  # the square 2x2 subgrid of each pod
        assert st["summa_algorithm"] == "ring" and st["summa_stages"] == 2
        assert st["exchange_words_summa"] > 0
    else:
        assert st["summa_algorithm"] == "allgather_fallback"
        assert st["summa_fallback_reason"] == (
            "multi-axis grid rows ('pod', 'data')")
        assert st["exchange_words_summa"] == st["exchange_rounds_summa"] == 0


@pytest.mark.parametrize("name", ["ring_data", "ring_pod_data"])
@pytest.mark.parametrize("variant", ["full", "fused", "ring"])
def test_dist_transitive_reduction_matches_jax(jax8, port8, name, variant):
    key = (f"trring_{name}" if variant == "ring"
           else f"tr_{name}_{variant == 'fused'}")
    want = jax8[key]
    for out in port8:
        got = out[key]
        _same_ell(got[0], want[0])
        assert got[1:3] == want[1:3]  # iterations, nnz
        if variant == "ring":
            for k in ("summa_algorithm", "exchange_words_summa",
                      "exchange_rounds_summa"):
                assert got[3][k] == want[3][k], k


def test_doubling_on_pod_grid_matches_jax(jax8, port8):
    want = jax8["doubling"]
    for out in port8:
        got = out["doubling"]
        for k in ("succ", "pred", "labels", "head", "rank"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in ("n_cut", "cc_iterations", "exchange_words"):
            assert int(got[k]) == int(want[k]), k


def test_contig_stage_on_pod_grid_matches_jax(jax8, port8):
    want_st, want_x = jax8["contig_stage"]
    for out in port8:
        got_st, got_x = out["contig_stage"]
        for k, v in want_st.items():
            np.testing.assert_array_equal(np.asarray(got_st[k]), v, err_msg=k)
        assert got_x == want_x
    # P = 4 grid rows over pod x data: the analytic models of the stage
    assert want_x["exchange_words_sort"] == words_chain_sort(2 * 56, 4)
    assert want_x["exchange_words_cut"] == words_graph_cut(2 * 56, 4)


def test_align_bucket_on_pod_grid_matches_batch_extend(inputs, port8):
    want = _jax_reference(inputs["codes"], inputs["cand"])
    assert (want[0] > K).any()
    for out in port8:
        for got, w in zip(out["align"]["res"], want):
            np.testing.assert_array_equal(got, w)
        # the nested rings move the words of one ring over P = 4 rows, in
        # one hop on each axis of size 2, and one score allreduce
        st = out["align"]["stats"]
        assert st["exchange_words_align"] == words_align(
            n_pad=24, row_width=inputs["codes"].shape[1], bucket_pad=40, p=4)
        assert st["exchange_rounds_align"] == 3
