"""The port's 2D distributed SUMMA and transitive reduction
(``repro_torch.core.summa``) on gloo ranks, against the JAX package's local
products.

* The overlap product of ``overlap_spgemm_shard_map`` on a 2×2 grid equals
  JAX's local ``spgemm`` — cols, vals, overflow — with read pairs sharing
  more than ``NUM_POS_PAIRS`` k-mers (the order-dependent ⊕) and an odd
  read count (row padding), for one batch and for one stage per batch.
* ``tests/test_summa_dist.py``'s min-plus inputs replayed: ring, all-gather
  and host-level products agree with the local one, and the measured
  exchange words equal ``bench_comm_model.words_summa`` exactly.
* On 1×2 the ring records ``summa_algorithm="allgather_fallback"``.
* The distributed TR (ring, all-gather, fused) gives JAX's local S.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.assembly.counter import first_semiring as j_first
from repro.core.semiring import minplus_orient_semiring as J_MPSR
from repro.core.semiring import overlap_semiring as j_overlap
from repro.core.spgemm import spgemm as j_spgemm
from repro.core.spmat import from_coo as j_from_coo
from repro.core.transitive_reduction import transitive_reduction as j_tr

from _torch_dist import run_ranks

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks.bench_comm_model import words_summa  # noqa: E402

pytestmark = pytest.mark.dist


def _np_ell(m):
    vals = m.vals if isinstance(m.vals, dict) else {"v": m.vals}
    return {"cols": np.asarray(m.cols),
            "vals": {k: np.asarray(v) for k, v in vals.items()},
            "n_cols": int(m.n_cols)}


def _assert_ell(got, want):
    assert got["n_cols"] == want["n_cols"]
    np.testing.assert_array_equal(got["cols"], want["cols"])
    assert sorted(got["vals"]) == sorted(want["vals"])
    for k in want["vals"]:
        np.testing.assert_array_equal(got["vals"][k], want["vals"][k])


def _edges(m):
    """{(row, col): value tuple} of an ELL matrix in any block layout."""
    cols, vals = m["cols"], m["vals"]["v"]
    return {(int(i), int(cols[i, s])): tuple(vals[i, s].tolist())
            for i, s in zip(*np.nonzero(cols >= 0))}


def _pos_mat(rows, cols, n, m, cap, seed):
    """``tests/test_summa_dist.py``'s ``pos_mat``."""
    rng = np.random.default_rng(seed)
    vals = {"pos": jnp.asarray(rng.integers(0, 60, len(rows)), jnp.int32)}
    mat, ovf = j_from_coo(jnp.asarray(rows), jnp.asarray(cols), vals,
                          jnp.ones(len(rows), bool), n_rows=n, n_cols=m,
                          capacity=cap, semiring=j_first)
    assert int(ovf) == 0
    return mat


def _mpsr_mat(n, m, cap, e, seed):
    """``tests/test_summa_dist.py``'s ``mpsr_mat``."""
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, n, e), rng.integers(0, m, e)
    combos = rng.integers(0, 4, e)
    suf = rng.integers(1, 100, e).astype(np.float32)
    vals = np.full((e, 4), np.inf, np.float32)
    vals[np.arange(e), combos] = suf
    mat, _ = j_from_coo(jnp.asarray(rows), jnp.asarray(cols),
                        jnp.asarray(vals), jnp.ones(e, bool), n_rows=n,
                        n_cols=m, capacity=cap, semiring=J_MPSR)
    return mat, {"rows": rows, "cols": cols, "vals": vals,
                 "valid": np.ones(e, bool)}


def _overlap_inputs():
    """``test_overlap_semiring_parity_with_padding_and_shared_kmers``'s
    operands: 15 reads (odd), reads 1 and 2 share k-mers 3..6."""
    rng = np.random.default_rng(5)
    n_reads, m = 15, 32
    rows = list(rng.integers(0, n_reads, 50))
    cols = list(rng.integers(0, m, 50))
    for km in (3, 4, 5, 6):
        rows += [1, 2]
        cols += [km, km]
    a = _pos_mat(np.array(rows), np.array(cols), n_reads, m, 12, 1)
    at = _pos_mat(np.array(cols), np.array(rows), m, n_reads, 12, 2)
    return a, at


@pytest.fixture(scope="module")
def inputs():
    a, at = _overlap_inputs()
    r, r_coo = _mpsr_mat(16, 16, 8, 60, 0)
    return {"A": _np_ell(a), "At": _np_ell(at), "R": _np_ell(r),
            "R_coo": r_coo, "cap": 16, "_j": (a, at, r)}


def _run(world, job, inputs, tmp_path_factory, **extra):
    send = {k: v for k, v in inputs.items() if not k.startswith("_")}
    return run_ranks(world, job, {**send, **extra},
                     tmp_path_factory.mktemp(f"{job}{world}"))


@pytest.fixture(scope="module")
def summa4(inputs, tmp_path_factory):
    return _run(4, "job_summa", inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def summa2(inputs, tmp_path_factory):
    return _run(2, "job_summa", inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def tr4(inputs, tmp_path_factory):
    return _run(4, "job_tr", inputs, tmp_path_factory, fuzz=50.0)


def test_overlap_ring_matches_jax_local_spgemm(inputs, summa4):
    a, at, _ = inputs["_j"]
    c, ovf = j_spgemm(a, at, semiring=j_overlap, capacity=16)
    want = _np_ell(c)
    assert (want["vals"]["cnt"] > 2).any()  # pairs beyond NUM_POS_PAIRS
    for out in summa4:
        assert out["grid"] == (2, 2)
        got, got_ovf, st = out["overlap"]
        _assert_ell(got, want)
        assert got_ovf == int(ovf)
        assert st["summa_algorithm"] == "ring"
        assert st["summa_backend"] == "reference"
        assert st["spgemm_hbm_round_trips"] == 2
        # one stage per batch: the rotation between batches, same product
        got1, ovf1, st1 = out["overlap_g1"]
        _assert_ell(got1, want)
        assert ovf1 == int(ovf)
        assert st1["exchange_words_summa"] == st["exchange_words_summa"]


def test_overlap_ring_exchange_words_match_model(inputs, summa4):
    for out in summa4:
        st = out["overlap"][2]
        assert st["summa_stages"] == 2
        assert st["exchange_rounds_summa"] == 2 - 1
        # 2 words a slot: the column id and the int32 position
        assert st["exchange_words_summa"] == words_summa(
            n_rows=16, a_block_slots=12, a_words_per_slot=2, m_rows=32,
            b_block_slots=12, b_words_per_slot=2, pr=2, pc=2)


def test_minplus_ring_allgather_local_parity_replay(inputs, summa4):
    """``tests/test_summa_dist.py:57`` replayed on 4 gloo ranks."""
    _, _, r = inputs["_j"]
    c_loc, ovf_loc = j_spgemm(r, r, semiring=J_MPSR, capacity=16)
    for out in summa4:
        ring, ovf_rg, st = out["mp_ring"]
        ag, ovf_ag = out["mp_allgather"]
        _assert_ell(ring, ag)
        assert ovf_rg == ovf_ag
        host, ovf_h = out["mp_host"]
        _assert_ell(host, _np_ell(c_loc))
        assert ovf_h == int(ovf_loc)
        assert st["summa_algorithm"] == "ring" and st["summa_stages"] == 2
        assert st["exchange_rounds_summa"] == 1
        assert st["exchange_words_summa"] == words_summa(
            n_rows=16, a_block_slots=8, a_words_per_slot=5, m_rows=16,
            b_block_slots=8, b_words_per_slot=5, pr=2, pc=2)
        assert st["spgemm_hbm_round_trips_reference"] == 2
        assert out["skew_ok"]
        assert out["coo_equal"]  # distribute_ell == distribute_ell_blocks


def test_non_square_grid_records_allgather_fallback(inputs, summa2):
    a, at, r = inputs["_j"]
    c, ovf = j_spgemm(a, at, semiring=j_overlap, capacity=16)
    c_mp, _ = j_spgemm(r, r, semiring=J_MPSR, capacity=16)
    for out in summa2:
        assert out["grid"] == (1, 2)
        got, got_ovf, st = out["overlap"]
        _assert_ell(got, _np_ell(c))
        assert got_ovf == int(ovf)
        assert st["summa_algorithm"] == "allgather_fallback"
        assert st["summa_fallback_reason"] == "non-square grid 1x2"
        assert st["exchange_words_summa"] == st["exchange_rounds_summa"] == 0
        _assert_ell(out["mp_host"][0], _np_ell(c_mp))
        assert out["skew_ok"]


def test_dist_tr_ring_matches_jax_local(inputs, tr4):
    """``tests/test_summa_dist.py:243`` replayed: same S as the local
    Algorithm 2, one rotation per pass on 2×2."""
    _, _, r = inputs["_j"]
    s, st_loc = j_tr(r, fuzz=50.0, n_capacity=64)
    want = _edges(_np_ell(s))
    for out in tr4:
        got, iters, nnz, st = out["ring"]
        assert _edges(got) == want
        assert nnz == int(s.nnz()) == len(want)
        assert iters == int(st_loc.iterations)
        assert st["summa_algorithm"] == "ring"
        assert st["exchange_rounds_summa"] == iters
        assert st["exchange_words_summa"] == iters * words_summa(
            n_rows=16, a_block_slots=8, a_words_per_slot=5, m_rows=16,
            b_block_slots=8, b_words_per_slot=5, pr=2, pc=2)


@pytest.mark.parametrize("variant", ["allgather", "fused", "knob"])
def test_dist_tr_allgather_variants_match_jax_local(inputs, tr4, variant):
    _, _, r = inputs["_j"]
    s, _ = j_tr(r, fuzz=50.0, n_capacity=64)
    for out in tr4:
        got = out[variant]
        assert _edges(got[0]) == _edges(_np_ell(s))
        assert got[-1] == int(s.nnz())


def _plain_block(cols, vals, n_cols, pr, pc, i, j, bc):
    """Block ``(i, j)`` of the 2D block layout by a loop over the entries:
    each row's entries of grid column ``j``'s range, in row order, in
    ``bc`` slots; and the entries past ``bc`` in any (row, block)."""
    n, k = cols.shape
    nb, cb = n // pr, -(-n_cols // pc)
    out_c = np.full((nb, bc), -1, np.int32)
    out_v = np.full((nb, bc, 4), np.inf, np.float32)
    overflow = 0
    for r in range(n):
        used = [0] * pc
        for q in range(k):
            c = int(cols[r, q])
            if c < 0:
                continue
            b = c // cb
            if used[b] >= bc:
                overflow += 1
            elif b == j and i * nb <= r < (i + 1) * nb:
                out_c[r - i * nb, used[b]] = c
                out_v[r - i * nb, used[b]] = vals[r, q]
            used[b] += 1
    return out_c, out_v, overflow


@pytest.mark.parametrize("pr,pc", [(1, 1), (2, 2), (1, 2), (2, 1), (4, 2),
                                   (3, 3)])
@pytest.mark.parametrize("block_capacity", [8, 3, 1])
def test_own_block_is_the_block_of_the_2d_layout(pr, pc, block_capacity):
    """``own_block`` builds block ``(i, j)`` of the 2D block layout from
    the rank's rows alone, every rank gets the layout's overflow, and
    ``block_layout`` is the blocks of a grid row side by side."""
    import torch

    from repro_torch.convert import ell_from_numpy
    from repro_torch.core import summa as S
    from repro_torch.core.semiring import MP
    from repro_torch.core.semiring import minplus_orient_semiring as MPSR

    mat, _ = _mpsr_mat(36, 34, 8, 160, pr * 10 + pc)
    d = _np_ell(mat)
    r = ell_from_numpy(**d)
    g, ovf = S.block_layout(r, pc=pc, block_capacity=block_capacity,
                            semiring=MPSR)
    for i in range(pr):
        for j in range(pc):
            want_c, want_v, want_ovf = _plain_block(
                d["cols"], d["vals"]["v"], d["n_cols"], pr, pc, i, j,
                block_capacity)
            got, got_ovf = S.own_block(r, pr=pr, pc=pc, i=i, j=j,
                                       block_capacity=block_capacity,
                                       semiring=MPSR)
            assert int(got_ovf) == int(ovf) == want_ovf
            np.testing.assert_array_equal(got.cols.numpy(), want_c)
            np.testing.assert_array_equal(got.vals[MP].numpy(), want_v)
            lb = S.local_block(g, pr, pc, i, j)
            assert torch.equal(lb.cols, got.cols)
            assert torch.equal(lb.vals[MP], got.vals[MP])
    assert (int(ovf) == 0) == (block_capacity == r.capacity)
