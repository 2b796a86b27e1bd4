"""CountKmer and CreateSpMat of the port vs the JAX package: canonical
k-mer packing, reverse complement, the sort-based count and reliable
window, and the A / Aᵀ matrices.  Reads come from both simulators (which
must agree) at a small size; every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.assembly import counter as jc
from repro.assembly import kmers as jk
from repro.assembly import simulate as jsim
from repro_torch.assembly import counter as tc
from repro_torch.assembly import kmers as tk
from repro_torch.assembly import simulate as tsim


def _reads(seed=0, genome=2500, error=0.03):
    g = jsim.simulate_genome(np.random.default_rng(seed), genome)
    return jsim.simulate_reads(g, depth=6, mean_len=300, std_len=50,
                               error_rate=error, seed=seed + 1)


def test_simulators_agree():
    for seed in (0, 3):
        g1 = jsim.simulate_genome(np.random.default_rng(seed), 1500)
        g2 = tsim.simulate_genome(np.random.default_rng(seed), 1500)
        assert np.array_equal(g1, g2)
        a = jsim.simulate_reads(g1, depth=5, mean_len=200, error_rate=0.05,
                                seed=seed)
        b = tsim.simulate_reads(g2, depth=5, mean_len=200, error_rate=0.05,
                                seed=seed)
        assert np.array_equal(a.codes, b.codes)
        assert np.array_equal(a.lengths, b.lengths)
        assert np.array_equal(a.truth_start, b.truth_start)


@pytest.mark.parametrize("k", [7, 15, 21])
def test_extract_kmers_matches_jax(k):
    rs = _reads(seed=k)
    j = jk.extract_kmers(jnp.asarray(rs.codes), jnp.asarray(rs.lengths), k=k)
    t = tk.extract_kmers(torch.from_numpy(rs.codes), torch.from_numpy(rs.lengths), k=k)
    for key in ("hi", "lo", "strand", "pos", "valid"):
        np.testing.assert_array_equal(np.asarray(j[key]), t[key].numpy(), key)


@pytest.mark.parametrize("k", [7, 15, 21])
def test_extract_kmers_at_edge_lengths_matches_jax(k):
    """Seeded reads whose lengths include k, k + 1, the padded maximum,
    and lengths below k (no valid k-mer): every field equals JAX's."""
    rng = np.random.default_rng(100 + k)
    lmax = 3 * k + 5
    codes = rng.integers(0, 4, (9, lmax)).astype(np.uint8)
    lens = np.array([k, k + 1, lmax, lmax, k - 1, 0, 2 * k, lmax - 1, k + 2],
                    np.int32)
    codes[np.arange(lmax)[None, :] >= lens[:, None]] = 0
    j = jk.extract_kmers(jnp.asarray(codes), jnp.asarray(lens), k=k)
    t = tk.extract_kmers(torch.from_numpy(codes), torch.from_numpy(lens), k=k)
    for key in ("hi", "lo", "strand", "pos", "valid"):
        np.testing.assert_array_equal(np.asarray(j[key]), t[key].numpy(), key)
    assert t["hi"].shape == (9, lmax - k + 1)


def test_revcomp_matches_jax():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, (6, 30)).astype(np.uint8)
    lens = rng.integers(0, 31, 6).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jk.revcomp(jnp.asarray(codes), jnp.asarray(lens))),
        tk.revcomp(torch.from_numpy(codes), torch.from_numpy(lens)).numpy())


@pytest.mark.parametrize("lower,upper", [(2, 8), (2, 48), (3, 5)])
def test_count_and_build_match_jax(lower, upper):
    rs = _reads(seed=lower + upper)
    jkm = jk.extract_kmers(jnp.asarray(rs.codes), jnp.asarray(rs.lengths), k=15)
    tkm = tk.extract_kmers(torch.from_numpy(rs.codes),
                           torch.from_numpy(rs.lengths), k=15)
    jcnt = jc.count_and_select(jkm, lower=lower, upper=upper)
    tcnt = tc.count_and_select(tkm, lower=lower, upper=upper)
    for f in jc.KmerCount._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jcnt, f)),
                                      getattr(tcnt, f).numpy(), f)
    n = rs.codes.shape[0]
    kw = dict(n_reads=n, m_capacity=1 << 13, read_capacity=24,
              kmer_capacity=upper)
    ja = jc.build_matrices(jcnt, **kw)
    ta = tc.build_matrices(tcnt, **kw)
    for jm, tm in ((ja[0], ta[0]), (ja[1], ta[1])):
        np.testing.assert_array_equal(np.asarray(jm.cols), tm.cols.numpy())
        np.testing.assert_array_equal(np.asarray(jm.vals["pos"]),
                                      tm.vals["pos"].numpy())
        assert jm.n_cols == tm.n_cols
    assert int(ja[2]) == int(ta[2]) and int(ja[3]) == int(ta[3])
    jax.clear_caches()
