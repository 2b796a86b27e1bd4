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


def _kmer_dict(keys, valid, shape):
    """A ``extract_kmers`` dict of the given shape whose instance i (in
    row-major order) has packed k-mer ``keys[i]`` (hi = key >> 15, lo = the
    low 15 bits) and validity ``valid[i]``; invalid instances carry
    arbitrary words, as padding does."""
    n, p = shape
    keys = np.asarray(keys, np.int64).reshape(n, p)
    rng = np.random.default_rng(int(keys.sum()) % 1000)
    return {
        "hi": (keys >> 15).astype(np.int32),
        "lo": (keys & 0x7FFF).astype(np.int32),
        "strand": rng.integers(0, 2, (n, p)).astype(np.int32),
        "pos": np.broadcast_to(np.arange(p, dtype=np.int32), (n, p)).copy(),
        "valid": np.asarray(valid, bool).reshape(n, p),
    }


def _run_structure(case, lower, upper):
    """(keys, valid, shape) of a run structure that random reads rarely
    give."""
    rng = np.random.default_rng(len(case) + 7 * lower + upper)
    if case == "one_instance":
        return [12345], [True], (1, 1)
    if case == "one_invalid_instance":
        return [12345], [False], (1, 1)
    if case == "all_invalid":
        return rng.integers(0, 1 << 29, 24), np.zeros(24, bool), (4, 6)
    if case == "one_kmer":
        # one run over every valid instance, then the padding run
        valid = np.arange(30) % 6 < 4
        return np.full(30, 777), valid, (5, 6)
    if case == "one_kmer_no_padding":
        return np.full(12, 1 << 20), np.ones(12, bool), (3, 4)
    if case == "all_distinct":
        keys = rng.permutation(1 << 12)[:40] * 4099
        return keys, np.ones(40, bool), (5, 8)
    if case == "window_edges":
        # k-mers counted exactly lower - 1, lower, upper and upper + 1
        # times (and once and twice above), shuffled, with invalid
        # instances of a valid key among them
        mult = [lower - 1, lower, upper, upper + 1, 1, upper + 2]
        keys = np.concatenate([np.full(m, 1000 + 37 * i)
                               for i, m in enumerate(mult)])
        pad = np.full(7, 1000 + 37 * 2)
        keys = np.concatenate([keys, pad])
        valid = np.concatenate([np.ones(sum(mult), bool), np.zeros(7, bool)])
        perm = rng.permutation(len(keys))
        keys, valid = keys[perm], valid[perm]
        extra = (-len(keys)) % 5
        keys = np.concatenate([keys, np.zeros(extra, np.int64)])
        valid = np.concatenate([valid, np.zeros(extra, bool)])
        return keys, valid, (len(keys) // 5, 5)
    raise ValueError(case)


CASES = ["one_instance", "one_invalid_instance", "all_invalid", "one_kmer",
         "one_kmer_no_padding", "all_distinct", "window_edges"]


@pytest.mark.parametrize("lower,upper", [(2, 8), (3, 5)])
@pytest.mark.parametrize("case", CASES)
def test_count_and_select_run_structures_match_jax(case, lower, upper):
    """Run structures the random reads rarely give: a single instance, no
    valid instance, one run over the whole valid range, all distinct
    k-mers and counts at both edges of the reliable window.  Every field
    equals JAX's."""
    keys, valid, shape = _run_structure(case, lower, upper)
    km = _kmer_dict(keys, valid, shape)
    jcnt = jc.count_and_select({k: jnp.asarray(v) for k, v in km.items()},
                               lower=lower, upper=upper)
    tcnt = tc.count_and_select({k: torch.from_numpy(v) for k, v in km.items()},
                               lower=lower, upper=upper)
    for f in jc.KmerCount._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jcnt, f)),
                                      getattr(tcnt, f).numpy(), f)
        assert getattr(tcnt, f).dtype in (torch.int32, torch.bool), f
    if case == "window_edges":
        counts = set(tcnt.count[tcnt.reliable].tolist())
        assert counts == {lower, upper}
        assert int(tcnt.m_reliable) == 2
    jax.clear_caches()
