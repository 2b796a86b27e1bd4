"""The port's host satellites against the JAX package, on the CPU.

Replays ``tests/test_io_fasta.py``, ``tests/test_metrics.py``,
``tests/test_bloom.py`` and the host-contig cases of
``tests/test_contigs.py`` against the port's own copies, and holds each
against the JAX function on the same numpy inputs: FASTA files written by
both are byte-identical; identities, truth intervals and edit distances
are equal; the Bloom filter's bits and query hits are bit-identical; the
host walk, ``read_components``, ``pileup_polish_host``, ``myers_baseline``,
``extend_pair``, ``encode_seq`` / ``decode_seq`` and the ``contig_gen``
builders give the JAX results.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.assembly import bloom as jbloom
from repro.assembly import contigs as jcontigs
from repro.assembly import io_fasta as jfa
from repro.assembly import metrics as jmet
from repro.assembly.alignment import extend_pair as j_extend_pair
from repro.assembly.contig_gen import consistent_chain_graph as j_chain_graph
from repro.assembly.contig_gen import generate_contigs as j_generate
from repro.assembly.contig_gen import string_matrix_from_edges as j_smat
from repro.assembly.kmers import decode_seq as j_decode
from repro.assembly.kmers import encode_seq as j_encode
from repro.core import myers_baseline as jmy
from repro.core.semiring import minplus_orient_semiring as JSR
from repro.core.spmat import from_coo as j_from_coo
from repro_torch.assembly import bloom as tbloom
from repro_torch.assembly import contigs as tcontigs
from repro_torch.assembly import io_fasta as tfa
from repro_torch.assembly import metrics as tmet
from repro_torch.assembly.alignment import extend_pair
from repro_torch.assembly.contig_gen import (
    consistent_chain_graph,
    generate_contigs,
    string_matrix_from_edges,
)
from repro_torch.assembly.kmers import decode_seq, encode_seq
from repro_torch.assembly.simulate import simulate_genome, simulate_reads
from repro_torch.convert import ell_from_numpy
from repro_torch.core import myers_baseline as tmy
from repro_torch.core.semiring import MP
from repro_torch.core.spmat import ell_equal
from repro_torch.core.transitive_reduction import transitive_reduction


def _port(m):
    return ell_from_numpy(np.asarray(m.cols), np.asarray(m.vals), m.n_cols)


def _sym(edges):
    out = list(edges)
    for (i, j, a, b, suf) in edges:
        out.append((j, i, 1 - b, 1 - a, suf + 7))
    return out


def _reads(n, seed=1, lmax=150):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, lmax)).astype(np.uint8)
    lengths = rng.integers(80, lmax - 10, n).astype(np.int32)
    return codes, lengths


# --- FASTA I/O ----------------------------------------------------------------


def test_fasta_roundtrip_matches_jax(tmp_path):
    names = ["r1", "r2 extra info", "r3"]
    seqs = ["ACGT" * 30, "TTTGGG", "A"]
    codes, lens = tfa.pack_reads(seqs)
    jc, jl = jfa.pack_reads(seqs)
    np.testing.assert_array_equal(codes, jc)
    np.testing.assert_array_equal(lens, jl)
    tpath, jpath = str(tmp_path / "t.fasta"), str(tmp_path / "j.fasta")
    tfa.write_fasta(tpath, names, codes, lens)
    jfa.write_fasta(jpath, names, jc, jl)
    assert open(tpath).read() == open(jpath).read()
    n2, c2, l2 = tfa.read_fasta_sharded(tpath)
    assert n2 == names
    np.testing.assert_array_equal(l2, lens)
    np.testing.assert_array_equal(c2, codes)
    assert tfa.parse_fasta(open(tpath).read()) == jfa.parse_fasta(open(jpath).read())


@pytest.mark.parametrize("n_shards", [1, 3, 4, 7])
def test_sharded_reading_matches_jax(tmp_path, n_shards):
    names = [f"read{i}" for i in range(20)]
    seqs = [("ACGT" * (i + 3))[: 7 + 3 * i] for i in range(20)]
    codes, lens = tfa.pack_reads(seqs)
    path = str(tmp_path / "y.fasta")
    tfa.write_fasta(path, names, codes, lens)
    got = []
    for shard in range(n_shards):
        n, c, l = tfa.read_fasta_sharded(path, shard, n_shards)
        jn, jc, jl = jfa.read_fasta_sharded(path, shard, n_shards)
        assert n == jn
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(l, jl)
        got.extend(n)
    assert got == names  # every record exactly once, in order


def test_component_grouped_contigs_match_jax(tmp_path):
    """Two disjoint chains: ``read_components`` labels them, and
    ``write_contig_fasta`` writes the same bytes as JAX's."""
    edges = [(0, 1, 0, 0, 10), (1, 2, 0, 0, 10), (3, 4, 0, 0, 10)]
    s, js = string_matrix_from_edges(5, edges), j_smat(5, edges)
    comp = tcontigs.read_components(s)
    assert list(comp) == [0, 0, 0, 3, 3]
    np.testing.assert_array_equal(comp, jcontigs.read_components(js))

    rng = np.random.default_rng(0)
    specs = [([(0, 0), (1, 0), (2, 0)], 40), ([(3, 0), (4, 0)], 25),
             ([(2, 1)], 12)]
    tc, jc = [], []
    for reads, ln in specs:
        codes = rng.integers(0, 4, ln).astype(np.uint8)
        tc.append(tcontigs.Contig(reads=reads, length=ln, codes=codes))
        jc.append(jcontigs.Contig(reads=reads, length=ln, codes=codes))
    labels = tcontigs.contig_components(tc, comp)
    assert labels == jcontigs.contig_components(jc, comp) == [0, 3, 0]
    kw = dict(identity=[0.99, 0.98, 1.0], depth=[4.0, 2.0, 1.0])
    tpath, jpath = str(tmp_path / "t.fasta"), str(tmp_path / "j.fasta")
    assert tfa.write_contig_fasta(tpath, tc, labels, **kw) == 3
    assert jfa.write_contig_fasta(jpath, jc, labels, **kw) == 3
    assert open(tpath).read() == open(jpath).read()
    names, c2, l2 = tfa.read_fasta_sharded(tpath)
    assert [h.split()[0] for h in names] == ["contig_0_0", "contig_0_1",
                                             "contig_1_0"]
    assert "comp_contigs=2" in names[0] and "comp_total=52" in names[0]
    np.testing.assert_array_equal(c2[2][: l2[2]], tc[1].codes)
    assert [tcontigs.contig_str(c) for c in tc] == [
        jcontigs.contig_str(c) for c in jc]


# --- truth metrics --------------------------------------------------------------


def test_banded_edit_distance_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(25):
        a = rng.integers(0, 4, int(rng.integers(0, 80)))
        b = rng.integers(0, 4, int(rng.integers(0, 80)))
        for band in (4, 96):
            assert tmet.banded_edit_distance(a, b, band) == \
                jmet.banded_edit_distance(a, b, band)
        assert tmet.identity(a, b) == jmet.identity(a, b)


def test_identity_on_mutated_copy_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 4, 400)
    b = list(a)
    for _ in range(16):
        p = int(rng.integers(0, len(b)))
        r = rng.random()
        if r < 0.5:
            b[p] = (b[p] + 1) % 4
        elif r < 0.75:
            del b[p]
        else:
            b.insert(p, int(rng.integers(0, 4)))
    b = np.asarray(b)
    assert tmet.banded_edit_distance(a, b, 32) == jmet.banded_edit_distance(a, b, 32)
    assert tmet.identity(a, a) == 1.0
    assert tmet.identity(a, b) == jmet.identity(a, b) < 1.0


def test_truth_mapping_and_assembly_identity_match_jax():
    """A perfect two-read contig (identity 1) and the host walk's contigs of
    a genome-consistent chain, measured by both packages."""
    g = simulate_genome(np.random.default_rng(2), 2000)
    rs = simulate_reads(g, depth=6, mean_len=300, std_len=40,
                        error_rate=0.0, seed=3)
    lo = int(min(rs.truth_start[0], rs.truth_start[1]))
    hi = int(max(rs.truth_end[0], rs.truth_end[1]))
    reads = [(0, int(rs.truth_strand[0])), (1, int(rs.truth_strand[1]))]
    c = tcontigs.Contig(reads=reads, length=hi - lo, codes=g[lo:hi].copy())
    assert tmet.contig_truth_interval(c, rs)[:2] == (lo, hi)
    assert tmet.contig_truth_interval(c, rs) == jmet.contig_truth_interval(c, rs)
    assert tmet.contig_identity_vs_truth(c, rs) == 1.0
    assert tmet.assembly_identity([c], rs) == (1.0, hi - lo)

    # reads with 2 % substitutions of a chain whose error-free reads (the
    # same seed without errors) locate each read on the genome
    s, codes, lengths, genome = consistent_chain_graph(12, seed=4, err=0.02)
    clean = consistent_chain_graph(12, seed=4)[1]
    starts = np.asarray([genome.tobytes().find(clean[i, :lengths[i]].tobytes())
                         for i in range(12)])
    assert (starts >= 0).all()
    contigs = tcontigs.extract_contigs(s, codes, lengths)
    truth = simulate_reads(genome, depth=1, mean_len=100, std_len=1, seed=0)
    truth.truth_start, truth.truth_end = starts, starts + lengths
    truth.truth_strand = np.zeros(12, np.int32)
    for min_reads in (1, 2):
        got = tmet.assembly_identity(contigs, truth, min_reads=min_reads)
        want = jmet.assembly_identity(contigs, truth, min_reads=min_reads)
        assert got == want and 0.9 < got[0] < 1.0


# --- Bloom filter ---------------------------------------------------------------


@pytest.mark.parametrize("n_bits,n_hashes,seed", [(4096, 3, 0), (1 << 14, 3, 1),
                                                  (1000, 4, 2), (257, 2, 3)])
def test_bloom_bits_and_hits_match_jax(n_bits, n_hashes, seed):
    rng = np.random.default_rng(seed)
    n = 500
    hi = rng.integers(-2**31, 2**31, n).astype(np.int32)
    lo = rng.integers(-2**31, 2**31, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    tf = tbloom.BloomFilter.create(n_bits, n_hashes, device="cpu").insert(
        torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(valid))
    jf = jbloom.BloomFilter.create(n_bits, n_hashes).insert(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    np.testing.assert_array_equal(tf.bits.numpy(), np.asarray(jf.bits))
    for s in range(n_hashes):
        np.testing.assert_array_equal(
            tbloom._hash(torch.from_numpy(hi), torch.from_numpy(lo), s).numpy(),
            np.asarray(jbloom._hash(jnp.asarray(hi), jnp.asarray(lo), s)))
    qhi = rng.integers(-2**31, 2**31, 2000).astype(np.int32)
    qlo = rng.integers(-2**31, 2**31, 2000).astype(np.int32)
    qhi[:n], qlo[:n] = hi, lo
    got = tf.query(torch.from_numpy(qhi), torch.from_numpy(qlo)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf.query(jnp.asarray(qhi),
                                                           jnp.asarray(qlo))))
    assert got[:n][valid].all()  # no false negatives


def test_bloom_invalid_not_inserted():
    bf = tbloom.BloomFilter.create(256, 2, device="cpu").insert(
        torch.tensor([5]), torch.tensor([7]), torch.tensor([False]))
    assert not bool(bf.query(torch.tensor([5]), torch.tensor([7]))[0])
    assert not bf.bits.any()


# --- host contigs -----------------------------------------------------------------


SCENARIOS = {
    "linear": (5, _sym([(i, i + 1, 0, 0, 30) for i in range(4)])),
    "branch": (4, _sym([(0, 1, 0, 0, 30), (0, 2, 0, 0, 25), (2, 3, 0, 0, 20)])),
    "cycle": (3, _sym([(0, 1, 0, 0, 30), (1, 2, 0, 0, 30), (2, 0, 0, 0, 30)])),
    "strand_mix": (4, _sym([(0, 1, 0, 1, 30), (1, 2, 1, 1, 25),
                            (2, 3, 1, 0, 20)])),
    "zero_suffix": (3, _sym([(0, 1, 0, 0, 0), (1, 2, 0, 0, 15)])),
    "empty": (3, []),
}


def _random_edges(seed, n=16, e=40):
    rng = np.random.default_rng(seed)
    return [(int(i), int(j), int(a), int(b), int(s))
            for i, j, a, b, s in zip(
                rng.integers(0, n, e), rng.integers(0, n, e),
                rng.integers(0, 2, e), rng.integers(0, 2, e),
                rng.integers(1, 60, e)) if i != j]


@pytest.mark.parametrize("name", sorted(SCENARIOS) + ["random_0", "random_1"])
def test_extract_contigs_matches_jax(name):
    if name.startswith("random"):
        n, edges = 16, _random_edges(int(name[-1]))
    else:
        n, edges = SCENARIOS[name]
    s, js = string_matrix_from_edges(n, edges), j_smat(n, edges)
    assert ell_equal(s, _port(js))
    codes, lengths = _reads(n)
    contained = np.zeros(n, bool)
    contained[n - 1] = True
    for cont in (None, contained):
        got = tcontigs.extract_contigs(s, codes, lengths, cont)
        want = jcontigs.extract_contigs(js, codes, lengths, cont)
        assert [(c.reads, c.length, c.codes.tobytes()) for c in got] == [
            (c.reads, c.length, c.codes.tobytes()) for c in want]
        assert tcontigs.contig_stats(got) == tcontigs.ContigStats(
            **jcontigs.contig_stats(want).__dict__)
    np.testing.assert_array_equal(tcontigs.read_components(s),
                                  jcontigs.read_components(js))


@pytest.mark.parametrize("seed,err,break_every", [(5, 0.03, None), (6, 0.0, 7)])
def test_pileup_polish_host_matches_jax(seed, err, break_every):
    """The host cross-check of the consensus op, on the same contig set,
    by both packages; and the builders give JAX's graph and reads."""
    s, codes, lengths, genome = consistent_chain_graph(
        16, seed=seed, err=err, break_every=break_every)
    js, jcodes, jlengths, jgenome = j_chain_graph(16, seed=seed, err=err,
                                                  break_every=break_every)
    assert ell_equal(s, _port(js))
    for a, b in ((codes, jcodes), (lengths, jlengths), (genome, jgenome)):
        np.testing.assert_array_equal(a, np.asarray(b))
    cset = generate_contigs(s, torch.from_numpy(codes),
                            torch.from_numpy(lengths), backend="cuda")
    jset = j_generate(js, codes, lengths, backend="pallas")
    args = (*cset.padded(rows=jset.codes.shape[0], cols=jset.codes.shape[1],
                         slots=jset.states.shape[1]), codes, lengths)
    got = tcontigs.pileup_polish_host(*args, min_depth=2)
    want = jcontigs.pileup_polish_host(
        jset.codes, jset.lengths, jset.states, jset.offsets, jset.widths,
        codes, lengths, min_depth=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] > 0).any()


# --- myers baseline, extend_pair, encode/decode ----------------------------------


def _rand_graph(seed, n=20, e=80):
    """``tests/test_transitive_reduction.py``'s symmetric random graph."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, n, e)
    combos = rng.integers(0, 4, e)
    suf = rng.integers(1, 200, e).astype(np.float32)
    r2, c2 = cols.copy(), rows.copy()
    cb2 = 2 * (1 - combos % 2) + (1 - combos // 2)
    s2 = rng.integers(1, 200, e).astype(np.float32)
    rows = np.concatenate([rows, r2])
    cols = np.concatenate([cols, c2])
    combos = np.concatenate([combos, cb2])
    suf = np.concatenate([suf, s2])
    ok = rows != cols
    vals = np.full((len(rows), 4), np.inf, np.float32)
    vals[np.arange(len(rows)), combos] = suf
    mat, _ = j_from_coo(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                        jnp.asarray(ok), n_rows=n, n_cols=n,
                        capacity=2 * e // n + 8, semiring=JSR)
    return mat, n


@pytest.mark.parametrize("seed,fuzz", [(0, 20.0), (1, 100.0), (2, 50.0)])
def test_myers_baseline_matches_jax(seed, fuzz):
    jr, n = _rand_graph(seed)
    r = _port(jr)
    edges = tmy.from_ell(r)
    assert edges == jmy.from_ell(jr)
    got = tmy.myers_transitive_reduction(edges, fuzz=fuzz)
    want = jmy.myers_transitive_reduction(jmy.from_ell(jr), fuzz=fuzz)
    assert got == want
    assert tmy.graphs_equal(got[0], want[0])
    dense = tmy.dense_square_transitive_reduction(edges, n, fuzz=fuzz)
    assert dense == jmy.dense_square_transitive_reduction(edges, n, fuzz=fuzz)
    # the oracle agrees with the port's Algorithm 2
    s, _ = transitive_reduction(r, fuzz=fuzz, n_capacity=r.capacity ** 2)
    assert tmy.graphs_equal(tmy.from_ell(s), got[0])


def test_extend_pair_matches_jax():
    genome = "ACGTTGCAAGGCTTACCGGATTACGCAT"
    a, b = genome[2:20], genome[8:28]
    al = extend_pair(encode_seq(a), len(a), encode_seq(b), len(b), 6, 0, k=6,
                     band=17, max_steps=128)
    assert int(al.score) == len(a) - 6
    assert int(al.bi) == 6 and int(al.ei) == len(a)
    assert int(al.bj) == 0 and int(al.ej) == len(a) - 6
    rng = np.random.default_rng(3)
    for _ in range(4):
        x = rng.integers(0, 4, 120).astype(np.uint8)
        y = np.where(rng.random(120) < 0.1, (x + 1) % 4, x).astype(np.uint8)
        pa = int(rng.integers(0, 100))
        got = extend_pair(torch.from_numpy(x), 120, torch.from_numpy(y), 120,
                          pa, pa, k=11, xdrop=12, band=17, max_steps=256)
        want = j_extend_pair(jnp.asarray(x), 120, jnp.asarray(y), 120,
                             jnp.int32(pa), jnp.int32(pa), k=11, xdrop=12,
                             band=17, max_steps=256)
        assert tuple(int(v) for v in got) == tuple(int(v) for v in want)


@pytest.mark.parametrize("s", ["ACGT", "acgtNNacg", "", "TTTTGGGGCCCCAAAA" * 5])
def test_encode_decode_match_jax(s):
    codes = encode_seq(s)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_encode(s)))
    assert decode_seq(codes) == j_decode(j_encode(s))
    if set(s) <= set("ACGT"):
        assert decode_seq(codes) == s


def test_string_matrix_from_edges_matches_jax():
    for n, edges in list(SCENARIOS.values()) + [(16, _random_edges(2))]:
        for cap in (4, 8):
            got = string_matrix_from_edges(n, edges, capacity=cap)
            want = j_smat(n, edges, capacity=cap)
            assert ell_equal(got, _port(want))
            assert set(got.vals) == {MP}
