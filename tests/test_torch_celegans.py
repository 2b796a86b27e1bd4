"""The C. elegans deployment (``portbench/configs/celegans-gspmd.json``:
Table IV's depth 40 and mean read 11,241) at a CPU's size, and the packed
Contigs and Consensus layouts that hold only live slots.

* A seeded assembly of ~30 reads of the cell's read law, its lengths cut
  twentyfold, through ``assemble(backend="reference")`` with the cell's
  pipeline (``m_capacity`` cut to the small genome), judged by the plain
  reference assembler of ``portbench/reference`` on every check it makes,
  every read in the sample: all 0.
* One long chain beside many singletons, the shape depth 40 gives: the
  packed ``ContigSet`` and ``ConsensusResult`` laid back out as rows equal
  the JAX package's padded tensors bit for bit, on both backends, while
  holding only the live pieces and bases.
"""

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.assembly import consensus as jcons  # noqa: E402
from repro.assembly.contig_gen import (  # noqa: E402
    _device_contig_gen as j_device_contigs,
    _reference_contig_gen as j_host_contigs,
    string_matrix_from_edges,
)
from repro_torch.assembly import consensus as tcons  # noqa: E402
from repro_torch.assembly import contig_gen as tcg  # noqa: E402
from repro_torch.assembly.pipeline import PipelineConfig, assemble  # noqa: E402
from repro_torch.convert import ell_from_numpy  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.readgen import make_reads  # noqa: E402
from portbench.reference.judge import judge  # noqa: E402

CELL = "celegans-gspmd.pb-d40-l11241"
# the read law's lengths cut twentyfold (depth, errors and strands as
# stated), the width 1.0415 x the longest read to a multiple of 32
SCALED = {"mean_len": 562, "std_len": 100, "min_len": 120, "max_len": 962,
          "width": 1024}


def test_cell_files_state_the_deployment():
    """The cell's configuration and traffic: Table IV's depth and mean
    read, the read law's widths, the genome the only cut."""
    _, cell, config, traffic = harness.load_cell(CELL, REPO)
    assert cell["chips"] == 1 and config["distribution"] == "gspmd"
    assert config["reduced"] == ["genome_length"]
    assert (traffic["depth"], traffic["mean_len"]) == (40, 11241)
    assert traffic["max_len"] == traffic["mean_len"] + 4 * traffic["std_len"]
    assert traffic["width"] % 32 == 0 and traffic["width"] >= 1.0415 * (
        traffic["max_len"])
    p = config["pipeline"]
    assert p["max_steps"] >= 2 * traffic["width"]
    for key in ("overlap_capacity", "r_capacity", "m_capacity", "max_steps"):
        assert p[key] & (p[key] - 1) == 0, key  # powers of two
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert [c["name"] for c in bench["configs"]].count(cell["config"]) == 1


def test_depth40_assembly_matches_the_plain_reference():
    _, _, config, traffic = harness.load_cell(CELL, REPO)
    law = {**traffic, **SCALED}
    genome = 420  # 30 reads at depth 40
    reads = make_reads(genome, law, 4_000_000_017)
    n = reads.n_reads
    assert 30 <= n <= 60 and reads.n_cut == 0
    pipe = {**config["pipeline"], "m_capacity": 1 << 16}
    cfg = PipelineConfig(**pipe, distribution=config["distribution"],
                         backend="reference", device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops: a thread pool only contends
    try:
        res = assemble(reads.codes, reads.lengths, cfg)
        checks, _ = judge(reads.codes, reads.lengths,
                          harness.program_output(res), pipe, seed=17,
                          sample_reads=n)
    finally:
        torch.set_num_threads(threads)
    st = res.stats
    # depth 40: every read overlaps most others, and the capacities hold
    assert st["n_aligned"] > 10 * n
    assert st["overflow_C"] == st["overflow_R"] == st["tr_overflow"] == 0
    assert st["n_contained"] > 0 and len(res.polished_contigs) > 0
    assert set(checks) == {"kmer_counts", "a_matrix", "c_matrix", "r_rows",
                           "s_graph", "contigs", "polished"}
    assert {k: v for k, (v, _) in checks.items()} == dict.fromkeys(checks, 0)


def _chain_and_singletons(seed, n_chain=48, n_single=40, err=0.03):
    """One dovetail chain of ``n_chain`` reads of a random genome (edges as
    ``consistent_chain_graph``'s) beside ``n_single`` reads with no edge:
    ``(s, codes, lengths)``, JAX's string matrix and numpy reads."""
    rng = np.random.default_rng(seed)
    n = n_chain + n_single
    lengths = rng.integers(180, 250, n).astype(np.int32)
    pos = np.zeros(n_chain, np.int64)
    edges = []
    for i in range(n_chain - 1):
        ov = int(rng.integers(80, 140))
        pos[i + 1] = pos[i] + lengths[i] - ov
        edges.append((i, i + 1, 0, 0, int(lengths[i + 1]) - ov))
        edges.append((i + 1, i, 1, 1, int(lengths[i]) - ov))
    genome = rng.integers(0, 4, int(pos[-1] + lengths.max()), dtype=np.uint8)
    codes = rng.integers(0, 4, (n, int(lengths.max()))).astype(np.uint8)
    for i in range(n_chain):
        codes[i, :lengths[i]] = genome[pos[i]:pos[i] + lengths[i]]
    flip = rng.random(codes.shape) < err
    codes = np.where(flip, (codes + 1) % 4, codes).astype(np.uint8)
    return string_matrix_from_edges(n, edges, capacity=8), codes, lengths


@pytest.mark.parametrize("backend,jbackend", [("reference", "reference"),
                                              ("cuda", "pallas")])
@pytest.mark.parametrize("radius", [0, 12])
def test_long_chain_beside_singletons_packs_the_padded_layout(
        backend, jbackend, radius):
    s, codes, lengths = _chain_and_singletons(31)
    ts = ell_from_numpy(np.asarray(s.cols), np.asarray(s.vals), s.n_cols)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lengths)
    j = j_device_contigs(s, codes, lengths)
    jh = j_host_contigs(s, codes, lengths)
    for t, want in ((tcg._device_contig_gen(ts, tc, tl), j),
                    (tcg.generate_contigs(ts, tc, tl, backend="reference"),
                     jh)):
        assert t.n_contigs == want.n_contigs == 41
        got = t.padded(rows=want.codes.shape[0], cols=want.codes.shape[1],
                       slots=want.states.shape[1])
        for g, w in zip(got, (want.codes, want.lengths, want.states,
                              want.offsets, want.widths)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cset = tcg._device_contig_gen(ts, tc, tl)
    # live slots only: one chain of 48 pieces and 40 of one, where the
    # padded layout gives every contig the longest chain's and contig's
    assert cset.states.numel() == int(cset.n_pieces.sum()) == 88
    assert int(cset.n_pieces.max()) == 48
    assert cset.codes.numel() == int(cset.lengths.sum())
    assert cset.codes.numel() < 0.1 * j.codes.size
    jr = jcons.polish_contig_set(j, codes, lengths, backend=jbackend,
                                 junction_radius=radius)
    tr = tcons.polish_contig_set(cset, tc, tl, backend=backend,
                                 junction_radius=radius)
    got = tr.padded(rows=jr.codes.shape[0], cols=jr.codes.shape[1],
                    slots=jr.states.shape[1])
    for f, g in zip(("codes", "lengths", "states", "depth", "agree"), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(jr, f)), f)
    for f in ("depth_mean", "identity", "qv"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f))[:tr.n_contigs],
                                   rtol=1e-6)
    assert tr.stats == pytest.approx(jr.stats, rel=1e-6)
    assert tr.codes.numel() == int(tr.lengths.sum())
    assert [c.reads for c in tr.to_contigs()] == [c.reads for c in
                                                  cset.to_contigs()]
    if radius:
        assert tr.stats["n_changed"] > 0


def test_packed_layouts_keep_their_shape_in_an_assembly():
    """``assemble()``'s contig and consensus tensors hold exactly the live
    bases and pieces of the contigs they give."""
    s, codes, lengths = _chain_and_singletons(5, n_chain=20, n_single=6)
    ts = ell_from_numpy(np.asarray(s.cols), np.asarray(s.vals), s.n_cols)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lengths)
    cset = tcg._device_contig_gen(ts, tc, tl)
    res = tcons.polish_contig_set(cset, tc, tl, backend="cuda")
    for packed, contigs in ((cset, cset.to_contigs()),
                            (res, res.to_contigs())):
        assert packed.codes.shape == (sum(c.length for c in contigs),)
        assert packed.states.shape == (sum(len(c.reads) for c in contigs),)
        assert packed.lengths.tolist() == [c.length for c in contigs]
        assert packed.n_pieces.tolist() == [len(c.reads) for c in contigs]
