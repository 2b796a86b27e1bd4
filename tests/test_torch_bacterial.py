"""``chip_smoke.py`` phase 6b (``assemble()`` at bacterial scale), its
shared configuration and its truth metrics, rehearsed on the CPU at a
small genome (the card is the measurement)."""

from __future__ import annotations

import importlib.util
import os
import types

import pytest
import torch

from repro_torch.assembly import simulate as sim
from repro_torch.assembly.metrics import assembly_identity
from repro_torch.assembly.pipeline import assemble

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("genome_kb, m_capacity", [
    (20, 1 << 15), (400, 1 << 20), ("bacterial", 1 << 23)])
def test_assembly_config_sizes_m_capacity_from_the_genome(cs, genome_kb,
                                                          m_capacity):
    """One configuration for every assembly run: phase 3's (1 << 20 at
    400 kb, as before) and the bacterial one (1 << 23, the next power of
    two above the 6,366,718 reliable k-mers of 4,641,652 bp)."""
    kb = cs.BACTERIAL_KB if genome_kb == "bacterial" else genome_kb
    cfg = cs.assembly_config(kb, device="cpu")
    assert cfg.m_capacity == m_capacity
    assert cs.RELIABLE_PER_BP * kb * 1000 <= cfg.m_capacity
    assert (cfg.upper, cfg.read_capacity, cfg.overlap_capacity,
            cfg.r_capacity, cfg.band, cfg.max_steps, cfg.xdrop,
            cfg.align_chunk) == (56, 160, 64, 40, 65, 4096, 30, 4096)
    if genome_kb == "bacterial":
        assert round(kb * 1000) == 4_641_652
        assert cfg.m_capacity > 6_366_718 > cfg.m_capacity // 2


def test_truth_quality_on_a_small_assembly(cs, monkeypatch):
    """The window identity equals ``assembly_identity`` (contigs of 2 reads
    or more) when the window holds the whole genome, and measures about
    the window's length of contig when it cuts the contig; the genome
    fraction is the union of the truth intervals."""
    reads = cs.simulate(sim, 2, 0)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # small ops: a thread pool only contends
    try:
        res = assemble(reads.codes, reads.lengths,
                       cs.assembly_config(2, device="cpu"))
    finally:
        torch.set_num_threads(threads)
    band = max(64, int(8 * 0.05 * 1400))
    whole = cs.truth_quality(res, reads)
    want, nb = assembly_identity(res.contigs, reads, min_reads=2, band=band)
    assert whole["draft_identity"] == pytest.approx(want, abs=1e-12)
    assert whole["identity_bases"][0] == nb
    want_p, _ = assembly_identity(res.polished_contigs, reads, min_reads=2,
                                  band=band)
    assert whole["polished_identity"] == pytest.approx(want_p, abs=1e-12)
    assert 0.5 < whole["genome_fraction"] <= 1.0
    assert whole["n_contigs"] == res.stats["contigs"]["n_contigs"]
    monkeypatch.setattr(cs, "IDENTITY_BP", 1000)
    cut = cs.truth_quality(res, reads)
    assert abs(cut["identity_bases"][0] - 1000) < 100
    assert 0.5 < cut["draft_identity"] <= 1.0


def _short_reads(simulate_mod, genome_kb, seed):
    """``chip_smoke.simulate``'s genome and error model with 250-base
    reads: the plain x-drop steps once per base of a walk, so short reads
    keep the CPU rehearsal quick."""
    import numpy as np

    genome = simulate_mod.simulate_genome(np.random.default_rng(seed),
                                          round(genome_kb * 1000))
    return simulate_mod.simulate_reads(
        genome, depth=14, mean_len=250, std_len=35, error_rate=0.05,
        indel_frac=0.6, seed=seed + 1)


def test_bacterial_phase_rehearses_on_the_cpu(cs, monkeypatch):
    """Phase 6b's control flow on the CPU at a 0.8 kb genome of short reads:
    gspmd and shard_map on a 1-rank gloo group equal, each kernel's
    captured input equal to its plain version (the ``cuda`` backend's
    plain versions on the CPU), the records gain their ``"bacterial"``
    entries."""
    records = [{"name": n} for n in cs.KERNEL_NAMES]
    monkeypatch.setattr(cs, "BACTERIAL_KB", 0.8)
    monkeypatch.setattr(cs, "simulate", _short_reads)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops: a thread pool only contends
    try:
        phase = cs.bacterial_phase(types.SimpleNamespace(seed=0), cs.check,
                                   records, device="cpu")
    finally:
        torch.set_num_threads(threads)
    by = {r["name"]: r for r in records}
    assert [e["input"].split(",")[0] for e in by["xdrop"]["bacterial"]] == [
        "gspmd first and last chunk"]  # one chunk at this size
    for name in ("xdrop", "spgemm", "pileup"):
        for e in by[name]["bacterial"]:
            assert e["max_abs_err"] == 0 and e["plain_ms"] > 0
            assert e["bound_ms"] > 0 and e["bound_by"] in ("bytes",
                                                           "operations")
    assert by["minplus"]["bacterial"][0]["input"].endswith("the dense TR")
    assert "bacterial" not in by["cc"]
    assert phase["n_reads"] == 45 and phase["n_contigs"] >= 1
    assert phase["draft_identity"] <= phase["polished_identity"]


def test_bacterial_phase_rehearses_the_sampled_tr_on_the_cpu(cs, monkeypatch):
    """Phase 6b above TR_DENSE_MAX_ROWS (cut to 16 rows here): the TR squares
    through the ``spgemm_masked`` op once an iteration on both paths, and
    its first and last squares are held to the plain version and the torch
    square."""
    from repro_torch.core import transitive_reduction as ttr

    records = [{"name": n} for n in cs.KERNEL_NAMES]
    monkeypatch.setattr(cs, "BACTERIAL_KB", 0.8)
    monkeypatch.setattr(cs, "simulate", _short_reads)
    monkeypatch.setattr(ttr, "TR_DENSE_MAX_ROWS", 16)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops: a thread pool only contends
    try:
        phase = cs.bacterial_phase(types.SimpleNamespace(seed=0), cs.check,
                                   records, device="cpu")
    finally:
        torch.set_num_threads(threads)
    by = {r["name"]: r for r in records}
    assert by["minplus"]["bacterial"][0]["input"].endswith(
        "the sampled square")
    entries = by["spgemm_masked"]["bacterial"]
    assert [e["input"].split(",")[1] for e in entries] == [
        " first iteration's R: 45 rows x 40 slots", " last iteration's R: "
        "45 rows x 40 slots"]
    for e in entries:
        assert e["max_abs_err"] == 0 and e["plain_ms"] > 0
        assert e["bound_ms"] > 0 and e["bound_by"] in ("bytes", "operations")
    assert phase["n_reads"] == 45 and phase["n_contigs"] >= 1
