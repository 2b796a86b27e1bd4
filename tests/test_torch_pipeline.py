"""The golden test of the port: ``repro_torch`` ``assemble(device="cpu")``
against JAX ``assemble()`` on ``tests/test_backend.py``'s input and config.

R and S are ``ell_equal``; the integer stats, the contig summary and the
polished contigs are identical; the f32 quality means agree to rel 1e-6
(their summation order differs).  Both port backends are held to the JAX
reference run: ``"reference"`` (plain torch, host contig walk) and
``"cuda"`` (on CPU tensors: every kernel's plain version, the dense min-plus
TR path and the device contig path)."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.assembly.contig_gen import _device_contig_gen as j_device_contigs
from repro.assembly.pipeline import assemble as j_assemble
from repro_torch.assembly.pipeline import PipelineConfig, assemble
from repro_torch.convert import config_from_dict, ell_from_numpy
from repro_torch.core.spmat import ell_equal
from repro_torch.obs import schema

from test_backend import _cfg, _sim

F32_KEYS = ("consensus_depth_mean", "identity_estimate", "qv_estimate")
MEMORY_KEYS = ("peak_hbm_bytes", "hbm_bytes_in_use")
# the keys that name the path that ran
PATH_KEYS = {"backend": "cuda", "tr_backend": "cuda", "distribution": "gspmd"}


def _port(m):
    vals = (jax.tree.map(np.asarray, m.vals) if isinstance(m.vals, dict)
            else np.asarray(m.vals))
    return ell_from_numpy(np.asarray(m.cols), vals, m.n_cols)


@pytest.fixture(scope="module")
def golden():
    rs = _sim()
    jres = j_assemble(rs.codes, rs.lengths, _cfg("reference"))
    ports = {
        b: assemble(rs.codes, rs.lengths,
                    config_from_dict(dataclasses.asdict(_cfg(b)), device="cpu"))
        for b in ("reference", "pallas")
    }
    return rs, jres, ports["reference"], ports["pallas"]


def _assert_same_assembly(jres, tres, skip=()):
    assert ell_equal(_port(jres.r_graph), tres.r_graph)
    assert ell_equal(_port(jres.s_graph), tres.s_graph)
    assert list(tres.stats) == list(jres.stats)
    for key, val in jres.stats.items():
        if key in MEMORY_KEYS or key in skip:
            continue
        if key in F32_KEYS:
            assert tres.stats[key] == pytest.approx(val, rel=1e-6), key
        else:
            assert tres.stats[key] == val, key
    np.testing.assert_array_equal(tres.contained.numpy(),
                                  np.asarray(jres.contained))
    for drafts in ((jres.contigs, tres.contigs),
                   (jres.polished_contigs, tres.polished_contigs)):
        assert len(drafts[0]) == len(drafts[1])
        for x, y in zip(*drafts):
            assert x.reads == y.reads and x.length == y.length
            assert np.array_equal(x.codes, y.codes)


def test_golden_reference_backend_matches_jax(golden):
    _, jres, tref, _ = golden
    assert tref.stats["backend"] == "reference"
    _assert_same_assembly(jres, tref)
    assert tref.stats["hbm_source"] == "live_buffers"
    assert tref.stats["n_passed"] > 0 and tref.stats["tr_iterations"] >= 1


def test_golden_cuda_backend_matches_jax(golden):
    rs, jres, _, tcuda = golden
    for key, val in PATH_KEYS.items():
        assert tcuda.stats[key] == val, key
    _assert_same_assembly(jres, tcuda, skip=tuple(PATH_KEYS) + ("cc_iterations",))
    jdev = j_device_contigs(jres.s_graph, rs.codes, rs.lengths, jres.contained)
    assert tcuda.stats["cc_iterations"] == jdev.stats["cc_iterations"]
    assert (tcuda.consensus.lengths.numpy()[:tcuda.consensus.n_contigs]
            == np.asarray(jres.consensus.lengths)[:jres.consensus.n_contigs]).all()


def test_stats_validate_and_compaction(golden):
    _, _, tref, tcuda = golden
    for res in (tref, tcuda):
        assert schema.validate_stats(res.stats, require_groups=schema.ZERO_GROUPS) == []
        st = res.stats
        assert st["align_candidates"] == st["n_reads"] * 32
        assert st["n_aligned"] <= st["align_bucket"] < 2 * max(st["n_aligned"], 1)
        assert set(res.timings) == {"CountKmer", "CreateSpMat", "SpGEMM",
                                    "Alignment", "BuildR", "TrReduction",
                                    "Contigs", "Consensus"}


@pytest.mark.parametrize("field,value", [("mesh", object())])
def test_unported_features_raise(field, value):
    """A mesh that is not a ``ProcessGrid`` (a JAX mesh, multi-row-axis
    grids) still raises; ``trace=True`` and ``connected_components`` are
    ported and held to JAX in ``test_torch_obs.py`` and
    ``test_torch_cc.py``."""
    rs = _sim()
    cfg = dataclasses.replace(PipelineConfig(device="cpu"), **{field: value})
    with pytest.raises(TypeError, match="ProcessGrid"):
        assemble(rs.codes, rs.lengths, cfg)
