"""The golden test of the port's ``distribution="shard_map"`` path:
``assemble(distribution="shard_map", device="cpu")`` on 4 gloo ranks and on
1 rank against JAX ``assemble()`` (gspmd) on ``tests/test_backend.py``'s
``_sim()`` / ``_cfg``.

R and S are ``ell_equal``, every stats key but the path, exchange and
memory keys is equal, the polished contigs are identical, and the stats
carry the keys of a JAX shard_map run in its order.  The exchange keys
equal ``bench_comm_model``'s analytic models.  Both port backends run:
``"reference"`` (host contig walk) and ``"cuda"`` (on CPU tensors: every
kernel's plain version and the distributed contig chain stage)."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from repro.assembly.contig_gen import _device_contig_gen as j_device_contigs
from repro.assembly.pipeline import assemble as j_assemble
from repro_torch.assembly.pipeline import assemble
from repro_torch.convert import config_from_dict
from repro_torch.obs import schema

from _torch_dist import _ell_np, run_ranks
from test_backend import _cfg, _sim

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks.bench_comm_model import (  # noqa: E402
    words_align,
    words_chain_sort,
    words_graph_cut,
    words_summa,
)

SUMMA_KEYS = ("summa_algorithm", "summa_stages", "summa_backend",
              "exchange_words_summa", "exchange_rounds_summa",
              "spgemm_hbm_round_trips", "spgemm_hbm_round_trips_reference")
PATH_KEYS = ("backend", "tr_backend", "distribution", "overlap_distribution",
             "align_distribution", "cc_iterations", "summa_backend",
             "spgemm_hbm_round_trips")
MEMORY_KEYS = ("peak_hbm_bytes", "hbm_bytes_in_use")
F32_KEYS = ("consensus_depth_mean", "identity_estimate", "qv_estimate")


def _pad(x, p):
    return -(-x // p) * p


@pytest.fixture(scope="module")
def golden():
    rs = _sim()
    jres = j_assemble(rs.codes, rs.lengths, _cfg("reference"))
    jdev = j_device_contigs(jres.s_graph, rs.codes, rs.lengths, jres.contained)
    return rs, jres, jdev


def _port_cfg(backend):
    cfg = config_from_dict(dataclasses.asdict(_cfg(backend)), device="cpu")
    return dataclasses.replace(cfg, distribution="shard_map")


@pytest.fixture(scope="module")
def ranks4(golden, tmp_path_factory):
    rs = golden[0]
    cfg = dataclasses.asdict(_port_cfg("reference"))
    for key in ("backend", "distribution", "device"):
        cfg.pop(key)
    return run_ranks(4, "job_assemble",
                     {"codes": rs.codes, "lengths": rs.lengths, "cfg": cfg,
                      "backends": ("reference", "cuda")},
                     tmp_path_factory.mktemp("assemble4"))


@pytest.fixture(scope="module")
def rank1(golden):
    rs = golden[0]
    out = {}
    for backend in ("reference", "cuda"):
        res = assemble(rs.codes, rs.lengths, _port_cfg(
            "pallas" if backend == "cuda" else "reference"))
        out[backend] = {
            "R": _ell_np(res.r_graph), "S": _ell_np(res.s_graph),
            "stats": dict(res.stats), "contained": res.contained.numpy(),
            "polished": [(c.reads, c.length, c.codes)
                         for c in res.polished_contigs]}
    return out


def _expected_keys(jstats, tr_on_grid):
    """The key order of a JAX shard_map run: the ring SUMMA's stats right
    after ``overlap_distribution``; where TrReduction ran on a grid of
    several ranks, the port's own TR exchange keys right after
    ``tr_overflow``."""
    keys = [k for k in jstats if k not in SUMMA_KEYS]
    at = keys.index("overlap_distribution") + 1
    keys = keys[:at] + list(SUMMA_KEYS) + keys[at:]
    if tr_on_grid:
        at = keys.index("tr_overflow") + 1
        keys = keys[:at] + list(schema.PORT_ONLY) + keys[at:]
    return keys


def _np_ell(m):
    vals = m.vals if isinstance(m.vals, dict) else {"v": m.vals}
    return {"cols": np.asarray(m.cols),
            "vals": {k: np.asarray(v) for k, v in vals.items()}}


def _assert_same(jres, jdev, got, backend, tr_on_grid=False):
    for key in ("R", "S"):
        want = _np_ell(jres.r_graph if key == "R" else jres.s_graph)
        np.testing.assert_array_equal(got[key]["cols"], want["cols"])
        for k, v in want["vals"].items():
            np.testing.assert_array_equal(got[key]["vals"][k], v)
    st = got["stats"]
    assert list(st) == _expected_keys(jres.stats, tr_on_grid)
    # TrReduction on the grid (the ring's plain version on CPU tensors)
    # where it has several ranks, else the local TR, as in JAX
    if tr_on_grid:
        assert st["tr_backend"] == "ring_reference"
    else:
        assert st["tr_backend"] in ("reference", "cuda")
    assert schema.validate_stats(st, require_groups=schema.ZERO_GROUPS) == []
    for key, val in jres.stats.items():
        if key in PATH_KEYS or key in MEMORY_KEYS or key.startswith("exchange_"):
            continue
        if key in F32_KEYS:
            assert st[key] == pytest.approx(val, rel=1e-6), key
        else:
            assert st[key] == val, key
    for key in ("overlap_distribution", "align_distribution"):
        assert st[key] == "shard_map"
    assert st["summa_backend"] == "reference"  # CPU tensors: the plain version
    assert st["distribution"] == ("shard_map" if backend == "cuda" else "host")
    if backend == "cuda":
        assert st["cc_iterations"] == jdev.stats["cc_iterations"]
    np.testing.assert_array_equal(got["contained"], np.asarray(jres.contained))
    want = [(c.reads, c.length, c.codes) for c in jres.polished_contigs]
    assert len(got["polished"]) == len(want)
    for x, y in zip(got["polished"], want):
        assert x[0] == y[0] and x[1] == y[1] and np.array_equal(x[2], y[2])


@pytest.mark.dist
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_golden_shard_map_on_four_ranks_matches_jax(golden, ranks4, backend):
    _, jres, jdev = golden
    for out in ranks4:
        _assert_same(jres, jdev, out[backend], backend, tr_on_grid=True)


@pytest.mark.dist
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_shard_map_exchange_words_match_models_on_four_ranks(golden, ranks4,
                                                             backend):
    rs, jres, _ = golden
    cfg = _port_cfg("reference")
    n, width = rs.codes.shape
    for out in ranks4:
        st = out[backend]["stats"]
        assert st["summa_algorithm"] == "ring" and st["summa_stages"] == 2
        assert st["exchange_rounds_summa"] == 1
        assert st["exchange_words_summa"] == words_summa(
            n_rows=_pad(n, 2), a_block_slots=cfg.read_capacity,
            a_words_per_slot=2, m_rows=_pad(cfg.m_capacity, 2),
            b_block_slots=cfg.upper, b_words_per_slot=2, pr=2, pc=2)
        assert st["exchange_words_align"] == words_align(
            n_pad=_pad(n, 4), row_width=width,
            bucket_pad=_pad(st["align_bucket"], 4), p=4)
        assert st["exchange_rounds_align"] == 4
        if backend == "cuda":
            assert st["exchange_words_cut"] == words_graph_cut(2 * n, 4)
            assert st["exchange_words_sort"] == words_chain_sort(2 * n, 4)
            assert st["exchange_words_doubling"] > 0
        else:  # the host walk has no exchange
            assert st["exchange_words"] == st["exchange_rounds"] == 0


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_golden_shard_map_on_one_rank_matches_jax(golden, rank1, backend):
    _, jres, jdev = golden
    got = rank1[backend]
    _assert_same(jres, jdev, got, backend)
    st = got["stats"]
    assert st["summa_algorithm"] == "ring" and st["summa_stages"] == 1
    for key in ("exchange_words_summa", "exchange_rounds_summa",
                "exchange_words_align", "exchange_rounds_align",
                "exchange_words"):
        assert st[key] == 0, key
    assert st["spgemm_hbm_round_trips"] == 1
