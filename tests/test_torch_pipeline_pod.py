"""``assemble(distribution="shard_map")`` on a ``(2, 1, 2)`` ``("pod",
"data", "model")`` grid of 4 gloo ranks against JAX ``assemble()`` on the
golden input of ``tests/test_torch_pipeline.py`` (``tests/test_backend.py``'s
``_sim()`` / ``_cfg``), for both grid-row choices:

* the default, JAX's ``infer_row_axes``: rows on ``("pod", "data")`` (P = 2
  grid rows, 2 columns).  The overlap ring takes the recorded all-gather
  fallback for multi-axis rows, the x-drop and the contig chain stage split
  over the two pods;
* ``row_axes=("data",)``: the pods are replicas, the grid 1 × 2 (the ring's
  non-square fallback), Alignment and Contigs on one grid row.

R, S, every stats key but the path, exchange, SUMMA and memory keys, and
the polished contigs equal JAX's, on every rank."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from repro_torch.core.grid import POD_AXES

from _torch_dist import run_ranks
from test_torch_pipeline_dist import (  # noqa: F401  (golden is a fixture)
    F32_KEYS,
    MEMORY_KEYS,
    PATH_KEYS,
    SUMMA_KEYS,
    _np_ell,
    _pad,
    _port_cfg,
    golden,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks.bench_comm_model import (  # noqa: E402
    words_align,
    words_chain_sort,
    words_graph_cut,
)

pytestmark = pytest.mark.dist

ROW_AXES = (None, ("data",))


@pytest.fixture(scope="module")
def pod4(golden, tmp_path_factory):
    rs = golden[0]
    cfg = dataclasses.asdict(_port_cfg("reference"))
    for key in ("backend", "distribution", "device", "mesh", "row_axes"):
        cfg.pop(key)
    return run_ranks(4, "job_assemble",
                     {"codes": rs.codes, "lengths": rs.lengths, "cfg": cfg,
                      "backends": ("cuda",),
                      "grid": ((2, 1, 2), POD_AXES),
                      "row_axes_list": ROW_AXES},
                     tmp_path_factory.mktemp("pod4"))


@pytest.mark.parametrize("row_axes", ROW_AXES)
def test_golden_shard_map_on_pod_grid_matches_jax(golden, pod4, row_axes):
    _, jres, jdev = golden
    skip = set(PATH_KEYS) | set(MEMORY_KEYS) | set(SUMMA_KEYS)
    for out in pod4:
        got = out[("cuda", row_axes)]
        for key in ("R", "S"):
            want = _np_ell(jres.r_graph if key == "R" else jres.s_graph)
            np.testing.assert_array_equal(got[key]["cols"], want["cols"])
            for k, v in want["vals"].items():
                np.testing.assert_array_equal(got[key]["vals"][k], v)
        st = got["stats"]
        for key, val in jres.stats.items():
            if key in skip or key.startswith("exchange_"):
                continue
            if key in F32_KEYS:
                assert st[key] == pytest.approx(val, rel=1e-6), key
            else:
                assert st[key] == val, key
        assert st["cc_iterations"] == jdev.stats["cc_iterations"]
        np.testing.assert_array_equal(got["contained"],
                                      np.asarray(jres.contained))
        want = [(c.reads, c.length, c.codes) for c in jres.polished_contigs]
        assert len(got["polished"]) == len(want)
        for x, y in zip(got["polished"], want):
            assert x[0] == y[0] and x[1] == y[1] and np.array_equal(x[2], y[2])


@pytest.mark.parametrize("row_axes", ROW_AXES)
def test_pod_grid_paths_and_exchange_words(golden, pod4, row_axes):
    rs = golden[0]
    n, width = rs.codes.shape
    p = 2 if row_axes is None else 1  # grid rows of Alignment and Contigs
    for out in pod4:
        st = out[("cuda", row_axes)]["stats"]
        assert st["overlap_distribution"] == "shard_map"
        assert st["summa_algorithm"] == "allgather_fallback"
        assert st["summa_fallback_reason"] == (
            "multi-axis grid rows ('pod', 'data')" if row_axes is None
            else "non-square grid 1x2")
        assert st["exchange_words_summa"] == st["exchange_rounds_summa"] == 0
        assert st["exchange_words_align"] == (words_align(
            n_pad=_pad(n, p), row_width=width,
            bucket_pad=_pad(st["align_bucket"], p), p=p) if p > 1 else 0)
        assert st["exchange_words_cut"] == (
            words_graph_cut(2 * n, p) if p > 1 else 0)
        assert st["exchange_words_sort"] == (
            words_chain_sort(2 * n, p) if p > 1 else 0)
