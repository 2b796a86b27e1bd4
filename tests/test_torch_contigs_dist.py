"""The port's distributed contig chain stage (``core/components_dist.py``)
on gloo ranks, against JAX's single-device chain state.

``tests/test_distributed.py``'s string matrix (odd n, branches, a cycle)
goes through ``contig_stage_shard_map`` on 4 ranks (the bitonic network)
and 3 ranks (odd-even transposition, one shard idle per stage): every
chain-state array and the ``path_components`` count equal JAX's
``_chain_state(distribution="gspmd")``, the device contig path gives JAX's
ContigSet, and the per-phase words equal ``bench_comm_model``'s models.
JAX's own ``contig_stage_shard_map``, run on as many fake host devices,
gives the same chain state and the same exchange counts."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.assembly.contig_gen import _chain_state as j_chain_state
from repro.assembly.contig_gen import _doubling_local as j_doubling_local
from repro.assembly.contig_gen import _graph_cut as j_graph_cut
from repro.assembly.contig_gen import generate_contigs as j_generate
from repro.assembly.contig_gen import string_matrix_from_edges
from repro.core.components_dist import exchange_words as j_exchange_words
from repro_torch.assembly.contig_gen import ContigSet
from repro_torch.core import components_dist as tcd

from _dist_helpers import run_with_devices
from _torch_dist import run_ranks

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks.bench_comm_model import (  # noqa: E402
    words_chain_sort,
    words_graph_cut,
)

pytestmark = pytest.mark.dist

N = 23  # odd: the pad-to-a-multiple-of-P read path
ST_KEYS = ("state_s", "elig_s", "rank_s", "chain_idx_s", "new_chain", "insuf",
           "has_edge", "n_chains", "max_chain", "n_branch_cut",
           "cc_iterations")


def _string_matrix():
    rng = np.random.default_rng(0)
    edges = []
    for i in range(N - 1):
        if i % 7 != 6:  # several chains
            edges.append((i, i + 1, 0, 0, 30))
            edges.append((i + 1, i, 1, 1, 30))
    edges += [(3, 9, 0, 0, 12), (12, 5, 1, 0, 11)]  # branches
    edges += [(21, 18, 0, 0, 7), (18, 21, 1, 1, 7)]  # extra cycle edges
    s = string_matrix_from_edges(N, edges)
    codes = rng.integers(0, 4, (N, 128)).astype(np.uint8)
    lengths = rng.integers(80, 120, N).astype(np.int32)
    return s, codes, lengths


@pytest.fixture(scope="module")
def case():
    s, codes, lengths = _string_matrix()
    st, _ = j_chain_state(s, distribution="gspmd")
    cut = j_graph_cut(s)
    st["_doubling"] = j_doubling_local(cut["succ0"], cut["pred0"])
    cset = j_generate(s, jnp.asarray(codes), jnp.asarray(lengths),
                      backend="pallas", distribution="gspmd")
    inputs = {"S": {"cols": np.asarray(s.cols),
                    "vals": {"v": np.asarray(s.vals)}, "n_cols": s.n_cols},
              "codes": codes, "lengths": lengths}
    return inputs, st, cset


@pytest.fixture(scope="module", params=[4, 3], ids=["p4", "p3"])
def ranks(request, case, tmp_path_factory):
    p = request.param
    return p, run_ranks(p, "job_contigs", case[0],
                        tmp_path_factory.mktemp(f"contigs{p}"))


def test_chain_state_matches_jax(case, ranks):
    _, st, _ = case
    _, outs = ranks
    for out in outs:
        for key in ST_KEYS:
            np.testing.assert_array_equal(np.asarray(out["st"][key]),
                                          np.asarray(st[key]), err_msg=key)


def test_doubling_middle_matches_jax(case, ranks):
    _, st, _ = case
    p, outs = ranks
    want = st["_doubling"]
    n_pad = -(-2 * N // p) * p
    for out in outs:
        got = out["doubling"]
        for key in ("labels", "head", "rank"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), key)
        assert got["cc_iterations"] == int(want["cc_iterations"])
        assert got["exchange_words"] == j_exchange_words(
            n_pad, p, got["bc_rounds"], got["cc_iterations"],
            got["cr_iterations"]) > 0


def test_device_contigs_match_jax(case, ranks):
    _, _, cset = case
    _, outs = ranks
    for out in outs:
        assert out["n_contigs"] == cset.n_contigs
        # the port's set is packed (live slots only); laid out as rows of
        # JAX's shapes it is JAX's padded set
        packed = ContigSet(**{f: torch.from_numpy(x)
                              for f, x in out["cset"].items()},
                           n_contigs=out["n_contigs"], stats={})
        assert packed.codes.numel() == int(packed.lengths.sum())
        got = packed.padded(rows=cset.codes.shape[0],
                            cols=cset.codes.shape[1],
                            slots=cset.states.shape[1])
        for f, g in zip(("codes", "lengths", "states", "offsets", "widths"),
                        got):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(getattr(cset, f)), f)
        st = out["cset_stats"]
        assert st["distribution"] == "shard_map"
        assert st["n_branch_cut"] == cset.stats["n_branch_cut"]
        assert st["cc_iterations"] == cset.stats["cc_iterations"]


def test_exchange_words_match_models(case, ranks):
    p, outs = ranks
    n_pad = 2 * (-(-N // p) * p)
    for out in outs:
        st = out["stats"]
        assert st["exchange_words_cut"] == words_graph_cut(2 * N, p) > 0
        assert st["exchange_words_sort"] == words_chain_sort(2 * N, p) > 0
        bc = tcd._log2_ceil(n_pad) + 1
        pc_it = int(out["st"]["cc_iterations"])
        cr_it = st["exchange_rounds_doubling"] - bc - pc_it
        assert st["exchange_words_doubling"] == j_exchange_words(
            n_pad, p, bc, pc_it, cr_it) > 0
        assert st["exchange_words"] == (st["exchange_words_cut"]
                                        + st["exchange_words_doubling"]
                                        + st["exchange_words_sort"])
        assert st["exchange_rounds_sort"] == tcd.n_sort_stages(p) + 1


def test_chain_stage_matches_jax_shard_map_on_fake_devices(case, ranks,
                                                           tmp_path):
    """The port on P gloo ranks against JAX's own ``contig_stage_shard_map``
    on a (P, 1) mesh of P fake host devices: every chain-state array and
    every exchange count (words and rounds, per phase) are equal."""
    p, outs = ranks
    root = os.path.join(os.path.dirname(__file__), "..")
    s = case[0]["S"]
    path = str(tmp_path / "s.npz")
    np.savez(path, cols=s["cols"], vals=s["vals"]["v"])
    stdout = run_with_devices(f"""
import sys, json
sys.path.insert(0, {root!r})
import numpy as np, jax.numpy as jnp
from repro.core.components_dist import contig_stage_shard_map
from repro.core.spmat import EllMatrix
from repro.launch.mesh import make_test_mesh

z = np.load({path!r})
s = EllMatrix(cols=jnp.asarray(z["cols"]), vals=jnp.asarray(z["vals"]),
              n_cols={s["n_cols"]})
st, stats = contig_stage_shard_map(s, mesh=make_test_mesh(({p}, 1)))
print(json.dumps({{"st": {{k: np.asarray(v).tolist() for k, v in st.items()}},
                  "stats": {{k: int(v) for k, v in stats.items()}}}}))
""", n_devices=p)
    want = json.loads(stdout.strip().splitlines()[-1])
    assert set(want["st"]) == set(ST_KEYS)
    for out in outs:
        for key in ST_KEYS:
            np.testing.assert_array_equal(np.asarray(out["st"][key]),
                                          np.asarray(want["st"][key]),
                                          err_msg=key)
        assert out["stats"] == want["stats"]


def test_sort_network_and_word_formulas_match_jax():
    from repro.core import components_dist as jcd

    for p in (1, 2, 3, 4, 5, 8, 16):
        assert tcd.sort_network(p) == jcd.sort_network(p)
        assert tcd.n_sort_stages(p) == jcd.n_sort_stages(p)
        for n_pad in (48, 96):
            assert tcd.exchange_words_sort(n_pad, p) == \
                jcd.exchange_words_sort(n_pad, p)
            assert tcd.exchange_words_cut(n_pad, p) == \
                jcd.exchange_words_cut(n_pad, p)
            assert tcd.exchange_words(n_pad, p, 7, 3, 2) == \
                jcd.exchange_words(n_pad, p, 7, 3, 2)
    assert tcd.GATHERS_PER_ROUND == jcd.GATHERS_PER_ROUND
    assert tcd.CUT_ALLREDUCES == jcd.CUT_ALLREDUCES
