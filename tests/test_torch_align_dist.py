"""The port's distributed x-drop extension (``core/align_dist.py``) on 4
gloo ranks, held per pair against JAX's local ``batch_extend`` (JAX's own
``align_bucket_shard_map`` does not run here: ROADMAP queue 3) and its
exchange words against ``bench_comm_model.words_align``."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.assembly.alignment import batch_extend as j_batch_extend
from repro.assembly.kmers import revcomp as j_revcomp
from repro_torch.core.align_dist import align_bucket_shard_map

from _torch_dist import run_ranks

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks.bench_comm_model import words_align  # noqa: E402

K = 11
KW = dict(backend="reference", xdrop=20, band=17, max_steps=256)


def _bucket(seed=0, n=23, width=160, bucket=37):
    """Reads cut from one genome at known offsets (a third of them reverse
    complemented) and a bucket of candidate pairs seeded at a shared
    genome position, plus random pairs; odd sizes exercise the padding."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 2000)
    starts = np.sort(rng.integers(0, 2000 - width, n))
    lens = rng.integers(width // 2, width + 1, n).astype(np.int32)
    codes = np.zeros((n, width), np.uint8)
    for r in range(n):
        seg = genome[starts[r]:starts[r] + lens[r]].copy()
        flip = rng.random(len(seg)) < 0.03
        seg[flip] = (seg[flip] + 1) % 4
        codes[r, :lens[r]] = seg
    cand = {key: np.zeros(bucket, np.int32)
            for key in ("i", "j", "li", "lj", "pa", "pb", "strand")}
    for e in range(bucket):
        i, j = sorted(rng.choice(n, 2, replace=False))
        lo = max(starts[i], starts[j])
        hi = min(starts[i] + lens[i], starts[j] + lens[j]) - K
        g = rng.integers(lo, hi) if hi > lo else lo
        pa = int(np.clip(g - starts[i], 0, lens[i] - K))
        pb = int(np.clip(g - starts[j], 0, lens[j] - K))
        strand = int(e % 3 == 2)
        cand["i"][e], cand["j"][e] = i, j
        cand["li"][e], cand["lj"][e] = lens[i], lens[j]
        cand["pa"][e], cand["pb"][e], cand["strand"][e] = pa, pb, strand
    return codes, cand


def _jax_reference(codes, cand):
    c = {k: jnp.asarray(v) for k, v in cand.items()}
    codes = jnp.asarray(codes)
    ai, bj = codes[c["i"]], codes[c["j"]]
    bj = jnp.where((c["strand"] == 1)[:, None], j_revcomp(bj, c["lj"]), bj)
    out = j_batch_extend(ai, c["li"], bj, c["lj"], c["pa"], c["pb"], k=K,
                         **KW)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def case():
    codes, cand = _bucket()
    return codes, cand, _jax_reference(codes, cand)


@pytest.fixture(scope="module")
def align4(case, tmp_path_factory):
    codes, cand, _ = case
    return run_ranks(4, "job_align", {"codes": codes, "cand": cand, "k": K,
                                      "kw": KW},
                     tmp_path_factory.mktemp("align4"))


@pytest.mark.dist
def test_align_bucket_matches_jax_batch_extend_on_four_ranks(case, align4):
    _, _, want = case
    assert (want[0] > K).any()  # some pairs really extend
    for out in align4:
        for got, w in zip(out["res"], want):
            np.testing.assert_array_equal(got, w)


@pytest.mark.dist
def test_align_exchange_words_match_model(case, align4):
    codes, cand, _ = case
    model = words_align(n_pad=24, row_width=codes.shape[1], bucket_pad=40,
                        p=4)
    for out in align4:
        assert out["stats"]["exchange_words_align"] == model
        # 3 ring hops of the read rows + the score allreduce
        assert out["stats"]["exchange_rounds_align"] == 4


def test_align_bucket_single_rank_matches_jax(case):
    codes, cand, want = case
    res, stats = align_bucket_shard_map(
        torch.from_numpy(codes), {k: torch.from_numpy(v) for k, v in cand.items()},
        k=K, **KW)
    for got, w in zip(res, want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert stats == {"exchange_words_align": 0, "exchange_rounds_align": 0}


# --- n_live: pad slots are not extended ---------------------------------------


def _padded_bucket(n_live, bucket=40):
    """The pipeline's bucket: live pairs first, then pad slots that repeat
    pair 0 (the compaction's index 0)."""
    codes, cand = _bucket(seed=3, bucket=bucket)
    for v in cand.values():
        v[max(n_live, 1):] = v[0]
    return codes, cand


def _cfg(align_chunk):
    from repro_torch.assembly.pipeline import PipelineConfig

    return PipelineConfig(k=K, xdrop=KW["xdrop"], band=KW["band"],
                          max_steps=KW["max_steps"], align_chunk=align_chunk,
                          device="cpu")


@pytest.mark.parametrize("n_live", [0, 1, 23, 40])
def test_align_local_skips_pad_slots_and_matches_jax(n_live):
    """``_align_local`` extends rows ``[0, max(n_live, 1))`` in
    ``align_chunk`` blocks, one op call a block, and fills the pad rows
    from row 0: every row, pad slots included, equals JAX's whole-bucket
    ``batch_extend``."""
    from repro_torch.assembly.pipeline import _align_local
    from repro_torch.core.backend import register_op
    from repro_torch.kernels import xdrop_extend_batch

    codes, cand = _padded_bucket(n_live)
    want = _jax_reference(codes, cand)
    calls = []

    def spy(*args, **kw):
        calls.append(tuple(args[1].shape))
        return xdrop_extend_batch(*args, **kw)

    register_op("xdrop_extend", "cuda", spy)
    try:
        got = _align_local(torch.from_numpy(codes),
                           {k: torch.from_numpy(v) for k, v in cand.items()},
                           40, n_live, _cfg(16), "cuda")
    finally:
        register_op("xdrop_extend", "cuda", xdrop_extend_batch)
    assert calls == [(2, 16)] * -(-max(n_live, 1) // 16)
    for g, w in zip(got, want):
        assert g.shape == (40,)
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n_live", [0, 9, 40])
def test_align_bucket_n_live_single_rank(n_live):
    codes, cand = _padded_bucket(n_live)
    want = _jax_reference(codes, cand)
    res, stats = align_bucket_shard_map(
        torch.from_numpy(codes),
        {k: torch.from_numpy(v) for k, v in cand.items()}, k=K, n_live=n_live,
        **KW)
    for got, w in zip(res, want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert stats == {"exchange_words_align": 0, "exchange_rounds_align": 0}


@pytest.mark.dist
def test_align_bucket_n_live_on_four_ranks(tmp_path):
    """n_live = 23 of a 37-pair bucket on 4 ranks (blocks of 10): ranks 0-2
    extend 10, 10 and 3 rows, rank 3 none; every rank's result equals JAX
    and the local path, and the exchange words stay the whole bucket's."""
    from repro_torch.assembly.pipeline import _align_local

    codes, cand = _padded_bucket(23, bucket=37)
    want = _jax_reference(codes, cand)
    local = _align_local(torch.from_numpy(codes),
                         {k: torch.from_numpy(v) for k, v in cand.items()},
                         37, 23, _cfg(4096), "reference")
    outs = run_ranks(4, "job_align", {"codes": codes, "cand": cand, "k": K,
                                      "kw": {**KW, "n_live": 23}}, tmp_path)
    model = words_align(n_pad=24, row_width=codes.shape[1], bucket_pad=40,
                        p=4)
    for out in outs:
        for got, w, loc in zip(out["res"], want, local):
            np.testing.assert_array_equal(got, w)
            np.testing.assert_array_equal(got, loc.numpy())
        assert out["stats"]["exchange_words_align"] == model
        assert out["stats"]["exchange_rounds_align"] == 4
