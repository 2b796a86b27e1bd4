"""A run whose timed path is broken underneath comes out not correct: the
harness past its look for a card, on the CPU at a tiny genome, once for
each fault the cells can have."""

import pytest
import torch

from portbench import harness


def _tr_unchanged(mp):
    from repro_torch.assembly import pipeline

    real = pipeline.transitive_reduction_fused

    def tr(r, **kw):  # a step that returns its state unchanged
        return r, real(r, **kw)[1]
    mp.setattr(pipeline, "transitive_reduction_fused", tr)


def _half_aligned(mp):
    from repro_torch.assembly import pipeline

    real = pipeline._align_local

    def align(codes, cand, bucket, n_live, cfg, backend):
        # half of the batch left out: the rest take row 0's result
        return real(codes, cand, bucket, max(n_live // 2, 1), cfg, backend)
    mp.setattr(pipeline, "_align_local", align)


def _polished_base(mp):
    from repro_torch.assembly import pipeline

    real = pipeline.polish_contig_set

    def polish(*a, **kw):  # an answer altered where it is produced
        out = real(*a, **kw)
        out.codes[0, 0] = (out.codes[0, 0] + 1) % 4
        return out
    mp.setattr(pipeline, "polish_contig_set", polish)


def _kmer_count(mp):
    from repro_torch.assembly import pipeline

    real = pipeline.count_and_select

    def count(*a, **kw):  # a count altered where it is produced
        kc = real(*a, **kw)
        return kc._replace(n_unique=kc.n_unique + 1)
    mp.setattr(pipeline, "count_and_select", count)


@pytest.mark.parametrize("fault,caught_by", [
    (_tr_unchanged, "s_graph"),
    (_half_aligned, "r_rows"),
    (_polished_base, "polished"),
    (_kmer_count, "kmer_counts"),
])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, fault, caught_by):
    fault(monkeypatch)
    line = harness.run_rank("gspmd", 9090, 0.5, False, t_start=0.0,
                            device="cpu", root=tiny_root)
    assert line["correct"] is False
    assert line["failed"] == line["attempted"]
    assert line["checks"][caught_by]["value"] > line["checks"][caught_by]["limit"]


def test_the_whole_check_sees_one_pair_changed(tiny_root, monkeypatch):
    """One aligned pair's score cut (a fault the sample may miss) fails the
    whole check's R-wide counts."""
    from repro_torch.assembly import pipeline

    real = pipeline._align_local

    def align(*a, **kw):
        score, *rest = real(*a, **kw)
        score = score.clone()
        score[torch.argmax(score)] = 0  # the best pair fails its test
        return (score, *rest)
    monkeypatch.setattr(pipeline, "_align_local", align)
    line = harness.run_rank("gspmd", 9090, 0.5, False, t_start=0.0,
                            device="cpu", root=tiny_root, check_all=True)
    assert line["correct"] is False
    assert line["checks"]["r_rows"]["value"] > 0


def test_a_sound_run_is_correct(tiny_root):
    line = harness.run_rank("gspmd", 9090, 0.5, False, t_start=0.0,
                            device="cpu", root=tiny_root)
    assert line["correct"] is True and line["failed"] == 0


def _grid_rank(rank, port, root, leave_out, queue):
    """One gloo rank of the tiny four-rank cell, the exchange between ranks
    left out where ``leave_out``."""
    import torch

    torch.set_num_threads(2)
    if leave_out:
        from repro_torch.core.grid import ProcessGrid

        ProcessGrid.ppermute = lambda self, x, axes, perm: x
    line = harness.run_rank("grid", 515, 0.5, False, t_start=0.0,
                            device="cpu", rank=rank, world=4, port=port,
                            root=root)
    if rank == 0:
        queue.put(line)


@pytest.mark.parametrize("leave_out", [True, False])
def test_the_grid_without_its_exchange_is_not_correct(tiny_root, leave_out):
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_grid_rank,
                         args=(r, port, tiny_root, leave_out, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    line = queue.get(timeout=600)
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0
    assert line["correct"] is (not leave_out)
    if leave_out:
        assert line["failed"] == line["attempted"]
