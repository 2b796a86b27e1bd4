"""The plain reference agrees with the program (``assemble(device="cpu")``)
at a tiny genome, stage by stage, and its x-drop with the port's plain
x-drop walk for walk."""

import pytest
import torch

from portbench import harness
from portbench.readgen import make_reads
from portbench.reference.judge import judge
from portbench.reference.xdrop import xdrop_walks


@pytest.mark.parametrize("whole", [False, True])
@pytest.mark.parametrize("workload", ["gspmd", "summa"])
def test_reference_agrees_with_the_program(tiny_root, workload, whole):
    from repro_torch.assembly.pipeline import PipelineConfig, assemble

    _, _, config, traffic = harness.load_cell(workload, tiny_root)
    reads = make_reads(config["genome_length"], traffic, 4242)
    cfg = PipelineConfig(**config["pipeline"], distribution=config["distribution"],
                         device="cpu")
    res = assemble(reads.codes, reads.lengths, cfg)
    assert res.stats["n_aligned"] > 100 and res.stats["nnz_S"] > 10
    checks, work = judge(reads.codes, reads.lengths, harness.program_output(res),
                         config["pipeline"], seed=4242,
                         sample_reads=(reads.n_reads if whole
                                       else config["check"]["sample_reads"]))
    assert {k: v for k, (v, _) in checks.items()} == dict.fromkeys(checks, 0)
    assert all(w["ops"] > 0 and w["bytes"] > 0 for w in work.values())


def test_xdrop_agrees_with_the_ports_plain_walk():
    from repro_torch.kernels.xdrop.ref import xdrop_extend_batch_ref

    g = torch.Generator().manual_seed(7)
    e, width = 64, 300
    a = torch.randint(0, 4, (e, width), generator=g, dtype=torch.uint8)
    b = a.clone()
    noise = torch.rand((e, width), generator=g) < 0.08
    b[noise] = torch.randint(0, 4, (int(noise.sum()),), generator=g,
                             dtype=torch.uint8)
    b[e // 2:] = torch.randint(0, 4, (e - e // 2, width), generator=g,
                               dtype=torch.uint8)  # unrelated pairs
    base_a = torch.randint(0, 100, (e,), generator=g)
    step = torch.where(torch.arange(e) % 2 == 0, 1, -1)
    len_a = torch.where(step > 0, width - base_a, base_a + 1)
    kw = dict(xdrop=20, match=1, mismatch=-1, gap=-1, band=33, max_steps=256)
    want = xdrop_extend_batch_ref(
        a, base_a.int(), step.int(), len_a.int(), b, base_a.int(), step.int(),
        len_a.int(), with_cells=True, **kw)
    got = xdrop_walks(a, base_a, step, len_a, b, base_a, step, len_a,
                      count_cells=True, **kw)
    for w, x in zip(want, got):
        assert torch.equal(w.long(), x.long())
