"""A tiny copy of the benchmark for the CPU tests: the cells' configurations
and traffic at a few kilobases, under a root of their own."""

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
GENOME = 6000
TRAFFIC = "pb-d10-l7401.json"


def tiny_traffic() -> dict:
    """``pb-d10-l7401`` with short reads, so the plain x-drop runs fast on
    the CPU."""
    t = json.loads((REPO / "portbench" / "traffic" / TRAFFIC).read_text())
    t.update(name="tiny", mean_len=300, std_len=40, min_len=150, max_len=420,
             width=448)
    return t


def tiny_config(name: str, genome: int = GENOME, sample_reads: int = 48
                ) -> dict:
    """A cell configuration cut to ``genome`` bases."""
    c = json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
    c.update(genome_length=genome)
    c["pipeline"].update(m_capacity=max(1 << 16, 1 << (2 * genome).bit_length()))
    c["check"].update(sample_reads=sample_reads)
    return c


def make_root(tmp: Path, genome: int = GENOME, sample_reads: int = 48,
              traffic: dict = None) -> Path:
    """A root holding ``BENCHMARK.json`` with the tiny cells (``gspmd``,
    ``summa`` on one rank, ``grid`` on four) and their files: a ``genome``
    of a few kilobases and short reads (``traffic``, by default
    :func:`tiny_traffic`)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "portbench" / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "portbench" / "traffic").mkdir(parents=True, exist_ok=True)
    cells = {"gspmd": ("hsapiens-gspmd", 1), "summa": ("hsapiens-summa", 1),
             "grid": ("hsapiens-summa", 4)}
    bench["workloads"] = [
        {"name": name, "config": cfg, "traffic": "tiny", "chips": n,
         "why": "tiny"} for name, (cfg, n) in cells.items()]
    for m in bench["per_layer"]:
        m["workloads"] = ["grid"] if m["name"] == "collective_s" else list(cells)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    for cfg in sorted({cfg for cfg, _ in cells.values()}):
        (tmp / "portbench" / "configs" / f"{cfg}.json").write_text(
            json.dumps(tiny_config(cfg, genome, sample_reads)))
    (tmp / "portbench" / "traffic" / "tiny.json").write_text(
        json.dumps(traffic or tiny_traffic()))
    return tmp
