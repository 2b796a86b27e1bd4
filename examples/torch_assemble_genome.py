"""End-to-end run on the PyTorch port: assemble a larger simulated
long-read dataset, report the graph and contig statistics, polish the
contigs, hold the draft and polished identity against the known genome,
and write component-grouped FASTA.  Runs on the card unless told
otherwise.

    PYTHONPATH=src python examples/torch_assemble_genome.py [--genome-kb 40] \\
        [--device cpu] [--out contigs.fasta]

The configuration is ``chip_smoke.assembly_config``'s, sized from the
genome's length: ``--genome-kb 4641.652`` (E. coli K-12's length, 46,417
reads at depth 14, ``chip_smoke.py`` phase 6b's size) takes ``m_capacity``
1 << 23.
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import assembly_config  # noqa: E402

from repro_torch.assembly.contigs import contig_components, read_components
from repro_torch.assembly.io_fasta import write_contig_fasta
from repro_torch.assembly.metrics import assembly_identity
from repro_torch.assembly.pipeline import assemble
from repro_torch.assembly.simulate import simulate_genome, simulate_reads


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-kb", type=float, default=30)
    ap.add_argument("--depth", type=float, default=14)
    ap.add_argument("--error-rate", type=float, default=0.05)
    ap.add_argument("--indel-frac", type=float, default=0.6,
                    help="fraction of errors that are indels (0 = CCS-like "
                         "substitutions, 0.6 = CLR-like)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="contigs.fasta")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    genome = simulate_genome(rng, round(args.genome_kb * 1000))
    reads = simulate_reads(genome, depth=args.depth, mean_len=1400,
                           std_len=250, error_rate=args.error_rate,
                           indel_frac=args.indel_frac, seed=1)
    print(f"[data] genome {len(genome)/1e3:.0f} kb, {reads.n_reads} reads, "
          f"depth {reads.depth:.1f}, error {args.error_rate:.0%} "
          f"(indel {args.indel_frac:.0%})")

    cfg = dataclasses.replace(assembly_config(args.genome_kb,
                                              device=args.device),
                              upper=int(4 * args.depth))
    t0 = time.time()
    res = assemble(reads.codes, reads.lengths, cfg)
    print(f"[run] {time.time()-t0:.1f}s total; stages:",
          {k: round(v, 2) for k, v in res.timings.items()})

    s = res.stats
    print(f"[stats] c={s['c_density']:.1f} r={s['r_density']:.2f} "
          f"s={s['s_density']:.2f} TR iters={s['tr_iterations']} "
          f"nnz R->S {s['nnz_R']}->{s['nnz_S']}")
    cs = s["contigs"]
    print(f"[contigs] n={cs['n_contigs']} N50={cs['n50']} L50={cs['l50']} "
          f"mean={cs['mean_length']:.0f} longest={cs['longest']} "
          f"total={cs['total_length']}")

    band = max(64, int(8 * args.error_rate * 1400))
    draft_id, nb = assembly_identity(res.contigs, reads, min_reads=2,
                                     band=band)
    pol_id, _ = assembly_identity(res.polished_contigs, reads, min_reads=2,
                                  band=band)
    print(f"[consensus] depth {s['consensus_depth_mean']:.1f}x, "
          f"{s['consensus_changed']} columns re-called; identity vs truth "
          f"({nb} bases): draft {draft_id:.4f} -> polished {pol_id:.4f}")

    polished = res.polished_contigs
    comps = contig_components(polished, read_components(res.s_graph))
    n_rec = write_contig_fasta(
        args.out, polished, comps,
        identity=np.asarray(res.consensus.identity.cpu()),
        depth=np.asarray(res.consensus.depth_mean.cpu()),
    )
    print(f"[out] {args.out}: {n_rec} records, "
          f"{len(set(comps))} component group(s)")


if __name__ == "__main__":
    main()
