"""Quickstart on the PyTorch port: assemble a small synthetic genome end to
end (the paper's Alg. 1 plus the consensus polish), on the card unless
told otherwise.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.assembly.contigs import contig_str
from repro_torch.assembly.metrics import assembly_identity
from repro_torch.assembly.pipeline import PipelineConfig, assemble
from repro_torch.assembly.simulate import simulate_genome, simulate_reads


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-kb", type=int, default=8)
    ap.add_argument("--error-rate", type=float, default=0.03)
    ap.add_argument("--indel-frac", type=float, default=0.0,
                    help="fraction of errors that are indels; 0 (CCS-like "
                         "substitutions) is where pileup polish shines")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args()

    rng = np.random.default_rng(42)
    genome = simulate_genome(rng, args.genome_kb * 1000)
    reads = simulate_reads(genome, depth=12, mean_len=900, std_len=120,
                           error_rate=args.error_rate,
                           indel_frac=args.indel_frac, seed=1)
    print(f"genome {len(genome)} bp; {reads.n_reads} reads, "
          f"depth {reads.depth:.1f}, error {args.error_rate:.0%}")

    cfg = PipelineConfig(m_capacity=1 << 15, upper=48, read_capacity=128,
                         overlap_capacity=48, r_capacity=32, band=33,
                         max_steps=2048, align_chunk=8192, device=args.device)
    res = assemble(reads.codes, reads.lengths, cfg)

    print("\npipeline stages:")
    for k, v in res.timings.items():
        print(f"  {k:<12} {v:7.2f} s")
    print("\nstatistics:")
    for k in ("c_density", "r_density", "s_density", "tr_iterations",
              "n_contained", "n_branch_cut", "cc_iterations"):
        print(f"  {k:<15} {res.stats[k]}")
    cs = res.stats["contigs"]
    print(f"\ncontigs: {cs['n_contigs']}  N50={cs['n50']}  L50={cs['l50']}  "
          f"mean={cs['mean_length']:.0f}  "
          f"longest={cs['longest']} (genome={len(genome)})")

    draft_id, nb = assembly_identity(res.contigs, reads, min_reads=2)
    pol_id, _ = assembly_identity(res.polished_contigs, reads, min_reads=2)
    print(f"\nconsensus: depth {res.stats['consensus_depth_mean']:.1f}x, "
          f"{res.stats['consensus_changed']} columns re-called; identity vs "
          f"truth ({nb} bases): draft {draft_id:.4f} -> polished "
          f"{pol_id:.4f}")
    longest = max(res.polished_contigs, key=lambda c: c.length)
    print(f"longest polished contig head: {contig_str(longest)[:60]}...")


if __name__ == "__main__":
    main()
