"""Synthetic long-read dataset generator (PacBio-CLR-like, paper Table IV).

Host-side numpy (data generation, not part of the compute path).  Generates a
random genome, samples reads at a target depth with normally-distributed
lengths, flips half the reads to the reverse strand, and corrupts them with
substitutions and short indels at a configurable error rate (CLR errors are
indel-dominated; we default to 60% indels / 40% substitutions of the total
error budget).  Ground-truth positions are returned for validation.

The port's own copy of ``repro.assembly.simulate``: the same seeds give the
same reads, so a script can build the pipeline's input without the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ReadSet:
    codes: np.ndarray  # (n, L_max) uint8
    lengths: np.ndarray  # (n,) int32
    truth_start: np.ndarray  # (n,) genome start of the error-free template
    truth_end: np.ndarray
    truth_strand: np.ndarray  # (n,) 0 fwd / 1 rc
    genome: np.ndarray  # (G,) uint8

    @property
    def n_reads(self) -> int:
        return self.codes.shape[0]

    @property
    def depth(self) -> float:
        return float(self.lengths.sum()) / len(self.genome)


def simulate_genome(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.uint8)


def _corrupt(read: np.ndarray, rng, error_rate: float, indel_frac: float):
    if error_rate <= 0:
        return read
    n_err = rng.poisson(error_rate * len(read))
    out = list(read)
    for _ in range(n_err):
        if not out:
            break
        p = rng.integers(0, len(out))
        r = rng.random()
        if r < 1 - indel_frac:  # substitution
            out[p] = (out[p] + rng.integers(1, 4)) % 4
        elif r < 1 - indel_frac / 2:  # deletion
            del out[p]
        else:  # insertion
            out.insert(p, rng.integers(0, 4))
    return np.asarray(out, np.uint8)


def simulate_reads(
    genome: np.ndarray,
    *,
    depth: float = 15.0,
    mean_len: int = 1200,
    std_len: int = 200,
    min_len: int = 300,
    error_rate: float = 0.0,
    indel_frac: float = 0.6,
    seed: int = 0,
    circular: bool = False,
) -> ReadSet:
    rng = np.random.default_rng(seed)
    g = len(genome)
    n = max(2, int(round(depth * g / mean_len)))
    lengths = np.clip(
        rng.normal(mean_len, std_len, size=n).astype(int), min_len, None
    )
    if circular:
        starts = rng.integers(0, g, size=n)
    else:
        starts = rng.integers(0, np.maximum(1, g - lengths), size=n)
        lengths = np.minimum(lengths, g - starts)
    strands = rng.integers(0, 2, size=n)

    reads = []
    for s, l, st in zip(starts, lengths, strands):
        if circular and s + l > g:
            tmpl = np.concatenate([genome[s:], genome[: (s + l) % g]])
        else:
            tmpl = genome[s : s + l]
        if st:
            tmpl = 3 - tmpl[::-1]
        reads.append(_corrupt(tmpl, rng, error_rate, indel_frac))

    lmax = max(len(r) for r in reads)
    codes = np.zeros((n, lmax), np.uint8)
    out_len = np.zeros(n, np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = r
        out_len[i] = len(r)
    return ReadSet(
        codes=codes,
        lengths=out_len,
        truth_start=starts.astype(np.int64),
        truth_end=(starts + lengths).astype(np.int64),
        truth_strand=strands.astype(np.int32),
        genome=genome,
    )
