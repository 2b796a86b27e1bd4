"""The traffic generator: a random genome and CLR-like long reads from a seed.

A vectorised form of the read model of ``repro_torch.assembly.simulate``
(the same parameters, without its per-read host loop): a uniform random
genome; ``round(depth * G / mean_len)`` reads with lengths drawn from a
normal law, clipped to ``[min_len, max_len]``, placed uniformly so that
each lies inside the genome; each read taken from the reverse strand with
probability ``rc_frac``; then every template base independently suffers an
error with probability ``error_rate``, of which ``1 - indel_frac`` are
substitutions (to one of the three other bases) and the rest half
deletions, half insertions of a random base before it.

Everything comes from the run's seed: the genome, the reads' layout
(template lengths, places and strands) and the place and kind of every
sequencing error.  Different seeds give different genomes and reads of
the same sizes and error law.  The reads are padded to a fixed ``width``
columns; a read whose insertions would carry it past ``width`` is cut
there (the traffic file sets ``width`` far enough above ``max_len`` that
this does not happen in practice; ``n_cut`` counts it).

The traffic file (``portbench/traffic/<mix>.json``) holds the parameters;
the genome length comes from the configuration.  Everything is drawn on
``device`` from one ``torch.Generator``, in a few bulk calls, and written
nowhere: the same seed on the same kind of device gives the same reads.
"""

from __future__ import annotations

import dataclasses

import torch

TRAFFIC_KEYS = ("depth", "mean_len", "std_len", "min_len", "max_len",
                "width", "error_rate", "indel_frac", "rc_frac")
_I64 = torch.int64


@dataclasses.dataclass
class Reads:
    """The reads of one run and their truth (tensors on the run's device)."""

    codes: torch.Tensor  # (n, width) uint8, A=0 C=1 G=2 T=3, zero padded
    lengths: torch.Tensor  # (n,) int32
    truth_start: torch.Tensor  # (n,) int64, genome start of the template
    truth_end: torch.Tensor  # (n,) int64
    truth_strand: torch.Tensor  # (n,) int32, 1 = reverse complement
    genome: torch.Tensor  # (G,) uint8
    n_cut: int  # reads cut at ``width``

    @property
    def n_reads(self) -> int:
        """Number of reads."""
        return int(self.codes.shape[0])


def n_reads(genome_length: int, traffic: dict) -> int:
    """The read count of ``traffic`` on a ``genome_length`` genome."""
    return max(2, int(round(traffic["depth"] * int(genome_length)
                            / traffic["mean_len"])))


def make_reads(genome_length: int, traffic: dict, seed: int,
               device="cpu") -> Reads:
    """The reads of ``traffic`` on a random ``genome_length`` genome."""
    t = {key: traffic[key] for key in TRAFFIC_KEYS}
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))  # any whole number is a seed
    g = int(genome_length)
    n = n_reads(g, t)

    def rand(size):
        return torch.rand(size, generator=gen, device=dev)

    def randint(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=gen, device=dev,
                             dtype=_I64)

    # the layout, the errors of each template base and the genome
    tl = torch.normal(float(t["mean_len"]), float(t["std_len"]), (n,),
                      generator=gen, device=dev).to(_I64)
    tl = torch.clamp(tl, t["min_len"], min(t["max_len"], g))
    starts = torch.floor(rand(n).double() * (g - tl + 1).double()).to(_I64)
    strand = (rand(n) < t["rc_frac"]).to(torch.int32)
    total = int(tl.sum())
    err = torch.nonzero(rand(total) < t["error_rate"]).reshape(-1)
    kind = rand(err.numel())
    sub_p = 1.0 - t["indel_frac"]
    del_p = 1.0 - t["indel_frac"] / 2
    sub = err[kind < sub_p]
    dele = err[(kind >= sub_p) & (kind < del_p)]
    ins = err[kind >= del_p]
    sub_shift = randint(1, 4, sub.numel())
    ins_base = randint(0, 4, ins.numel()).to(torch.uint8)

    genome = randint(0, 4, g).to(torch.uint8)

    # the templates, read by read, in one flat stream
    first = torch.cumsum(tl, 0) - tl
    off = torch.arange(total, device=dev) - torch.repeat_interleave(
        first, tl, output_size=total)
    rc = torch.repeat_interleave(strand.bool(), tl, output_size=total)
    gpos = torch.where(
        rc, torch.repeat_interleave(starts + tl - 1, tl, output_size=total) - off,
        torch.repeat_interleave(starts, tl, output_size=total) + off)
    base = genome[gpos]
    base = torch.where(rc, 3 - base, base)

    # substitution, deletion, or insertion of a base before it
    base[sub] = ((base[sub].to(_I64) + sub_shift) % 4).to(torch.uint8)
    copies = torch.ones(total, dtype=_I64, device=dev)
    copies[dele] = 0
    copies[ins] = 2
    out_total = int(copies.sum())
    stream = torch.repeat_interleave(base, copies, output_size=out_total)
    landing = torch.cumsum(copies, 0) - copies  # where each base lands
    stream[landing[ins]] = ins_base

    read_of = torch.repeat_interleave(torch.arange(n, device=dev), tl,
                                      output_size=total)
    lengths = torch.zeros(n, dtype=_I64, device=dev).index_add_(
        0, read_of, copies)
    out_read = torch.repeat_interleave(torch.arange(n, device=dev), lengths,
                                       output_size=out_total)
    col = torch.arange(out_total, device=dev) - torch.repeat_interleave(
        torch.cumsum(lengths, 0) - lengths, lengths, output_size=out_total)
    width = int(t["width"])
    keep = col < width
    codes = torch.zeros((n, width), dtype=torch.uint8, device=dev)
    codes[out_read[keep], col[keep]] = stream[keep]
    return Reads(
        codes=codes,
        lengths=torch.clamp(lengths, max=width).to(torch.int32),
        truth_start=starts,
        truth_end=starts + tl,
        truth_strand=strand,
        genome=genome,
        n_cut=int(torch.sum(lengths > width)),
    )
