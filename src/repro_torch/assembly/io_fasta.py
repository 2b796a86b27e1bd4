"""FASTA I/O with chunked parallel-read emulation (paper §IV-B).

The port's own copy of ``repro.assembly.io_fasta`` (plain Python and
numpy).  The paper reads equal-sized independent chunks per MPI rank;
``read_fasta_sharded(path, shard, n_shards)`` byte-splits the file, and a
shard owns every record that *starts* in its chunk (the protocol of
parallel MPI-IO readers).  ``write_contig_fasta`` writes contigs grouped by
string-graph component, with per-component statistics in every header.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from .kmers import BASES

_LUT = np.full(256, 0, np.uint8)
for _i, _c in enumerate(BASES):
    _LUT[ord(_c)] = _i
    _LUT[ord(_c.lower())] = _i


def parse_fasta(text: str) -> Tuple[List[str], List[str]]:
    """``(names, sequences)`` of FASTA text."""
    names, seqs = [], []
    cur: List[str] = []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith(">"):
            if cur:
                seqs.append("".join(cur))
                cur = []
            names.append(line[1:].strip())
        else:
            cur.append(line.strip())
    if cur:
        seqs.append("".join(cur))
    return names, seqs


def read_fasta_sharded(path: str, shard: int = 0, n_shards: int = 1):
    """Parse the ``shard``-th byte chunk of a FASTA file (the records that
    start in it).  Returns ``(names, codes (n, L_max) uint8, lengths (n,)
    int32)``."""
    size = os.path.getsize(path)
    lo = size * shard // n_shards
    hi = size * (shard + 1) // n_shards
    with open(path, "rb") as f:
        f.seek(lo)
        buf = f.read(hi - lo)
        # include the tail of the record spilling past hi
        tail = b""
        while True:
            chunk = f.read(1 << 16)
            if not chunk:
                break
            nxt = chunk.find(b">")
            if nxt >= 0:
                tail += chunk[:nxt]
                break
            tail += chunk
    data = buf + tail
    # drop the partial record at the head (it belongs to the previous shard)
    if shard > 0:
        first = data.find(b">")
        data = data[first:] if first >= 0 else b""
    names, seqs = parse_fasta(data.decode("ascii", errors="ignore"))
    return names, *pack_reads(seqs)


def pack_reads(seqs: List[str]):
    """Sequences → ``(codes (n, L_max) uint8, lengths (n,) int32)``."""
    n = len(seqs)
    lmax = max((len(s) for s in seqs), default=1)
    codes = np.zeros((n, lmax), np.uint8)
    lens = np.zeros((n,), np.int32)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s.encode(), np.uint8)
        codes[i, : len(b)] = _LUT[b]
        lens[i] = len(b)
    return codes, lens


def _emit_record(f, name: str, seq: str) -> None:
    f.write(f">{name}\n")
    for off in range(0, len(seq), 80):
        f.write(seq[off : off + 80] + "\n")


def write_fasta(path: str, names, codes, lengths) -> None:
    """Write reads ``codes[i][:lengths[i]]`` under ``names[i]``, 80 bases
    a line."""
    with open(path, "w") as f:
        for i, name in enumerate(names):
            seq = "".join(BASES[int(c)] for c in codes[i][: int(lengths[i])])
            _emit_record(f, name, seq)


def write_contig_fasta(path: str, contigs, components=None, identity=None,
                       depth=None) -> int:
    """Write contigs grouped by string-graph connected component, with
    per-component assembly stats in every header.

    ``components``: per-contig component labels (``contigs.read_components``
    + ``contig_components``); contigs of one component are written
    consecutively, components in label order.  ``identity`` / ``depth``:
    optional per-contig consensus identity estimate and mean pileup depth
    appended to the headers.  Returns the number of records written."""
    from .contigs import contig_stats

    comp = list(components) if components is not None else [0] * len(contigs)
    groups = {}
    for idx, c in enumerate(comp):
        groups.setdefault(c, []).append(idx)
    n_written = 0
    with open(path, "w") as f:
        for rank, c in enumerate(sorted(groups)):
            idxs = groups[c]
            cs = contig_stats([contigs[i] for i in idxs])
            tag = (f"component={rank} comp_contigs={cs.n_contigs} "
                   f"comp_total={cs.total_length} comp_n50={cs.n50}")
            for k, i in enumerate(idxs):
                ct = contigs[i]
                hdr = (f"contig_{rank}_{k} length={ct.length} "
                       f"reads={len(ct.reads)} {tag}")
                if identity is not None:
                    hdr += f" identity={float(identity[i]):.4f}"
                if depth is not None:
                    hdr += f" depth={float(depth[i]):.1f}"
                _emit_record(f, hdr, "".join(BASES[int(x)] for x in ct.codes))
                n_written += 1
    return n_written
