"""The paper's own pipeline as a selectable arch (``--arch dibella``).

The port's copy of ``repro.configs.dibella``, with the same field values:
the H. sapiens row of the paper's Table IV (4.42 M reads) padded to a power
of two, with static ELL capacities per grid column block.  The dibella cell
(``launch/dibella_cell.py``) runs one distributed overlap SpGEMM
(C = A·Aᵀ over the position-pair semiring) and one distributed transitive
reduction at these sizes."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class DibellaConfig:
    name: str = "dibella"
    family: str = "assembly"
    n_reads: int = 4_194_304  # ~H. sapiens Table IV (4.42M), pow2-padded
    m_kmers: int = 1 << 24  # reliable k-mer space
    read_capacity: int = 64  # K_A block capacity per grid column
    kmer_capacity: int = 8  # u (max k-mer frequency, paper uses 4-8)
    overlap_block_capacity: int = 16  # K_C per grid column block
    r_block_capacity: int = 8  # K_R per grid column block
    tr_fuzz: float = 1000.0

    def reduced_sizes(self):
        return dataclasses.replace(
            self, n_reads=256, m_kmers=4096, read_capacity=8,
            overlap_block_capacity=8, r_block_capacity=4,
        )


CONFIG = DibellaConfig()


def reduced():
    return CONFIG.reduced_sizes()
