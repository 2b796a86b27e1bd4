"""Seeded inputs of the ``kmer_pack`` op: (codes, lengths) numpy pairs that
the CPU emulation of the kernel (``tests/test_torch_kmer_pack.py``) and the
card tests (``tests/test_torch_cuda.py``) share.  Numpy only, so the card's
test file imports no JAX through it."""

import numpy as np

#: positions a block of the kernel takes (``csrc/kmer_pack.cu`` TILE)
TILE = 1024

CASES = ["seeded", "edge_lengths", "tile_edges", "one_tile", "codes_past_3"]
KS = [1, 7, 15, 16, 21, 30]


def _pad(codes, lens):
    codes[np.arange(codes.shape[1])[None, :] >= lens[:, None]] = 0
    return codes, lens


def reads(case: str, k: int, seed: int = 0):
    """codes (n, L) uint8 and lengths (n,) int32 of ``case`` at ``k``:

    * ``seeded``: 12 reads of up to 2,600 codes (three tiles a row), random
      lengths from 0 to the padded width, zeros past each length;
    * ``edge_lengths``: lengths 0, k − 1, k, k + 1, 2k and the padded maximum
      on a width of 3k + 5;
    * ``tile_edges``: P = L − k + 1 = two tiles and one position, lengths
      on either side of the tiles' edges;
    * ``one_tile``: P = one tile exactly;
    * ``codes_past_3``: bytes outside 0..3 (a whole random row, and one 4 in
      a single tile of another row) beside rows of plain codes.
    """
    rng = np.random.default_rng(1000 * seed + 10 * k + CASES.index(case))
    if case == "seeded":
        width = 2600
        codes = rng.integers(0, 4, (12, width)).astype(np.uint8)
        lens = rng.integers(0, width + 1, 12).astype(np.int32)
        lens[:3] = [width, width - 1, k]
        return _pad(codes, lens)
    if case == "edge_lengths":
        lmax = 3 * k + 5
        codes = rng.integers(0, 4, (9, lmax)).astype(np.uint8)
        lens = np.array([k, k + 1, lmax, lmax, k - 1, 0, 2 * k, lmax - 1,
                         k + 2], np.int32)
        return _pad(codes, lens)
    if case == "tile_edges":
        width = 2 * TILE + k  # P = 2 TILE + 1: the last tile holds one position
        codes = rng.integers(0, 4, (8, width)).astype(np.uint8)
        lens = np.array([TILE + k - 2, TILE + k - 1, TILE + k, 2 * TILE + k - 1,
                         2 * TILE + k, width, width - 1,
                         rng.integers(0, width + 1)], np.int32)
        return _pad(codes, lens)
    if case == "one_tile":
        width = TILE + k - 1  # P = TILE
        codes = rng.integers(0, 4, (4, width)).astype(np.uint8)
        lens = np.array([width, width - 1, k, rng.integers(0, width + 1)],
                        np.int32)
        return _pad(codes, lens)
    if case == "codes_past_3":
        width = 2100
        codes = rng.integers(0, 4, (6, width)).astype(np.uint8)
        codes[1] = rng.integers(0, 256, width).astype(np.uint8)
        codes[3, TILE + 17] = 4
        codes[4, rng.integers(0, width, 40)] = 255
        lens = np.full(6, width, np.int32)
        lens[5] = width // 2
        return codes, lens
    raise ValueError(case)
