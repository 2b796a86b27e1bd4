"""The ``kmer_pack`` op (``kernels/kmer_pack``) on the CPU: the CUDA kernel's
algorithm (``csrc/kmer_pack.cu``), emulated in numpy with its own constants
and 32-bit words, equals the plain version bit for bit on every case of
``tests/_kmer_cases.py`` — the packed 2-bit streams, their 64-bit windows
and the reversed, complemented stream where a tile holds only codes 0..3,
and the ring sum over the window where it holds a code past 3.  The kernel
itself is held to the plain version on the card in
``tests/test_torch_cuda.py``; ``extract_kmers`` through the op is held to
JAX's in ``tests/test_torch_kmers_counter.py``."""

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.core import backend as B

import _kmer_cases

# csrc/kmer_pack.cu
THREADS, PER_THREAD, MAX_K = 256, 4, 30
TILE = THREADS * PER_THREAD
WORDS = (TILE + MAX_K - 1 + 15) // 16
CODES = 16 * WORDS
M32 = np.uint64(0xFFFFFFFF)
U = np.uint64


def _brev(x):
    y = np.zeros_like(x)
    for b in range(32):
        y |= ((x >> U(b)) & U(1)) << U(31 - b)
    return y


def _revcomp_digits(x):
    y = _brev(x)
    swapped = ((y >> U(1)) & U(0x55555555)) | ((y & U(0x55555555)) << U(1))
    return ~swapped & M32


def _window(s, start):
    """``window``: the two 32-bit words of the 64-bit window at ``start``
    (``__funnelshift_l`` of three stream words)."""
    w = start >> 4
    sh = ((start & 15) * 2).astype(np.uint64)
    a0, a1, a2 = s[w], s[w + 1], s[w + 2]
    return (((a0 << U(32)) | a1) << sh) >> U(32), \
        (((a1 << U(32)) | a2) << sh) >> U(32)


def _split(w_hi, w_lo, hi_mask, lo_mask):
    return ((w_hi >> U(2)) & hi_mask,
            (((w_hi & U(3)) << U(28)) | (w_lo >> U(4))) & lo_mask)


def _i32(x):
    return (np.asarray(x, np.uint64) & M32).astype(np.uint32).view(np.int32)


def emulate(codes: np.ndarray, lengths: np.ndarray, k: int):
    """The kernel's outputs, block by block: (hi, lo, strand, valid) and the
    number of blocks that took the general (ring-sum) path."""
    n, width = codes.shape
    p_all = width - k + 1
    kh = min(k, 15)
    hi_mask = U((0xFFFFFFFF << (2 * (15 - kh))) & 0xFFFFFFFF)
    lo_mask = U((0xFFFFFFFF << (2 * (30 - k))) & 0xFFFFFFFF) if k > 15 else U(0)
    out = [np.zeros((n, p_all), np.int32) for _ in range(3)]
    valid = np.zeros((n, p_all), bool)
    general_blocks = 0
    for row in range(n):
        limit = _i32(np.int64(lengths[row]) - k + 1)
        for p0 in range(0, p_all, TILE):
            g = p0 + np.arange(CODES)
            code = np.where(g < width, codes[row, np.minimum(g, width - 1)],
                            0).astype(np.uint64)
            o = np.arange(min(TILE, p_all - p0))
            if not (code > 3).any():
                digits = code.reshape(WORDS, 16) & U(3)
                fwd = np.zeros(WORDS + 2, np.uint64)
                fwd[:WORDS] = np.bitwise_or.reduce(
                    digits << (U(30) - U(2) * np.arange(16, dtype=np.uint64)),
                    axis=1)
                rev = np.zeros(WORDS + 2, np.uint64)
                rev[WORDS - 1 - np.arange(WORDS)] = _revcomp_digits(fwd[:WORDS])
                fh, fl = _split(*_window(fwd, o), hi_mask, lo_mask)
                rh, rl = _split(*_window(rev, CODES - o - k), hi_mask, lo_mask)
            else:
                general_blocks += 1
                fh, fl, rh, rl = (np.zeros(len(o), np.uint64) for _ in range(4))
                for t in range(k):
                    c = code[o + t]
                    r = (U(3) - c) & M32  # 3u - c
                    if t < 15:
                        fh += c << U(28 - 2 * t)
                    else:
                        fl += c << U(58 - 2 * t)
                    u = k - 1 - t
                    if u < 15:
                        rh += r << U(28 - 2 * u)
                    else:
                        rl += r << U(58 - 2 * u)
            fh, fl, rh, rl = (_i32(x) for x in (fh, fl, rh, rl))
            fwd_smaller = (fh < rh) | ((fh == rh) & (fl <= rl))
            p = p0 + o
            out[0][row, p] = np.where(fwd_smaller, fh, rh)
            out[1][row, p] = np.where(fwd_smaller, fl, rl)
            out[2][row, p] = (~fwd_smaller).astype(np.int32)
            valid[row, p] = p < limit
    return (*out, valid), general_blocks


@pytest.mark.parametrize("k", _kmer_cases.KS)
@pytest.mark.parametrize("case", _kmer_cases.CASES)
def test_kernel_algorithm_equals_plain_version(case, k):
    codes, lens = _kmer_cases.reads(case, k)
    got, general = emulate(codes, lens, k)
    want = K.kmer_pack_ref(torch.from_numpy(codes), torch.from_numpy(lens),
                           k=k)
    for name, g, w in zip(("hi", "lo", "strand", "valid"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), name)
    # the general path runs exactly where a tile holds a code past 3
    assert (general > 0) == (case == "codes_past_3")


def test_plain_codes_fill_the_whole_two_words():
    """At k = 30 the canonical words use all 30 bits of each word: the plain
    version's top digits reach bits 29-28 of hi and lo."""
    codes = np.full((1, 30), 3, np.uint8)
    hi, lo, strand, valid = K.kmer_pack_ref(
        torch.from_numpy(codes), torch.tensor([30], dtype=torch.int32), k=30)
    # TTT...T's reverse complement AAA...A is the smaller
    assert hi.tolist() == [[0]] and lo.tolist() == [[0]]
    assert strand.tolist() == [[1]] and valid.tolist() == [[True]]
    codes[:] = 0
    got, _ = emulate(codes, np.array([30], np.int32), 30)
    assert [int(x[0, 0]) for x in got[:3]] == [0, 0, 0]


def test_kmer_pack_op_has_both_backends():
    assert B.available_backends("kmer_pack") == ("cuda", "reference")
    assert "kmer_pack" in K.KERNELS


@pytest.mark.parametrize("k", [0, 31])
def test_kmer_pack_refuses_k_outside_1_to_30(k):
    codes = torch.zeros(2, 40, dtype=torch.uint8)
    lens = torch.full((2,), 40, dtype=torch.int32)
    with pytest.raises(ValueError, match="k must lie in 1..30"):
        K.kmer_pack(codes, lens, k=k)


@pytest.mark.parametrize("backend", ["auto", "reference", "cuda"])
def test_extract_kmers_through_either_backend_on_the_cpu(backend):
    """``extract_kmers`` dispatches ``kmer_pack``: on CPU tensors every
    backend runs the plain version (the ``cuda`` wrapper included), and the
    step span says ``path="torch"``."""
    from repro_torch.assembly.kmers import extract_kmers
    from repro_torch.obs import Tracer, tracing

    codes, lens = _kmer_cases.reads("seeded", 15)
    with tracing(Tracer(device="cpu", memory=False)) as tr:
        got = extract_kmers(torch.from_numpy(codes), torch.from_numpy(lens),
                            k=15, backend=backend)
    want = K.kmer_pack_ref(torch.from_numpy(codes), torch.from_numpy(lens),
                           k=15)
    for key, w in zip(("hi", "lo", "strand", "valid"), want):
        assert torch.equal(got[key], w), key
    p = codes.shape[1] - 14
    assert torch.equal(got["pos"], torch.arange(p, dtype=torch.int32)
                       .expand(codes.shape[0], p))
    (sp,) = tr.find("CountKmer.extract")
    assert sp.attrs["path"] == "torch"
    (op,) = tr.find("op:kmer_pack")
    assert op.attrs["backend"] == ("reference" if backend == "auto"
                                   else backend)
