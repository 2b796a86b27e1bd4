"""Wrapper of the ring-SUMMA stage kernel (``csrc/spgemm.cu``) + dispatch
registration of the ``spgemm_ring_stages`` op.

``spgemm_ring_stages`` launches the CUDA kernel for CUDA tensors and runs
the plain version (``ref.py``) for CPU tensors.  One launch computes every
stage of the batch; a semiring the kernel does not serve raises — there is
no fallback to the plain version on the card.  The kernel serves
the two semirings the explicit-exchange path multiplies in: the overlap
semiring (operands ``{"pos"}``, result ``{"cnt", "apos", "bpos"}``) and
the min-plus orientation semiring (``{MP}`` (4,) f32 on both sides).

A launch is sized by the candidates that exist: a count launch of the same
library finds, per row, the live candidates, and lists the rows that hold
more than a block's shared memory can (:func:`fit_candidates`); the
wrapper reads the most of the rows that fit, the most of the rest, their
number and the largest output column (the launch's one host read), gives
each block of the shared-memory instance room for the first
(:func:`shared_bytes`), the radix sort as many 4-bit passes as the column
needs, and the rows too full to the global instance of the same kernel,
whose blocks keep their buffers in global scratch (:func:`global_bytes`,
:func:`global_blocks`).  No row is refused.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core.backend import register_op
from ...core.semiring import MP, NUM_POS_PAIRS, Semiring
from ...obs.trace import span
from ..build import CudaKernel, check_cuda, check_dtype, stream_handle
from .ref import spgemm_ring_stages_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("spgemm", [
    _I, _P, _P, _P, _P, _P,  # semiring, offsets, a_cols, a_vals, b_cols, b_vals
    _P, _P, _P, _P, _P,  # out cols, out value leaves 0..2, overflow
    _P, _I, _P, _I, _I,  # rows too full, their number, global scratch,
                         # global blocks, candidates a global block holds
    _I, _I, _I, _I, _I, _I,  # stages, n, ka, nb, kb, capacity
    _I, _I, _P,  # candidates a shared block holds, column bits, stream
])
#: the count launch: (semiring, offsets, a_cols, a_vals, b_cols, b_vals,
#: maxes, rows too full, fit, stages, n, ka, nb, kb, stream)
_COUNT_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
#: template instances of the kernel, by semiring name
SEMIRINGS = {"overlap_pospair": 0, "minplus_orient": 1}
#: shared memory a block may use on Hopper (hopper-kernels guide §1)
MAX_SHARED_BYTES = 232448
#: threads of a block, and the radix sort's digit counters a thread holds
THREADS = 256
RADIX = 16
#: global scratch the global instance may take, and its blocks an SM
GLOBAL_SCRATCH_BYTES = 1 << 30
GLOBAL_BLOCKS_PER_SM = 2


def global_bytes(sr_id: int, vcap: int, ka: int, kb: int) -> int:
    """The candidate-sized buffers of one block holding ``vcap`` candidates
    of a row with ``ka`` A slots and B rows of ``kb`` (``csrc/spgemm.cu:
    layout``, up to ``digits``): each candidate's operands (8 bytes
    overlap, 16 min-plus), column and two sort indices; the live A slots
    and the B rows they select; the offset of each (A slot, 32-lane chunk
    of its B row); rounded up to 16 bytes.  In global scratch for a block
    of the global instance."""
    o = ((8 if sr_id == 0 else 16) * vcap + 12 * vcap + 8 * ka
         + 4 * ka * -(-kb // 32))
    return -(-o // 16) * 16


def shared_bytes(sr_id: int, vcap: int, ka: int, kb: int) -> int:
    """Dynamic shared memory of one block of the shared-memory instance:
    :func:`global_bytes`, the radix counters (one pad word every 32) and
    the scan scratch."""
    return (global_bytes(sr_id, vcap, ka, kb)
            + 4 * (RADIX * THREADS + RADIX * THREADS // 32) + 4 * 64)


@functools.lru_cache(maxsize=64)
def fit_candidates(sr_id: int, ka: int, kb: int) -> int:
    """The most candidates a row may hold and still run in the
    shared-memory instance: the largest multiple of 4 whose
    :func:`shared_bytes` fit in :data:`MAX_SHARED_BYTES`, or -1 where not
    even 4 fit (then every row takes the global instance)."""
    per = (8 if sr_id == 0 else 16) + 12
    v = max(0, (MAX_SHARED_BYTES - shared_bytes(sr_id, 0, ka, kb)) // per)
    v -= v % 4
    while shared_bytes(sr_id, v + 4, ka, kb) <= MAX_SHARED_BYTES:
        v += 4
    while v >= 4 and shared_bytes(sr_id, v, ka, kb) > MAX_SHARED_BYTES:
        v -= 4
    return v if v >= 4 else -1


def global_rows(per_row: torch.Tensor, fit: int) -> torch.Tensor:
    """Which rows take the global instance, from their live candidates
    (the count launch's per-row totals): those holding more than
    ``fit``."""
    return per_row > fit


def global_blocks(n_full: int, per_block: int, sms: int) -> int:
    """Blocks of the global instance: one a row too full, at most
    :data:`GLOBAL_BLOCKS_PER_SM` an SM and as many as
    :data:`GLOBAL_SCRATCH_BYTES` holds (at least one)."""
    return max(1, min(n_full, GLOBAL_BLOCKS_PER_SM * sms,
                      GLOBAL_SCRATCH_BYTES // max(per_block, 1)))


def block_candidates(max_candidates: int) -> int:
    """Candidates a block makes room for: the launch's most in a row,
    rounded up to a multiple of 4."""
    return max(4, -(-max_candidates // 4) * 4)


def live_candidates(offsets, a_cols, b_cols) -> torch.Tensor:
    """Per (stage, row), the candidates that exist before (×): the sum, over
    the row's live A slots inside the stage's B row block, of the live slots
    of the B row each selects.  ``(S, n)`` int64.  (The kernel's count
    launch computes the same on the card, less the min-plus products that
    are zero.)"""
    stages, _, _ = a_cols.shape
    nb = b_cols.shape[1]
    reb = a_cols.long() - offsets.long()[:, None, None]
    live_a = (a_cols >= 0) & (reb >= 0) & (reb < nb)
    b_live = (b_cols >= 0).sum(-1)
    sidx = torch.arange(stages, device=a_cols.device)[:, None, None]
    per = torch.where(live_a, b_live[sidx, reb.clamp(0, max(nb - 1, 0))], 0)
    return per.sum(-1)


def _check_vals(sr_id, a_vals, b_vals, semiring):
    want = {"pos"} if sr_id == 0 else {MP}
    for key, vals in (("a_vals", a_vals), ("b_vals", b_vals)):
        if set(vals) != want:
            raise ValueError(f"spgemm: {key} of the {semiring.name} instance "
                             f"must hold {sorted(want)}, got {sorted(vals)}")


def spgemm_ring_stages(offsets, a_cols, a_vals, b_cols, b_vals, *,
                       semiring: Semiring, capacity: int, n_cols_out: int):
    """S ring-SUMMA local SpGEMM stages in one launch — the signature and
    the exact outputs of :func:`~.ref.spgemm_ring_stages_ref`:
    ``(st_cols (S, n, capacity), st_vals, overflow)``."""
    tensors = dict(offsets=offsets, a_cols=a_cols, b_cols=b_cols,
                   **{f"a_{k}": v for k, v in a_vals.items()},
                   **{f"b_{k}": v for k, v in b_vals.items()})
    if all(t.device.type == "cpu" for t in tensors.values()):
        return spgemm_ring_stages_ref(
            offsets, a_cols, a_vals, b_cols, b_vals, semiring=semiring,
            capacity=capacity, n_cols_out=n_cols_out)
    if semiring.name not in SEMIRINGS:
        raise ValueError(f"spgemm: no kernel instance for semiring "
                         f"{semiring.name!r}; have {sorted(SEMIRINGS)}")
    sr_id = SEMIRINGS[semiring.name]
    _check_vals(sr_id, a_vals, b_vals, semiring)
    dev = check_cuda("spgemm", **tensors)
    for key in ("offsets", "a_cols", "b_cols"):
        check_dtype("spgemm", tensors[key], torch.int32, key)
    stages, n, ka = a_cols.shape
    sb, nb, kb = b_cols.shape
    if sb != stages or tuple(offsets.shape) != (stages,):
        raise ValueError(f"spgemm: need offsets ({stages},), a_cols (S, n, "
                         f"K_A), b_cols (S, nb, K_B); got "
                         f"{tuple(offsets.shape)}, {tuple(a_cols.shape)}, "
                         f"{tuple(b_cols.shape)}")
    if sr_id == 0:
        av, bv = a_vals["pos"], b_vals["pos"]
        check_dtype("spgemm", av, torch.int32, "a_vals['pos']")
        check_dtype("spgemm", bv, torch.int32, "b_vals['pos']")
        a_tail = b_tail = ()
    else:
        av, bv = a_vals[MP], b_vals[MP]
        check_dtype("spgemm", av, torch.float32, "a_vals[MP]")
        check_dtype("spgemm", bv, torch.float32, "b_vals[MP]")
        a_tail = b_tail = (4,)
        for key, t in (("a_vals", av), ("b_vals", bv)):
            if t.data_ptr() % 16:
                raise ValueError(f"spgemm: {key} must be 16-byte aligned")
    if tuple(av.shape) != (stages, n, ka) + a_tail \
            or tuple(bv.shape) != (stages, nb, kb) + b_tail:
        raise ValueError(f"spgemm: value shapes {tuple(av.shape)}, "
                         f"{tuple(bv.shape)} do not match the column panels")
    if capacity < 1:
        raise ValueError(f"spgemm: capacity must be >= 1, got {capacity}")

    i32 = dict(dtype=torch.int32, device=dev)
    out_cols = torch.empty((stages, n, capacity), **i32)
    if sr_id == 0:
        out = {"cnt": torch.empty((stages, n, capacity), **i32),
               "apos": torch.empty((stages, n, capacity, NUM_POS_PAIRS), **i32),
               "bpos": torch.empty((stages, n, capacity, NUM_POS_PAIRS), **i32)}
        leaves = [out["cnt"], out["apos"], out["bpos"]]
    else:
        out = {MP: torch.empty((stages, n, capacity, 4), dtype=torch.float32,
                               device=dev)}
        leaves = [out[MP], out[MP], out[MP]]
    overflow = torch.zeros((1,), **i32)
    if stages and n:
        ptrs = (offsets.data_ptr(), a_cols.data_ptr(), av.data_ptr(),
                b_cols.data_ptr(), bv.data_ptr())
        stream = stream_handle(a_cols)
        # one buffer: the count launch's four maxima (its one host read,
        # which sizes the main launch), then the ids of the rows too full
        # for shared memory
        fit = fit_candidates(sr_id, ka, kb)
        counts = torch.zeros(4 + stages * n, **i32)
        full = counts.data_ptr() + 16
        KERNEL.check(KERNEL.entry("spgemm_count", _COUNT_ARGS)(
            sr_id, *ptrs, counts.data_ptr(), full, fit, stages, n, ka, nb, kb,
            stream), "count launch")
        v_fit, c_max, n_full, v_full = counts[:4].tolist()
        vcap = block_candidates(v_fit) if fit >= 0 else 0
        shmem = shared_bytes(sr_id, vcap, ka, kb) if vcap else 0
        vcap_g = block_candidates(v_full) if n_full else 0
        per_block = global_bytes(sr_id, vcap_g, ka, kb)
        g_blocks = global_blocks(
            n_full, per_block,
            torch.cuda.get_device_properties(dev).multi_processor_count) \
            if n_full else 0
        scratch = torch.empty(g_blocks * per_block, dtype=torch.uint8,
                              device=dev) if n_full else None
        with span("kernel_launch", kind="kernel", kernel="spgemm_ring_stages",
                  stages=stages, rows=n, max_candidates=max(v_fit, v_full),
                  shared_bytes=shmem, global_rows=n_full,
                  global_blocks=g_blocks, global_bytes=g_blocks * per_block):
            KERNEL.launch(
                sr_id, *ptrs, out_cols.data_ptr(),
                *(t.data_ptr() for t in leaves), overflow.data_ptr(),
                full, n_full, scratch.data_ptr() if n_full else None,
                g_blocks, vcap_g,
                stages, n, ka, nb, kb, capacity, vcap,
                max(c_max, 0).bit_length(), stream)
    return out_cols, out, overflow[0]


def blocks_per_sm(semiring: Semiring, max_candidates: int, ka: int,
                  kb: int) -> int:
    """Blocks of the main kernel one SM holds at the shared memory a launch
    with ``max_candidates`` in its fullest row, ``ka`` A slots and B rows of
    ``kb`` uses (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; on the
    card)."""
    blocks = ctypes.c_int(0)
    fn = KERNEL.entry("spgemm_blocks_per_sm", [_I, _I, _I, _I, _P])
    KERNEL.check(fn(SEMIRINGS[semiring.name], block_candidates(max_candidates),
                    ka, kb, ctypes.addressof(blocks)), "occupancy query")
    return blocks.value


register_op("spgemm_ring_stages", "cuda", spgemm_ring_stages)
register_op("spgemm_ring_stages", "reference", spgemm_ring_stages_ref)
