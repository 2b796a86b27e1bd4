"""Wrapper of the connected-components kernel (``csrc/cc.cu``), the plain
chunk driver and the dispatch registration of the ``cc_labels`` op.

Both backends of ``cc_labels`` share one signature, ``(cols, *, max_iters)
-> (labels, iters)``:

* ``"reference"`` — :func:`~.ref.cc_labels_ref`, one round at a time, the
  exact rounds to convergence;
* ``"cuda"`` — :func:`cc_labels_cuda`: one launch of the kernel runs the
  whole call.  The rule is JAX's ``lax.while_loop`` (and :func:`_drive_chunks`,
  its plain counterpart): ``ROUNDS_PER_CALL`` (8) rounds per chunk while
  labels still change, at most ``max_iters // 8`` chunks, then at most one
  ``max_iters % 8``-round tail, so the total never exceeds ``max_iters``.
  It reports the rounds *executed* (a multiple of 8 plus the tail), as
  JAX's ``pallas`` backend does, and its labels equal the reference
  backend's bit for bit.

On the card the graph goes to the kernel as an edge list (:func:`edge_list`)
built once per call, and the call takes one of two paths by the bytes of
its state (:func:`cc_path`): ``"block"``, one block holding everything in
shared memory, or ``"grid"``, a cooperative launch over device memory.  The
host reads the live-edge count (it sizes the list and picks the path)
before the launch and the rounds and chunks once after it.  On CPU tensors
every entry runs the plain versions (:func:`~.ref.cc_rounds_ref` under
:func:`_drive_chunks`); on CUDA tensors it launches or raises (no fallback).

:func:`cc_rounds` is the kernel capped at one chunk: ``rounds`` rounds on
given out- and in-neighbour ELLs, returning the labels and the changed flag.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...core.backend import register_op
from ...core.spmat import next_pow2
from ...obs.trace import span
from ..build import CudaKernel, check_cuda, check_dtype, stream_handle
from .ref import cc_labels_ref, cc_rounds_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("cc", [
    _P, _I, _P, _P, _P, _P,  # edges, m, labels (in/out), scratch, flags, info
    _I, _I, _I, _I, _I, _P,  # n, rounds, n_chunks, rem, path, stream
])
#: rounds fused into one chunk
ROUNDS_PER_CALL = 8
#: shared memory a block may use on Hopper (hopper-kernels guide §1)
MAX_SHARED_BYTES = 232448
#: flag bits of an edge's dst: the edge takes part in one hook only
OUT_ONLY = -(1 << 31)
IN_ONLY = 1 << 30
_PATHS = {"block": 0, "grid": 1}


def _in_capacity(cols: torch.Tensor) -> int:
    """Pow-2 in-capacity (≥ the max in-degree, read on the host) of the ELL
    transpose; columns outside ``[0, n)`` count nowhere, as JAX's scatter
    drops them."""
    n = cols.shape[0]
    m = (cols >= 0) & (cols < n)
    in_deg = torch.zeros(n + 1, dtype=torch.int32, device=cols.device)
    in_deg.index_add_(0, torch.where(m, cols, n).reshape(-1).to(torch.int64),
                      m.reshape(-1).to(torch.int32))
    return next_pow2(int(torch.max(in_deg[:n])) if n else 0)


def transpose_ell(cols: torch.Tensor) -> torch.Tensor:
    """In-neighbour ELL of an out-neighbour ELL ``cols`` (n, K): row v lists
    the sources u of the edges ``u→v``, ascending, ``-1`` padded, in
    ``next_pow2(max in-degree)`` slots.  Returns ``(n, k_in)`` int32."""
    n, k = cols.shape
    k_in = _in_capacity(cols)
    dev = cols.device
    m = cols >= 0
    src = torch.arange(n, dtype=torch.int32, device=dev)[:, None].expand(n, k)
    dst = torch.where(m, cols, n).reshape(-1).to(torch.int64)
    # stable: each destination keeps its sources in (src, slot) order
    ds, order = torch.sort(dst, stable=True)
    ss = src.reshape(-1)[order]
    rank = (torch.arange(n * k, device=dev)
            - torch.searchsorted(ds, ds, side="left"))
    live = ds < n  # rank < k_in there by construction of k_in
    out = torch.full((n, k_in), -1, dtype=torch.int32, device=dev)
    out[ds[live], rank[live]] = ss[live]
    return out


def _live_slots(cols: torch.Tensor):
    """Rows and columns of an ELL's live slots, in row-major order."""
    row, slot = torch.nonzero(cols >= 0, as_tuple=True)
    return row.to(torch.int32), cols[row, slot]


def edge_list(oc: torch.Tensor, ic: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """The kernel's ``(m, 2)`` int32 edge list, ``(src, dst | flags)``.

    Without ``ic``: one edge ``(v, c)`` per live slot of ``oc``, for both
    hooks; a column ``c >= n`` becomes ``(v, n - 1)`` flagged ``OUT_ONLY``
    (the out-hook clamps it, the ELL transpose drops it).  With ``ic`` (the
    ``cc_rounds`` entry): every ``oc`` edge ``OUT_ONLY``, and one ``IN_ONLY``
    edge ``(min(u, n - 1), v)`` per live slot ``u`` of ``ic``'s row v."""
    n = oc.shape[0]
    v, c = _live_slots(oc)
    if ic is None:
        return torch.stack([v, torch.where(c < n, c, (n - 1) | OUT_ONLY)], 1)
    w, u = _live_slots(ic)
    return torch.cat([
        torch.stack([v, torch.clamp(c, max=n - 1) | OUT_ONLY], 1),
        torch.stack([torch.clamp(u, max=n - 1), w | IN_ONLY], 1)])


def block_bytes(n: int, m: int) -> int:
    """Shared memory of the block path: four label vectors and the edges."""
    return 16 * n + 8 * m


def cc_path(n: int, m: int) -> str:
    """The kernel's path for ``n`` vertices and ``m`` edges: ``"block"`` if
    the whole state fits in one block's shared memory, else ``"grid"``."""
    return "block" if block_bytes(n, m) <= MAX_SHARED_BYTES else "grid"


def _launch(edges: torch.Tensor, labels: torch.Tensor, *, rounds: int,
            n_chunks: int, rem: int):
    """One launch: returns ``(labels', info)`` with ``info`` the host list
    ``[rounds executed, chunks, last chunk's changed flag]``."""
    n, m = labels.shape[0], edges.shape[0]
    if n >= IN_ONLY or m >= 1 << 31:
        raise ValueError(f"cc: {n} vertices and {m} edges exceed the "
                         f"kernel's int32 indices")
    path = cc_path(n, m)
    i32 = dict(dtype=torch.int32, device=labels.device)
    out = labels.clone()
    scratch = torch.empty(3 * n if path == "grid" else 0, **i32)
    flags, info = torch.zeros(5, **i32).split([2, 3])
    with span("kernel_launch", kind="kernel", kernel="cc_labels", n=n,
              edges=m, path=path) as sp:
        KERNEL.launch(edges.data_ptr(), m, out.data_ptr(), scratch.data_ptr(),
                      flags.data_ptr(), info.data_ptr(), n, rounds, n_chunks,
                      rem, _PATHS[path], stream_handle(labels))
    got = info.tolist()  # the one read of the result
    sp.annotate(rounds=got[0], chunks=got[1])
    return out, got


def cc_rounds(oc: torch.Tensor, ic: torch.Tensor, labels: torch.Tensor,
              rounds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rounds`` hook / in-hook / pointer-jump rounds in one launch (the
    kernel capped at one chunk): ``oc`` (n, k_out), ``ic`` (n, k_in) and
    ``labels`` (n,) int32, labels in ``[0, n)`` → ``(labels', changed)``
    with ``changed`` a 0-d int32 tensor."""
    args = dict(oc=oc, ic=ic, labels=labels)
    if all(t.device.type == "cpu" for t in args.values()):
        return cc_rounds_ref(oc, ic, labels, rounds)
    check_cuda("cc", **args)
    for key, t in args.items():
        check_dtype("cc", t, torch.int32, key)
    n = labels.shape[0]
    if labels.dim() != 1 or oc.dim() != 2 or ic.dim() != 2 \
            or oc.shape[0] != n or ic.shape[0] != n:
        raise ValueError(f"cc: need oc (n, k_out), ic (n, k_in), labels (n,); "
                         f"got {tuple(oc.shape)}, {tuple(ic.shape)}, "
                         f"{tuple(labels.shape)}")
    if rounds < 1:
        raise ValueError(f"cc: rounds must be >= 1, got {rounds}")
    if not n:
        return labels.clone(), torch.zeros((), dtype=torch.int32,
                                           device=labels.device)
    out, info = _launch(edge_list(oc, ic), labels, rounds=rounds, n_chunks=1,
                        rem=0)
    return out, torch.tensor(info[2], dtype=torch.int32, device=labels.device)


def _drive_chunks(oc, ic, labels0, *, rounds: int, n_chunks: int, rem: int,
                  rounds_fn=cc_rounds_ref):
    """The chunk rule on the host, one ``rounds_fn`` call a chunk: while
    labels change, ``rounds`` rounds per call (at most ``n_chunks`` calls),
    then at most one ``rem``-round tail, so the total never exceeds the
    caller's ``max_iters``.  Over the plain rounds it is the plain version
    of :func:`cc_labels_cuda`'s launch.  Returns ``(labels, rounds
    executed, calls)``."""
    lab, changed, iters, chunks = labels0, True, 0, 0
    while changed and chunks < n_chunks:
        lab, chg = rounds_fn(oc, ic, lab, rounds)
        changed = bool(chg)  # the one host read of the chunk
        iters += rounds
        chunks += 1
    if rem and changed:
        lab, _ = rounds_fn(oc, ic, lab, rem)
        iters += rem
        chunks += 1
    return lab, iters, chunks


def chunk_rule(max_iters: int) -> Tuple[int, int, int]:
    """``(rounds a chunk, chunks at most, tail rounds)`` for ``max_iters``."""
    rounds = max(1, min(ROUNDS_PER_CALL, max_iters))
    return rounds, max_iters // rounds, max_iters % rounds


def cc_components(cols: torch.Tensor, *, max_iters: Optional[int] = None
                  ) -> Tuple[torch.Tensor, int, int]:
    """The ``cuda`` backend's whole call: ``(labels, rounds executed,
    chunks)``; one launch on CUDA tensors, the plain chunk driver on CPU
    tensors."""
    n = cols.shape[0]
    if max_iters is None:
        max_iters = n
    cols = cols.to(torch.int32).contiguous()
    rounds, n_chunks, rem = chunk_rule(max_iters)
    lab0 = torch.arange(n, dtype=torch.int32, device=cols.device)
    if cols.device.type == "cpu":
        return _drive_chunks(cols, transpose_ell(cols), lab0, rounds=rounds,
                             n_chunks=n_chunks, rem=rem)
    check_cuda("cc", cols=cols)
    if cols.dim() != 2:
        raise ValueError(f"cc: need cols (n, k), got {tuple(cols.shape)}")
    if not n:
        return lab0, 0, 0
    lab, info = _launch(edge_list(cols), lab0, rounds=rounds,
                        n_chunks=n_chunks, rem=rem)
    return lab, info[0], info[1]


def cc_labels_cuda(cols: torch.Tensor, *, max_iters: Optional[int] = None
                   ) -> Tuple[torch.Tensor, int]:
    """Kernel backend of the ``cc_labels`` op (module docstring): labels
    equal to :func:`~.ref.cc_labels_ref`'s, and the rounds executed."""
    lab, iters, _ = cc_components(cols, max_iters=max_iters)
    return lab, iters


def hbm_round_trips(iters: int) -> int:
    """The 8-round chunks in ``iters`` executed rounds: the device-memory
    round trips of JAX's ``pallas`` path, whose labels leave VMEM once a
    chunk (the reference backend needs ``iters``).  Here a chunk ends in a
    barrier inside the one launch."""
    return -(-int(iters) // ROUNDS_PER_CALL)


register_op("cc_labels", "reference", cc_labels_ref)
register_op("cc_labels", "cuda", cc_labels_cuda)
