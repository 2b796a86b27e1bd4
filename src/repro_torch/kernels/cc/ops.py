"""Wrapper of the cc rounds kernel (``csrc/cc.cu``), the chunk driver and
the dispatch registration of the ``cc_labels`` op.

Both backends of ``cc_labels`` share one signature, ``(cols, *, max_iters)
-> (labels, iters)``:

* ``"reference"`` — :func:`~.ref.cc_labels_ref`, one round at a time, the
  exact rounds to convergence;
* ``"cuda"`` — :func:`cc_labels_cuda`: the in-neighbour ELL is built once
  (:func:`transpose_ell`), then :func:`cc_rounds` runs ``ROUNDS_PER_CALL``
  (8) rounds per launch while labels still change, with one shorter tail launch
  so the total never exceeds ``max_iters``.  It reports the rounds
  *executed* (a multiple of 8 plus the tail), as JAX's
  ``pallas`` backend does, and its labels equal the reference backend's bit
  for bit.

:func:`cc_rounds` launches the kernel for CUDA tensors and runs
:func:`~.ref.cc_rounds_ref` for CPU tensors; on the card it launches or
raises (no fallback, and no counterpart of the TPU wrapper's VMEM budget:
the cooperative launch works at any size that fits on the card).

One difference from JAX: JAX keeps the chunk loop on the device
(``lax.while_loop``); here the driver reads the changed flag on the host
once per chunk to decide whether to launch the next.
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
    _P, _P, _P, _P, _P, _P,  # oc, ic, labels (in/out), l1, l2, changed
    _I, _I, _I, _I, _P,  # n, k_out, k_in, rounds, stream
])
#: rounds fused into one launch
ROUNDS_PER_CALL = 8


def _in_capacity(cols: torch.Tensor) -> int:
    """Pow-2 in-capacity (≥ the max in-degree, read on the host) of the ELL
    transpose."""
    n = cols.shape[0]
    m = cols >= 0
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


def cc_rounds(oc: torch.Tensor, ic: torch.Tensor, labels: torch.Tensor,
              rounds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rounds`` hook / in-hook / pointer-jump rounds in one launch:
    ``oc`` (n, k_out), ``ic`` (n, k_in) and ``labels`` (n,) int32, labels in
    ``[0, n)`` → ``(labels', changed)`` with ``changed`` a 0-d int32
    tensor."""
    args = dict(oc=oc, ic=ic, labels=labels)
    if all(t.device.type == "cpu" for t in args.values()):
        return cc_rounds_ref(oc, ic, labels, rounds)
    dev = check_cuda("cc", **args)
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
    out = labels.clone()
    l1, l2 = torch.empty_like(out), torch.empty_like(out)
    changed = torch.zeros((), dtype=torch.int32, device=dev)
    if n:
        with span("kernel_launch", kind="kernel", kernel="cc_labels", n=n,
                  k_out=oc.shape[1], k_in=ic.shape[1], rounds=rounds):
            KERNEL.launch(oc.data_ptr(), ic.data_ptr(), out.data_ptr(),
                          l1.data_ptr(), l2.data_ptr(), changed.data_ptr(), n,
                          oc.shape[1], ic.shape[1], rounds,
                          stream_handle(labels))
    return out, changed


def _drive_chunks(oc, ic, labels0, *, rounds: int, n_chunks: int, rem: int,
                  rounds_fn=cc_rounds):
    """While labels change, run ``rounds`` rounds per ``rounds_fn`` call
    (at most ``n_chunks`` calls), then at most one ``rem``-round tail, so
    the total never exceeds the caller's ``max_iters``.  ``rounds_fn`` is
    the kernel wrapper, or its plain version to drive that on any device.
    Returns ``(labels, rounds executed, calls)``."""
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


def cc_labels_cuda(cols: torch.Tensor, *, max_iters: Optional[int] = None
                   ) -> Tuple[torch.Tensor, int]:
    """Kernel backend of the ``cc_labels`` op (module docstring): labels
    equal to :func:`~.ref.cc_labels_ref`'s, and the rounds executed."""
    n = cols.shape[0]
    if max_iters is None:
        max_iters = n
    cols = cols.to(torch.int32).contiguous()
    rounds = max(1, min(ROUNDS_PER_CALL, max_iters))
    lab, iters, _ = _drive_chunks(
        cols, transpose_ell(cols),
        torch.arange(n, dtype=torch.int32, device=cols.device),
        rounds=rounds, n_chunks=max_iters // rounds, rem=max_iters % rounds)
    return lab, iters


def hbm_round_trips(iters: int) -> int:
    """Device-memory round trips the kernel path needs for ``iters``
    executed rounds (the reference backend needs ``iters``)."""
    return -(-int(iters) // ROUNDS_PER_CALL)


register_op("cc_labels", "reference", cc_labels_ref)
register_op("cc_labels", "cuda", cc_labels_cuda)
