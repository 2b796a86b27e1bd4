"""Plain PyTorch versions of the connected-components rounds.

Two levels, as in the JAX package (``repro.kernels.cc``):

* :func:`cc_labels_ref` — the ``reference`` backend of the op
  ``cc_labels``, a mirror of ``repro.kernels.cc.ref.cc_labels_ref``: one
  round is a hook (gather-min over out-neighbours, then a scatter-min along
  the edges, i.e. a min over in-neighbours) and a pointer jump
  (``l ← l[l]``), iterated until the labels stop changing or ``max_iters``
  rounds ran.  It reports the exact rounds to convergence.
* :func:`cc_rounds_ref` — the plain version of the kernel itself (the JAX
  ``_cc_rounds_kernel``): ``rounds`` rounds over the out-neighbour ELL and
  its transpose, returning the labels and a flag set if any round changed
  any label.  On CPU tensors the ``cuda`` backend's chunk driver runs over
  it, so it reports the rounds *executed*, as JAX's ``pallas`` backend
  does.

Empty slots (``-1``) count as ``2^30``; columns are clipped to ``[0, n)``
as the JAX versions clip them.  Labels are int32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_BIG = 2**30


def _gather_min(lab: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Per row, the min of ``lab`` over the row's live slots of ``cols``
    (``_BIG`` for a row without any)."""
    n = lab.shape[0]
    safe = torch.clamp(cols, 0, max(n - 1, 0)).to(torch.int64)
    g = torch.where(cols >= 0, lab[safe], _BIG)
    return torch.amin(g, dim=1) if cols.shape[1] else torch.full_like(lab, _BIG)


def cc_rounds_ref(oc: torch.Tensor, ic: torch.Tensor, labels: torch.Tensor,
                  rounds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rounds`` fused hook / in-hook / pointer-jump rounds.

    ``oc`` (n, k_out) and ``ic`` (n, k_in) are the out- and in-neighbour
    ELL blocks (int32, ``-1`` = empty), ``labels`` (n,) int32.  Returns
    ``(labels', changed)``: ``changed`` is a 0-d int32 tensor, 1 iff some
    round's pointer jump gave a label other than the one the round started
    from."""
    lab = labels.to(torch.int32)
    chg = torch.zeros((), dtype=torch.int32, device=lab.device)
    for _ in range(rounds):
        l1 = torch.minimum(lab, _gather_min(lab, oc))
        l2 = torch.minimum(l1, _gather_min(l1, ic))
        l3 = l2[l2.to(torch.int64)]
        chg = chg | torch.any(l3 != lab).to(torch.int32)
        lab = l3
    return lab, chg


def cc_labels_ref(cols: torch.Tensor, *, max_iters: Optional[int] = None
                  ) -> Tuple[torch.Tensor, int]:
    """Min-label connected components of the ELL adjacency ``cols`` (n, K)
    int32, treated as undirected, one round at a time.

    ``max_iters`` caps the rounds (default ``n``).  Returns ``(labels (n,)
    int32 — the minimum vertex id of each component, n_iterations)``, the
    exact rounds run before the labels stopped changing.  The loop reads the changed flag on the host once a round."""
    n = cols.shape[0]
    if max_iters is None:
        max_iters = n
    dev = cols.device
    m = cols >= 0
    # masked slots go to index 0 with the ⊕-identity, so both the gather and
    # the scatter-min are no-ops there
    safe = torch.clamp(torch.where(m, cols, 0), 0, max(n - 1, 0)).to(torch.int64)
    sf = safe.reshape(-1)
    lab = torch.arange(n, dtype=torch.int32, device=dev)
    it, changed = 0, True
    while changed and it < max_iters:
        pulled = torch.where(m, lab[safe], _BIG)
        pulled = (torch.amin(pulled, dim=1) if cols.shape[1]
                  else torch.full_like(lab, _BIG))
        l1 = torch.minimum(lab, pulled)
        push = torch.where(m, l1[:, None].expand(m.shape), _BIG).reshape(-1)
        l2 = l1.scatter_reduce(0, sf, push.to(torch.int32), "amin",
                               include_self=True)
        l3 = l2[l2.to(torch.int64)]
        changed = bool(torch.any(l3 != lab))
        lab = l3
        it += 1
    return lab, it
