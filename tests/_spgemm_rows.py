"""Ring-stage panels whose rows hold chosen numbers of live candidates, for
the tests of the ``spgemm`` kernel's row routing (rows past a block's
shared memory take the global instance)."""

import numpy as np

from repro_torch.core.semiring import MP


def rows_of_sizes(rng, sizes, kb, kind, ka=None):
    """One stage: A row ``r`` holds exactly ``sizes[r]`` live candidates
    (every product non-zero), made of whole B rows of ``kb`` live slots and
    one B row of ``sizes[r] % kb``; numpy ``(offsets, a_cols, a_vals,
    b_cols, b_vals, n_out)``.  K_A is ``ka``, or the fewest slots that
    hold them."""
    n_whole = [v // kb for v in sizes]
    need = max(max(w + (v % kb > 0) for w, v in zip(n_whole, sizes)), 1)
    ka = need if ka is None else ka
    assert ka >= need
    nb = max(n_whole) + kb  # whole rows, then a row of k live slots, k < kb
    n_out = 4 * kb + 7
    b_cols = np.full((nb, kb), -1, np.int32)
    for r in range(nb):
        k = kb if r < max(n_whole) else r - max(n_whole)
        b_cols[r, :k] = np.sort(rng.choice(n_out, k, replace=False))
    a_cols = np.full((len(sizes), ka), -1, np.int32)
    for r, (w, v) in enumerate(zip(n_whole, sizes)):
        sel = list(rng.permutation(max(n_whole))[:w])
        if v % kb:
            sel.append(max(n_whole) + v % kb)
        a_cols[r, :len(sel)] = np.sort(sel)
    if kind == "overlap":
        def vals(cols):
            return {"pos": np.where(cols >= 0, rng.integers(0, 900, cols.shape),
                                    -1).astype(np.int32)}
    else:
        def vals(cols):
            v = rng.integers(1, 90, cols.shape + (4,)).astype(np.float32)
            v[..., 1:][rng.random(v[..., 1:].shape) < 0.5] = np.inf
            v[cols < 0] = np.inf
            return {MP: v}
    return (np.zeros(1, np.int32), a_cols[None], vals(a_cols[None]),
            b_cols[None], vals(b_cols[None]), n_out)
