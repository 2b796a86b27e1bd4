"""The port's ``spgemm_ring_stages`` op (``kernels/spgemm``) against the JAX
package's: its plain version equals JAX's oracle ``spgemm_ring_stages_ref``
and JAX's Pallas kernel in interpret mode, bit for bit — stage buffers and
overflow — for S ∈ {1, 3} stages with non-zero offsets, both semirings of
the explicit-exchange path, and rows that overflow ``capacity``.  The CUDA
kernel itself is held to the plain version in ``tests/test_torch_cuda.py``
(on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.assembly.counter import first_semiring as j_first
from repro.core.semiring import minplus_orient_semiring as J_MPSR
from repro.core.semiring import overlap_semiring as j_overlap
from repro.core.spmat import from_coo as j_from_coo
from repro.kernels.spgemm.ref import spgemm_ring_stages_ref as j_ref
from repro.kernels.spgemm.spgemm import spgemm_ring_stages_pallas as j_pallas
from repro_torch import kernels as K
from repro_torch.convert import ell_from_numpy
from repro_torch.core import backend as tb
from repro_torch.core import summa as SU
from repro_torch.core.semiring import MP, minplus_orient_semiring, overlap_semiring
from repro_torch.kernels.spgemm import ops as tops

N, NB, KA, KB, N_OUT = 10, 7, 6, 5, 24


def _panel(rng, kind, rows, k, hi, e):
    r = jnp.asarray(rng.integers(0, rows, e))
    c = jnp.asarray(rng.integers(0, hi, e))
    if kind == "mpsr":
        v = np.full((e, 4), np.inf, np.float32)
        v[np.arange(e), rng.integers(0, 4, e)] = rng.integers(1, 90, e)
        vals, sr = jnp.asarray(v), J_MPSR
    else:
        vals, sr = {"pos": jnp.asarray(rng.integers(0, 50, e), jnp.int32)}, j_first
    m, _ = j_from_coo(r, c, vals, jnp.ones(e, bool), n_rows=rows, n_cols=hi,
                      capacity=k, semiring=sr)
    return m


def _stack(mats):
    cols = np.stack([np.asarray(m.cols) for m in mats])
    if isinstance(mats[0].vals, dict):
        vals = {k: np.stack([np.asarray(m.vals[k]) for m in mats])
                for k in mats[0].vals}
    else:
        vals = np.stack([np.asarray(m.vals) for m in mats])
    return cols, vals


def _case(stages, kind):
    """Stacked panels: A ids over ``stages + 1`` B row blocks (so every
    stage, S = 1 included, drops the slots of other blocks), B panels
    dense enough that some rows overflow capacity 6."""
    rng = np.random.default_rng(10 * stages + (kind == "mpsr"))
    m_tot = (stages + 1) * NB
    a_cols, a_vals = _stack([_panel(rng, kind, N, KA, m_tot, 5 * N)
                             for _ in range(stages)])
    b_cols, b_vals = _stack([_panel(rng, kind, NB, KB, N_OUT, 5 * NB)
                             for _ in range(stages)])
    offsets = ((np.arange(stages) + 1) * NB).astype(np.int32)
    return offsets, a_cols, a_vals, b_cols, b_vals


def _port(offsets, a_cols, a_vals, b_cols, b_vals, kind, cap):
    def vals(v):
        return ({MP: torch.from_numpy(v)} if kind == "mpsr"
                else {k: torch.from_numpy(x) for k, x in v.items()})
    sr = minplus_orient_semiring if kind == "mpsr" else overlap_semiring
    return K.spgemm_ring_stages(
        torch.from_numpy(offsets), torch.from_numpy(a_cols), vals(a_vals),
        torch.from_numpy(b_cols), vals(b_vals), semiring=sr, capacity=cap,
        n_cols_out=N_OUT)


def _jax(fn, offsets, a_cols, a_vals, b_cols, b_vals, kind, cap, **kw):
    sr = J_MPSR if kind == "mpsr" else j_overlap
    tree = (lambda v: jnp.asarray(v)) if kind == "mpsr" else (
        lambda v: {k: jnp.asarray(x) for k, x in v.items()})
    return fn(jnp.asarray(offsets), jnp.asarray(a_cols), tree(a_vals),
              jnp.asarray(b_cols), tree(b_vals), semiring=sr, capacity=cap,
              n_cols_out=N_OUT, **kw)


def _assert_equal(got, want, kind):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    wv = {MP: want[1]} if kind == "mpsr" else want[1]
    assert sorted(got[1]) == sorted(wv)
    for k in wv:
        np.testing.assert_array_equal(got[1][k].numpy(), np.asarray(wv[k]))
    assert got[2].dtype == torch.int32
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("kind", ["overlap", "mpsr"])
@pytest.mark.parametrize("stages", [1, 3])
def test_plain_version_matches_jax(stages, kind, oracle):
    case = _case(stages, kind)
    cap = 6
    got = _port(*case, kind, cap)
    if oracle == "ref":
        want = _jax(j_ref, *case, kind, cap)
    else:
        want = _jax(j_pallas, *case, kind, cap, interpret=True)
    _assert_equal(got, want, kind)
    assert int(want[2]) > 0  # some row overflowed capacity
    assert (np.asarray(want[0]) >= 0).any()


def test_dispatch_and_round_trips():
    # the registered implementation, wrapped once in its op span
    for b, fn in (("cuda", tops.spgemm_ring_stages),
                  ("reference", K.spgemm_ring_stages_ref)):
        op = tb.dispatch("spgemm_ring_stages", b)
        assert op is tb.dispatch("spgemm_ring_stages", b)
        assert op.__wrapped__ is fn
    # the ring's stats name what ran: on CPU tensors the cuda backend runs
    # the plain version, one round trip per stage
    m = _panel(np.random.default_rng(3), "mpsr", N, KA, N, 5 * N)
    r = ell_from_numpy(m.cols, m.vals, N)
    d, _ = SU.distribute_ell_blocks(r, block_capacity=KA,
                                    semiring=minplus_orient_semiring)
    for backend in ("cuda", "reference"):
        _, _, st = SU.summa_ring(d, d, semiring=minplus_orient_semiring,
                                 out_block_capacity=8, backend=backend)
        assert st["summa_backend"] == "reference"
        assert st["spgemm_hbm_round_trips"] == st["summa_stages"] == 1
    # the kernel's shared buffer follows the live candidates, not the
    # K_A x K_B grid: the 4000-read overlap launch's fullest row (1891 of
    # 160 x 56 slots) needs under a third of a block's shared memory
    assert tops.block_candidates(1891) == 1892
    assert tops.block_candidates(0) == 4
    assert tops.shared_bytes(0, 1892, 160, 56) < tops.MAX_SHARED_BYTES // 3
    assert tops.shared_bytes(1, 1892, 160, 56) < tops.MAX_SHARED_BYTES // 2
    assert tops.shared_bytes(0, 160 * 56, 160, 56) > tops.MAX_SHARED_BYTES // 2
    assert tops.shared_bytes(1, 20000, 160, 56) > tops.MAX_SHARED_BYTES
    assert set(tops.SEMIRINGS) == {overlap_semiring.name,
                                   minplus_orient_semiring.name}


# --- the card kernel's algorithm, emulated on the host -------------------------
#
# ``csrc/spgemm.cu`` cannot run here, so its algorithm is emulated step for
# step and held against the plain version and JAX's oracle: live-slot
# enumeration by 32-lane ballots of units (an A slot and a 32-lane chunk of
# the B row it selects), placed by a scan of the units' counts (a-slot-major,
# b-slot-minor), the stable LSD radix sort of the candidate indices on the
# column (4-bit digits, each of 256 threads counting a contiguous chunk, one
# scan over the (digit, thread) counts), and the fold in tiles of 256: run
# heads and lengths (overlap), a segmented min-scan over warps of 32 with
# the warps' aggregates and the tile's carry (min-plus), the rank of the
# kept runs and the compaction to capacity.

LANES, TILE, BITS = 32, tops.THREADS, 4


def _mp_mul(x, y):
    return np.array([min(x[0] + y[0], x[1] + y[2]), min(x[0] + y[1], x[1] + y[3]),
                     min(x[2] + y[0], x[3] + y[2]), min(x[2] + y[1], x[3] + y[3])],
                    np.float32)


def _enumerate(a_row, a_val, off, b_cols, b_vals, kind):
    """The row's candidates in the kernel's order: (columns, operands).
    The row's live A slots (in the stage's block) are listed in order;
    each unit (a live A slot and one 32-lane chunk of the B row it selects)
    ballots its live lanes; an exclusive scan of the units' counts gives
    each unit its place, and a live lane writes at its unit's place plus
    the live lanes below it."""
    nb, kb = b_cols.shape
    nch = -(-kb // LANES)
    live = [a for a, c in enumerate(a_row) if c >= 0 and 0 <= c - off < nb]
    units = []
    for u in range(len(live) * nch):
        i, k = divmod(u, nch)
        a = live[i]
        r = a_row[a] - off
        lanes = []
        for b in range(k * LANES, min(k * LANES + LANES, kb)):
            bc = b_cols[r, b]
            if bc < 0:
                continue
            if kind == "mpsr":
                prod = _mp_mul(a_val[a], b_vals[r, b])
                if not np.isfinite(prod).any():
                    continue
                lanes.append((int(bc), prod))
            else:
                lanes.append((int(bc), (a_val[a], b_vals[r, b])))
        units.append(lanes)
    counts = np.array([len(x) for x in units], np.int64)
    places = np.cumsum(counts) - counts
    cols, pay = [None] * int(counts.sum()), [None] * int(counts.sum())
    for u, lanes in enumerate(units):
        for i, (c, p) in enumerate(lanes):
            cols[places[u] + i], pay[places[u] + i] = c, p
    return cols, pay


def _radix_sort(cols, col_bits):
    """Stable LSD radix sort of the indices 0..V-1 on ``cols``."""
    v = len(cols)
    perm = list(range(v))
    ipt = -(-v // TILE)
    for shift in range(0, col_bits, BITS):
        digit = [(cols[q] >> shift) & 15 for q in perm]
        cnt = np.zeros((16, TILE), np.int64)
        for t in range(TILE):
            for i in range(min(t * ipt, v), min(t * ipt + ipt, v)):
                cnt[digit[i], t] += 1
        flat = cnt.reshape(-1)
        offs = (np.cumsum(flat) - flat).reshape(16, TILE)
        out = [None] * v
        for t in range(TILE):
            for i in range(min(t * ipt, v), min(t * ipt + ipt, v)):
                out[offs[digit[i], t]] = perm[i]
                offs[digit[i], t] += 1
        perm = out
    return perm


def _seg_min_tile(x, f, carry):
    """A tile's segmented inclusive min-scan: within each warp by doubling
    steps, then the earlier warps' aggregates and the carry."""
    x, f = x.copy(), f.copy()
    lane = np.arange(TILE) % LANES
    for o in (1, 2, 4, 8, 16):
        ok = lane >= o
        y = np.roll(x, o, axis=0)
        g = np.roll(f, o)
        x = np.where((ok & ~f)[:, None], np.fmin(y, x), x)
        f = f | (ok & g)
    pre = carry
    for w in range(TILE // LANES):
        sl = slice(w * LANES, (w + 1) * LANES)
        x[sl] = np.where((~f[sl])[:, None], np.fmin(pre, x[sl]), x[sl])
        last = w * LANES + LANES - 1
        pre = x[last]
    return x


def _fold(cols, pay, perm, kind, cap):
    """Runs of equal column in sorted order, their totals, the kept ones
    ranked and compacted: (out cols, out values, kept runs)."""
    v = len(perm)
    out_cols = np.full(cap, -1, np.int32)
    if kind == "mpsr":
        out_v = np.full((cap, 4), np.inf, np.float32)
    else:
        out_v = (np.zeros(cap, np.int32), np.full((cap, 2), -1, np.int32),
                 np.full((cap, 2), -1, np.int32))
    kept_total, start = 0, {}
    carry = np.full(4, np.inf, np.float32)
    for base in range(0, v, TILE):
        p = np.arange(base, base + TILE)
        inn = p < v
        col = np.array([cols[perm[i]] if i < v else -1 for i in p])
        prev = np.array([cols[perm[i - 1]] if 0 < i <= v else -2 for i in p])
        nxt = np.array([cols[perm[i + 1]] if i + 1 < v else -2 for i in p])
        head = inn & ((p == 0) | (prev != col))
        tail = inn & ((p == v - 1) | (nxt != col))
        if kind == "mpsr":
            x = np.array([pay[perm[i]] if i < v else np.full(4, np.inf)
                          for i in p], np.float32)
            x = _seg_min_tile(x, head | ~inn, carry)
            kept = tail & np.isfinite(x).any(1)
            rank = kept_total + np.cumsum(kept) - kept
            for i in np.nonzero(kept & (rank < cap))[0]:
                out_cols[rank[i]], out_v[rank[i]] = col[i], x[i]
            carry = x[-1]
        else:
            # every run is kept: its number, counted at its head, is its rank
            kept = head
            rid = kept_total + np.cumsum(head) - 1
            for i in np.nonzero(head)[0]:
                start[rid[i]] = p[i]
            for i in np.nonzero(tail & (rid < cap))[0]:
                hp = start[rid[i]]
                cnt = p[i] - hp + 1
                f0 = pay[perm[hp]]
                f1 = pay[perm[hp + 1]] if cnt > 1 else (-1, -1)
                o = rid[i]
                out_cols[o] = col[i]
                out_v[0][o] = cnt
                out_v[1][o] = (f0[0], f1[0])
                out_v[2][o] = (f0[1], f1[1])
        kept_total += int(kept.sum())
    return out_cols, out_v, kept_total


def _emulate(offsets, a_cols, a_vals, b_cols, b_vals, kind, cap):
    """The kernel's launch on numpy panels: (cols, vals, overflow, most
    candidates in a row)."""
    stages, n, _ = a_cols.shape
    av = a_vals if kind == "mpsr" else a_vals["pos"]
    bv = b_vals if kind == "mpsr" else b_vals["pos"]
    rows = [[_enumerate(a_cols[s, i], av[s, i], offsets[s], b_cols[s], bv[s],
                        kind) for i in range(n)] for s in range(stages)]
    c_max = max([max(c) for row in rows for c, _ in row if c] + [0])
    cols = np.full((stages, n, cap), -1, np.int32)
    if kind == "mpsr":
        vals = {MP: np.full((stages, n, cap, 4), np.inf, np.float32)}
    else:
        vals = {"cnt": np.zeros((stages, n, cap), np.int32),
                "apos": np.full((stages, n, cap, 2), -1, np.int32),
                "bpos": np.full((stages, n, cap, 2), -1, np.int32)}
    overflow = v_max = 0
    for s in range(stages):
        for i in range(n):
            c, pay = rows[s][i]
            v_max = max(v_max, len(c))
            oc, ov, kept = _fold(c, pay, _radix_sort(c, c_max.bit_length()),
                                 kind, cap)
            cols[s, i] = oc
            if kind == "mpsr":
                vals[MP][s, i] = ov
            else:
                vals["cnt"][s, i], vals["apos"][s, i], vals["bpos"][s, i] = ov
            overflow += max(kept - cap, 0)
    return cols, vals, overflow, v_max


def _dense_case(stages, kind, seed=4):
    """Rows of up to 24 x 48 candidates on 5 output columns: long runs that
    span warps and tiles, ties broken by candidate order, rows past
    capacity, empty rows, slots outside the stage's block and (min-plus)
    candidates whose product is zero."""
    rng = np.random.default_rng(seed)
    n, nb, ka, kb, n_out = 7, 9, 24, 48, 5
    a_cols = rng.integers(0, (stages + 1) * nb, (stages, n, ka)).astype(np.int32)
    a_cols[rng.random(a_cols.shape) < 0.2] = -1
    a_cols[:, 2] = -1  # an empty row
    b_cols = rng.integers(0, n_out, (stages, nb, kb)).astype(np.int32)
    b_cols[rng.random(b_cols.shape) < 0.3] = -1
    offsets = ((np.arange(stages) + 1) * nb).astype(np.int32)
    if kind == "mpsr":
        def mp(shape):
            v = rng.integers(1, 90, shape + (4,)).astype(np.float32)
            v[rng.random(v.shape) < 0.4] = np.inf
            return v
        a_vals, b_vals = mp(a_cols.shape), mp(b_cols.shape)
    else:
        a_vals = {"pos": rng.integers(0, 900, a_cols.shape).astype(np.int32)}
        b_vals = {"pos": rng.integers(0, 900, b_cols.shape).astype(np.int32)}
    return (offsets, a_cols, a_vals, b_cols, b_vals), n_out


@pytest.mark.parametrize("kind", ["overlap", "mpsr"])
@pytest.mark.parametrize("case", ["panels_s1", "panels_s3", "dense_s1",
                                  "dense_s2"])
def test_kernel_emulation_matches_plain_and_jax(case, kind):
    """Cols, every value leaf and the overflow of the emulated launch equal
    the port's plain version and JAX's oracle; the fullest row's count is
    the one the wrapper sizes from (before the min-plus zero products)."""
    global N_OUT
    if case.startswith("dense"):
        panels, n_out = _dense_case(int(case[-1]), kind)
        cap = 3
    else:
        panels, n_out = _case(int(case[-1]), kind), N_OUT
        cap = 6
    cols, vals, overflow, v_max = _emulate(*panels, kind, cap)
    saved, N_OUT = N_OUT, n_out
    try:
        want = _port(*panels, kind, cap)
        jwant = _jax(j_ref, *panels, kind, cap)
    finally:
        N_OUT = saved
    np.testing.assert_array_equal(cols, want[0].numpy())
    for k, v in vals.items():
        np.testing.assert_array_equal(v, want[1][k].numpy())
    assert overflow == int(want[2]) == int(jwant[2]) > 0
    _assert_equal(want, jwant, kind)
    live = tops.live_candidates(*(torch.from_numpy(x) for x in (
        panels[0], panels[1], panels[3])))
    if kind == "overlap":
        assert v_max == int(live.max())
    else:
        assert v_max < int(live.max())  # some products are zero
    if case.startswith("dense"):
        assert v_max > TILE  # runs cross tiles
        assert (cols[:, 2] == -1).all()  # the empty row


def test_radix_sort_emulation_is_stable():
    """Ties keep the candidate order; passes follow the column's bits."""
    rng = np.random.default_rng(0)
    for v, hi in ((1, 1), (300, 7), (1000, 4000), (2000, 1 << 20)):
        cols = [int(x) for x in rng.integers(0, hi, v)]
        perm = _radix_sort(cols, max(cols).bit_length())
        assert perm == sorted(range(v), key=lambda q: (cols[q], q))


def test_row_routing_is_a_function_of_the_counts():
    """Which rows take the global instance follows from the count launch's
    per-row totals alone: those past ``fit_candidates``, the largest
    multiple of 4 whose block fits in shared memory (-1 where not even 4
    do); the shared-memory instance, sized by the rows that fit, holds at
    most ``fit`` and so returns from exactly the routed rows."""
    from _spgemm_rows import rows_of_sizes

    for sr in (0, 1):
        for ka, kb in ((160, 56), (512, 64), (256, 256), (1, 1)):
            fit = tops.fit_candidates(sr, ka, kb)
            assert fit % 4 == 0 and tops.block_candidates(fit) == fit
            assert tops.shared_bytes(sr, fit, ka, kb) <= tops.MAX_SHARED_BYTES
            assert tops.shared_bytes(sr, fit + 4, ka, kb) > tops.MAX_SHARED_BYTES
        assert tops.fit_candidates(sr, 28000, 32) == -1
    assert tops.fit_candidates(0, 160, 56) > 1891  # the 4000-read launch fits
    rng = np.random.default_rng(4)
    kb = 64
    for sr, kind in ((0, "overlap"), (1, "mpsr")):
        ka = 512
        fit = tops.fit_candidates(sr, ka, kb)
        sizes = [fit, fit + 1, 0, fit - 3, 3 * fit, fit + 4, 17]
        offsets, a_cols, _, b_cols, _, _ = rows_of_sizes(rng, sizes, kb, kind,
                                                         ka=ka)
        live = tops.live_candidates(*(torch.from_numpy(x) for x in (
            offsets, a_cols, b_cols)))
        assert live[0].tolist() == sizes
        routed = tops.global_rows(live, fit)
        assert routed[0].tolist() == [False, True, False, False, True, True,
                                      False]
        vcap = tops.block_candidates(int(live[~routed].max()))
        assert vcap <= fit and bool((live[routed] > vcap).all())
    assert tops.global_rows(torch.tensor([0, 5]), -1).all()
    # the global instance's grid: a block a routed row, at most 2 an SM and
    # what the scratch budget holds, at least one
    assert tops.global_blocks(1, 10 ** 6, 132) == 1
    assert tops.global_blocks(5000, 1_400_000, 132) == 264
    assert tops.global_blocks(40, 1 << 28, 132) == 4
    assert tops.global_blocks(3, 1 << 31, 132) == 1
    assert tops.global_bytes(0, 4, 1, 1) + 4 * (16 * 256 + 128) + 256 == \
        tops.shared_bytes(0, 4, 1, 1)

