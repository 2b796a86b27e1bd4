"""The port's ``connected_components`` and ``kernels/cc`` against the JAX
package on the CPU.

Replays ``tests/test_components.py``'s cc cases (the golden permuted-chain
and cycle-heavy adjacencies, three random graphs, the ``transpose_ell``
case) through both packages, with inputs made by numpy from a seed:

* port ``reference`` vs JAX ``reference``: labels and the exact rounds to
  convergence;
* port ``cuda`` on CPU tensors (the chunk driver over the plain rounds
  ``cc_rounds_ref``) vs JAX ``pallas`` (the Pallas kernel in interpret
  mode): labels and the rounds executed;
* the kernel level: ``cc_rounds_ref`` vs JAX's ``cc_rounds_pallas``
  (interpret) at 1, 3 and 8 rounds, labels and changed flag.

Every comparison is exact (integer labels and counts).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.assembly.contig_gen import string_matrix_from_edges as j_smat
from repro.core import components as jcomp
from repro.core.spmat import EllMatrix as JEll
from repro.kernels.cc import hbm_round_trips as j_trips
from repro.kernels.cc import transpose_ell as j_transpose
from repro.kernels.cc.cc import cc_rounds_pallas
from repro_torch import kernels as K
from repro_torch.assembly.contig_gen import string_matrix_from_edges
from repro_torch.core import backend as tb
from repro_torch.core import components as tcomp
from repro_torch.core.spmat import EllMatrix
from repro_torch.kernels import cc as tcc


def _adj_cols(n, pairs, capacity):
    """Directed ELL columns (n, capacity) from (u, v) pairs."""
    cols = np.full((n, capacity), -1, np.int32)
    fill = np.zeros(n, int)
    for u, v in sorted(pairs):
        cols[u, fill[u]] = v
        fill[u] += 1
    return cols


def _permuted_chain(n, seed, capacity=2):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return _adj_cols(n, [(int(perm[i]), int(perm[i + 1])) for i in range(n - 1)],
                     capacity)


def _cycle_heavy(n, cycle, seed, capacity=4):
    rng = np.random.default_rng(seed)
    pairs = []
    for c0 in range(0, n, cycle):
        cyc = [c0 + t for t in range(cycle)]
        rng.shuffle(cyc)
        pairs += [(cyc[t], cyc[(t + 1) % cycle]) for t in range(cycle)]
    return _adj_cols(n, pairs, capacity)


def _random_graphs():
    """The three graphs of ``test_cc_kernel_parity_on_random_graphs``."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(3):
        n = int(rng.integers(40, 200))
        e = int(rng.integers(n // 2, 2 * n))
        pairs = {(int(rng.integers(n)), int(rng.integers(n))) for _ in range(e)}
        cap = max(sum(1 for u, _ in pairs if u == r) for r in range(n))
        out.append(_adj_cols(n, sorted(pairs), max(cap, 1)))
    return out


CASES = {
    "permuted_chain_257": lambda: _permuted_chain(257, seed=2),
    "cycle_heavy_320_10": lambda: _cycle_heavy(320, cycle=10, seed=3),
    "cycle_heavy_96_3": lambda: _cycle_heavy(96, cycle=3, seed=4),
    "random_0": lambda: _random_graphs()[0],
    "random_1": lambda: _random_graphs()[1],
    "random_2": lambda: _random_graphs()[2],
}


def _both(cols):
    n = cols.shape[0]
    j = JEll(cols=jnp.asarray(cols),
             vals=jnp.zeros(cols.shape, jnp.float32), n_cols=n)
    t = EllMatrix(cols=torch.from_numpy(cols), vals={}, n_cols=n)
    return j, t


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_backend_matches_jax(case):
    jadj, tadj = _both(CASES[case]())
    jl, ji = jcomp.connected_components(jadj, backend="reference")
    tl, ti = tcomp.connected_components(tadj, backend="reference")
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert ti == int(ji)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_backend_on_cpu_matches_jax_pallas(case):
    """Labels and the rounds *executed* (8-round chunks) equal JAX's
    ``pallas`` backend; the labels also equal the reference backend's."""
    jadj, tadj = _both(CASES[case]())
    jl, ji = jcomp.connected_components(jadj, backend="pallas")
    tl, ti = tcomp.connected_components(tadj, backend="cuda")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert ti == int(ji)
    rl, ri = tcomp.connected_components(tadj, backend="reference")
    assert torch.equal(tl, rl)
    assert tcc.hbm_round_trips(ti) == j_trips(int(ji))
    assert tcc.hbm_round_trips(ti) <= tcc.hbm_round_trips(ri) + 1


@pytest.mark.parametrize("backend,jax_backend", [("reference", "reference"),
                                                 ("cuda", "pallas")])
def test_capped_tail_matches_jax(backend, jax_backend):
    """``max_iters=13`` on the 257-vertex chain: one 8-round chunk and a
    5-round tail, labels compared unconverged."""
    jadj, tadj = _both(_permuted_chain(257, seed=2))
    jl, ji = jcomp.connected_components(jadj, max_iters=13, backend=jax_backend)
    tl, ti = tcomp.connected_components(tadj, max_iters=13, backend=backend)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert ti == int(ji) == 13
    assert len(torch.unique(tl)) > 1  # not converged


def test_transpose_ell_matches_jax():
    cols = _adj_cols(5, [(0, 2), (1, 2), (3, 2), (4, 0)], capacity=2)
    t = tcc.transpose_ell(torch.from_numpy(cols))
    ins = {r: sorted(int(c) for c in t[r] if c >= 0) for r in range(5)}
    assert ins == {0: [4], 1: [], 2: [0, 1, 3], 3: [], 4: []}
    np.testing.assert_array_equal(t.numpy(), np.asarray(j_transpose(jnp.asarray(cols))))
    for case in ("cycle_heavy_320_10", "random_1"):
        cols = CASES[case]()
        np.testing.assert_array_equal(
            tcc.transpose_ell(torch.from_numpy(cols)).numpy(),
            np.asarray(j_transpose(jnp.asarray(cols))))


@pytest.mark.parametrize("rounds", [1, 3, 8])
def test_plain_rounds_match_jax_kernel(rounds):
    """The plain version of the kernel against the Pallas kernel in
    interpret mode, one call, from the identity and from a later state."""
    cols = CASES["random_2"]()
    n, k = cols.shape
    ic = tcc.transpose_ell(torch.from_numpy(cols))
    lab = torch.arange(n, dtype=torch.int32)
    for _ in range(2):
        tl, tchg = K.cc_rounds_ref(torch.from_numpy(cols), ic, lab, rounds)
        jl, jchg = cc_rounds_pallas(
            jnp.asarray(cols).reshape(1, -1), jnp.asarray(ic.numpy()).reshape(1, -1),
            jnp.asarray(lab.numpy()).reshape(1, n), rounds=rounds, interpret=True)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl).reshape(-1))
        assert int(tchg) == int(np.asarray(jchg)[0, 0])
        lab = tl
    # the CPU wrapper runs the plain version
    got = K.cc_rounds(torch.from_numpy(cols), ic, lab, rounds)
    want = K.cc_rounds_ref(torch.from_numpy(cols), ic, lab, rounds)
    assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


def test_state_graph_components_match_jax():
    """``connected_components(expand_states(S))`` — the bench's use — on a
    two-chain string graph, both backends against JAX's."""
    edges = [(0, 1, 0, 0, 30), (1, 2, 0, 1, 25), (3, 4, 1, 1, 20),
             (4, 5, 0, 0, 10), (2, 0, 1, 1, 12)]
    tg = tcomp.expand_states(string_matrix_from_edges(6, edges))
    jg = jcomp.expand_states(j_smat(6, edges))
    np.testing.assert_array_equal(tg.cols.numpy(), np.asarray(jg.cols))
    for tb_, jb in (("reference", "reference"), ("cuda", "pallas")):
        tl, ti = tcomp.connected_components(tg, backend=tb_)
        jl, ji = jcomp.connected_components(jg, backend=jb)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert ti == int(ji)


def test_cc_labels_registered_and_launch_span():
    assert tb.available_backends("cc_labels") == ("cuda", "reference")
    from repro_torch.obs import Tracer, tracing

    tr = Tracer(memory=False)
    _, tadj = _both(_permuted_chain(40, seed=1))
    with tracing(tr):
        tcomp.connected_components(tadj, backend="cuda")
    (op,) = tr.roots
    assert op.name == "op:cc_labels" and op.attrs["backend"] == "cuda"
    # CPU tensors run the plain rounds: no kernel launch, so no launch span
    # (tests/test_torch_cuda.py holds the spans of the card's launches)
    assert op.children == []


# --- the card kernel's algorithm, emulated on the host -------------------------
#
# ``csrc/cc.cu`` cannot run here, so its algorithm is emulated step for step
# with torch ops and held against the plain versions and JAX: the edge list
# the wrapper builds (``kernels.cc.ops.edge_list``), the three steps as
# scatter-mins over it (step 1 lowers l1 and the round's l2 together, step 3
# writes the next round's l2), and the chunk rule the launch runs on the
# device.


def _emulate_launch(edges, labels, rounds, n_chunks, rem):
    """One launch of the kernel: ``(labels, rounds executed, chunks, the
    last chunk's changed flag)``."""
    src = edges[:, 0].long()
    flagged = edges[:, 1]
    out_only = flagged < 0
    in_only = (flagged & tcc.ops.IN_ONLY) != 0
    dst = (flagged & (tcc.ops.IN_ONLY - 1)).long()
    s1, s2 = ~in_only, ~out_only
    lab = labels.clone()
    l1 = lab.clone()
    l2 = [lab.clone(), lab.clone()]
    cur = 0

    def chunk(r_count):
        nonlocal cur
        chg = False
        for _ in range(r_count):
            l2c = l2[cur]
            pulled = lab[dst[s1]]  # step 1: l1 and l2 from l
            l1.scatter_reduce_(0, src[s1], pulled, "amin")
            l2c.scatter_reduce_(0, src[s1], pulled, "amin")
            l2c.scatter_reduce_(0, dst[s2], l1[src[s2]], "amin")  # step 2
            l3 = l2c[l2c.long()]  # step 3
            chg |= bool(torch.any(l3 != lab))
            lab.copy_(l3)
            l1.copy_(l3)
            l2[cur ^ 1] = l3.clone()
            cur ^= 1
        return chg

    iters = chunks = 0
    changed = True
    while changed and chunks < n_chunks:
        changed = chunk(rounds)
        iters += rounds
        chunks += 1
    if rem and changed:
        changed = chunk(rem)
        iters += rem
        chunks += 1
    return lab, iters, chunks, changed


def _emulate_call(cols, max_iters=None):
    """A whole ``cc_labels`` call as the card runs it."""
    n = cols.shape[0]
    rounds, n_chunks, rem = tcc.ops.chunk_rule(n if max_iters is None
                                               else max_iters)
    return _emulate_launch(tcc.edge_list(cols),
                           torch.arange(n, dtype=torch.int32), rounds,
                           n_chunks, rem)[:3]


def _out_of_range(cols, seed):
    """``cols`` with a few live slots pointing past the last vertex."""
    rng = np.random.default_rng(seed)
    cols = cols.copy()
    n = cols.shape[0]
    hit = rng.random(cols.shape) < 0.05
    cols[hit] = n + rng.integers(0, 5, int(hit.sum()))
    return cols


EMU_CASES = dict(CASES)
EMU_CASES.update({
    "n_1_self_loop": lambda: np.zeros((1, 1), np.int32),
    "n_1_empty": lambda: np.full((1, 2), -1, np.int32),
    # one row of 70 out-edges, 70 rows of one in-edge
    "star_71": lambda: np.where(np.arange(71)[:, None] == 0,
                                np.arange(1, 71)[None, :], -1).astype(np.int32),
    "random_1_out_of_range": lambda: _out_of_range(_random_graphs()[1], 3),
    "cycle_heavy_96_3_out_of_range": lambda: _out_of_range(
        _cycle_heavy(96, cycle=3, seed=4), 5),
})


@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_edge_list_emulation_matches_jax(case):
    """The kernel's whole call (edge-list scatter-min, the on-device chunk
    rule) equals JAX's ``pallas`` backend (labels, rounds executed), the
    port's cuda backend on CPU tensors, and the chunks of the plain driver;
    out-of-range columns hook in the out-hook only, n = 1 included."""
    cols = EMU_CASES[case]()
    jadj, tadj = _both(cols)
    lab, iters, chunks = _emulate_call(tadj.cols)
    jl, ji = jcomp.connected_components(jadj, backend="pallas")
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
    assert iters == int(ji)
    want = tcc.cc_components(tadj.cols)
    assert torch.equal(lab, want[0]) and (iters, chunks) == want[1:]
    if (cols < cols.shape[0]).all():  # the reference clamps both hooks
        assert torch.equal(lab, tcomp.connected_components(
            tadj, backend="reference")[0])


@pytest.mark.parametrize("max_iters", [0, 1, 5, 8, 13, 21, 64])
@pytest.mark.parametrize("case", ["permuted_chain_257", "cycle_heavy_320_10",
                                  "random_1_out_of_range"])
def test_chunk_rule_emulation_matches_jax(case, max_iters):
    """``max_iters`` tails: the launch's chunk rule gives JAX's capped
    labels and rounds executed, and the plain driver's chunk count."""
    cols = EMU_CASES[case]()
    jadj, tadj = _both(cols)
    lab, iters, chunks = _emulate_call(tadj.cols, max_iters)
    jl, ji = jcomp.connected_components(jadj, max_iters=max_iters,
                                        backend="pallas")
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
    assert iters == int(ji) <= max_iters
    want = tcc.cc_components(tadj.cols, max_iters=max_iters)
    assert torch.equal(lab, want[0]) and (iters, chunks) == want[1:]
    rounds, n_chunks, rem = tcc.ops.chunk_rule(max_iters)
    assert chunks <= n_chunks + (rem > 0)


@pytest.mark.parametrize("rounds", [1, 3, 8])
@pytest.mark.parametrize("case", ["random_2", "random_1_out_of_range",
                                  "n_1_self_loop"])
def test_one_chunk_emulation_matches_jax_kernel(case, rounds):
    """The ``cc_rounds`` entry (the kernel capped at one chunk, ``oc`` edges
    out-hook only, ``ic`` edges in-hook only) equals the plain rounds and
    JAX's Pallas kernel in interpret mode: labels and changed flag, from
    the identity and from a later state."""
    cols = EMU_CASES[case]()
    n = cols.shape[0]
    oc = torch.from_numpy(cols)
    ic = tcc.transpose_ell(oc)
    lab = torch.arange(n, dtype=torch.int32)
    for _ in range(2):
        got, iters, chunks, chg = _emulate_launch(tcc.edge_list(oc, ic), lab,
                                                  rounds, 1, 0)
        assert (iters, chunks) == (rounds, 1)
        want = K.cc_rounds_ref(oc, ic, lab, rounds)
        assert torch.equal(got, want[0]) and int(chg) == int(want[1])
        jl, jchg = cc_rounds_pallas(
            jnp.asarray(cols).reshape(1, -1),
            jnp.asarray(ic.numpy()).reshape(1, -1),
            jnp.asarray(lab.numpy()).reshape(1, n), rounds=rounds,
            interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jl).reshape(-1))
        assert int(chg) == int(np.asarray(jchg)[0, 0])
        lab = got


def test_edge_list_and_paths():
    """The edge list's flags and the size dispatch between the paths."""
    cols = torch.tensor([[1, 9], [2, -1], [-1, -1]], dtype=torch.int32)
    e = tcc.edge_list(cols)
    assert e.tolist() == [[0, 1], [0, 2 | tcc.ops.OUT_ONLY], [1, 2]]
    e = tcc.edge_list(cols, tcc.transpose_ell(cols))
    assert e.tolist() == [[0, 1 | tcc.ops.OUT_ONLY], [0, 2 | tcc.ops.OUT_ONLY],
                          [1, 2 | tcc.ops.OUT_ONLY], [0, 1 | tcc.ops.IN_ONLY],
                          [1, 2 | tcc.ops.IN_ONLY]]
    # the out-of-range column is absent from the in-neighbour ELL
    assert tcc.transpose_ell(cols).tolist() == [[-1], [0], [1]]
    # the pipeline's state graphs at 4000 reads (8000 states): S's 2716
    # edges and R's 12914 fit one block; a 2^17 chain does not
    assert tcc.cc_path(8000, 2716) == "block"
    assert tcc.cc_path(8000, 12914) == "block"
    assert tcc.cc_path(1 << 17, (1 << 17) - 1) == "grid"
    assert tcc.ops.block_bytes(8000, 12914) <= tcc.ops.MAX_SHARED_BYTES
