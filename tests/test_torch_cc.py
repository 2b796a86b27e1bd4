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
