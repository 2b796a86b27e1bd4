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
    # the kernel's shared buffer: 8960 candidates a row sort as 16384 keys
    assert tops.sort_keys(160, 56) == 16384
    assert tops.shared_bytes(160, 56) <= tops.MAX_SHARED_BYTES
    assert tops.shared_bytes(200, 100) > tops.MAX_SHARED_BYTES
    assert set(tops.SEMIRINGS) == {overlap_semiring.name,
                                   minplus_orient_semiring.name}
