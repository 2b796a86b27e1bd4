"""The port's training path against JAX's, on the CPU: the two backward
rules (rope's inverse rotation, the bf16 cotangent barrier), the chunked
cross entropy, ``loss_fn`` and every gradient leaf for all ten LM archs at
``reduced()``, ``make_train_step`` over 3 steps from JAX's carried state,
the compressed train step of ``launch/train.py``, and the training entry
point (``python -m repro_torch.launch.train``): losses against JAX's
``main`` from the same state, resume reproducing the straight run, and the
default device raising without a card.

Parameters cross with ``convert.lm_params_from_numpy(train=True)`` /
``lm_train_state_from_numpy``; inputs are drawn with numpy from a seed.
Tolerances: the rope and barrier cotangents bit for bit; f32 losses rtol
1e-5 and each gradient leaf within 1e-4 of the leaf's max |g| (JAX sums in
other orders); bf16 losses within 5e-3 and leaves within 0.08 of the max
|g| (the rounding of bf16 activations, not the algebra: the largest seen
is 0.055, gemma3's 16-element ``q_norm``, and 1.9e-3 for a loss);
optimizer states within 2e-5 of each leaf's max after 3 steps in f32
(looser where bf16 compute or compressed gradients meet rounding
boundaries: ``STEP_TOL``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import reduced_config as j_reduced_config
from repro.launch import train as JT
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as j_cosine
from repro.runtime import CompressedAllReduce as JComp
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import (
    _jax_leaf,
    lm_config_from_dict,
    lm_params_from_numpy,
    lm_train_state_from_numpy,
)
from repro_torch.data import as_tensors
from repro_torch.launch import train as TT
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime import CompressedAllReduce

B, S, CE_CHUNK = 2, 40, 16  # S is not a multiple of the CE chunk
F32_LOSS, F32_LEAF = 1e-5, 1e-4
BF16_LOSS, BF16_LEAF = 5e-3, 0.08
STATE_TOL = 2e-5
MOE = {"qwen2-moe-a2.7b", "granite-moe-1b-a400m"}


def _cfgs(arch, dtype="float32", **over):
    jcfg = dataclasses.replace(j_reduced_config(arch), dtype=dtype,
                               ce_chunk=CE_CHUNK, **over)
    return jcfg, lm_config_from_dict(dataclasses.asdict(jcfg))


def _batch(cfg, seed=3):
    """Tokens (or f32 embeddings) and labels with some −1, drawn with numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.1] = -1
    if cfg.frontend == "token":
        x = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)}
    else:
        x = {"embeddings": rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)}
    return {**x, "labels": labels}


def _np(x):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), x)


def _leaf_close(got, want, tol, what=""):
    """|got − want| ≤ tol · max|want| (an all-zero leaf must be zero)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _grads_vs_jax(jgrads, tgrads, tol):
    for name, g in tgrads.items():
        _leaf_close(g.float().numpy(), _jax_leaf(jgrads, name), tol, name)


# --- the backward rules -----------------------------------------------------


def test_rope_grad_is_jax_vjp_bit_for_bit():
    """bf16 q/k cotangents through rope equal ``jax.vjp`` of JAX's
    ``apply_rope`` bit for bit: the inverse rotation in f32, rounded once.
    The same angles go into both (JAX's, as numpy)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    cos, sin = (np.array(a) for a in JL.rope_freqs(jnp.arange(24), 16, 1e6))
    jx, jg = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    jout, vjp = jax.vjp(lambda a: JL.apply_rope(a, jnp.asarray(cos),
                                                jnp.asarray(sin)), jx)
    (jdx,) = vjp(jg)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    tout = TL.apply_rope(tx, tc, ts)
    tout.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert tx.grad.dtype == torch.bfloat16
    assert np.array_equal(tout.detach().float().numpy(),
                          np.asarray(jout.astype(jnp.float32)))
    assert np.array_equal(tx.grad.float().numpy(),
                          np.asarray(jdx.astype(jnp.float32)))


def test_bf16_grad_barrier_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jout, vjp = jax.vjp(JM._bf16_grad_barrier, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = TM.bf16_grad_barrier(tx)
    tout.backward(torch.from_numpy(g))
    assert torch.equal(tout.detach(), torch.from_numpy(x))
    assert tx.grad.dtype == torch.float32
    assert np.array_equal(tx.grad.numpy(), np.asarray(jdx))
    assert not np.array_equal(tx.grad.numpy(), g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_ce_loss_matches_jax(dtype):
    """Value and gradients in x and ``w_unembed``: 40 tokens in chunks of
    16 (a padded tail), −1 labels, vocab 300 padded to 512."""
    jcfg, tcfg = _cfgs("qwen3-4b", dtype, vocab_size=300)
    assert jcfg.vocab_padded == 512
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    w = (rng.normal(size=(jcfg.d_model, 512)) / 8).astype(np.float32)
    labels = rng.integers(0, 300, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    jdt = jnp.dtype(dtype)

    def jloss(xx, ww):
        return JM.chunked_ce_loss(xx.astype(jdt), jnp.asarray(labels), ww, jcfg)

    jl, (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = TM.chunked_ce_loss(tx.to(getattr(torch, dtype)),
                            torch.from_numpy(labels), tw, tcfg)
    tl.backward()
    tol = F32_LOSS if dtype == "float32" else 1e-5
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=tol)
    leaf = F32_LEAF if dtype == "float32" else 1e-2
    _leaf_close(tx.grad.numpy(), jgx, leaf, "x")
    _leaf_close(tw.grad.numpy(), jgw, leaf, "w_unembed")
    assert not tw.grad[:, 300:].any()  # padded vocab ids get no gradient


def test_chunked_ce_loss_vocab_parallel_raises():
    """The vocab-parallel branch on a 1×1 grid equals the plain CE (loss
    and both gradients); a mesh that is not a ``ProcessGrid`` raises.  On
    more ranks it is held to JAX's shard_map in
    ``tests/test_torch_mesh_models.py``."""
    from repro_torch.core.grid import ProcessGrid

    _, tcfg = _cfgs("qwen3-4b")
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (B, S, tcfg.d_model)).astype(np.float32)
    w = rng.normal(0, 0.1, (tcfg.d_model, tcfg.vocab_padded)).astype(np.float32)
    labels = _batch(tcfg)["labels"]
    res = []
    for mesh in (None, ProcessGrid(1, 1)):
        tx = torch.from_numpy(x).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        loss = TM.chunked_ce_loss(tx, torch.from_numpy(labels), tw, tcfg,
                                  mesh=mesh)
        loss.backward()
        res.append((float(loss.detach()), tx.grad.numpy(), tw.grad.numpy()))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=F32_LOSS)
    _leaf_close(res[1][1], res[0][1], F32_LEAF, "x")
    _leaf_close(res[1][2], res[0][2], F32_LEAF, "w_unembed")
    with pytest.raises(TypeError, match="ProcessGrid"):
        TM.chunked_ce_loss(torch.zeros(1, 2, tcfg.d_model),
                           torch.zeros(1, 2, dtype=torch.int32),
                           torch.zeros(tcfg.d_model, tcfg.vocab_padded), tcfg,
                           mesh=object())


# --- loss_fn and every gradient, all ten archs -------------------------------


def _loss_pair(arch, dtype, **over):
    jcfg, tcfg = _cfgs(arch, dtype, **over)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jb, jcfg)))(params)
    model = lm_params_from_numpy(_np(params), tcfg, train=True)
    tl, tg = TM.loss_and_grads(model, as_tensors(batch, "cpu"), tcfg)
    return float(jl), _np(jg), float(tl), tg


@pytest.mark.parametrize("arch", J_ARCH_NAMES)
def test_loss_and_grads_match_jax_f32(arch):
    jl, jg, tl, tg = _loss_pair(arch, "float32")
    np.testing.assert_allclose(tl, jl, rtol=F32_LOSS)
    assert all(g.dtype == torch.float32 for g in tg.values())
    _grads_vs_jax(jg, tg, F32_LEAF)


@pytest.mark.parametrize("arch", [a for a in J_ARCH_NAMES if a not in MOE])
def test_loss_and_grads_match_jax_bf16(arch):
    """bf16 compute from f32 parameters.  MoE archs are left out: XLA's
    and torch's bf16 rounding differ, a top-k at a near tie flips, and a
    flipped expert moves its token's gradient by far more than rounding
    (their serving parity hands the port JAX's top-k instead)."""
    jl, jg, tl, tg = _loss_pair(arch, "bfloat16")
    np.testing.assert_allclose(tl, jl, atol=BF16_LOSS, rtol=0)
    _grads_vs_jax(jg, tg, BF16_LEAF)


def test_bf16_grad_activations_matches_jax():
    """The barrier after each block and before the loss: gradients match
    JAX's with it, and differ from the run without it."""
    jl, jg, tl, tg = _loss_pair("qwen3-4b", "float32",
                                bf16_grad_activations=True)
    np.testing.assert_allclose(tl, jl, rtol=F32_LOSS)
    _grads_vs_jax(jg, tg, 1e-2)
    _, _, _, plain = _loss_pair("qwen3-4b", "float32")
    assert any(not torch.equal(plain[n], g) for n, g in tg.items())


def test_train_model_is_f32_with_gradients_and_remat():
    """``init_params(train=True)`` stores every parameter in f32 with
    gradients; its forward without caches recomputes each period group in
    the backward (one checkpoint a group) and gives the serving forward's
    output."""
    _, tcfg = _cfgs("gemma3-4b")
    model = TM.init_params(tcfg, torch.Generator().manual_seed(0), train=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    toks = torch.from_numpy(_batch(tcfg)["tokens"])
    calls = []
    orig = TM.checkpoint

    def spy(fn, *a, **k):
        calls.append(fn.__name__)
        return orig(fn, *a, **k)

    TM.checkpoint = spy
    try:
        x, _ = TM.forward(model, {"tokens": toks}, tcfg)
    finally:
        TM.checkpoint = orig
    assert calls == ["run"] * tcfg.n_periods
    with torch.no_grad():
        y, _ = TM.forward(model, {"tokens": toks}, tcfg)
    assert torch.equal(x.detach(), y)


def _saved(fn, *args):
    """What ``fn(*args)`` saves for its backward outside any checkpoint (a
    checkpoint's own hooks take what is saved inside it): the saved
    tensors' shapes and the count of distinct storages among them."""
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return ({tuple(t.shape) for t in saved},
            len({t.untyped_storage().data_ptr() for t in saved}))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b", "qwen3-4b"])
def test_ssd_and_query_block_steps_are_recomputed(arch, monkeypatch):
    """With gradients on, the SSD chunk step and the attention query-block
    step run under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of
    ``chunk_step`` and ``q_step``): no (B, Q, Q, H) chunk buffer and no
    per-KV-block accumulator is saved outside a checkpoint, and the
    storages saved grow by one (B, H, N, P) carry a chunk and by none a
    query block.  The same loops with the checkpoints taken out (patched
    to plain calls here) save both, and more storage a step.  Loss and
    gradients at ``reduced()``, with several SSD chunks, still equal
    JAX's."""
    from repro_torch.models import attention as TA
    from repro_torch.models import ssm as TS

    over = {"ssd_chunk": 8} if arch != "qwen3-4b" else {}
    _, tcfg = _cfgs(arch, **over)
    rng = np.random.default_rng(7)

    def leaf(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)
        ).requires_grad_(True)

    def runs(mod, fn, make, n_steps):
        """{plain, remat}: {steps: (shapes, storages)}."""
        out = {}
        for mode in ("remat", "plain"):
            if mode == "plain":
                monkeypatch.setattr(mod, "checkpoint",
                                    lambda f, *a, **k: f(*a))
            out[mode] = {n: _saved(fn, *make(n)) for n in n_steps}
        monkeypatch.undo()
        return out

    if tcfg.family in ("ssm", "hybrid"):
        h, p, n, q = 4, tcfg.ssm_headdim, tcfg.ssm_state, tcfg.ssd_chunk
        r = runs(TS, lambda *a: TS.ssd_chunked(*a, chunk=q),
                 lambda nc: (leaf(B, nc * q, h, p),
                             leaf(B, nc * q, h, scale=0.1).abs(), leaf(h),
                             leaf(B, nc * q, n), leaf(B, nc * q, n)), (2, 5))
        assert (B, q, q, h) not in r["remat"][5][0]
        assert (B, q, q, h) in r["plain"][5][0]
        assert r["remat"][5][1] - r["remat"][2][1] == 3  # one carry a chunk
        assert r["plain"][5][1] - r["plain"][2][1] > 3 * 4
    if tcfg.family != "ssm":
        hq, hkv, d, blk = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim, 8
        r = runs(TA, lambda *a: TA.flash_attention(*a, q_block=blk,
                                                   kv_block=blk),
                 lambda nb: (leaf(B, nb * blk, hq, d),
                             leaf(B, nb * blk, hkv, d),
                             leaf(B, nb * blk, hkv, d)), (2, 5))
        acc = (B, hkv, hq // hkv, blk, d)
        assert acc not in r["remat"][5][0]
        assert acc in r["plain"][5][0]
        assert r["remat"][5][1] == r["remat"][2][1]  # nothing a query block
        assert r["plain"][5][1] - r["plain"][2][1] > 3 * 4
    jl, jg, tl, tg = _loss_pair(arch, "float32", **over)
    np.testing.assert_allclose(tl, jl, rtol=F32_LOSS)
    _grads_vs_jax(jg, tg, F32_LEAF)


# --- the train step over 3 steps from JAX's carried state ---------------------


def _state_close(jstate, tstate, tol, per_leaf=True):
    """Step, parameters, μ and ν: each leaf within ``tol`` of its max, or
    (``per_leaf=False``) each of the three within ``tol`` in relative L2
    over the whole model."""
    jparams, (jmu, jnu), jstep = jstate
    model, opt_state, step = tstate
    assert step == int(jstep)
    for what, jtree, ours in (
            ("", jparams, {n: p.detach() for n, p in model.named_parameters()}),
            ("mu ", jmu, opt_state.mu), ("nu ", jnu, opt_state.nu)):
        jtree = _np(jtree)
        pairs = [(t.numpy(), _jax_leaf(jtree, n), what + n)
                 for n, t in ours.items()]
        if per_leaf:
            for got, want, name in pairs:
                _leaf_close(got, want, tol, name)
        else:
            num = sum(np.sum((g.astype(np.float64) - w) ** 2) for g, w, _ in pairs)
            den = sum(np.sum(np.asarray(w, np.float64) ** 2) for _, w, _ in pairs)
            assert np.sqrt(num / den) <= tol, (what, np.sqrt(num / den))


# (loss rtol, grad_norm rtol, state tol): f32 holds the sums' order; bf16
# compute (mixed precision) and compressed gradients turn an ulp of
# difference into a bf16 or int8 step where a value sits at a rounding
# boundary, which Adam's normalisation carries into μ, ν and the
# parameters (measured: mixed 1.3e-2 of a leaf's max, bf16 compression
# 1.7e-3).  An int8 code flip moves a small-valued leaf (a norm scale) by a
# large share of its max, so int8 holds the whole model in relative L2
# (measured 5.0e-3 for μ, 1.1e-3 for the parameters)
STEP_TOL = {"f32": (F32_LOSS, F32_LEAF, STATE_TOL),
            "mixed": (1e-4, 1e-3, 0.03),
            "bf16": (F32_LOSS, F32_LEAF, 0.01),
            "int8": (F32_LOSS, F32_LEAF, 0.02)}


def _metrics_close(tm, jm, case):
    loss_tol, gn_tol, _ = STEP_TOL[case]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=loss_tol)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=gn_tol)


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_train_step_matches_jax_over_three_steps(mixed_precision):
    """JAX runs 2 steps; its state crosses with
    ``lm_train_state_from_numpy``; then 3 steps in each package: loss,
    grad_norm, step, parameters, μ and ν."""
    case = "mixed" if mixed_precision else "f32"
    jcfg, tcfg = _cfgs("qwen3-4b")
    jopt = JAdamW(learning_rate=j_cosine(3e-3, 2, 6))
    topt = AdamW(learning_rate=cosine_schedule(3e-3, 2, 6))
    jstep = jax.jit(JM.make_train_step(jcfg, jopt,
                                       mixed_precision=mixed_precision))
    tstep = TM.make_train_step(tcfg, topt, mixed_precision=mixed_precision)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = (params, jopt.init(params), jnp.int32(0))
    for s in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in _batch(jcfg, 10 + s).items()})
    jparams, jopt_state, js = jstate
    tstate = lm_train_state_from_numpy(_np(jparams), _np(tuple(jopt_state)),
                                       int(js), tcfg)
    _state_close(jstate, tstate, 0.0)
    for s in range(2, 5):
        batch = _batch(jcfg, 10 + s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, as_tensors(batch, "cpu"))
        _metrics_close(tm, jm, case)
        _state_close(jstate, tstate, STEP_TOL[case][2])


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compressed_train_step_matches_jax(mode):
    """``launch.train.build_train_step`` with error feedback, 2 steps from
    JAX's initial state against JAX's (f32 compute).  The residuals are not
    compared element by element: where the two packages' gradients sit on
    either side of a rounding boundary the residual changes sign
    (``tests/test_torch_runtime.py`` holds ``compress_ef`` bit for bit on
    equal gradients)."""
    jcfg, tcfg = _cfgs("qwen3-4b")
    jopt = JAdamW(learning_rate=j_cosine(3e-3, 1, 4))
    topt = AdamW(learning_rate=cosine_schedule(3e-3, 1, 4))
    jcomp, tcomp = JComp(mode=mode), CompressedAllReduce(mode=mode)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = (params, jopt.init(params), jnp.int32(0))
    jerr = jcomp.init_error(params)
    tstate = lm_train_state_from_numpy(_np(params), _np(tuple(jstate[1])),
                                       0, tcfg)
    jfn = JT.build_train_step(jcfg, jopt, jcomp)
    terr = tcomp.init_error(dict(tstate[0].named_parameters()))
    tfn = TT.build_train_step(tcfg, topt, tcomp)
    for s in range(2):
        batch = _batch(jcfg, 20 + s)
        jstate, jerr, jm = jfn(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, jerr)
        tstate, terr, tm = tfn(tstate, as_tensors(batch, "cpu"), terr)
        _metrics_close(tm, jm, mode)
        _state_close(jstate, tstate, STEP_TOL[mode][2],
                     per_leaf=mode != "int8")
    assert set(terr) == {n for n, _ in tstate[0].named_parameters()}


# --- the entry point ------------------------------------------------------------

MAIN = ["--arch", "qwen3-4b", "--reduced", "--batch", "4", "--seq", "32",
        "--log-every", "100"]


def test_train_main_matches_jax_main(tmp_path):
    """JAX's ``main`` (bf16, 8 steps) against the port's ``main`` on the
    CPU resumed from JAX's initial state, written as the port's step-0
    checkpoint: every loss within 0.02 (bf16 rounding over 8 steps)."""
    jlosses = JT.main(MAIN + ["--steps", "8"])
    jcfg = j_reduced_config("qwen3-4b")
    jopt = JAdamW(learning_rate=j_cosine(3e-3, 10, 8))
    jstate = JT.make_state(jcfg, jopt, jax.random.PRNGKey(0))
    tcfg = lm_config_from_dict(dataclasses.asdict(jcfg))
    state = lm_train_state_from_numpy(_np(jstate[0]), _np(tuple(jstate[1])),
                                      0, tcfg)
    CheckpointManager(str(tmp_path), async_write=False).save(0, state)
    tlosses = TT.main(MAIN + ["--steps", "8", "--device", "cpu", "--ckpt-dir",
                              str(tmp_path), "--resume"])
    assert len(tlosses) == len(jlosses) == 8
    np.testing.assert_allclose(tlosses, jlosses, atol=0.02, rtol=0)
    assert tlosses[-1] < tlosses[0]


def test_train_resume_on_cpu_is_exact(tmp_path):
    """8 steps straight equal 5 steps, a checkpoint, and ``--resume`` to 8,
    exactly (deterministic data and the f32 state restored bit for bit)."""
    cpu = ["--device", "cpu"]
    full = TT.main(MAIN + cpu + ["--steps", "8"])
    part1 = TT.main(MAIN + cpu + ["--steps", "5", "--ckpt-dir", str(tmp_path),
                                  "--ckpt-every", "5"])
    part2 = TT.main(MAIN + cpu + ["--steps", "8", "--ckpt-dir", str(tmp_path),
                                  "--resume"])
    assert part1 == full[:5]
    assert part2 == full[5:]
    assert sorted(os.listdir(tmp_path)) == ["step_00000005", "step_00000008"]


def test_train_main_compress_int8_runs_on_cpu():
    losses = TT.main(MAIN + ["--device", "cpu", "--steps", "3",
                             "--compress", "int8"])
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_train_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.main(MAIN + ["--steps", "1"])


def test_ssd_gradient_stays_finite_past_the_exp_range():
    """Decays whose within-chunk gap passes exp's f32 range (88.7) above
    the diagonal: JAX's ``ssd_chunked`` masks ``exp(gap)`` after the exp,
    and its Δ gradient comes out non-finite (0 · inf, spread over every
    position); the port masks the gap before the exp, so its gradients are
    finite, and its value and its input gradient equal JAX's.  Just inside
    the range (gaps up to 82.6) JAX's gradients are finite, and the port's
    value, input gradient and Δ gradient all equal them."""
    from repro.models import ssm as JS
    from repro_torch.models import ssm as TS

    rng = np.random.default_rng(11)
    b, s, h, p, n = 1, 256, 2, 8, 4
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    a_log = np.zeros((h,), np.float32)  # A = -1: a chunk's gaps up to 127·Δ
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))

    def jsum(x, d):
        y, _ = JS.ssd_chunked(x, d, jnp.asarray(a_log), jnp.asarray(bm),
                              jnp.asarray(cm), chunk=128)
        return jnp.sum(y)

    for delta, jax_finite in ((1.0, False), (0.65, True)):
        dt = np.full((b, s, h), delta, np.float32)
        jv, (jgx, jgd) = jax.value_and_grad(jsum, argnums=(0, 1))(
            jnp.asarray(xh), jnp.asarray(dt))
        assert np.isfinite(np.asarray(jgd)).all() == jax_finite
        tx = torch.from_numpy(xh).requires_grad_(True)
        td = torch.from_numpy(dt).requires_grad_(True)
        y, _ = TS.ssd_chunked(tx, td, torch.from_numpy(a_log),
                              torch.from_numpy(bm), torch.from_numpy(cm),
                              chunk=128)
        y.sum().backward()
        assert torch.isfinite(tx.grad).all() and torch.isfinite(td.grad).all()
        np.testing.assert_allclose(float(y.sum()), float(jv), rtol=F32_LOSS)
        _leaf_close(tx.grad.numpy(), jgx, F32_LEAF, f"xh, delta {delta}")
        if jax_finite:
            _leaf_close(td.grad.numpy(), jgd, F32_LEAF, f"dt, delta {delta}")
