"""The port's language-model modules (``repro_torch.models``,
``configs/``, ``convert.py``) against JAX's, module by module, on inputs
drawn with numpy from a seed, and every arch's serving path in bf16.

Each parity trap of the port has a test here that fails when it is got
wrong: the tanh gelu, the f32 products of bf16 operands
(``preferred_element_type``), GQA as ``jnp.repeat``, the ``1 + scale``
norms, the per-layer window/θ switches, the order-dependent MoE capacity
drop, the clamped ``dynamic_update_slice``, softplus, and the embed
frontend.  f32 comparisons hold 1e-5 (one module) or 1e-4 (a model); bf16
outputs of one module must equal JAX's bit for bit on at least 99 % of the
elements (a bf16 product where JAX asks for f32 changes ~40 %); a bf16
model holds JAX's 0.15 bound."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import ALL_NAMES as J_ALL_NAMES
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs import shapes as j_shapes
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoe
from repro.models import ssm as JS
from repro_torch import configs as TC
from repro_torch.configs import shapes as t_shapes
from repro_torch.convert import lm_config_from_dict, lm_params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoe
from repro_torch.models import ssm as TS

from _lm_parity import jax_keep, routed_alike, run_pair

F32_TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _pair(a, dtype=np.float32):
    """The same numpy array as a JAX and a torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(t, j, tol=F32_TOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


def _bf16_alike(t, j):
    """bf16 outputs equal bit for bit but on ≤ 1 % of the elements."""
    a, b = _np(t), _np(j)
    assert a.shape == b.shape
    assert np.mean(a != b) <= 0.01, np.mean(a != b)


def _carried(arch, dtype="float32", **over):
    jcfg = dataclasses.replace(j_reduced_config(arch), dtype=dtype, **over)
    tcfg = lm_config_from_dict(dataclasses.asdict(jcfg))
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, params, lm_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg)


# --- layers ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_is_one_plus_scale(dtype):
    r = _rng()
    jx, tx = _pair(r.normal(size=(3, 5, 64)), "bf16" if dtype == "bf16" else np.float32)
    js, ts = _pair(r.normal(size=(64,)))  # non-zero scales: 1 + scale
    out = TL.rms_norm(tx, ts, 1e-6)
    assert out.dtype == tx.dtype
    if dtype == "f32":
        _close(out, JL.rms_norm(jx, js, 1e-6))
    else:
        _bf16_alike(out, JL.rms_norm(jx, js, 1e-6))
    # nn.RMSNorm scales by the weight, not by 1 + weight
    wrong = torch.nn.functional.rms_norm(tx.float(), (64,), ts, 1e-6)
    assert np.abs(_np(wrong) - _np(out)).max() > 0.1


@pytest.mark.parametrize("theta", [1e4, 1e6, 5e6])
def test_rope(theta):
    r = _rng(1)
    pos = np.arange(0, 300, 7)
    jx, tx = _pair(r.normal(size=(2, len(pos), 3, 16)))
    jc, js = JL.rope_freqs(jnp.asarray(pos), 16, theta)
    tc, ts = TL.rope_freqs(torch.from_numpy(pos), 16, theta)
    _close(tc, jc)
    _close(ts, js)
    _close(TL.apply_rope(tx, tc, ts), JL.apply_rope(jx, jc, js))
    # θ as an f32 0-d tensor (gemma3's per-layer switch) gives the same
    tc2, _ = TL.rope_freqs(torch.from_numpy(pos), 16,
                           torch.tensor(theta, dtype=torch.float32))
    assert torch.equal(tc, tc2)


def test_softplus_has_no_threshold():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` returns
    ``x`` above 20, which differs by at most e⁻²⁰ (below f32's resolution
    there), so either is within 1e-6 — the port mirrors JAX's form."""
    x = np.linspace(-40, 40, 2001).astype(np.float32)
    j = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    t = TL.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    assert np.abs(F.softplus(torch.from_numpy(x)).numpy() - j).max() < 1e-6


def test_gelu_is_tanh_form():
    x = np.linspace(-4, 4, 801).astype(np.float32)
    j = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    t = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    # torch's default (erf) form is another function
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - j).max() > 1e-4


@pytest.mark.parametrize("mlp_type", ["gelu", "geglu", "swiglu"])
def test_mlp_forms(mlp_type):
    arch = {"gelu": "musicgen-large", "geglu": "gemma3-4b",
            "swiglu": "qwen3-4b"}[mlp_type]
    jcfg, tcfg, params, model = _carried(arch)
    assert jcfg.mlp_type == mlp_type
    jx, tx = _pair(_rng(2).normal(size=(2, 7, jcfg.d_model)))
    jp = jax.tree.map(lambda a: a[0], params["slots"][0]["mlp"])
    _close(model.slots[0][0].mlp(tx, tcfg), JM._mlp_forward(jx, jp, jcfg))


# --- attention --------------------------------------------------------------

FLASH_CASES = {
    # name: (sq, skv, hq, hkv, causal, window, q_offset)
    "causal": (40, 40, 4, 4, True, None, 0),
    "window_gqa": (40, 40, 4, 2, True, 12, 0),
    "q_offset": (24, 40, 4, 4, True, None, 16),
    "offset_window": (24, 40, 4, 2, True, 9, 16),
    "noncausal": (20, 40, 4, 1, False, None, 0),
    "global_window": (40, 40, 4, 2, True, 2 ** 30, 0),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention(case, dtype):
    sq, skv, hq, hkv, causal, window, q_offset = FLASH_CASES[case]
    r = _rng(3)
    dt = "bf16" if dtype == "bf16" else np.float32
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(r.normal(size=(2, sq, hq, 16)), dt),
        _pair(r.normal(size=(2, skv, hkv, 16)), dt),
        _pair(r.normal(size=(2, skv, hkv, 16)), dt))
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=16,
              kv_block=16)  # lengths not multiples of the block
    out = TA.flash_attention(tq, tk, tv, **kw)
    ref = JA.flash_attention(jq, jk, jv, **kw)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    (_close if dtype == "f32" else _bf16_alike)(out, ref)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 10])
def test_decode_attention(dtype, window):
    r = _rng(4)
    dt = "bf16" if dtype == "bf16" else np.float32
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(r.normal(size=(2, 1, 4, 16)), dt),
        _pair(r.normal(size=(2, 40, 2, 16)), dt),
        _pair(r.normal(size=(2, 40, 2, 16)), dt))
    cur = np.array([30, 37])
    out = TA.decode_attention(tq, tk, tv, torch.from_numpy(cur), window=window)
    ref = JA.decode_attention(jq, jk, jv, jnp.asarray(cur), window=window)
    (_close if dtype == "f32" else _bf16_alike)(out, ref)
    # a scalar length, as the model passes it
    out2 = TA.decode_attention(tq, tk, tv, 33, window=window)
    ref2 = JA.decode_attention(jq, jk, jv, jnp.full((2,), 33), window=window)
    (_close if dtype == "f32" else _bf16_alike)(out2, ref2)


@pytest.mark.parametrize("pos", [0, 5, 37, 38, 50])
def test_cache_update_clamps_like_dynamic_update_slice(pos):
    r = _rng(5)
    (jk, tk), (jv, tv) = _pair(r.normal(size=(2, 40, 2, 8))), _pair(
        r.normal(size=(2, 40, 2, 8)))
    (jkn, tkn), (jvn, tvn) = _pair(r.normal(size=(2, 3, 2, 8))), _pair(
        r.normal(size=(2, 3, 2, 8)))
    kc, vc = TA.cache_update(tk.clone(), tv.clone(), tkn, tvn, pos)
    rk, rv = JA.cache_update(jk, jv, jkn, jvn, pos)
    assert np.array_equal(_np(kc), _np(rk)) and np.array_equal(_np(vc), _np(rv))


def test_gqa_is_repeat_and_decode_cache():
    """The attention block (prefill without and with a cache, then one
    decode step) against JAX's ``_attn_forward``, GQA g = 2."""
    jcfg, tcfg, params, model = _carried("qwen3-4b")
    assert jcfg.n_heads // jcfg.n_kv_heads == 2
    jp = jax.tree.map(lambda a: a[0], params["slots"][0]["attn"])
    att = model.slots[0][0].attn
    jx, tx = _pair(_rng(6).normal(size=(2, 12, jcfg.d_model)))
    pos = np.arange(12)
    out = att(tx, tcfg, window=None, positions=torch.from_numpy(pos))
    ref, _ = JM._attn_forward(jx, jp, jcfg, window=None,
                              positions=jnp.asarray(pos))
    _close(out, ref)
    # ``Tensor.repeat`` would give query head h the KV head h % Hkv
    jc = {"k": jnp.zeros((2, 16, 2, 16)), "v": jnp.zeros((2, 16, 2, 16))}
    tc = {"k": torch.zeros(2, 16, 2, 16), "v": torch.zeros(2, 16, 2, 16)}
    out = att(tx, tcfg, window=None, positions=torch.from_numpy(pos),
              cache=tc, pos=0)
    ref, jc = JM._attn_forward(jx, jp, jcfg, window=None,
                               positions=jnp.asarray(pos), cache=jc, pos=0)
    _close(out, ref)
    _close(tc["k"], jc["k"])
    jx1, tx1 = _pair(_rng(7).normal(size=(2, 1, jcfg.d_model)))
    out = att(tx1, tcfg, window=None, positions=torch.tensor([12]),
              cache=tc, pos=12)
    ref, jc = JM._attn_forward(jx1, jp, jcfg, window=None,
                               positions=jnp.asarray([12]), cache=jc, pos=12)
    _close(out, ref)
    _close(tc["v"], jc["v"])


def test_unembed_logits_are_f32_products():
    r = _rng(8)
    (jx, tx), (jw, tw) = _pair(r.normal(size=(4, 64)), "bf16"), _pair(
        r.normal(size=(64, 512)) / 8, "bf16")
    out = TM.unembed_logits(tx, tw)
    ref = jnp.einsum("bd,dv->bv", jx, jw, preferred_element_type=jnp.float32)
    assert out.dtype == torch.float32
    _close(out, ref, 1e-6)
    # a bf16 product rounds the logits
    assert np.abs(_np(tx @ tw) - _np(ref)).max() > 1e-3


def test_greedy_ties_go_to_the_first_maximum():
    x = np.array([[1.0, 3.0, 3.0, -2.0], [5.0, 5.0, 5.0, 5.0]], np.float32)
    assert torch.argmax(torch.from_numpy(x), -1).tolist() == np.asarray(
        jnp.argmax(jnp.asarray(x), -1)).tolist() == [1, 0]


# --- ssm --------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_and_tail(with_state):
    r = _rng(9)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(r.normal(size=(2, 7, 24))),
                                    _pair(r.normal(size=(4, 24))),
                                    _pair(r.normal(size=(24,))))
    st = _pair(r.normal(size=(2, 3, 24))) if with_state else (None, None)
    y, tail = TS._causal_conv(tx, tw, tb, st[1])
    ry, rtail = JS._causal_conv(jx, jw, jb, st[0])
    _close(y, ry)
    assert np.array_equal(_np(tail), _np(rtail))


@pytest.mark.parametrize("compute_bf16", [False, True])
@pytest.mark.parametrize("s", [50, 64])
def test_ssd_chunked(compute_bf16, s):
    r = _rng(10)
    b, h, p, n = 2, 3, 8, 6
    (jx, tx), (jdt, tdt), (ja, ta), (jb, tb), (jc, tc) = (
        _pair(r.normal(size=(b, s, h, p))),
        _pair(np.log1p(np.exp(r.normal(size=(b, s, h)) - 1))),
        _pair(r.normal(size=(h,)) * 0.3),
        _pair(r.normal(size=(b, s, n))), _pair(r.normal(size=(b, s, n))))
    y, hf = TS.ssd_chunked(tx, tdt, ta, tb, tc, chunk=16,
                           compute_bf16=compute_bf16)
    ry, rh = JS.ssd_chunked(jx, jdt, ja, jb, jc, chunk=16,
                            compute_bf16=compute_bf16)
    assert hf.dtype == torch.float32
    # bf16 buffers: the same casts of f32 values that differ by an ulp
    tol = 2e-3 if compute_bf16 else F32_TOL
    _close(y, ry, tol)
    _close(hf, rh, tol)
    if compute_bf16:  # the switch changes numbers
        y32, _ = TS.ssd_chunked(tx, tdt, ta, tb, tc, chunk=16)
        assert np.abs(_np(y32) - _np(y)).max() > 1e-3


def test_ssd_decode_step():
    r = _rng(11)
    b, h, p, n = 2, 3, 8, 6
    (jh, th), (jx, tx), (jdt, tdt), (ja, ta), (jb, tb), (jc, tc) = (
        _pair(r.normal(size=(b, h, n, p))), _pair(r.normal(size=(b, h, p))),
        _pair(np.abs(r.normal(size=(b, h)))), _pair(r.normal(size=(h,))),
        _pair(r.normal(size=(b, n))), _pair(r.normal(size=(b, n))))
    h2, y = TS.ssd_decode_step(th, tx, tdt, ta, tb, tc)
    rh2, ry = JS.ssd_decode_step(jh, jx, jdt, ja, jb, jc)
    _close(h2, rh2)
    _close(y, ry)


@pytest.mark.parametrize("s", [1, 9])
def test_mamba2_mixer(s):
    jcfg, tcfg, params, model = _carried("mamba2-1.3b")
    jp = jax.tree.map(lambda a: a[0], params["slots"][0]["ssm"])
    mix = model.slots[0][0].ssm
    jx, tx = _pair(_rng(12).normal(size=(2, s, jcfg.d_model)))
    r = _rng(13)
    dims = TS.mamba2_params_shapes(jcfg.d_model, expand=jcfg.ssm_expand,
                                   headdim=jcfg.ssm_headdim,
                                   state=jcfg.ssm_state,
                                   conv_width=jcfg.conv_width)
    jh, th = _pair(r.normal(size=(2, dims["n_heads"], jcfg.ssm_state,
                                  dims["d_inner"] // dims["n_heads"])))
    jcv, tcv = _pair(r.normal(size=(2, jcfg.conv_width - 1, dims["conv_dim"])))
    out, st = mix(tx, tcfg, TS.SSMState(th, tcv))
    ref, rst = JS.mamba2_forward(jx, jp, jcfg, state=JS.SSMState(jh, jcv))
    _close(out, ref)
    _close(st.h, rst.h)
    _close(st.conv, rst.conv)


# --- moe --------------------------------------------------------------------


@pytest.mark.parametrize("t", [4, 24])
def test_moe_capacity_drop_and_padded_experts(t):
    """qwen2-moe's reduced layer: 8 real experts padded to 16, top-2; at
    T = 4 (a batch-4 decode step) capacity is 1 and most assignments
    drop; the port drops the same ones and gives the same output."""
    jcfg, tcfg, params, model = _carried("qwen2-moe-a2.7b")
    assert (jcfg.n_experts, jcfg.n_experts_padded) == (8, 16)
    jp = jax.tree.map(lambda a: a[0], params["slots"][0]["moe"])
    moe = model.slots[0][0].moe
    jx, tx = _pair(_rng(14).normal(size=(t, jcfg.d_model)))
    w, r = TMoe.route(tx, moe, n_experts_real=8, top_k=2)
    jw, jidx = JMoe.router_topk(jx, jp["router"], 8, 2)
    assert np.array_equal(r.expert.numpy(), np.asarray(jidx).reshape(-1))
    assert bool((r.expert < 8).all())  # padded experts never chosen
    assert np.array_equal(r.keep.numpy(), jax_keep(np.asarray(jidx), 16,
                                                   r.capacity))
    assert r.capacity == max(1, int(t * 2 * 1.25 / 16))
    assert 0 < int((~r.keep).sum()) < r.keep.numel()  # some, not all, drop
    _close(w, jw)
    out = TMoe.moe_ffn_gspmd(tx, moe, n_experts_real=8, top_k=2)
    ref = JMoe.moe_ffn_gspmd(jx, jp, n_experts_real=8, top_k=2)
    _close(out, ref)
    # slots in flat (token, k) order: token 0 keeps both its experts and
    # token 1 drops both; in k-major order each token would keep one
    two = TMoe.dispatch_slots(torch.tensor([[0, 1], [1, 0]]), 16, 1)
    assert two.keep.tolist() == [True, True, False, False]
    assert two.keep.tolist() == list(jax_keep(np.array([[0, 1], [1, 0]]), 16, 1))
    # the shared experts: the whole MoE block
    jx3, tx3 = _pair(_rng(15).normal(size=(1, t, jcfg.d_model)))
    _close(moe(tx3, tcfg), JM._moe_forward(jx3, jp, jcfg))


# --- per-layer switches -----------------------------------------------------


def test_layer_switches():
    g = TC.get_config("gemma3-4b")
    assert g.local_global_period == 1 and g.local_global_every == 6
    assert g.slot_kind(0) == "attn_local"
    got = [TM.layer_attn(g, "attn_local", i) for i in range(g.n_layers)]
    for i, (w, th) in enumerate(got):
        if i % 6 == 5:
            assert (w, th) == (2 ** 30, 1e6), i
        else:
            assert (w, th) == (1024, 1e4), i
    assert TC.reduced_config("gemma3-4b").n_layers == 6  # one global layer
    h = TC.get_config("hymba-1.5b")
    got = [TM.layer_attn(h, "hybrid", i) for i in range(h.n_layers)]
    assert [i for i, (w, _) in enumerate(got) if w == 2 ** 30] == [0, 15, 31]
    assert {w for w, _ in got} == {1024, 2 ** 30}
    assert {th for _, th in got} == {h.rope_theta}  # the window only
    h2 = dataclasses.replace(h, rope_theta_local=123.0)
    assert {TM.layer_attn(h2, "hybrid", i)[1] for i in range(32)} == {h.rope_theta}
    q = TC.get_config("qwen3-4b")
    assert {TM.layer_attn(q, "attn", i) for i in range(36)} == {(None, 1e6)}


# --- every arch in bf16 -----------------------------------------------------


@pytest.mark.parametrize("arch", J_ARCH_NAMES)
def test_arch_serving_matches_jax_bf16(arch):
    """Prefill and 4 teacher-forced decode steps in bf16 within JAX's 0.15
    bound, caches after prefill too.  MoE: bf16 rounding differs between
    the packages, and a top-k decision at a near tie can flip; the port is
    handed JAX's top-k (``force_routing``) so every other part is held to
    the bound, and each place its own choice differs must be a near tie:
    JAX's logit gap at most twice the two runs' router-logit difference."""
    res = run_pair(arch, "bfloat16", force_routing=True)
    cfg = res["cfg"]
    if cfg.family == "moe":
        _, flips = routed_alike(res, cfg.top_k)
        for f in flips:
            assert f["gap"] <= 2 * f["dlogit"], f
    for c, (jl, tl) in enumerate(zip(res["j_logits"], res["t_logits"])):
        assert np.isfinite(tl).all()
        np.testing.assert_allclose(tl, jl, rtol=0.15, atol=0.15,
                                   err_msg=f"{arch} call {c}")
    for a, b in zip(jax.tree_util.tree_leaves(res["j_cache"]),
                    jax.tree_util.tree_leaves(res["t_cache"])):
        np.testing.assert_allclose(b, a, rtol=0.15, atol=0.15)


# --- flags, mesh, parameters --------------------------------------------------

SERVE_NEUTRAL = {"decode_unroll": True, "bf16_grad_activations": True,
                 "batch_over_model": True, "sharded_cache_update": True,
                 "moe_impl": "gspmd", "ce_chunk": 7}


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b"])
def test_lowering_flags_leave_serving_unchanged(arch):
    cfg = dataclasses.replace(TC.reduced_config(arch), dtype="float32")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_rng(16).integers(1, cfg.vocab_size, (2, 10))
                            .astype(np.int32))

    def run(c):
        caches = TM.init_cache(c, 2, 12)
        lp, caches = TM.make_prefill_step(c)(model, caches, {"tokens": toks})
        ld, _ = TM.make_serve_step(c)(model, caches, {"tokens": toks[:, :1]}, 10)
        return lp, ld

    base = run(cfg)
    for flag, value in SERVE_NEUTRAL.items():
        got = run(dataclasses.replace(cfg, **{flag: value}))
        assert all(torch.equal(a, b) for a, b in zip(base, got)), flag


def test_ssd_bf16_is_honoured_like_jax():
    res = run_pair("mamba2-1.3b", "float32", ssd_bf16=True)
    for jl, tl in zip(res["j_logits"], res["t_logits"]):
        np.testing.assert_allclose(tl, jl, rtol=1e-2, atol=1e-2)
    plain = run_pair("mamba2-1.3b", "float32")
    assert np.abs(plain["t_logits"][0] - res["t_logits"][0]).max() > 1e-4


def test_mesh_raises_naming_the_roadmap():
    """A mesh that is not a ``ProcessGrid`` raises, naming the class that
    is the port's counterpart of a JAX mesh (the mesh paths themselves are
    held to JAX in ``tests/test_torch_mesh_models.py``)."""
    cfg = TC.reduced_config("qwen3-4b")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    caches = TM.init_cache(cfg, 1, 4)
    batch = {"tokens": torch.ones(1, 2, dtype=torch.int32)}
    for call in (lambda: TM.forward(model, batch, cfg, mesh=object()),
                 lambda: TM.make_serve_step(cfg, mesh=object())(
                     model, caches, batch, 0),
                 lambda: TM.make_prefill_step(cfg, mesh=object())(
                     model, caches, batch),
                 lambda: TM.init_cache(cfg, 1, 4, mesh=object())):
        with pytest.raises(TypeError, match="ProcessGrid"):
            call()


def test_parameters_are_stored_in_the_dtype_of_use():
    model = TM.LanguageModel(TC.get_config("hymba-1.5b"), device="meta")
    f32 = {n for n, p in model.named_parameters() if p.dtype == torch.float32}
    bf16 = {n for n, p in model.named_parameters() if p.dtype == torch.bfloat16}
    assert f32 | bf16 == {n for n, _ in model.named_parameters()}
    leaf = {n.rsplit(".", 1)[-1] for n in f32}
    assert leaf == {"final_norm", "ln1", "ln2", "q_norm", "k_norm", "bnorm_a",
                    "bnorm_s", "norm", "dt_bias", "a_log"} - {"q_norm", "k_norm"}
    assert {n.rsplit(".", 1)[-1] for n in bf16} == {
        "embed", "unembed", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
        "in_proj", "out_proj", "conv_w", "conv_b", "d_skip"}
    moe = TM.LanguageModel(TC.get_config("qwen2-moe-a2.7b"), device="meta")
    names = dict(moe.named_parameters())
    assert names["slots.0.3.moe.router"].dtype == torch.float32
    assert names["slots.0.3.moe.w_up"].dtype == torch.bfloat16
    assert names["embed"].dtype == torch.bfloat16


def test_converter_is_a_table_of_jax_paths():
    jcfg, tcfg, params, model = _carried("gemma3-4b")
    names = dict(model.named_parameters())
    assert torch.equal(names["slots.0.5.attn.wq"],
                       torch.from_numpy(np.array(params["slots"][0]["attn"]["wq"][5])))
    assert torch.equal(names["unembed"], torch.from_numpy(np.array(params["unembed"])))
    tree = jax.tree.map(np.asarray, params)
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="no parameter"):
        lm_params_from_numpy(tree, tcfg)


# --- configs and shapes ---------------------------------------------------------


@pytest.mark.parametrize("arch", J_ARCH_NAMES)
def test_configs_and_param_counts_equal_jax(arch):
    assert TC.ARCH_NAMES == J_ARCH_NAMES and TC.ALL_NAMES == J_ALL_NAMES
    for get, jget in ((TC.get_config, j_get_config),
                      (TC.reduced_config, j_reduced_config)):
        port, ref = get(arch), jget(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert lm_config_from_dict(dataclasses.asdict(ref)) == port
        for prop in ("head_dim", "vocab_padded", "n_experts_padded", "period",
                     "n_periods"):
            assert getattr(port, prop) == getattr(ref, prop), prop
        assert [port.slot_kind(s) for s in range(port.period)] == [
            ref.slot_kind(s) for s in range(ref.period)]
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        # stored elements: the port's model against JAX's tree of shapes
        shapes = jax.eval_shape(lambda: JM.init_params(ref, jax.random.PRNGKey(0)))
        n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        assert TL.param_count(TM.LanguageModel(port, device="meta")) == n_jax
    if arch == "qwen3-4b":
        full = TC.get_config(arch)
        assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
                full.head_dim, full.d_ff, full.vocab_padded) == (
            36, 2560, 32, 8, 128, 9728, 152064)
        assert round(full.param_count() / 1e9, 3) == 4.411


def test_shapes_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in t_shapes.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_shapes.SHAPES.items()}
    assert t_shapes.LONG_CONTEXT_ARCHS == j_shapes.LONG_CONTEXT_ARCHS
    for arch in J_ALL_NAMES:
        for shape in j_shapes.SHAPES:
            assert t_shapes.runs_cell(arch, shape) == j_shapes.runs_cell(arch, shape)


def _spec_tree(x):
    if isinstance(x, dict):
        return {k: _spec_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_spec_tree(v) for v in x]
    return (tuple(x.shape), str(x.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", ["qwen3-4b", "hymba-1.5b", "musicgen-large",
                                  "mamba2-1.3b"])
def test_batch_and_cache_specs_equal_jax(arch):
    port, ref = TC.get_config(arch), j_get_config(arch)
    for name, shape in t_shapes.SHAPES.items():
        tb = t_shapes.batch_specs(port, shape)
        assert all(v.device.type == "meta" for v in tb.values())
        assert _spec_tree(tb) == _spec_tree(j_shapes.batch_specs(ref, j_shapes.SHAPES[name]))
        if shape.kind == "decode":
            tcs = t_shapes.cache_specs(port, shape)
            assert _spec_tree(tcs) == _spec_tree(
                j_shapes.cache_specs(ref, j_shapes.SHAPES[name]))
