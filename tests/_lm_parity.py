"""Serving runs of one LM arch in both packages on the same inputs, for the
port's parity tests.

``run_pair`` builds JAX's parameters from ``PRNGKey(0)``, carries them into
the port with ``lm_params_from_numpy``, and runs JAX's jitted
``make_prefill_step``/``make_serve_step`` and the port's on the same prompt
(drawn with numpy from a seed) and the same teacher-forced decode tokens.
Both runs record, for every MoE layer of every call, the router's input and
the routing (top-k experts in order and which assignments the capacity
keeps).  In bf16 the two runs' router inputs differ by rounding, and a
top-k decision at a near tie can flip, which changes a token's output by
far more than rounding; ``force_routing=True`` hands the port JAX's top-k
experts (the port's own softmax weights at them) so the rest of the forward
is compared at JAX's bound, and records the port's own choice beside it so
that every flip can be held to be a near tie.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.moe as j_moe
import repro_torch.models.moe as t_moe
from repro.configs import reduced_config as j_reduced_config
from repro.models import model as JM
from repro_torch.convert import lm_config_from_dict, lm_params_from_numpy
from repro_torch.launch.serve import step_input
from repro_torch.models import model as TM
from repro_torch.models.model import Moe

B, S, N_DECODE = 2, 40, 4


def jax_keep(idx: np.ndarray, n_experts: int, capacity: int) -> np.ndarray:
    """JAX's capacity rule on (T, K) routing, flat (token, k) order."""
    flat = idx.reshape(-1)
    pos = np.cumsum(np.eye(n_experts, dtype=np.int64)[flat], axis=0) - 1
    return pos[np.arange(flat.size), flat] < capacity


def inputs(cfg, seed: int = 1):
    """Prompt (B, S) and teacher-forced decode tokens (B, N_DECODE), and for
    the embed frontend the prompt embeddings (f64, cast by each side)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S + N_DECODE)).astype(np.int32)
    emb = (rng.normal(0, 1, (B, S, cfg.d_model))
           if cfg.frontend == "embed" else None)
    return toks, emb


def _tree_np(x):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), x)


def _torch_np(x):
    if isinstance(x, dict):
        return {k: _torch_np(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_torch_np(v) for v in x]
    return x.float().numpy().copy()


def run_pair(arch: str, dtype: str, seed: int = 1, force_routing: bool = False,
             **overrides) -> Dict[str, object]:
    """Both packages' logits (one (B, V) array a call: prefill, then each
    decode step), caches after prefill, and MoE routing records, for
    ``reduced(arch)`` in ``dtype`` with ``overrides`` of its fields."""
    jcfg = dataclasses.replace(j_reduced_config(arch), dtype=dtype,
                               **overrides)
    tcfg = lm_config_from_dict(dataclasses.asdict(jcfg))
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg)
    toks, emb = inputs(jcfg, seed)
    max_len = S + N_DECODE + 2

    # JAX: router inputs and top-k, captured in layer order by a callback
    j_routes: List = []
    orig = j_moe.router_topk

    def capturing_topk(x, w_router, n_real, top_k):
        w, idx = orig(x, w_router, n_real, top_k)
        jax.debug.callback(
            lambda xv, iv: j_routes.append((np.asarray(xv, np.float32),
                                            np.asarray(iv))),
            x.astype(jnp.float32), idx, ordered=True)
        return w, idx

    j_moe.router_topk = capturing_topk
    try:
        if emb is None:
            jp = {"tokens": jnp.asarray(toks[:, :S])}

            def jstep_in(t):
                return {"tokens": jnp.asarray(t)}
        else:
            jp = {"embeddings": jnp.asarray(emb, jnp.bfloat16)}

            def jstep_in(t):
                return {"embeddings": params["unembed"].T[jnp.asarray(t)]
                        .astype(jnp.bfloat16)}
        jc = JM.init_cache(jcfg, B, max_len)
        jl, jc = jax.jit(JM.make_prefill_step(jcfg))(params, jc, jp)
        j_logits = [np.asarray(jl)]
        jax.effects_barrier()
        j_calls = [len(j_routes)]
        j_cache = _tree_np(jc)
        step = jax.jit(JM.make_serve_step(jcfg))
        for i in range(N_DECODE):
            jl, jc = step(params, jc, jstep_in(toks[:, S + i:S + i + 1]),
                          jnp.int32(S + i))
            j_logits.append(np.asarray(jl))
            jax.effects_barrier()
            j_calls.append(len(j_routes))
        jax.effects_barrier()
    finally:
        j_moe.router_topk = orig

    # the port: its own top-k (and JAX's, when forced) at every MoE layer
    t_routes: List = []
    t_orig = t_moe.router_topk
    queue = list(j_routes)

    def port_topk(x, w_router, n_real, top_k):
        w, idx = t_orig(x, w_router, n_real, top_k)
        t_routes.append((x.float().numpy().copy(), idx.numpy().copy()))
        if force_routing:
            idx = torch.from_numpy(np.array(queue.pop(0)[1])).long()
            logits = torch.matmul(x.float(), w_router.float())
            w = torch.softmax(torch.gather(logits, 1, idx), dim=-1)
        return w, idx

    t_moe.router_topk = port_topk
    tp = ({"tokens": torch.from_numpy(toks[:, :S])} if emb is None
          else {"embeddings": torch.from_numpy(emb).to(torch.bfloat16)})

    def tstep_in(t):  # serve's decode input: ids, or unembed.T[tok] in bf16
        return step_input(tcfg, model, torch.from_numpy(t))
    tc = TM.init_cache(tcfg, B, max_len)
    try:
        tl, tc = TM.make_prefill_step(tcfg)(model, tc, tp)
    except BaseException:
        t_moe.router_topk = t_orig
        raise
    t_logits, t_calls = [tl.numpy().copy()], [len(t_routes)]
    t_cache = _torch_np(tc)
    tstep = TM.make_serve_step(tcfg)
    try:
        for i in range(N_DECODE):
            tl, tc = tstep(model, tc, tstep_in(toks[:, S + i:S + i + 1]), S + i)
            t_logits.append(tl.numpy().copy())
            t_calls.append(len(t_routes))
    finally:
        t_moe.router_topk = t_orig

    routing = []  # per call: list over MoE layers of a record
    if tcfg.family == "moe":
        e = tcfg.n_experts_padded
        router = [m.router.numpy().astype(np.float64)
                  for m in model.modules() if isinstance(m, Moe)]
        lo_j = lo_t = 0
        for c in range(N_DECODE + 1):
            recs = []
            for li, ((xj, ij), (xt, it)) in enumerate(zip(
                    j_routes[lo_j:j_calls[c]], t_routes[lo_t:t_calls[c]])):
                cap = t_moe.moe_capacity(ij.shape[0], tcfg.top_k, e)
                lj = xj.astype(np.float64) @ router[li % len(router)]
                lt = xt.astype(np.float64) @ router[li % len(router)]
                recs.append({
                    "idx_j": ij, "keep_j": jax_keep(ij, e, cap),
                    "idx_t": it, "keep_t": jax_keep(it, e, cap),
                    "logits_j": lj[:, :tcfg.n_experts],
                    "dlogit": np.abs(lj - lt)[:, :tcfg.n_experts].max(-1),
                })
            routing.append(recs)
            lo_j, lo_t = j_calls[c], t_calls[c]
        assert lo_j == len(j_routes) and lo_t == len(t_routes)
    return {"cfg": tcfg, "j_logits": j_logits, "t_logits": t_logits,
            "j_cache": j_cache, "t_cache": t_cache, "routing": routing}


def routed_alike(res, top_k: int):
    """Rows (per call, cumulative) whose tokens the two runs routed alike in
    every MoE layer so far, and the flips found: each a token whose top-k
    differs, with its JAX logit gap and the router-logit difference between
    the runs.  A flip is explained when the gap is at most twice the
    difference: the runs' inputs differ enough to reorder those experts."""
    alike = np.ones(B, bool)
    per_call, flips = [], []
    for c, recs in enumerate(res["routing"]):
        for li, rec in enumerate(recs):
            t = rec["idx_j"].shape[0]
            s_ = t // B
            k = rec["idx_j"].shape[1]
            diff_idx = (rec["idx_j"] != rec["idx_t"]).any(-1)
            diff_keep = (rec["keep_j"] != rec["keep_t"]).reshape(t, k).any(-1)
            for tok in np.nonzero(diff_idx)[0]:
                top = np.sort(rec["logits_j"][tok])[::-1][:top_k + 1]
                gap = float(np.min(top[:-1] - top[1:]))
                flips.append({"call": c, "layer": li, "token": int(tok),
                              "gap": gap, "dlogit": float(rec["dlogit"][tok])})
            assert diff_idx.any() or not diff_keep.any(), (
                f"call {c} layer {li}: the capacity keeps other assignments "
                "with the same top-k")
            bad = (diff_idx | diff_keep).reshape(B, s_).any(-1)
            alike &= ~bad
        per_call.append(alike.copy())
    return per_call, flips
