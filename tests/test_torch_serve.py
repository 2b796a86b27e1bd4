"""The port's serving path against JAX's: every LM arch at ``reduced()``,
prefill and teacher-forced decode steps in f32 (logits within atol = rtol
= 1e-4, equal greedy tokens, equal caches), and the serve entry point
(``python -m repro_torch.launch.serve``): greedy tokens equal to JAX's
loop on carried parameters, ``--device cpu --reduced`` serving, and the
default device raising without a card.

JAX runs on the CPU; parameters cross with ``lm_params_from_numpy``; the
inputs are drawn with numpy from a seed (``tests/_lm_parity.py``)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import reduced_config as j_reduced_config
from repro.models import model as JM
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import lm_config_from_dict, lm_params_from_numpy
from repro_torch.launch import serve as SV

from _lm_parity import routed_alike, run_pair

REPO = Path(__file__).resolve().parent.parent
F32_TOL = 1e-4


@pytest.mark.parametrize("arch", J_ARCH_NAMES)
def test_arch_serving_matches_jax_f32(arch):
    res = run_pair(arch, "float32")
    cfg = res["cfg"]
    for c, (jl, tl) in enumerate(zip(res["j_logits"], res["t_logits"])):
        assert tl.dtype == np.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=f"{arch} call {c}")
        assert np.array_equal(tl.argmax(-1), jl.argmax(-1)), f"{arch} call {c}"
    flat_j = jax.tree_util.tree_leaves(res["j_cache"])
    flat_t = jax.tree_util.tree_leaves(res["t_cache"])
    assert len(flat_j) == len(flat_t) > 0
    for a, b in zip(flat_j, flat_t):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=F32_TOL, atol=F32_TOL)
    if cfg.family == "moe":
        per_call, flips = routed_alike(res, cfg.top_k)
        assert flips == [] and per_call[-1].all()


def _jax_greedy(jcfg, params, prompt, gen):
    """JAX serve's loop (``repro.launch.serve.main``) on given params."""
    caches = JM.init_cache(jcfg, prompt.shape[0], prompt.shape[1] + gen)
    logits, caches = jax.jit(JM.make_prefill_step(jcfg))(
        params, caches, {"tokens": jnp.asarray(prompt)})
    step = jax.jit(JM.make_serve_step(jcfg))
    toks = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for i in range(gen - 1):
        logits, caches = step(params, caches, {"tokens": toks[-1][:, None]},
                              jnp.int32(prompt.shape[1] + i))
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    return np.asarray(jnp.stack(toks, 1))


@pytest.mark.parametrize("arch", ["qwen3-4b", "hymba-1.5b"])
def test_serve_matches_jax_greedy_on_carried_params(arch):
    jcfg = dataclasses.replace(j_reduced_config(arch), dtype="float32")
    tcfg = lm_config_from_dict(dataclasses.asdict(jcfg))
    params = JM.init_params(jcfg, jax.random.PRNGKey(3))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg)
    prompt = SV.make_prompt(tcfg, 3, 24, seed=5)
    # the port's prompt is the one JAX serve draws for the same seed
    rng = np.random.default_rng(5)
    assert np.array_equal(prompt["tokens"].numpy(),
                          rng.integers(1, jcfg.vocab_size, (3, 24)))
    res = SV.serve(tcfg, model, prompt, gen=12)
    ref = _jax_greedy(jcfg, params, prompt["tokens"].numpy(), 12)
    assert res.tokens.dtype == torch.int32 and res.tokens.shape == (3, 12)
    assert np.array_equal(res.tokens.numpy(), ref)
    assert res.decode_steps == 11 and res.peak_bytes is None


def test_embed_prompt_is_jax_serves():
    cfg = get_config("musicgen-large")
    p = SV.make_prompt(cfg, 2, 3, seed=7)["embeddings"]
    ref = jnp.asarray(np.random.default_rng(7).normal(0, 1, (2, 3, cfg.d_model)),
                      jnp.bfloat16)
    assert p.dtype == torch.bfloat16
    assert np.array_equal(p.float().numpy(), np.asarray(ref, np.float32))


def test_embed_decode_input_is_bf16_unembed_row():
    """The embed frontend's decode input is ``unembed.T[tok]`` cast to bf16
    (JAX serve's), also for an f32 config."""
    jcfg = dataclasses.replace(j_reduced_config("internvl2-26b"), dtype="float32")
    tcfg = lm_config_from_dict(dataclasses.asdict(jcfg))
    params = JM.init_params(jcfg, jax.random.PRNGKey(4))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg)
    tok = np.array([[3], [250]], np.int32)
    got = SV.step_input(tcfg, model, torch.from_numpy(tok))["embeddings"]
    ref = params["unembed"].T[jnp.asarray(tok)].astype(jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, jcfg.d_model)
    assert np.array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("arch", ["qwen3-4b", "musicgen-large"])
def test_serve_main_on_cpu(arch):
    out = SV.main(["--arch", arch, "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "8", "--gen", "5"])
    assert out.shape == (2, 5) and out.dtype == torch.int32
    cfg = reduced_config(arch)
    assert bool(((out >= 0) & (out < cfg.vocab_padded)).all())


def test_serve_default_device_raises_without_cuda():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced"],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO))
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert "prefill" not in r.stdout
