"""The language models' mesh paths of the port on gloo ranks, against JAX.

* All ten archs at ``reduced()`` in f32 on a 2×2 ``("data", "model")``
  grid (4 ranks, FSDP on), against JAX without a mesh (the values GSPMD
  leaves unchanged): the loss within 1e-5 relative and every gathered
  gradient within 1e-4 of its leaf's max |g| (the single-device
  tolerances of ``tests/test_torch_train.py``); prefill plus 4
  teacher-forced decode steps with the caches' sequence sharded over
  ``"model"`` (split-KV decode, ``sharded_cache_update`` off and on):
  logits within 1e-4 and the same greedy tokens.  The MoE archs run
  ``moe_impl="gspmd"`` here: JAX's ``moe_ffn_shardmap`` takes capacity
  from the local token block, so its results differ from JAX's own
  single-device path by design; it is held to JAX's shard_map below.
* qwen3 the same way on a ``(2, 1, 2)`` ``("pod", "data", "model")`` grid.
* The stream's layout: a rank's block input is ``(B/n_dp, S/tp, D)``
  for the attention archs (sequence parallelism) and ``(B/n_dp, S, D)``
  for SSM/hybrid.
* The shard_map bodies (``decode_attention_sharded`` with the window off
  and on, ``cache_update_sharded`` exactly, ``moe_ffn_shardmap`` in f32
  within 1e-5, the vocab-parallel ``chunked_ce_loss`` and its gradients)
  against JAX's shard_map on 4 host devices (JAX in a subprocess).
* Three ``build_train_step(mesh=)`` steps on 2×2 against the one-rank
  steps on the same global batches (loss and grad norm within 1e-5);
  ``reshard_state`` from 2×2 onto 4×1 (bit-equal logical parameters and
  moments, step kept); a checkpoint of the 2×2 state resumed on 4×1
  reaching the straight run's final loss.

Each multi-rank job spawns its grid once and loops over the archs inside.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCH_NAMES
from repro.configs import reduced_config as j_reduced_config
from repro.models import model as JM
from repro_torch.core.grid import AXES, POD_AXES

from _dist_helpers import run_with_devices
from _torch_dist import run_ranks

pytestmark = pytest.mark.dist

B, S, N_DECODE, CE_CHUNK = 4, 24, 4, 16  # S is not a multiple of the chunk
MAX_LEN = S + N_DECODE + 4
F32_LOSS, F32_LEAF, F32_LOGITS = 1e-5, 1e-4, 1e-4
MOE = {"qwen2-moe-a2.7b", "granite-moe-1b-a400m"}


def _jcfg(arch):
    over = {"moe_impl": "gspmd"} if arch in MOE else {}
    return dataclasses.replace(j_reduced_config(arch), dtype="float32",
                               ce_chunk=CE_CHUNK, **over)


def _np(x):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), x)


def _case(arch, seed=3):
    """JAX's parameters, batch and serving inputs of ``arch``, and JAX's
    loss, gradients and logits without a mesh."""
    cfg = _jcfg(arch)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.1] = -1
    toks = rng.integers(1, cfg.vocab_size, (B, S + N_DECODE)).astype(np.int32)
    if cfg.frontend == "token":
        prompt = {"tokens": toks[:, :S]}
        decode = [{"tokens": toks[:, S + i:S + i + 1]} for i in range(N_DECODE)]
    else:
        prompt = {"embeddings": rng.normal(0, 1, (B, S, cfg.d_model))
                  .astype(np.float32)}
        unemb_t = np.asarray(params["unembed"]).T
        decode = [{"embeddings": unemb_t[toks[:, S + i:S + i + 1]]}
                  for i in range(N_DECODE)]
    batch = {**prompt, "labels": labels}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jb, cfg)))(params)
    caches = JM.init_cache(cfg, B, MAX_LEN)
    lg, caches = jax.jit(JM.make_prefill_step(cfg))(
        params, caches, {k: jnp.asarray(v) for k, v in prompt.items()})
    logits = [np.asarray(lg)]
    step = jax.jit(JM.make_serve_step(cfg))
    for i, d in enumerate(decode):
        lg, caches = step(params, caches,
                          {k: jnp.asarray(v) for k, v in d.items()},
                          jnp.int32(S + i))
        logits.append(np.asarray(lg))
    port = {"name": arch, "cfg": dataclasses.asdict(cfg), "params": _np(params),
            "batch": batch, "prompt": prompt, "decode": decode,
            "max_len": MAX_LEN, "pos0": S}
    ref = {"loss": float(loss), "grads": _np(grads), "logits": logits,
           "cfg": cfg}
    return port, ref


@pytest.fixture(scope="module")
def cases():
    return {arch: _case(arch) for arch in ARCH_NAMES}


@pytest.fixture(scope="module")
def grid22(cases, tmp_path_factory):
    outs = run_ranks(4, "job_lm_mesh", {
        "grid": ((2, 2), AXES), "cases": [c[0] for c in cases.values()]},
        tmp_path_factory.mktemp("lm22"))
    return outs


@pytest.fixture(scope="module")
def grid_pod(cases, tmp_path_factory):
    return run_ranks(4, "job_lm_mesh", {
        "grid": ((2, 1, 2), POD_AXES), "cases": [cases["qwen3-4b"][0]]},
        tmp_path_factory.mktemp("lmpod"))


def _grad_leaf(tree, name):
    from repro_torch.convert import _jax_leaf

    return np.asarray(_jax_leaf(tree, name))


def _check_train(outs, ref):
    for out in outs:  # every rank holds the same loss and gathered grads
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=F32_LOSS)
    for name, got in outs[0]["grads"].items():
        want = _grad_leaf(ref["grads"], name)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max()) / scale
        assert err <= F32_LEAF, f"{name}: {err:.2e} of the leaf's max"


def _check_serve(outs, ref):
    for scu in (False, True):
        for out in outs:
            lo, n = out["rows"]
            for c, (got, want) in enumerate(zip(out[f"logits_scu{scu}"],
                                                ref["logits"])):
                want = want[lo:lo + n]
                np.testing.assert_allclose(got, want, atol=F32_LOGITS,
                                           rtol=0, err_msg=f"call {c}")
                np.testing.assert_array_equal(got.argmax(-1),
                                              want.argmax(-1))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_grads_on_2x2_match_jax(grid22, cases, arch):
    _check_train([o[arch] for o in grid22], cases[arch][1])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_prefill_and_decode_on_2x2_match_jax(grid22, cases, arch):
    _check_serve([o[arch] for o in grid22], cases[arch][1])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_stream_layout_on_2x2(grid22, cases, arch):
    cfg = cases[arch][1]["cfg"]
    seq = S if cfg.family in ("ssm", "hybrid") else S // 2
    assert grid22[0][arch]["block_input_shapes"] == [(B // 2, seq, cfg.d_model)]


def test_qwen3_on_the_pod_grid(grid_pod, cases):
    ref = cases["qwen3-4b"][1]
    outs = [o["qwen3-4b"] for o in grid_pod]
    _check_train(outs, ref)
    _check_serve(outs, ref)
    assert outs[0]["block_input_shapes"] == [(B // 2, S // 2, 64)]


# --- the shard_map bodies against JAX's, 4 host devices -----------------------

JAX_SHARDMAP = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_test_mesh
from repro.models import attention as A
from repro.models.model import ModelConfig, chunked_ce_loss
from repro.models.moe import moe_ffn_shardmap

inp = pickle.load(open(sys.argv[1], "rb"))
a = {k: jnp.asarray(v) for k, v in inp["arrays"].items()}
mesh = make_test_mesh((2, 2), ("data", "model"))
out = {}
for w in (None, inp["window"]):
    out[f"decode_{w}"] = np.asarray(A.decode_attention_sharded(
        a["q"], a["kc"], a["vc"], a["cur"], mesh=mesh, window=w))
for pos in inp["positions"]:
    k2, v2 = A.cache_update_sharded(a["kc"], a["vc"], a["kn"], a["vn"],
                                    jnp.int32(pos), mesh=mesh)
    out[f"update_{pos}"] = (np.asarray(k2), np.asarray(v2))
p = {n: a[n] for n in ("router", "w_gate", "w_up", "w_down")}
out["moe"] = np.asarray(moe_ffn_shardmap(
    a["x_moe"], p, mesh=mesh, n_experts_real=inp["n_real"],
    top_k=inp["top_k"], token_axes=("data",)))
cfg = ModelConfig(**inp["cfg"])
loss, (gx, gw) = jax.value_and_grad(
    lambda x, w: chunked_ce_loss(x, a["labels"], w, cfg, mesh=mesh),
    argnums=(0, 1))(a["x_ce"], a["w_ce"])
out["ce"] = (float(loss), np.asarray(gx), np.asarray(gw))
pickle.dump(out, open(sys.argv[2], "wb"))
print("OK")
"""


@pytest.fixture(scope="module")
def shardmap_inputs():
    rng = np.random.default_rng(7)
    b, s, hq, hkv, d = 4, 32, 4, 2, 16
    e, dm, f, t = 16, 32, 24, 64
    cfg = dataclasses.replace(_jcfg("qwen3-4b"), ce_chunk=8)

    def n(*shape, scale=1.0):
        return (rng.normal(0, scale, shape)).astype(np.float32)

    w_gate = n(e, dm, f, scale=dm ** -0.5)
    w_gate[12:] = 0.0  # padded experts: 12 real of 16
    labels = rng.integers(0, cfg.vocab_size, (4, 20)).astype(np.int32)
    labels[rng.random((4, 20)) < 0.1] = -1
    arrays = {
        "q": n(b, 1, hq, d), "kc": n(b, s, hkv, d), "vc": n(b, s, hkv, d),
        "cur": np.array([3, 17, 32, 9], np.int32),
        "kn": n(b, 1, hkv, d), "vn": n(b, 1, hkv, d),
        "router": n(dm, e, scale=dm ** -0.5), "w_gate": w_gate,
        "w_up": n(e, dm, f, scale=dm ** -0.5),
        "w_down": n(e, f, dm, scale=f ** -0.5), "x_moe": n(t, dm),
        "x_ce": n(4, 20, cfg.d_model), "labels": labels,
        "w_ce": n(cfg.d_model, cfg.vocab_padded, scale=cfg.d_model ** -0.5),
    }
    return {"arrays": arrays, "window": 7, "positions": [0, 15, 16, 31],
            "n_real": 12, "top_k": 2, "cfg": dataclasses.asdict(cfg)}


@pytest.fixture(scope="module")
def jax_shardmap(shardmap_inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jaxsm")
    src, dst = tmp / "in.pkl", tmp / "out.pkl"
    with open(src, "wb") as f:
        pickle.dump(shardmap_inputs, f)
    run_with_devices(JAX_SHARDMAP.replace("sys.argv[1]", repr(str(src)))
                     .replace("sys.argv[2]", repr(str(dst))), n_devices=4)
    with open(dst, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port_shardmap(shardmap_inputs, tmp_path_factory):
    return run_ranks(4, "job_lm_shardmap", shardmap_inputs,
                     tmp_path_factory.mktemp("portsm"))


@pytest.mark.parametrize("window", [None, 7])
def test_decode_attention_sharded_matches_jax(jax_shardmap, port_shardmap,
                                              window):
    for out in port_shardmap:
        np.testing.assert_allclose(out[f"decode_{window}"],
                                   jax_shardmap[f"decode_{window}"],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pos", [0, 15, 16, 31])
def test_cache_update_sharded_matches_jax_exactly(jax_shardmap, port_shardmap,
                                                  pos):
    for out in port_shardmap:
        for got, want in zip(out[f"update_{pos}"], jax_shardmap[f"update_{pos}"]):
            np.testing.assert_array_equal(got, want)


def test_moe_ffn_shardmap_matches_jax(jax_shardmap, port_shardmap):
    want = jax_shardmap["moe"]
    assert np.abs(want).max() > 0
    for out in port_shardmap:
        np.testing.assert_allclose(out["moe"], want, atol=1e-5, rtol=1e-5)


def test_vocab_parallel_ce_matches_jax(jax_shardmap, port_shardmap):
    loss, gx, gw = jax_shardmap["ce"]
    for out in port_shardmap:
        got_loss, got_gx, got_gw = out["ce"]
        np.testing.assert_allclose(got_loss, loss, rtol=F32_LOSS)
        for got, want in ((got_gx, gx), (got_gw, gw)):
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= F32_LEAF, err


# --- training, elastic resharding and resume ----------------------------------


@pytest.fixture(scope="module")
def train_resume(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    outs = run_ranks(4, "job_lm_train_resume", {
        "arch": "qwen3-4b", "dtype": "float32", "steps": 5, "seq": 16,
        "ckpt": str(tmp / "ckpt")}, tmp)
    return outs


def test_three_train_steps_on_2x2_match_one_rank(train_resume):
    for out in train_resume:
        for (l0, g0), (l1, g1) in zip(out["ref"], out["grid"]):
            np.testing.assert_allclose(l1, l0, rtol=F32_LOSS)
            np.testing.assert_allclose(g1, g0, rtol=F32_LOSS)


def test_reshard_2x2_to_4x1_is_bit_equal(train_resume):
    for out in train_resume:
        assert out["reshard_equal"] and out["reshard_moments_equal"]
        assert out["reshard_step"] == 3
    # on 4x1 with FSDP the big matrices are split four ways over "data"
    shapes = train_resume[0]["local_shapes"]
    assert shapes["slots.0.0.attn.wq"] == (16, 64)
    assert shapes["embed"] == (256, 64)  # vocab over a model axis of 1


def test_checkpoint_on_2x2_resumes_on_4x1(train_resume):
    for out in train_resume:
        np.testing.assert_allclose(out["resumed_final"], out["straight_final"],
                                   rtol=F32_LOSS)


# --- scripts/lm_grid_nccl.py on gloo ranks: the four-card runs' references ---

GRID_SCRIPT_ARCHS = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "mamba2-1.3b",
                     "hymba-1.5b")


@pytest.fixture(scope="module")
def grid_script(tmp_path_factory):
    """``scripts/lm_grid_nccl.py --backend gloo --device cpu --reduced`` on
    the archs it runs beside qwen3-4b, and its resume of qwen3-4b: its
    JSON lines by kind, and its exit code."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ck = tmp_path_factory.mktemp("grid_script") / "ckpt"
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "scripts", "lm_grid_nccl.py"),
         "--backend", "gloo", "--device", "cpu", "--reduced", "--seq", "64",
         "--arch", *GRID_SCRIPT_ARCHS, "--resume", "qwen3-4b",
         "--ckpt-dir", str(ck)],
        capture_output=True, text=True, timeout=900, cwd=root)
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    return {"rc": proc.returncode, "stderr": proc.stderr[-4000:],
            "refs": {x["arch"]: x for x in lines if "reference" in x},
            "grids": {(x["arch"], x["grid"]): x for x in lines if "grid" in x},
            "resume": [x["resume"] for x in lines if "resume" in x],
            "ckpt_left": ck.exists()}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"])
def test_moe_shardmap_on_2x2_equals_per_rank_reference(grid_script, arch):
    """``moe_impl="shardmap"`` takes each expert's capacity from the data
    rank's own tokens, so its one-card reference runs each data-parallel
    rank's rows as a batch of their own: the 2×2 loss and grad norm equal
    it in f32 within 1e-5, and the bf16 tokens, with the reference's top-k
    handed to the grid, equal it up to near ties, the grid's own top-k
    differing only at router near ties.  With the reference's top-k handed
    to the grid, step 0 and the f32 prefill logits equal it too (1e-5,
    1e-4)."""
    assert grid_script["rc"] == 0, grid_script["stderr"]
    rec = grid_script["grids"][(arch, "2x2")]
    assert rec["overrides"] == {"moe_impl": "shardmap"}
    assert grid_script["refs"][arch]["reference"]["train_layers"] == 2
    for r in rec["ranks"]:
        tr, sv = r["train"], r["serve"]
        assert tr["loss_rel_diff"] <= F32_LOSS
        assert tr["grad_norm_rel_diff"] <= F32_LOSS
        forced = tr["forced_reference_top_k"]
        assert forced["loss_rel_diff"] <= F32_LOSS
        assert forced["grad_norm_rel_diff"] <= F32_LOSS
        assert tr["flips_are_router_ties"]
        assert sv["forced_reference_top_k"] and sv["flips_are_router_ties"]
        assert sv["tokens_agree_to_ties"] and sv["prefill_logits_within_0.15"]
        assert sv["prefill_bf16_within_card_error"]
        assert sv["prefill32_logits_max_abs_diff"] <= F32_LOGITS


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_archs_on_2x2_match_one_rank_with_and_without_batch_over_model(
        grid_script, arch):
    """Two rows a data-parallel rank, so that ``batch_over_model`` splits
    them over ``"model"``: both layouts' loss and grad norm within 1e-5 of
    one rank's; serving (caches, so no ``batch_over_model``) up to near
    ties, its f32 prefill logits within 1e-4."""
    assert grid_script["rc"] == 0, grid_script["stderr"]
    plain = grid_script["grids"][(arch, "2x2")]
    bom = grid_script["grids"][(arch, "2x2+batch_over_model")]
    assert plain["rows_per_dp_rank"] == 2
    assert bom["overrides"] == {"batch_over_model": True}
    for rec in (plain, bom):
        for r in rec["ranks"]:
            assert r["train"]["loss_rel_diff"] <= F32_LOSS
            assert r["train"]["grad_norm_rel_diff"] <= F32_LOSS
    assert all(r["serve"]["tokens_agree_to_ties"] for r in plain["ranks"])
    assert all(r["serve"]["prefill32_logits_max_abs_diff"] <= F32_LOGITS
               for r in plain["ranks"])
    assert all(r["serve"]["prefill_bf16_within_card_error"]
               for r in plain["ranks"])
    assert all("serve" not in r for r in bom["ranks"])


def test_grid_script_resumes_a_2x2_checkpoint_on_4x1(grid_script):
    """Saved on 2×2 after two steps, restored, resharded onto 4×1: the third
    step equals the straight third step within 1e-5; the checkpoint is
    removed after."""
    assert grid_script["rc"] == 0, grid_script["stderr"]
    (rec,) = grid_script["resume"]
    assert rec["arch"] == "qwen3-4b" and rec["step"] == 3
    assert rec["loss_rel_diff"] <= F32_LOSS
    assert rec["grad_norm_rel_diff"] <= F32_LOSS
    assert rec["checkpoint_bytes"] > rec["state_bytes"] > 0
    assert not grid_script["ckpt_left"]
