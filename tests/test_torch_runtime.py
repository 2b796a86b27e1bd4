"""The port's training services against JAX's, on the CPU: ``AdamW`` and
``cosine_schedule`` on random trees at every step, the data pipeline bit
for bit, checkpointing (round trip of the train state, keep policy, torn
``.tmp``, the asynchronous writer's snapshot), gradient compression
(``compress_ef`` bit for bit, ``wire_bytes``, ``reduce`` on two gloo
ranks), the straggler monitor on injected timings, and ``chip_smoke.py``
phase 8's bound and memory plan, and its control flow rehearsed on the
CPU.

Inputs are drawn with numpy from a seed.  AdamW and the schedule hold rtol
1e-6 (JAX's f32 ``pow`` and ``cos`` may differ from torch's in the last
bit, and the global norm sums in another order); everything else is exact.
"""

import importlib.util
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLMData as JData
from repro.data import TokenPacker as JPacker
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as j_cosine
from repro.runtime import CompressedAllReduce as JComp
from repro.runtime import StragglerMonitor as JMonitor
from repro.runtime.compression import int8_compress as j_int8
from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch import configs as TC
from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import SyntheticLMData, TokenPacker, as_tensors
from repro_torch.models import model as TM
from repro_torch.optim import AdamW, OptState, cosine_schedule
from repro_torch.runtime import CompressedAllReduce, StragglerMonitor
from repro_torch.runtime.compression import int8_compress

from _torch_dist import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"a": (7, 5), "b": (33,), "c": (2, 3, 4), "scale": (4,)}


def _tree(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


# --- optimizer ------------------------------------------------------------------


@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_matches_jax_at_every_step(clip_norm):
    """Six steps on a random tree with random gradients (large enough that
    clipping acts), lr from the cosine schedule: parameters, μ and ν after
    every step; weight decay reaches every leaf."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    kw = dict(weight_decay=0.1, clip_norm=clip_norm)
    jopt = JAdamW(learning_rate=j_cosine(0.05, 2, 6), **kw)
    topt = AdamW(learning_rate=cosine_schedule(0.05, 2, 6), **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = topt.init(tp)
    for step in range(6):
        g = _tree(rng, scale=3.0)
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                              jp, jnp.int32(step))
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        topt.update_({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
                     step)
        for k in SHAPES:
            for got, want in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]),
                              (ts.nu[k], js.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)
    assert not np.allclose(tp["scale"].numpy(), p0["scale"])


def test_adamw_init_is_f32_zeros_and_step_zero_moves_nothing_at_lr_zero():
    opt = AdamW(learning_rate=cosine_schedule(1.0, 10, 100))
    p = {"w": torch.ones(3, dtype=torch.float32)}
    st = opt.init(p)
    assert isinstance(st, OptState)
    assert st.mu["w"].dtype == torch.float32 and not st.mu["w"].any()
    opt.update_({"w": torch.ones(3)}, st, p, 0)  # warm-up: lr(0) = 0
    assert torch.equal(p["w"], torch.ones(3))
    assert st.mu["w"].any() and st.nu["w"].any()


def test_cosine_schedule_matches_jax_at_every_step():
    for args in ((3e-3, 10, 30), (1.0, 1, 5), (0.5, 0, 7, 0.2)):
        jlr, tlr = j_cosine(*args), cosine_schedule(*args)
        got = [float(tlr(s)) for s in range(args[2] + 3)]
        want = [float(jlr(s)) for s in range(args[2] + 3)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    lr = cosine_schedule(1.0, 10, 100)
    assert float(lr(0)) == 0.0 and abs(float(lr(100)) - 0.1) < 1e-6


# --- data -------------------------------------------------------------------


@pytest.mark.parametrize("frontend", ["token", "embed"])
def test_synthetic_data_is_jax_bit_for_bit(frontend):
    kw = dict(vocab_size=151936, batch_size=8, seq_len=64, seed=3,
              frontend=frontend, d_model=16)
    jd, td = JData(**kw), SyntheticLMData(**kw)
    for step, shard, n in ((0, 0, 1), (7, 1, 2), (123, 3, 4)):
        a, b = jd.batch_at(step, shard, n), td.batch_at(step, shard, n)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    it = td.iter_batches(start_step=5)
    assert np.array_equal(next(it)["labels"], jd.batch_at(5)["labels"])
    t = as_tensors(td.batch_at(0), "cpu")
    assert all(isinstance(v, torch.Tensor) for v in t.values())
    assert t["labels"].dtype == torch.int32


def test_token_packer_is_jax_bit_for_bit():
    rng = np.random.default_rng(4)
    docs = [rng.integers(1, 100, rng.integers(1, 30)) for _ in range(25)]
    for seq in (8, 16, 40):
        a, b = JPacker(seq, 0).pack(docs), TokenPacker(seq, 0).pack(docs)
        assert a.dtype == b.dtype and np.array_equal(a, b)


# --- checkpoint -----------------------------------------------------------------


def _state(seed=0):
    cfg = reduced_config("qwen3-4b")
    model = TM.init_params(cfg, torch.Generator().manual_seed(seed), train=True)
    opt = AdamW()
    st = opt.init(dict(model.named_parameters()))
    for t in st.mu.values():
        t.normal_(generator=torch.Generator().manual_seed(seed + 1))
    return cfg, (model, st, 7)


def _same_state(a, b):
    (ma, sa, ka), (mb, sb, kb) = a, b
    assert ka == kb
    for (na, pa), (nb, pb) in zip(ma.named_parameters(), mb.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    for x, y in ((sa.mu, sb.mu), (sa.nu, sb.nu)):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)


def test_checkpoint_round_trip_and_keep_policy(tmp_path):
    _, state = _state(0)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, state, meta={"arch": "qwen3-reduced"})
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path / "step_00000004")) == ["arrays.npz",
                                                             "meta.json"]
    _, other = _state(5)
    got, step = restore_latest(str(tmp_path), other)
    assert step == 4 and isinstance(got[1], OptState)
    _same_state(got, state)
    assert got[0] is other[0]  # filled in place
    # a bf16 tensor round-trips through f32 storage to its own dtype
    path = str(tmp_path / "bf16")
    x = torch.randn(5).to(torch.bfloat16)
    TCK.save_pytree(path, {"x": x})
    y = TCK.load_pytree(path, {"x": torch.zeros(5, dtype=torch.bfloat16)})["x"]
    assert y.dtype == torch.bfloat16 and torch.equal(x, y)


def test_checkpoint_torn_tmp_is_never_restored(tmp_path):
    os.makedirs(tmp_path / "step_00000007.tmp")
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    tree = {"x": torch.zeros(2)}
    mgr.save(3, tree)
    got, step = restore_latest(str(tmp_path), tree)
    assert step == 3
    assert restore_latest(str(tmp_path / "step_00000007.tmp"), tree) == (None, None)


def test_async_checkpoint_snapshots_before_the_writer_starts(tmp_path):
    """The state is copied to host when ``save`` returns: an in-place
    update right after (a train step) does not reach the file, even while
    the writer thread is held back."""
    _, state = _state(0)
    before = {n: p.detach().clone() for n, p in state[0].named_parameters()}
    gate = threading.Event()
    orig = TCK._write

    def held(*a, **k):
        assert gate.wait(10)
        return orig(*a, **k)

    TCK._write = held
    try:
        mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
        mgr.save(1, state)
        with torch.no_grad():
            for p in state[0].parameters():
                p.add_(1.0)
        gate.set()
        mgr.wait()
    finally:
        TCK._write = orig
    _, like = _state(9)
    got, step = restore_latest(str(tmp_path), like)
    assert step == 1
    for n, p in got[0].named_parameters():
        assert torch.equal(p, before[n]), n


# --- compression ----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compress_ef_is_jax_bit_for_bit(mode):
    """Five rounds of error feedback on the same gradients: the
    decompressed gradients and the residuals equal JAX's exactly."""
    rng = np.random.default_rng(5)
    jc, tc = JComp(mode=mode), CompressedAllReduce(mode=mode)
    params = _tree(rng)
    jerr = jc.init_error({k: jnp.asarray(v) for k, v in params.items()})
    terr = tc.init_error({k: torch.from_numpy(v) for k, v in params.items()})
    for _ in range(5):
        g = _tree(rng, scale=rng.uniform(0.01, 10))
        jd, jerr = jc.compress_ef({k: jnp.asarray(v) for k, v in g.items()}, jerr)
        td, terr = tc.compress_ef({k: torch.from_numpy(v) for k, v in g.items()},
                                  terr)
        for k in SHAPES:
            assert np.array_equal(td[k].numpy(), np.asarray(jd[k])), k
            if mode != "none":
                assert np.array_equal(terr[k].numpy(), np.asarray(jerr[k])), k
    assert tc.wire_bytes({k: torch.from_numpy(v) for k, v in params.items()}) \
        == jc.wire_bytes({k: jnp.asarray(v) for k, v in params.items()})


def test_int8_compress_is_jax_bit_for_bit():
    """Codes and scale, ties included (round half to even)."""
    rng = np.random.default_rng(6)
    x = rng.normal(0, 3, 1000).astype(np.float32)
    x[:4] = [127.0, -63.5, 0.5, 1.5]  # amax 127: scale ≈ 1, halves tie
    jq, js = j_int8(jnp.asarray(x))
    tq, ts = int8_compress(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)


def _jax_reduce(mode, per_rank):
    """JAX's ``reduce`` algebra on the ranks' gradients: pmean of f32 or
    bf16, or the int32 psum of int8 codes times the max scale over n."""
    n = len(per_rank)
    out = {}
    for k in per_rank[0]:
        gs = [jnp.asarray(r[k]) for r in per_rank]
        if mode == "none":
            out[k] = sum(gs) / n
        elif mode == "bf16":
            out[k] = (sum(g.astype(jnp.bfloat16) for g in gs) / n).astype(
                jnp.float32)
        else:
            qs = [j_int8(g) for g in gs]
            qsum = sum(q.astype(jnp.int32) for q, _ in qs)
            smax = jnp.max(jnp.stack([s for _, s in qs]))
            out[k] = qsum.astype(jnp.float32) * smax / n
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.mark.dist
def test_compressed_reduce_on_two_gloo_ranks(tmp_path):
    rng = np.random.default_rng(7)
    grads = [_tree(rng), _tree(rng, scale=5.0)]
    outs = run_ranks(2, "job_compressed_reduce", {"grads": grads}, tmp_path)
    for mode in ("none", "bf16", "int8"):
        want = _jax_reduce(mode, grads)
        for out in outs:
            for k in SHAPES:
                np.testing.assert_allclose(out[mode][k], want[k],
                                           rtol=1e-6 if mode == "none" else 0,
                                           atol=0, err_msg=f"{mode} {k}")
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    per = {"none": 4, "bf16": 2, "int8": 4 + 4}  # int8: int32 codes, f32 scales
    assert outs[0]["none_bytes"] == n * per["none"]
    assert outs[0]["bf16_bytes"] == n * per["bf16"]
    assert outs[0]["int8_bytes"] == n * 4 + 4 * len(SHAPES)


# --- straggler ----------------------------------------------------------------------


def test_straggler_flags_equal_jax_on_injected_timings():
    rng = np.random.default_rng(8)
    kw = dict(n_hosts=6, threshold=1.4, patience=2)
    jm, tm = JMonitor(**kw), StragglerMonitor(**kw)
    j_cb, t_cb = [], []
    jm.on_straggler, tm.on_straggler = j_cb.append, t_cb.append
    for step in range(40):
        times = rng.uniform(0.9, 1.1, 6)
        if 5 <= step < 20:
            times[2] *= 2.5  # host 2 slows down, then recovers
        if step >= 25:
            times[4] *= 1.8
        for h, t in enumerate(times):
            jm.report(h, float(t))
            tm.report(h, float(t))
        assert tm.evaluate() == jm.evaluate()
        assert tm.flagged == jm.flagged
    assert t_cb == j_cb and 2 in t_cb and 4 in t_cb
    assert tm.history == jm.history
    assert tm.reassign_data_shards(5) == [(5, 0)]


# --- the card's training phase, rehearsed -------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_bound_and_memory_plan_of_qwen3_4b():
    """``chip_smoke.py`` phase 8a's arithmetic at full size: 6·N·T plus the
    causal attention products at 989 TFLOP/s and 28 B a stored parameter
    at 3.35 TB/s; the plan's f32 state is 16 B a stored parameter and its
    reckoned peak stays under the card's 80 GB."""
    cs = _chip_smoke()
    cfg = get_config("qwen3-4b")
    n = TM.LanguageModel(cfg, device="meta")
    n_stored = sum(p.numel() for p in n.parameters())
    assert n_stored == 4_412_079_616
    bd = cs.train_bound(cfg, n_stored, 4096, 4096)
    assert bd["model_flops"] == 6 * 4_411_228_160 * 4096
    assert bd["attention_flops"] == 12 * 32 * 128 * 36 * 4096 * 4097 // 2
    assert bd["optimizer_bytes"] == 28 * n_stored
    assert abs(bd["bound_ms"] - 161.505) < 0.01
    plan = cs.train_plan(cfg, n_stored, 4096)
    assert plan["subtotal_state"] == 16 * n_stored
    assert plan["reckoned_peak"] < 80e9


def test_chip_smoke_train_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 8's control flow on the CPU at ``reduced()`` (the card is the
    measurement), 8c on a dense and an MoE arch: every check of 8a-8c
    holds and nothing raises."""
    cs = _chip_smoke()
    monkeypatch.setattr(TC, "get_config", TC.reduced_config)
    monkeypatch.setattr(TC, "ARCH_NAMES", ["qwen3-4b", "granite-moe-1b-a400m"])
    monkeypatch.setattr(cs, "TRAIN_SEQ", 64)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: a thread pool only contends
    try:
        cs.train_phase(types.SimpleNamespace(seed=0), cs.check, device="cpu")
    finally:
        torch.set_num_threads(threads)


def test_chip_smoke_ssm_train_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 8d's control flow on the CPU at ``reduced()`` and 64 tokens:
    both SSM archs train finite, and the second timed step lowers its
    batch's loss."""
    cs = _chip_smoke()
    monkeypatch.setattr(TC, "get_config", TC.reduced_config)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 64)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cs.ssm_train_phase(types.SimpleNamespace(seed=0), cs.check,
                           device="cpu")
    finally:
        torch.set_num_threads(threads)


def test_chip_smoke_long_prefill_phase_rehearses_on_the_cpu(monkeypatch,
                                                             tmp_path):
    """Phase 9d's control flow on the CPU: the dry run's ``prefill_32k``
    step of qwen3-4b's ``reduced()`` config with the prompt cut to 1,024
    tokens, on a 1×1 grid over a 1-rank gloo group; the first 512
    positions equal the 512-token prefill's exactly on the CPU."""
    import torch.distributed as dist

    from repro_torch.core.grid import ProcessGrid, release_grids
    from repro_torch.launch import dryrun as DR

    cs = _chip_smoke()
    monkeypatch.setattr(TC, "get_config", TC.reduced_config)
    monkeypatch.setattr(DR, "get_config", TC.reduced_config)
    monkeypatch.chdir(tmp_path)  # the dry run writes under build/
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        rec = cs.long_prefill_phase(types.SimpleNamespace(seed=0), cs.check,
                                    ProcessGrid(1, 1), torch.device("cpu"),
                                    seq=1024)
    finally:
        dist.destroy_process_group()
        release_grids()
    assert rec["batch_cut"]["seq_cut_to"] == 1024
    assert rec["measured"]["rows_per_rank"] == 2 and rec["measured"]["finite"]
    assert rec["measured"]["flop_bound_ms"] > 0
    assert rec["prefix_logits_max_abs_diff"] == 0.0
