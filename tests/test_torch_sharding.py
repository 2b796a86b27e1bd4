"""The port's placement rules and cost model against JAX's, with no
process group (JAX on an ``AbstractMesh``, the port on a ``GridShape``):

* every parameter's spec from ``apply_sharding_rules``, for all ten archs
  at ``reduced()`` and full size, ``fsdp`` on and off, on the (2, 2),
  (2, 1, 2), (16, 16) and (2, 16, 16) grids (JAX's stacked leaves carry a
  leading ``None`` the port's unstacked layers do not);
* ``batch_sharding`` and ``cache_sharding`` on the same grids;
* the per-rank argument bytes of every cell on the production grids (the
  LM dry run's ``production`` record) against the sums of JAX's
  ``NamedSharding.shard_shape``;
* ``analytic_costs`` equal to JAX's for every arch × shape at 256 and 512
  chips;
* the LM dry run at ``--reduced --device cpu`` writes its record.
"""

import functools
import json

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_NAMES, SHAPES
from repro.configs import batch_specs as j_batch_specs
from repro.configs import cache_specs as j_cache_specs
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.launch import roofline as JR
from repro.models.model import init_params as j_init_params
from repro.runtime import sharding as JS
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import cache_specs
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as TR
from repro_torch.models.model import LanguageModel
from repro_torch.runtime import sharding as TS

GRIDS = [((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model")),
         ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
GRID_IDS = ["2x2", "2x1x2", "16x16", "2x16x16"]


def _norm(spec):
    """A spec as a tuple of entries: a name, a tuple of names, or None."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, size):
    """JAX's parameter shapes of ``arch`` (``"reduced"`` or ``"full"``)."""
    cfg = (j_reduced_config if size == "reduced" else j_get_config)(arch)
    return jax.eval_shape(lambda: j_init_params(cfg, jax.random.PRNGKey(0)))


def _key(path) -> str:
    """A JAX tree path as ``a/0/b``."""
    return "/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                    for p in path)


def _port_leaves(tree, prefix=""):
    """The port's spec tree (lists and dicts of spec tuples) by path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, f"{prefix}{k}/"))
    return out


def _jax_specs(params, mesh, fsdp):
    shard = JS.apply_sharding_rules(params, mesh, fsdp=fsdp)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shard)[0]:
        key = _key(path)
        spec = _norm(s.spec)
        out[key] = spec[1:] if key.startswith("slots/") else spec
    return out, params, shard


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_param_specs_equal_jax(grid, size):
    shape, axes = grid
    mesh = AbstractMesh(shape, axes)
    gs = TS.GridShape(shape, axes)
    for arch in ARCH_NAMES:
        tget = reduced_config if size == "reduced" else get_config
        model = LanguageModel(tget(arch), device="meta")
        for fsdp in (False, True):
            want, _, _ = _jax_specs(_jax_params(arch, size), mesh, fsdp)
            got = TS.apply_sharding_rules(model, gs, fsdp=fsdp)
            assert len(got) == sum(1 for _ in model.named_parameters())
            for name, spec in got.items():
                assert spec == want[TS.jax_path(name)], (arch, fsdp, name)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_batch_and_cache_specs_equal_jax(grid):
    shape, axes = grid
    mesh = AbstractMesh(shape, axes)
    gs = TS.GridShape(shape, axes)
    for b in (1, 2, 8, 32, 128, 256):
        assert TS.batch_sharding(gs, b) == _norm(
            JS.batch_sharding(mesh, b).spec), b
    assert TS.batch_sharding(gs) == _norm(JS.batch_sharding(mesh).spec)
    for arch in ARCH_NAMES:
        for name in ("decode_32k", "long_500k"):
            jc = j_cache_specs(j_get_config(arch), SHAPES[name])
            tc = cache_specs(get_config(arch), T_SHAPES[name])
            for seq in (False, True):
                want = {_key(path): _norm(sh.spec) for path, sh in
                        jax.tree_util.tree_flatten_with_path(
                            JS.cache_sharding(mesh, jc, seq_sharded=seq),
                            is_leaf=lambda x: hasattr(x, "spec"))[0]}
                got = _port_leaves(TS.cache_sharding(gs, tc, seq_sharded=seq))
                assert got == want, (arch, name, seq)


def _jax_bytes(tree, shardings):
    total = 0
    for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(
            shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))):
        total += int(np.prod(sh.shard_shape(leaf.shape))) * np.dtype(
            leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_production_argument_bytes_equal_jax_shard_shapes(mesh_kind):
    from repro_torch.launch.mesh import PRODUCTION_SHAPES

    shape, axes = PRODUCTION_SHAPES[mesh_kind]
    mesh = AbstractMesh(tuple(shape), tuple(axes))
    gs = TS.GridShape(tuple(shape), tuple(axes))
    import jax.numpy as jnp

    for arch in ARCH_NAMES:
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        params = _jax_params(arch, "full")
        serve = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
            s.shape, jnp.bfloat16 if s.dtype == jnp.float32 else s.dtype),
            params)
        for name, spec in SHAPES.items():
            got = dryrun.lm_argument_bytes(tcfg, T_SHAPES[name], gs, fsdp=True)
            batch = j_batch_specs(jcfg, spec)
            want_batch = sum(
                int(np.prod(JS.batch_sharding(mesh, s.shape[0])
                            .shard_shape(s.shape))) * np.dtype(s.dtype).itemsize
                for s in batch.values())
            assert got["batch"] == want_batch, (arch, name)
            if spec.kind == "train":
                want = _jax_bytes(params, JS.apply_sharding_rules(
                    params, mesh, fsdp=True))
                assert got["params"] == want and got["moments"] == 2 * want
            else:
                want = _jax_bytes(serve, JS.apply_sharding_rules(
                    serve, mesh, fsdp=False))
                caches = j_cache_specs(jcfg, spec)
                want_c = _jax_bytes(caches, JS.cache_sharding(
                    mesh, caches, seq_sharded=True))
                assert got["params"] == want, (arch, name)
                assert got["caches"] == want_c, (arch, name)


def test_analytic_costs_equal_jax_exactly():
    for arch in ARCH_NAMES:
        for name, spec in SHAPES.items():
            for chips in (256, 512):
                got = TR.analytic_costs(get_config(arch), spec.kind,
                                        spec.seq_len, spec.global_batch, chips)
                want = JR.analytic_costs(j_get_config(arch), spec.kind,
                                         spec.seq_len, spec.global_batch,
                                         chips)
                assert got == want, (arch, name, chips)
                assert TR.model_flops(get_config(arch), spec.kind,
                                      spec.seq_len, spec.global_batch) == \
                    JR.model_flops(j_get_config(arch), spec.kind,
                                   spec.seq_len, spec.global_batch)


def test_shard_and_gather_on_one_rank_round_trip():
    import torch

    from repro_torch.core.grid import ProcessGrid

    g = ProcessGrid(1, 1)
    x = torch.arange(24.0).reshape(4, 6)
    for spec in ((), ("data", "model"), (None, ("data", "model"))):
        blk = TS.shard_tensor(x, spec, g)
        assert torch.equal(blk, x) and blk.data_ptr() != x.data_ptr()
        assert torch.equal(TS.gather_tensor(blk, spec, g), x)
    gs = TS.GridShape((2, 3), ("data", "model"), coords=(1, 2))
    assert TS.shard_shape(x.shape, ("data", "model"), gs) == (2, 2)
    assert TS.shard_tensor(x, ("data", "model"), gs).tolist() == [
        [16.0, 17.0], [22.0, 23.0]]


@pytest.fixture
def one_thread():
    """One intra-op thread for a measured step, so that it takes seconds
    beside the other test workers' threads, not a minute."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("arch,shape", [("qwen3-4b", "decode_32k"),
                                        ("mamba2-1.3b", "train_4k"),
                                        ("mamba2-1.3b", "prefill_32k"),
                                        ("qwen2-moe-a2.7b", "decode_32k")])
def test_lm_dry_run_writes_its_record(tmp_path, arch, shape):
    path = tmp_path / "cell.json"
    rec = dryrun.main(["--arch", arch, "--shape", shape, "--reduced",
                       "--device", "cpu", "--batch", "1", "--out", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    prod, meas = rec["production"], rec["measured"]
    assert prod["chips"] == 256 and prod["grid"] == [16, 16]
    assert prod["memory"]["fits_80GB"]
    assert prod["memory"]["argument_bytes_per_device"] == sum(
        prod["memory"]["argument_by_part"].values())
    assert prod["roofline"]["flops_per_device"] > 0
    assert meas["grid"] == [1, 1] and meas["rows_per_rank"] == 1
    assert meas["ms"] > 0 and meas["finite"]
    assert meas["collective_bytes_per_device"] == 0  # 1x1: none issued
    assert rec["batch_cut"]["cut_to"] == 1


def test_lm_dry_run_cuts_the_measured_sequence(tmp_path):
    """``--seq`` cuts the measured step's prompt; the production record
    keeps the shape's whole sequence."""
    full = dryrun.main(["--arch", "qwen3-4b", "--shape", "prefill_32k",
                        "--reduced", "--device", "cpu", "--batch", "1",
                        "--seq", "256", "--out", str(tmp_path / "c.json")])
    assert full["batch_cut"] == {"rows_per_rank": 2, "cut_to": 1,
                                 "seq_len": 32768, "seq_cut_to": 256}
    assert full["measured"]["finite"]
    prod = full["production"]["roofline"]["flops_per_device"]
    meas = full["measured"]["roofline"]["flops_per_device"]
    assert meas < prod / 64  # 1 row of 256 tokens, not 2 of 32,768


def test_lm_dry_run_skips_the_cells_jax_skips(tmp_path):
    rec = dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k",
                       "--reduced", "--device", "cpu",
                       "--out", str(tmp_path / "c.json")])
    assert rec["skipped"] and "production" not in rec
