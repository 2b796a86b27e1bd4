"""The port's process grid (``repro_torch.core.grid``): the counterpart of
a JAX mesh and of the collectives of ``shard_map`` bodies, on gloo ranks.

``ppermute`` takes JAX's ``(source, destination)`` pairs: a reversed ring
would give wrong results, not an error, so the direction is checked on
every axis of every grid shape of 4 ranks, and on every axis and the
``("pod", "data")`` tuple of a ``(2, 2, 2)`` grid of 8 ranks."""

import itertools

import pytest
import torch

from repro_torch.core.grid import (
    POD_AXES,
    ProcessGrid,
    resolve_grid,
    resolve_row_axes,
    square_shape,
)

from _torch_dist import run_ranks


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    return run_ranks(4, "job_grid", {}, tmp_path_factory.mktemp("grid4"))


@pytest.mark.dist
@pytest.mark.parametrize("pr,pc", [(1, 4), (2, 2), (4, 1)])
def test_ppermute_direction(grid4, pr, pc):
    for rank, out in enumerate(grid4):
        res = out[f"{pr}x{pc}"]
        i, j = res["ij"]
        assert (i, j) == divmod(rank, pc)
        # left = [((t + 1) % n, t)]: index t receives from index t + 1
        assert res["left_model"] == 10 * (i * pc + (j + 1) % pc) + 1
        assert res["right_model"] == 10 * (i * pc + (j - 1) % pc) + 1
        assert res["left_data"] == 10 * (((i + 1) % pr) * pc + j) + 1
        assert res["right_data"] == 10 * (((i - 1) % pr) * pc + j) + 1
        if "pair" in res:  # index 2.. is idle and receives zeros
            want = {0: 10 * (i * pc + 1) + 1, 1: 10 * (i * pc) + 1}.get(j, 0)
            assert res["pair"] == want


@pytest.mark.dist
@pytest.mark.parametrize("pr,pc", [(1, 4), (2, 2), (4, 1)])
def test_reductions_and_gather_over_axis_subgroups(grid4, pr, pc):
    for rank, out in enumerate(grid4):
        res = out[f"{pr}x{pc}"]
        i, j = res["ij"]
        row = [i * pc + t for t in range(pc)]  # the "model" group
        col = [t * pc + j for t in range(pr)]  # the "data" group
        assert res["sum_model"] == sum(10 * r + 1 for r in row)
        assert res["max_model"] == 10 * max(row) + 1
        assert res["sum_data"] == sum(10 * r + 1 for r in col)
        assert res["max_data"] == 10 * max(col) + 1
        assert res["sum_all"] == sum(10 * r + 1 for r in range(4))
        assert res["any_model"] == (0 in row)  # bool travels as int32
        assert res["max_f32_data"] == float(max(col))
        assert res["gather_model"][:, 0].tolist() == row
        assert res["gather_data"][:, 0].tolist() == col


@pytest.mark.dist
def test_default_grids_on_four_ranks(grid4):
    for out in grid4:
        assert out["square"] == {"data": 2, "model": 2}
        assert out["rows"] == {"data": 4, "model": 1}


def test_one_by_one_grid_without_process_group():
    g = ProcessGrid.square()
    assert (g.pr, g.pc, g.i, g.j) == (1, 1, 0, 0)
    assert ProcessGrid.rows().shape == {"data": 1, "model": 1}
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert torch.equal(g.ppermute(x, "model", [(0, 0)]), x)
    assert torch.equal(g.psum(x, ("data", "model")), x)
    assert torch.equal(g.pmax(x, "data"), x)
    assert torch.equal(g.all_gather(x, "model", dim=1), x)
    assert resolve_grid(None, "square").shape == g.shape
    assert [square_shape(p) for p in (1, 2, 4, 8, 9, 12)] == [
        (1, 1), (1, 2), (2, 2), (2, 4), (3, 3), (3, 4)]


def test_pod_grid_axes_accepted():
    """``("pod", "data", "model")`` grids are grids like the 2D ones: the
    rows lie on ``("pod", "data")``, ``"model"`` is the column axis."""
    g = ProcessGrid(1, 1, 1, axis_names=POD_AXES)
    assert g.shape == {"pod": 1, "data": 1, "model": 1}
    assert g.row_axes == ("pod", "data")
    assert (g.pr, g.pc, g.i, g.j, g.coords) == (1, 1, 0, 0, (0, 0, 0))
    assert g.axis_index(("pod", "data")) == 0
    assert g.members(("pod", "data")) == [0]
    x = torch.arange(4, dtype=torch.int32)
    assert torch.equal(g.psum(x, ("pod", "data")), x)
    assert torch.equal(g.ppermute(x, ("pod", "data"), [(0, 0)]), x)
    assert torch.equal(g.all_gather(x, ("pod", "data", "model")), x)
    assert g.collective_bytes == {"all_gather": 0, "all_reduce": 0,
                                  "permute": 0}  # size 1: nothing issued
    assert ProcessGrid.of_shape((1, 1, 1), POD_AXES).shape == g.shape
    assert resolve_row_axes(g, None) == ("pod", "data")
    assert resolve_row_axes(g, ["data"]) == ("data",)
    for bad in (("model",), ("data", "pod"), ()):
        with pytest.raises(ValueError, match="row_axes"):
            resolve_row_axes(g, bad)
    with pytest.raises(ValueError, match="axes"):
        ProcessGrid(1, 1, axis_names=POD_AXES)  # two sizes for three axes
    with pytest.raises(ValueError, match="axes"):
        ProcessGrid(1, 1, axis_names=("x", "model"))
    with pytest.raises(ValueError, match="not one of"):
        g.psum(x, "x")


def test_non_process_grid_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        resolve_grid(object(), "rows")
    with pytest.raises(ValueError):
        ProcessGrid(2, 2)  # 4 ranks asked, 1 present
    with pytest.raises(ValueError):
        ProcessGrid(2, 1, 2, axis_names=POD_AXES)


@pytest.fixture(scope="module")
def grid8(tmp_path_factory):
    return run_ranks(8, "job_grid_pod", {"shape": (2, 2, 2)},
                     tmp_path_factory.mktemp("grid8"))


def _members(coords, axes, sizes=(2, 2, 2)):
    """The global ranks along ``axes`` through ``coords``, by axis index."""
    ks = [POD_AXES.index(a) for a in axes]
    out = []
    for idx in itertools.product(*(range(sizes[k]) for k in ks)):
        c = list(coords)
        for k, v in zip(ks, idx):
            c[k] = v
        out.append((c[0] * sizes[1] + c[1]) * sizes[2] + c[2])
    return out


@pytest.mark.dist
@pytest.mark.parametrize("axes", ["pod", "data", "model", ("pod", "data")])
def test_pod_grid_collectives_on_eight_ranks(grid8, axes):
    key = axes if isinstance(axes, str) else "+".join(axes)
    tup = (axes,) if isinstance(axes, str) else axes
    for rank, out in enumerate(grid8):
        p, d, j = out["coords"]
        assert (p, d, j) == (rank // 4, rank // 2 % 2, rank % 2)
        assert (out["pr"], out["pc"], out["i"], out["j"]) == (4, 2, 2 * p + d, j)
        res = out[key]
        mem = _members((p, d, j), tup)
        assert res["members"] == mem
        t = mem.index(rank)
        assert res["index"] == t
        if tup == ("pod", "data"):
            assert t == 2 * p + d  # JAX's order for a tuple axis
        # left = [((t + 1) % n, t)]: index t receives from index t + 1
        assert res["left"] == 10 * mem[(t + 1) % len(mem)] + 1
        assert res["sum"] == sum(10 * r + 1 for r in mem)
        assert res["max"] == 10 * max(mem) + 1
        assert res["any"] == (0 in mem)
        assert res["gather"][:, 0].tolist() == mem


@pytest.mark.dist
def test_pod_grid_counts_collective_bytes(grid8):
    for out in grid8:
        b = out["bytes"]
        # per axis set: one 4-byte permute sent, psum + pmax of 4 bytes and
        # the bool psum as int32, and an all-gather of n two-int32 rows
        sizes = [2, 2, 2, 4]
        assert b["permute"] == 4 * len(sizes)
        assert b["all_reduce"] == 3 * 4 * len(sizes)
        assert b["all_gather"] == sum(8 * n for n in sizes)
        assert out["bytes_after_reset"] == dict.fromkeys(b, 0)
