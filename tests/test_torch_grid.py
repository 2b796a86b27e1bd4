"""The port's process grid (``repro_torch.core.grid``): the counterpart of
a JAX mesh and of the collectives of ``shard_map`` bodies, on gloo ranks.

``ppermute`` takes JAX's ``(source, destination)`` pairs: a reversed ring
would give wrong results, not an error, so the direction is checked on
every axis of every grid shape of 4 ranks."""

import pytest
import torch

from repro_torch.core.grid import ProcessGrid, resolve_grid, square_shape

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


def test_unported_grids_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ProcessGrid(1, 1, axis_names=("pod", "data", "model"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        resolve_grid(object(), "rows")
    with pytest.raises(ValueError):
        ProcessGrid(2, 2)  # 4 ranks asked, 1 present
