"""The port's grid machinery on the CPU: parallel/launch.py, mesh.py and
graph_sharding.py, the dropout masks of a data slice, the CLI's grid
checks.

Ranks are gloo processes spawned by `run_ranks`, each spawn within a time
limit; one spawn checks the groups, the collectives and their gradients,
`shard_params` and the optimizer's norm over a sharded table; two more
show that a rank that raises, or hangs, fails the call with its traceback
within the limit.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from qagnn_tpu_torch import cli
from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.models import layers
from qagnn_tpu_torch.models.layers import CustomizedEmbedding
from qagnn_tpu_torch.parallel import launch
from qagnn_tpu_torch.parallel.graph_sharding import EDGE_ALIGN, shard_graph
from qagnn_tpu_torch.parallel import mesh as pm
from qagnn_tpu_torch.parallel.launch import run_ranks
from qagnn_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce,
    make_mesh,
    shard_batch,
    shard_params,
    sum_over,
    sum_shards,
)
from qagnn_tpu_torch.train.optim import TrainOptimizer
from qagnn_tpu_torch.train.step import Batch
from qagnn_tpu_torch.utils import config

SPAWN_S = 120


def _mesh(n_data, n_model, d, m):
    """A grid position without process groups, for the slicing helpers."""
    return Mesh(n_data, n_model, d, m, None, None, None, torch.device("cpu"))


# --------------------------------------------------------------------------
# one spawn: groups, collectives, shard_params, the sharded norm
# --------------------------------------------------------------------------

class _Tiny(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        torch.manual_seed(seed)
        self.encoder = torch.nn.Linear(2, 2)
        self.decoder = torch.nn.Module()
        self.decoder.concept_emb = CustomizedEmbedding(9, 3, 3)
        self.decoder.lin = torch.nn.Linear(3, 2)


def _rank_grid():
    mesh = make_mesh(2, 2, "cpu")
    r = mesh.rank
    out = {"where": (mesh.data_index, mesh.model_index)}
    t = torch.tensor([float(r)])
    out["data_sum"] = float(all_reduce(t.clone(), mesh.data_group)[0])
    out["model_max"] = float(all_reduce(t.clone(), mesh.model_group,
                                        "max")[0])
    out["gathered"] = [float(x[0]) for x in all_gather(t, mesh.world_group)]

    # sum_over: backward the same sum; sum_shards: backward the identity
    x = torch.tensor([1.0 + r], requires_grad=True)
    (sum_over(x, mesh.data_group) * (r + 1)).sum().backward()
    out["sum_over_grad"] = float(x.grad[0])
    y = torch.tensor([1.0 + r], requires_grad=True)
    (sum_shards(y, mesh.model_group) * 3.0).sum().backward()
    out["sum_shards_grad"] = float(y.grad[0])

    # every rank starts from other weights; rank 0's win, the table's rows
    # are split over `model`
    model = _Tiny(seed=r)
    full = torch.arange(27, dtype=torch.float32).reshape(9, 3)
    with torch.no_grad():
        model.decoder.concept_emb.emb.weight.copy_(full)
    shard_params(model, mesh)
    out["lin"] = model.decoder.lin.weight.detach().numpy().copy()
    out["rows"] = model.decoder.concept_emb.emb.weight.detach().numpy() \
        .copy()
    out["lookup"] = model.decoder.concept_emb(
        torch.tensor([[0, 4, 5, 8]])).detach().numpy()
    # the whole table back from the shards, in pieces of 2 rows
    pm.GATHER_ROWS = 2
    rs = model.decoder.concept_emb.shard
    out["gathered_table"] = pm.gather_rows(
        model.decoder.concept_emb.emb.weight.detach(), rs).numpy()

    # the global norm counts every row of the sharded table once
    opt = TrainOptimizer(model, optim="sgd", max_grad_norm=1e9)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    out["norm"] = float(opt.last_grad_norm)
    return out


@pytest.fixture(scope="module")
def grid():
    return run_ranks(_rank_grid, 4, "gloo", "cpu", SPAWN_S)


def test_groups_and_collectives(grid):
    for r, res in enumerate(grid):
        d, m = divmod(r, 2)
        assert res["where"] == (d, m)
        assert res["data_sum"] == m + (2 + m)     # ranks (0, m) and (1, m)
        assert res["model_max"] == 2 * d + 1      # ranks (d, 0) and (d, 1)
        assert res["gathered"] == [0.0, 1.0, 2.0, 3.0]


def test_differentiable_sums(grid):
    for r, res in enumerate(grid):
        d, m = divmod(r, 2)
        # d/dx_r of sum over the data group of (r' + 1) * (x_0 + x_2 ...)
        assert res["sum_over_grad"] == (m + 1) + (2 + m + 1)
        assert res["sum_shards_grad"] == 3.0


def test_shard_params_broadcasts_splits_and_gathers_the_table(grid):
    full = np.arange(27, dtype=np.float32).reshape(9, 3)   # shards 5 + 4
    for r, res in enumerate(grid):
        np.testing.assert_array_equal(res["lin"], grid[0]["lin"])
        m = r % 2
        np.testing.assert_array_equal(res["rows"], full[5 * m:5 * m + 5])
        np.testing.assert_array_equal(res["lookup"][0], full[[0, 4, 5, 8]])
        np.testing.assert_array_equal(res["gathered_table"], full)


def test_optimizer_norm_counts_each_table_row_once(grid):
    n_params = 9 * 3 + 2 * 3 + 2 + 2 * 2 + 2    # the whole table, the rest
    for res in grid:
        assert res["norm"] == pytest.approx(np.sqrt(n_params), rel=1e-6)


# --------------------------------------------------------------------------
# failures
# --------------------------------------------------------------------------

def _rank_raises():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank one fails here")
    dist.barrier()          # the others wait for it in a collective
    return "never"


def _rank_hangs():
    import torch.distributed as dist
    if dist.get_rank() == 0:
        time.sleep(3600)
    return dist.get_rank()


def _rank_dies():
    import os

    import torch.distributed as dist
    if dist.get_rank() == 1:
        os._exit(3)
    dist.barrier()
    return "never"


def test_a_rank_that_dies_fails_the_call():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited with code 3 without a "
                                           "report"):
        run_ranks(_rank_dies, 2, "gloo", "cpu", SPAWN_S)
    assert time.monotonic() - t0 < 60


def test_a_failing_rank_fails_the_call_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_ranks(_rank_raises, 2, "gloo", "cpu", SPAWN_S)
    assert "rank one fails here" in str(err.value)
    assert "--- rank 1 ---" in str(err.value)
    assert time.monotonic() - t0 < 60


def test_a_hung_rank_fails_the_call_at_the_limit():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish within 8"):
        run_ranks(_rank_hangs, 2, "gloo", "cpu", 8)
    assert time.monotonic() - t0 < 40


@pytest.mark.parametrize("backend,n,device,match", [
    ("nccl", 2, "cpu", "--dist_backend gloo"),
    ("nccl", 2, "cuda", "--dist_backend gloo"),
    ("mpi", 2, "cpu", "unknown backend")])
def test_backends_refused(monkeypatch, backend, n, device, match):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=match):
        launch.check_backend(backend, n, device)


# --------------------------------------------------------------------------
# slicing
# --------------------------------------------------------------------------

def _graphs(G=4, N=6, E=13, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    return BatchedGraphs(
        concept_ids=t(rng.integers(1, 50, (G, N)).astype(np.int32)),
        node_types=t(rng.integers(0, 4, (G, N)).astype(np.int32)),
        node_scores=t(rng.standard_normal((G, N)).astype(np.float32)),
        num_nodes=t(np.full(G, N, np.int32)),
        edge_src=t(rng.integers(0, N, (G, E)).astype(np.int32)),
        edge_dst=t(rng.integers(0, N, (G, E)).astype(np.int32)),
        edge_type=t(rng.integers(0, 5, (G, E)).astype(np.int32)),
        edge_mask=t(rng.random((G, E)) > 0.3))


@pytest.mark.parametrize("n_data,n_model", [(2, 2), (1, 4), (4, 1)])
def test_shard_graph_slices_and_pads(n_data, n_model):
    g = _graphs()
    E_pad = -(-13 // (n_model * EDGE_ALIGN)) * n_model * EDGE_ALIGN \
        if n_model > 1 else 13
    edges, nodes = {}, {}
    for d in range(n_data):
        for m in range(n_model):
            s = shard_graph(g, _mesh(n_data, n_model, d, m))
            assert s.edges_per_graph == E_pad // n_model
            assert s.n_graphs == 4 // n_data
            assert all(getattr(s, f.name).is_contiguous()
                       for f in dataclasses.fields(s))
            edges[d, m], nodes[d, m] = s, s.concept_ids
    for f in ("edge_src", "edge_dst", "edge_type", "edge_mask"):
        whole = torch.cat([torch.cat([getattr(edges[d, m], f)
                                      for m in range(n_model)], dim=1)
                           for d in range(n_data)])
        assert torch.equal(whole[:, :13], getattr(g, f))
        assert not whole[:, 13:].any()          # masked, zero padding
    assert torch.equal(torch.cat([nodes[d, 0] for d in range(n_data)]),
                       g.concept_ids)


def test_shard_batch_cuts_every_leaf():
    g = _graphs()
    batch = Batch({"input_ids": torch.arange(2 * 2 * 3).reshape(2, 2, 3)},
                  g, torch.tensor([0, 1]))
    s = shard_batch(batch, _mesh(2, 2, 1, 1))
    assert torch.equal(s.lm_inputs["input_ids"],
                       batch.lm_inputs["input_ids"][1:])
    assert torch.equal(s.labels, torch.tensor([1]))
    assert torch.equal(s.graph.concept_ids, g.concept_ids[2:])
    assert s.graph.edges_per_graph == 8
    with pytest.raises(ValueError, match="divide"):
        shard_batch(torch.zeros(3), _mesh(2, 1, 0, 0))


@pytest.mark.parametrize("groups", [1, 3])
def test_dropout_masks_of_data_slices_are_the_one_rank_masks(groups):
    """Each data slice draws the whole batch's mask from the same generator
    and keeps its rows (rows heads-major under batch_groups)."""
    x = torch.ones(groups * 4, 5)
    with layers.dropout_generator(torch.Generator().manual_seed(3)):
        with layers.batch_groups(groups):
            whole = layers.dropout(x, 0.5, True)
    parts = []
    for d in range(2):
        local = torch.ones(groups * 2, 5)
        with layers.dropout_generator(torch.Generator().manual_seed(3),
                                      (d, 2)):
            with layers.batch_groups(groups):
                parts.append(layers.dropout(local, 0.5, True)
                             .reshape(groups, 2, 5))
    assert torch.equal(torch.cat(parts, dim=1).reshape(-1, 5), whole)


def test_replicated_dropout_masks_are_whole_on_every_data_slice():
    """A mask of a tensor that every rank holds whole (not rows of the
    batch) is the one-rank run's mask on every data slice, and leaves the
    generator where the one-rank run leaves it."""
    x = torch.ones(6, 5)
    gen = torch.Generator().manual_seed(3)
    with layers.dropout_generator(gen):
        whole = layers.dropout(x, 0.5, True, replicated=True)
    after = torch.rand(4, generator=gen)
    for d in range(2):
        gen = torch.Generator().manual_seed(3)
        with layers.dropout_generator(gen, (d, 2)):
            assert torch.equal(layers.dropout(x, 0.5, True, replicated=True),
                               whole)
        assert torch.equal(torch.rand(4, generator=gen), after)


@pytest.mark.parametrize("kw,match", [
    (dict(mesh_data=3), "batch_size 4 must divide over 3"),
    (dict(mesh_data=4, mini_batch_size=2), "microbatch of 2"),
])
def test_mesh_shape_refuses_what_does_not_divide(kw, match):
    cfg = config.TrainConfig(batch_size=4, eval_batch_size=12,
                             **kw).resolved()
    with pytest.raises(ValueError, match=match):
        cli.mesh_shape(cfg, "cpu")


def test_mesh_shape_defaults_to_one_rank_on_the_cpu():
    cfg = config.TrainConfig(mesh_model=1).resolved()
    assert cli.mesh_shape(cfg, "cpu") == (1, 1)
    assert cli.mesh_shape(dataclasses.replace(cfg, mesh_model=2),
                          "cpu") == (1, 2)
