"""The (data, model) grid of ranks, batch and parameter slicing, and the
collectives the sharded ops run.

Counterpart of qagnn_tpu/parallel/mesh.py. The JAX package is one SPMD
program over a device mesh; the port runs one process per rank
(parallel/launch.py) on a grid of torch.distributed groups:

  * rank r = d * n_model + m holds data slice d and model slice m;
  * the `data` group of a rank joins the ranks of its m (every d), the
    `model` group those of its d (every m);
  * data slice d is the d-th of n_data equal parts of a batch's leading
    axis: B / n_data questions, so G / n_data graphs, the choices of a
    question together (`shard_batch`);
  * model slice m is the m-th of n_model equal parts of every graph's edge
    slots (parallel/graph_sharding.py) and, for the entity table, of its
    rows (`shard_params`); node arrays are whole on every rank of a data
    group and the other parameters are replicated.

The collectives are all_reduce (SUM, MAX), all_gather and broadcast, on
the rank's device. A group of one rank (or no process group) makes each of
them the identity. Two differentiable sums stand where JAX's psum sits
under autodiff: `sum_over` (backward: the same sum), for partial sums whose
downstream gradients differ across the group (BatchNorm row sums over
`data`), and `sum_shards` (backward: the identity), for shards whose sum
feeds a computation replicated across the group (the entity table's
lookup over `model`).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

# the grid's two axes, named as the JAX package's mesh names them
DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on an (n_data, n_model) grid, its two groups
    (None where the group is this rank alone) and its device."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object
    world_group: object
    device: torch.device

    @property
    def rank(self) -> int:
        return self.data_index * self.n_model + self.model_index

    @property
    def size(self) -> int:
        return self.n_data * self.n_model


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when `device` says so, else the card
    `LOCAL_RANK` (or the global rank) modulo the cards of the host."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device=None) -> Mesh:
    """The grid over the initialized world (or a 1 x 1 grid when there is no
    process group). n_data defaults to world size / n_model. Every rank
    must call it, in the same order as every other new group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} grid needs "
                         f"{n_data * n_model} ranks; the world has {world}")
    d, m = divmod(rank, n_model)
    data_group = model_group = None
    for dd in range(n_data):            # every rank creates every group
        ranks = [dd * n_model + mm for mm in range(n_model)]
        g = dist.new_group(ranks) if n_model > 1 else None
        if dd == d:
            model_group = g
    for mm in range(n_model):
        ranks = [dd * n_model + mm for dd in range(n_data)]
        g = dist.new_group(ranks) if n_data > 1 else None
        if mm == m:
            data_group = g
    world_group = dist.group.WORLD if world > 1 else None
    return Mesh(n_data, n_model, d, m, data_group, model_group, world_group,
                rank_device(device))


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place SUM or MAX of `t` over `group`; returns `t`. The identity
    for group None."""
    if group is None:
        return t
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> list:
    """Every rank's `t` (same shape on every rank), in group rank order."""
    if group is None:
        return [t]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def broadcast(t: torch.Tensor, group) -> torch.Tensor:
    """In place: global rank 0's `t` on every rank of `group`."""
    if group is None:
        return t
    dist.broadcast(t, src=0, group=group)
    return t


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _SumShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over(x: torch.Tensor, group):
    """Differentiable SUM over `group` whose backward sums the cotangents
    over the group too: each rank's partial sum feeds every rank's
    (different) downstream loss."""
    return x if group is None else _SumOver.apply(x, group)


def sum_shards(x: torch.Tensor, group):
    """Differentiable SUM over `group` whose backward is the identity: the
    summed value feeds a computation that every rank of the group repeats,
    so each rank's cotangent is already the whole one."""
    return x if group is None else _SumShards.apply(x, group)


# --------------------------------------------------------------------------
# batches and parameters
# --------------------------------------------------------------------------

def data_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The d-th of n_data equal parts of x's leading axis, contiguous."""
    if mesh.n_data == 1:
        return x
    n = x.shape[0]
    if n % mesh.n_data:
        raise ValueError(f"a leading axis of {n} does not divide over "
                         f"{mesh.n_data} data ranks")
    step = n // mesh.n_data
    return x[mesh.data_index * step:(mesh.data_index + 1) * step] \
        .contiguous()


def shard_batch(batch, mesh: Mesh):
    """This rank's data slice of every tensor of `batch` (tensors, dicts,
    lists, tuples and NamedTuples of them; a BatchedGraphs is cut by
    `shard_graph`, edges included). Scalars stay whole."""
    from qagnn_tpu_torch.graph.container import BatchedGraphs
    from qagnn_tpu_torch.parallel.graph_sharding import shard_graph

    if isinstance(batch, BatchedGraphs):
        return shard_graph(batch, mesh)
    if isinstance(batch, torch.Tensor):
        return batch if batch.ndim == 0 else data_slice(batch, mesh)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(shard_batch(v, mesh) for v in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return batch


@dataclasses.dataclass(frozen=True, eq=False)
class RowShard:
    """Rows [start, stop) of a table of n_rows rows, held on the rank of
    model slice m; shards are ceil(n_rows / n_model) rows, the last one
    shorter."""

    start: int
    stop: int
    n_rows: int
    group: object

    @property
    def rows(self) -> int:
        return -(-self.n_rows // dist.get_world_size(self.group)) \
            if self.group is not None else self.n_rows


def row_shard(n_rows: int, mesh: Mesh) -> RowShard:
    per = -(-n_rows // mesh.n_model)
    start = min(n_rows, mesh.model_index * per)
    return RowShard(start, min(n_rows, start + per), n_rows,
                    mesh.model_group)


# rows of a table that `gather_rows` moves in one all_gather (256 MB at 1024
# f32 columns): a collective on CUDA tensors holds its input and its outputs
# on the card and one more copy of them in the backend (gloo), so the
# gather goes by pieces and the pieces join on the host
GATHER_ROWS = 1 << 16


def gather_rows(shard: torch.Tensor, rs: RowShard) -> torch.Tensor:
    """The whole table, on the host, from every model rank's shard: pieces
    of GATHER_ROWS rows of each shard (zero-padded to one length) are
    gathered in turn and joined on the host."""
    if rs.group is None:
        return shard
    parts = [[] for _ in range(dist.get_world_size(rs.group))]
    for start in range(0, rs.rows, GATHER_ROWS):
        piece = shard.new_zeros((min(GATHER_ROWS, rs.rows - start),)
                                + tuple(shard.shape[1:]))
        mine = shard[start:start + piece.shape[0]]
        piece[:mine.shape[0]] = mine
        for r, p in enumerate(all_gather(piece, rs.group)):
            parts[r].append(p.cpu())
    return torch.cat([torch.cat(p) for p in parts])[:rs.n_rows]


def sharded_tables(model: torch.nn.Module) -> dict:
    """Parameter name -> RowShard of every row-sharded table of `model`."""
    return {f"{name}.emb.weight": mod.shard
            for name, mod in model.named_modules()
            if getattr(mod, "shard", None) is not None}


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Counterpart of `param_shardings`: broadcast every parameter and
    buffer from rank 0 (the entity tables excepted: every rank reads them
    from the same file or draws them from the same seed), then, with
    n_model > 1, keep of each entity table (a CustomizedEmbedding's `emb`)
    this rank's rows. Call it before an optimizer is built over the
    parameters."""
    from qagnn_tpu_torch.models.layers import CustomizedEmbedding

    tables = {f"{n}.emb.weight" for n, m in model.named_modules()
              if isinstance(m, CustomizedEmbedding)}
    for name, t in list(model.named_parameters()) + \
            list(model.named_buffers()):
        if name not in tables:
            broadcast(t.data, mesh.world_group)
    if mesh.n_model == 1:
        return model
    for name, mod in model.named_modules():
        if isinstance(mod, CustomizedEmbedding):
            w = mod.emb.weight
            rs = row_shard(w.shape[0], mesh)
            mod.emb.weight = torch.nn.Parameter(
                w[rs.start:rs.stop].clone(), requires_grad=w.requires_grad)
            mod.shard = rs
    return model
