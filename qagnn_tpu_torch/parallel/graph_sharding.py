"""Edge-partitioned graph slices: the graph analog of sequence parallelism.

Counterpart of qagnn_tpu/parallel/graph_sharding.py (`shard_graph`,
:27-49). There GSPMD places a global BatchedGraphs on the mesh; here each
rank cuts its own slice from the whole batch: graphs over `data`, edge
slots over `model`. Node arrays (G, N) keep every node of the rank's
graphs; edge arrays (G, E) keep E / n_model slots of every graph. E is
first padded with masked slots to a multiple of n_model * EDGE_ALIGN; a
masked slot is inert in every kernel, so the padding changes no value.
"""

from __future__ import annotations

import dataclasses

import torch

from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.parallel.mesh import Mesh, data_slice

# slots of a slice are a multiple of this: 16-byte rows of int32 indices
# and of bf16 edge rows at widths that are multiples of 8
EDGE_ALIGN = 8
EDGE_FIELDS = ("edge_src", "edge_dst", "edge_type", "edge_mask")


def pad_edges(graph: BatchedGraphs, multiple: int) -> BatchedGraphs:
    """`graph` with E padded by masked slots (src = dst = type = 0) to a
    multiple of `multiple`."""
    E = graph.edges_per_graph
    pad = -E % multiple
    if pad == 0:
        return graph
    return dataclasses.replace(graph, **{
        f: torch.nn.functional.pad(getattr(graph, f), (0, pad))
        for f in EDGE_FIELDS})


def edge_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Slots [m * E / n_model, (m + 1) * E / n_model) of every graph,
    contiguous."""
    if mesh.n_model == 1:
        return x
    step = x.shape[1] // mesh.n_model
    m = mesh.model_index
    return x[:, m * step:(m + 1) * step].contiguous()


def shard_graph(graph: BatchedGraphs, mesh: Mesh) -> BatchedGraphs:
    """This rank's (G / n_data, E / n_model) slice of a whole batch's
    graphs, every tensor contiguous (not a view), so that every kernel's
    contiguity and alignment checks hold."""
    if mesh.n_model > 1:
        graph = pad_edges(graph, mesh.n_model * EDGE_ALIGN)
    out = {}
    for f in dataclasses.fields(graph):
        x = data_slice(getattr(graph, f.name), mesh)
        if f.name in EDGE_FIELDS:
            x = edge_slice(x, mesh)
        out[f.name] = x
    return BatchedGraphs(**out)
