"""Parallelism: the (data, model) grid of ranks, its slicing and its
collectives (counterpart of qagnn_tpu/parallel)."""

from qagnn_tpu_torch.parallel.launch import run_ranks
from qagnn_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    shard_batch,
    shard_params,
)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "run_ranks",
    "shard_batch", "shard_params",
]
