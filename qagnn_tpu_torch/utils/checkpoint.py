"""Checkpointing: parameters + BatchNorm statistics + the FULL optimizer
state and step + the dropout generator.

Counterpart of qagnn_tpu/utils/checkpoint.py, in torch's format: a
checkpoint is a directory holding one `state.pt` written with torch.save
({"model": the model's state_dict, "optimizer": TrainOptimizer.state,
"generator": the generator's state}), with the run's TrainConfig beside it
as `<path>.config.json`. The reference saves weights only and cannot truly
resume (reference qagnn.py:317-333, 163-166). The JAX package's orbax
checkpoints are not read; utils/convert.py carries weights between the two
packages.

On a grid of ranks (qagnn_tpu_torch.parallel) every rank calls
`save_checkpoint`: a row-sharded entity table (and its optimizer moments)
is gathered from the model group, and rank 0 alone writes. `restore_into`
keeps a sharded table's rows of this rank. The file is the same whatever
the grid, so a grid's checkpoint loads on one card and the other way round.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import torch
import torch.distributed as dist
from torch import nn

from qagnn_tpu_torch.parallel.mesh import gather_rows, sharded_tables
from qagnn_tpu_torch.train.optim import TrainOptimizer
from qagnn_tpu_torch.utils.config import TrainConfig

STATE_FILE = "state.pt"


def save_checkpoint(path: str, model: nn.Module, optimizer: TrainOptimizer,
                    generator: torch.Generator | None = None,
                    cfg: TrainConfig | None = None) -> None:
    """Write the model, the optimizer's state and step and the generator's
    state to the directory `path` (replacing a checkpoint there), and `cfg`
    beside it. On a grid every rank calls it and rank 0 writes."""
    weights, moments = model.state_dict(), dict(optimizer.state)
    for name, rs in sharded_tables(model).items():
        weights[name] = gather_rows(weights[name], rs)
        for key in moments:
            if key.endswith("." + name):
                moments[key] = gather_rows(moments[key], rs)
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save({"model": weights, "optimizer": moments,
                "generator": None if generator is None
                else generator.get_state()},
               os.path.join(path, STATE_FILE))
    if cfg is not None:
        with open(path + ".config.json", "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def load_checkpoint(path: str):
    """Returns (state, TrainConfig or None); the state's tensors are on the
    CPU."""
    path = os.path.abspath(path)
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    cfg = None
    cfg_path = path + ".config.json"
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            d = json.load(f)
        known = {f.name for f in dataclasses.fields(TrainConfig)}
        d = {k: v for k, v in d.items() if k in known}
        for k in ("ent_emb", "ent_emb_paths"):
            if isinstance(d.get(k), list):
                d[k] = tuple(d[k])
        cfg = TrainConfig(**d)
    return state, cfg


@torch.no_grad()
def restore_into(state: dict, model: nn.Module,
                 optimizer: TrainOptimizer | None = None,
                 generator: torch.Generator | None = None) -> None:
    """Copy a loaded checkpoint into `model` (parameters and BatchNorm
    statistics), `optimizer` (moments, counts and step) and `generator`,
    each tensor into the existing one on its device. Keys and shapes must
    match (reference qagnn.py:163-166 --load_model_path, but with the full
    state); of a row-sharded table (and its moments) this rank's rows are
    kept."""
    weights, saved = dict(state["model"]), dict(state["optimizer"])
    for name, rs in sharded_tables(model).items():
        weights[name] = weights[name][rs.start:rs.stop]
        for key in saved:
            if key.endswith("." + name):
                saved[key] = saved[key][rs.start:rs.stop]
    model.load_state_dict(weights, strict=True)
    if optimizer is not None:
        if set(saved) != set(optimizer.state):
            diff = sorted(set(saved) ^ set(optimizer.state))
            raise KeyError(f"optimizer state keys differ: {diff[:10]}")
        for key, t in optimizer.state.items():
            if tuple(t.shape) != tuple(saved[key].shape):
                raise ValueError(f"checkpoint/optimizer shape mismatch for "
                                 f"{key}: {tuple(saved[key].shape)} vs "
                                 f"{tuple(t.shape)}")
            t.copy_(saved[key])
    if generator is not None and state["generator"] is not None:
        generator.set_state(state["generator"])
