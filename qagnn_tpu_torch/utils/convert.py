"""Carry a flax parameter tree across into the port's modules, and back.

Module paths of the port follow the flax module names, so a torch submodule
at `decoder.gnn.gnn_layer_0.key_x` reads `params["decoder"]["gnn"]
["gnn_layer_0"]["key_x"]`. Per module type:

  * nn.Linear      <- Dense {kernel (in, out), bias}, kernel transposed;
  * ProjParams     <- {kernel, bias} as they are (qagnn_tpu/models/gnn.py:46);
  * nn.Embedding   <- Embed {embedding};
  * nn.LayerNorm   <- LayerNorm {scale, bias};
  * MaskedBatchNorm <- {scale, bias} and batch_stats {mean, var}.

The load is strict: a leaf of either tree that no module reads, or a port
parameter or buffer that no leaf sets, raises. `to_flax_variables` and
`grads_to_flax` go the other way by the same table (Linear weights
transposed back), and raise on a port tensor that the table does not place.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from qagnn_tpu_torch.models.layers import ProjParams
from qagnn_tpu_torch.models.norm import MaskedBatchNorm


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping | None = None) -> None:
    """Fill `model` from flax `params` / `batch_stats` trees (nested dicts
    of numpy arrays), strictly."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    used: set[tuple] = set()
    assigned: set[str] = set()

    def read(tree_name, path):
        node = trees[tree_name]
        for p in path:
            if not isinstance(node, Mapping) or p not in node:
                raise KeyError(f"{tree_name} has no leaf {'/'.join(path)}")
            node = node[p]
        used.add((tree_name,) + path)
        return np.asarray(node)

    def put(module_name, module, attr, value):
        t = getattr(module, attr)
        src = torch.tensor(np.asarray(value), dtype=t.dtype)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{module_name}.{attr}: shape {tuple(t.shape)} "
                             f"but the flax leaf is {tuple(src.shape)}")
        with torch.no_grad():
            t.copy_(src)
        assigned.add(f"{module_name}.{attr}" if module_name else attr)

    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, nn.Linear):
            put(name, mod, "weight", read("params", path + ("kernel",)).T)
            if mod.bias is not None:
                put(name, mod, "bias", read("params", path + ("bias",)))
        elif isinstance(mod, ProjParams):
            put(name, mod, "kernel", read("params", path + ("kernel",)))
            if mod.bias is not None:
                put(name, mod, "bias", read("params", path + ("bias",)))
        elif isinstance(mod, nn.Embedding):
            put(name, mod, "weight", read("params", path + ("embedding",)))
        elif isinstance(mod, nn.LayerNorm):
            put(name, mod, "weight", read("params", path + ("scale",)))
            put(name, mod, "bias", read("params", path + ("bias",)))
        elif isinstance(mod, MaskedBatchNorm):
            put(name, mod, "scale", read("params", path + ("scale",)))
            put(name, mod, "bias", read("params", path + ("bias",)))
            put(name, mod, "mean", read("batch_stats", path + ("mean",)))
            put(name, mod, "var", read("batch_stats", path + ("var",)))

    unused = [(t,) + p for t in trees for p in _leaf_paths(trees[t])
              if (t,) + p not in used]
    if unused:
        raise ValueError("flax leaves not used by the port: "
                         + ", ".join("/".join(u) for u in unused[:10]))
    names = [n for n, _ in model.named_parameters()] \
        + [n for n, _ in model.named_buffers()]
    unset = [n for n in names if n not in assigned]
    if unset:
        raise ValueError("port tensors not set from the flax tree: "
                         + ", ".join(unset[:10]))


def _export(model: nn.Module, pick) -> tuple[dict, dict]:
    """(params, batch_stats) nested dicts under the flax names; pick(tensor)
    -> numpy array chooses what is exported of each parameter."""
    params: dict = {}
    stats: dict = {}
    placed: set[str] = set()

    def put(tree, path, module_name, attr, transpose=False):
        t = getattr(dict(model.named_modules())[module_name], attr)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        value = pick(t)
        node[path[-1]] = value.T.copy() if transpose else value
        placed.add(f"{module_name}.{attr}" if module_name else attr)

    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, nn.Linear):
            put(params, path + ("kernel",), name, "weight", transpose=True)
            if mod.bias is not None:
                put(params, path + ("bias",), name, "bias")
        elif isinstance(mod, ProjParams):
            put(params, path + ("kernel",), name, "kernel")
            if mod.bias is not None:
                put(params, path + ("bias",), name, "bias")
        elif isinstance(mod, nn.Embedding):
            put(params, path + ("embedding",), name, "weight")
        elif isinstance(mod, nn.LayerNorm):
            put(params, path + ("scale",), name, "weight")
            put(params, path + ("bias",), name, "bias")
        elif isinstance(mod, MaskedBatchNorm):
            put(params, path + ("scale",), name, "scale")
            put(params, path + ("bias",), name, "bias")
            put(stats, path + ("mean",), name, "mean")
            put(stats, path + ("var",), name, "var")

    names = [n for n, _ in model.named_parameters()] \
        + [n for n, _ in model.named_buffers()]
    missing = [n for n in names if n not in placed]
    if missing:
        raise ValueError("port tensors with no place in the flax tree: "
                         + ", ".join(missing[:10]))
    return params, stats


def to_flax_variables(model: nn.Module) -> tuple[dict, dict]:
    """(params, batch_stats) of `model` as nested dicts of numpy arrays under
    the flax names."""
    return _export(model, lambda t: t.detach().cpu().float().numpy().copy())


def grads_to_flax(model: nn.Module) -> dict:
    """The parameters' `.grad`s in the tree of `to_flax_variables`'s params
    (zeros where a parameter has no gradient)."""
    def grad(t):
        g = getattr(t, "grad", None)
        src = torch.zeros_like(t) if g is None else g
        return src.detach().cpu().float().numpy().copy()
    return _export(model, grad)[0]
