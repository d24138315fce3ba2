"""Carry a flax parameter tree across into the port's modules, and back.

Module paths of the port follow the flax module names, so a torch submodule
at `decoder.gnn.gnn_layer_0.key_x` reads `params["decoder"]["gnn"]
["gnn_layer_0"]["key_x"]`. Per module type:

  * nn.Linear      <- Dense {kernel (in, out), bias}, kernel transposed;
  * ProjParams     <- {kernel, bias} as they are (qagnn_tpu/models/gnn.py:46);
  * nn.Embedding   <- Embed {embedding};
  * nn.LayerNorm   <- LayerNorm {scale, bias};
  * MaskedBatchNorm <- {scale, bias} and batch_stats {mean, var};
  * XLNetRelativeAttention <- its raw leaves q, k, v, o, r, r_r_bias,
    r_s_bias, r_w_bias, seg_embed as they are;
  * LSTMCellParams <- an OptimizedLSTMCell: weight_ih stacks the input
    kernels ii, if, ig, io (each (in, H), transposed), weight_hh the hidden
    kernels hi, hf, hg, ho, bias their biases, in torch's gate order.

A module used several times (ALBERT's `layer_shared`) is one entry, as it
is one subtree in flax. The load is strict: a leaf of either tree that no
module reads, or a port parameter or buffer that no leaf sets, raises.
`to_flax_variables` and `grads_to_flax` go the other way by the same table,
and raise on a port tensor that the table does not place.
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping

import numpy as np
import torch
from torch import nn

from qagnn_tpu_torch.models.layers import ProjParams
from qagnn_tpu_torch.models.lstm_encoder import LSTMCellParams
from qagnn_tpu_torch.models.norm import MaskedBatchNorm
from qagnn_tpu_torch.models.xlnet_encoder import (
    RAW_PARAMS,
    XLNetRelativeAttention,
)

_GATES = "ifgo"     # torch's gate order; flax names a cell's gates so


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _table(model: nn.Module) -> Iterator[tuple]:
    """(module name, attribute, tree, flax paths, transpose) for every
    tensor of `model`. Several paths: the tensor is their leaves (each
    transposed when `transpose`) stacked along dim 0."""
    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()

        def leaf(attr, *leaf_path, tree="params", transpose=False):
            return (name, attr, tree, [path + leaf_path], transpose)
        if isinstance(mod, nn.Linear):
            yield leaf("weight", "kernel", transpose=True)
            if mod.bias is not None:
                yield leaf("bias", "bias")
        elif isinstance(mod, ProjParams):
            yield leaf("kernel", "kernel")
            if mod.bias is not None:
                yield leaf("bias", "bias")
        elif isinstance(mod, nn.Embedding):
            yield leaf("weight", "embedding")
        elif isinstance(mod, nn.LayerNorm):
            yield leaf("weight", "scale")
            yield leaf("bias", "bias")
        elif isinstance(mod, MaskedBatchNorm):
            yield leaf("scale", "scale")
            yield leaf("bias", "bias")
            yield leaf("mean", "mean", tree="batch_stats")
            yield leaf("var", "var", tree="batch_stats")
        elif isinstance(mod, XLNetRelativeAttention):
            for attr in RAW_PARAMS:
                yield leaf(attr, attr)
        elif isinstance(mod, LSTMCellParams):
            for attr, kind, what in (("weight_ih", "i", "kernel"),
                                     ("weight_hh", "h", "kernel"),
                                     ("bias", "h", "bias")):
                yield (name, attr, "params",
                       [path + (kind + g, what) for g in _GATES],
                       what == "kernel")


def flax_paths(model: nn.Module) -> dict[str, list[tuple]]:
    """Port parameter or buffer name -> the flax leaf paths it holds."""
    return {f"{name}.{attr}" if name else attr: paths
            for name, attr, _, paths, _ in _table(model)}


def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping | None = None) -> None:
    """Fill `model` from flax `params` / `batch_stats` trees (nested dicts
    of numpy arrays), strictly."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    used: set[tuple] = set()
    assigned: set[str] = set()
    modules = dict(model.named_modules())

    def read(tree_name, path):
        node = trees[tree_name]
        for p in path:
            if not isinstance(node, Mapping) or p not in node:
                raise KeyError(f"{tree_name} has no leaf {'/'.join(path)}")
            node = node[p]
        used.add((tree_name,) + path)
        return np.asarray(node)

    for name, attr, tree, paths, transpose in _table(model):
        leaves = [read(tree, p) for p in paths]
        value = np.concatenate([x.T if transpose else x for x in leaves])
        t = getattr(modules[name], attr)
        src = torch.tensor(value, dtype=t.dtype)
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}.{attr}: shape {tuple(t.shape)} "
                             f"but the flax leaves give {tuple(src.shape)}")
        with torch.no_grad():
            t.copy_(src)
        assigned.add(f"{name}.{attr}" if name else attr)

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
    trees: dict = {"params": {}, "batch_stats": {}}
    placed: set[str] = set()
    modules = dict(model.named_modules())

    for name, attr, tree, paths, transpose in _table(model):
        value = pick(getattr(modules[name], attr))
        for part, path in zip(np.split(value, len(paths)), paths):
            node = trees[tree]
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = part.T.copy() if transpose else part.copy()
        placed.add(f"{name}.{attr}" if name else attr)

    names = [n for n, _ in model.named_parameters()] \
        + [n for n, _ in model.named_buffers()]
    missing = [n for n in names if n not in placed]
    if missing:
        raise ValueError("port tensors with no place in the flax tree: "
                         + ", ".join(missing[:10]))
    return trees["params"], trees["batch_stats"]


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
