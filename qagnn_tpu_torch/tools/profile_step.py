"""A torch.profiler trace of the GNN train step on the card.

Counterpart of profile_step.py. It trains `QAGNNMessagePassing` at the
bench shapes (G=64 graphs, N=200 nodes, E=4096 edge slots, D=200, k=5, 38
relations, dropout 0.2, bf16) for one warm step, then three traced steps
under torch.profiler (CPU and CUDA activity), and writes the Chrome trace
into --trace-dir. On the card the trace opens with a lead-in, one small
kernel and LEAD_IN_S of idle time, ahead of the traced steps: on an H100 a
trace that opened with them held two of the three `edge_moments_kernel`
launches, the traced steps' first kernel of ours, in three of the six
traces of chip_smoke.py's tools phase on record, all late in a long
process. Whether the profiler drops a session's first records or places
its first kernels before the session's start, the lead-in takes the loss.
Each step is loss = sum(out * out), then backward, then
p -= 1e-5 * grad for every parameter and H += 1e-4 * dH, the BatchNorm
running statistics updated by the train-mode forward.

    python -m qagnn_tpu_torch.tools.profile_step [--backend cuda|scatter] \
        [--trace-dir /tmp/qagnn_prof] [--device cpu]
    python -m qagnn_tpu_torch.tools.trace_summary /tmp/qagnn_prof

backend "cuda" (the default) runs the kernels: on the card a step launches
rows 6 (scores and denominators) and 7-9 k times each and rows 10-12 once
each; "scatter" runs the scatter oracle. It runs on the card unless
--device names another device.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from qagnn_tpu_torch.models.gnn import QAGNNMessagePassing
from qagnn_tpu_torch.models.layers import dropout_generator
from qagnn_tpu_torch.ops import _build
from qagnn_tpu_torch.utils.config import resolve_device
from qagnn_tpu_torch.utils.initialization import init_weights


class Shapes(NamedTuple):
    G: int = 64
    N: int = 200
    E: int = 4096
    D: int = 200
    k: int = 5


N_NTYPE, N_ETYPE = 4, 38
TRACED_STEPS = 3
LEAD_IN_S = 0.05
TRACE_FILE = "profile_step.json"


def step_inputs(shapes: Shapes = Shapes()):
    """profile_step.py's inputs (:22-30) from default_rng(0): H, node_type,
    node_score, edge_src, edge_dst, edge_type, and a mask of all slots."""
    G, N, E, D, _ = shapes
    rng = np.random.default_rng(0)
    return (rng.standard_normal((G, N, D)).astype(np.float32),
            rng.integers(0, N_NTYPE, (G, N)).astype(np.int32),
            rng.standard_normal((G, N)).astype(np.float32),
            rng.integers(0, N, (G, E)).astype(np.int32),
            rng.integers(0, N, (G, E)).astype(np.int32),
            rng.integers(0, N_ETYPE, (G, E)).astype(np.int32),
            np.ones((G, E), bool))


def profile(trace_dir: str = "/tmp/qagnn_prof", backend: str = "cuda",
            device=None, shapes: Shapes = Shapes(),
            dtype: torch.dtype = torch.bfloat16, dropout: float = 0.2,
            state: dict | None = None) -> dict:
    """Train one warm step and TRACED_STEPS traced ones, printing `warm`,
    `traced` and `done`. `state` is a state_dict to start from; None draws
    normal(0, 0.02) weights from a generator seeded 0. Returns the losses
    ({"warm", "traced"}), the trace's path ("trace") and the kernels'
    launches over the traced steps ("launches", "routes": what
    `_build.LAUNCHES` and `_build.ROUTES` counted)."""
    dev = resolve_device(device)
    model = QAGNNMessagePassing(
        k=shapes.k, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=shapes.D,
        dropout=dropout, backend=backend, dtype=dtype).to(dev)
    generator = torch.Generator(device=dev).manual_seed(0)
    if state is None:
        init_weights(model, generator)
    else:
        model.load_state_dict(state)
    model.train()
    H, *rest = (torch.as_tensor(a, device=dev) for a in step_inputs(shapes))
    params = list(model.parameters())

    def step(H):
        H = H.detach().requires_grad_()
        with dropout_generator(generator):
            out = model(H, *rest)
        loss = torch.sum(out.float() * out.float())
        grads = torch.autograd.grad(loss, params + [H], allow_unused=True)
        with torch.no_grad():
            for p, g in zip(params, grads):
                if g is not None:
                    p -= 1e-5 * g
            H = H + 1e-4 * grads[-1]
        return H.detach(), loss.detach()

    H, warm = step(H)
    warm = warm.item()
    print("warm", warm, flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    launches = collections.Counter(_build.LAUNCHES)
    routes = collections.Counter(_build.ROUTES)
    with torch.profiler.profile(activities=activities) as prof:
        if dev.type == "cuda":
            torch.zeros(1, device=dev)
            torch.cuda.synchronize()
            time.sleep(LEAD_IN_S)
        for _ in range(TRACED_STEPS):
            H, loss = step(H)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    loss = loss.item()
    print("traced", loss, flush=True)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print("done", flush=True)
    return {"warm": warm, "traced": loss, "trace": path,
            "launches": dict(collections.Counter(_build.LAUNCHES) - launches),
            "routes": dict(collections.Counter(_build.ROUTES) - routes)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="cuda", choices=("cuda", "scatter"))
    ap.add_argument("--trace-dir", default="/tmp/qagnn_prof")
    ap.add_argument("--device", default=None,
                    help="torch device (e.g. cpu); default: the CUDA card, "
                         "and an error when there is none")
    args = ap.parse_args(argv)
    profile(args.trace_dir, args.backend, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
