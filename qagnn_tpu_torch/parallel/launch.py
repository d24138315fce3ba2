"""Start the ranks of a grid: one process per rank.

The JAX package is one SPMD process and needs nothing of the kind; the port
runs one process per rank. `run_ranks` spawns them with torch's
multiprocessing (the `spawn` method), each joined to the others through a
`file://` store in a fresh temporary directory (no TCP port, so concurrent
runs never collide), or, when RANK and WORLD_SIZE are set (torchrun), joins
that world in the calling process instead.

Before it spawns ranks on the card it builds the CUDA kernels and the C++
edge packer once, so that the ranks find them built (each build renames its
output into place, so concurrent builds would only be wasted work).
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")
# after one rank fails, the seconds the others get to report before they
# are stopped (they may wait in a collective that never completes)
GRACE_S = 10.0


def check_backend(backend: str, n: int, device) -> None:
    """Raise for a backend that cannot run `n` ranks on `device`: NCCL
    takes one card a rank (it refuses two ranks on one device) and no CPU
    tensors."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend != "nccl":
        return
    if torch.device(device or "cuda").type != "cuda":
        raise ValueError("the nccl backend takes CUDA tensors only; pass "
                         "--dist_backend gloo to run ranks on the CPU")
    cards = torch.cuda.device_count()
    if n > cards:
        raise ValueError(f"{n} ranks on {cards} card(s): NCCL runs one rank "
                         "a card; pass --dist_backend gloo to share cards")


def _rank_main(rank, n, backend, device, store, timeout_s, fn, args, out):
    os.environ["LOCAL_RANK"] = str(rank)
    if torch.device(device or "cuda").type == "cpu":
        torch.set_num_threads(1)
    try:
        kw = {} if timeout_s is None else {
            "timeout": datetime.timedelta(seconds=timeout_s)}
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=n, rank=rank, **kw)
        try:
            out.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def _prebuild(device) -> None:
    if torch.device(device or "cuda").type == "cuda":
        from qagnn_tpu_torch.ops import _build
        _build.build_all()
    from qagnn_tpu_torch.native import build as native_build
    native_build.build_library()


def run_ranks(fn, n: int, backend: str = "gloo", device=None,
              timeout_s: float | None = 120.0, *args) -> list:
    """Run fn(*args) on `n` ranks joined in one process group of `backend`
    and return their results in rank order. fn and args are pickled to the
    ranks (a module-level function; results as host values), and each
    rank's device is `device` (the CPU) or its card (qagnn_tpu_torch
    .parallel.mesh.rank_device). Every rank is joined within `timeout_s`
    seconds (None: no limit); a rank that raises, dies or outlives it fails
    the call with every failed rank's traceback, the others stopped.

    Under torchrun (RANK and WORLD_SIZE set) the calling process is one
    rank of that world: it joins it and returns [its own result]."""
    check_backend(backend, n, device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != n:
            raise ValueError(f"{n} ranks asked for in a torchrun world of "
                             f"{os.environ['WORLD_SIZE']}")
        if not dist.is_initialized():
            if backend == "nccl":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                      % torch.cuda.device_count())
            dist.init_process_group(backend, init_method="env://")
        return [fn(*args)]
    _prebuild(device)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="qagnn_ranks_")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, backend, device,
                               os.path.join(tmp, "store"), timeout_s, fn,
                               args, out)) for r in range(n)]
    try:
        for p in procs:
            p.start()
        results, errors = _collect(procs, out, timeout_s)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5.0)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError(f"{len(errors)} of {n} ranks failed:\n" + "\n".join(
            f"--- rank {r} ---\n{msg}" for r, msg in sorted(errors.items())))
    return [results[r] for r in range(n)]


def _collect(procs, out, timeout_s):
    """Read every rank's report, draining the queue before any join.
    Returns (results, errors) by rank. After a first error the others get
    GRACE_S more seconds."""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    results, errors = {}, {}

    def pending():
        return [r for r in range(len(procs))
                if r not in results and r not in errors]

    while pending():
        if deadline is not None and time.monotonic() >= deadline:
            why = "stopped after another rank failed" if errors \
                else f"did not finish within {timeout_s} s"
            errors.update({r: why for r in pending()})
            break
        dead = [r for r in pending() if procs[r].exitcode is not None]
        try:
            # a rank that exited may still have its report in the pipe
            rank, ok, value = out.get(timeout=2.0 if dead else 1.0)
            (results if ok else errors)[rank] = value
        except queue.Empty:
            if dead:
                errors[dead[0]] = (f"exited with code "
                                   f"{procs[dead[0]].exitcode} without a "
                                   "report")
        if errors:
            grace = time.monotonic() + GRACE_S
            deadline = grace if deadline is None else min(deadline, grace)
    return results, errors
