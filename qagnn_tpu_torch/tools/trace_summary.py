"""The device ops of a torch.profiler Chrome trace, by total time.

Counterpart of tools/trace_summary.py. It reads the newest `*.json` or
`*.json.gz` trace under a directory (`profile_step`'s, or the CLI's
`--profile_dir` trace.json), sums the complete ("ph": "X") events of the
device categories `kernel`, `gpu_memcpy` and `gpu_memset`, and prints the
total device op time and the top ops: ms, share, count, name.

    python -m qagnn_tpu_torch.tools.trace_summary DIR [top_n]

A trace with no device event (a CPU run's, or a window in which the
profiler recorded no device activity) is an error: it says so, naming the
file, and exits 1.

The port's kernels launch through ctypes, so a trace names them by their
`__global__` functions in csrc/, not by the entry points that
`ops/_build.LAUNCHES` counts; one entry point can run several, and
`reduce_partials_kernel` serves four. `PORT_KERNELS` maps each entry point
of rows 6-12, by route, to the `__global__` kernels one call launches, and
`expected_kernels` turns launch counts into the counts a trace must show.
"""

from __future__ import annotations

import collections
import gzip
import json
import re
import sys
from pathlib import Path
from typing import Mapping, NamedTuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# (entry point, route) -> {__global__ kernel: launches a call}; route None
# for the entry points with one route (csrc/gat_fwd.cu, gat_fwd_tc.cuh,
# gat_bwd.cu, gat_bwd_tc.cuh, edge_moments.cu, edge_hidden.cu,
# edge_hidden_tc.cuh). Route 1 of backward passes 1 and 2 launches its edge
# kernel once a call at every D: W resident in shared memory up to 256 rows,
# streamed through it past that (`edge_pass_tc_kernel<PASS, PAIRS, STREAM>`).
# A pass of more than one column launch ends on one `gat_bwd_demb` call,
# the demb product over all of its columns (its column launches then make
# none: on route 0 no `demb_kernel` of their own). Every pass on route 1
# makes its dW in one `gat_bwd_dw` call over all of its columns
# (`dw_wgmma_kernel` and the sum of its slot ranges' partials; its edge
# launches then make no dW), route 0 in each column launch.
# Route 1 of rows 11 and 12 runs all of D's column slices in one launch of
# each kernel (`edge_hidden_tc_kernel<T, PIECE, WINDOWS>`,
# `edge_hidden_bwd_tc_kernel<T, NT, PIECE>`) in both dtypes.
_BWD_TC = {"edge_pass_tc_kernel": 1, "reduce_partials_kernel": 1}
PORT_KERNELS: dict[tuple[str, int | None], dict[str, int]] = {
    ("gat_pass_a_scores", 1): {"fwd_pass_tc_kernel": 1},
    ("gat_pass_a_scores", 0): {"pass_a_scores_kernel": 1},
    ("gat_pass_a_denoms", None): {"pass_a_denoms_kernel": 1},
    ("gat_pass_c", 1): {"fwd_pass_tc_kernel": 1},
    ("gat_pass_c", 0): {"pass_c_kernel": 1},
    ("gat_bwd_pass1", 1): _BWD_TC,
    ("gat_bwd_pass1", 0): {"bwd1_edge_kernel": 1, "demb_kernel": 1,
                           "dw_partial_kernel": 1,
                           "reduce_partials_kernel": 2},
    ("gat_bwd_pass2", 1): _BWD_TC,
    ("gat_bwd_pass2", 0): {"bwd2_edge_kernel": 1, "demb_kernel": 1,
                           "dw_partial_kernel": 1,
                           "reduce_partials_kernel": 2},
    ("gat_bwd_demb", 1): {"demb_tc_kernel": 1},
    ("gat_bwd_demb", 0): {"demb_kernel": 1},
    ("gat_bwd_dw", 1): {"dw_wgmma_kernel": 1, "reduce_partials_kernel": 1},
    ("gat_bwd_dw", 0): {"dw_tc_kernel": 1, "reduce_partials_kernel": 1},
    ("edge_moments", None): {"edge_moments_kernel": 1},
    ("edge_hidden", 1): {"edge_hidden_tc_kernel": 1},
    ("edge_hidden", 0): {"edge_hidden_kernel": 1},
    ("edge_hidden_bwd", 1): {"edge_rows_kernel": 1,
                             "edge_hidden_bwd_tc_kernel": 1,
                             "reduce_partials_kernel": 1},
    ("edge_hidden_bwd", 0): {"edge_hidden_bwd_kernel": 1,
                             "reduce_partials_kernel": 1},
}


class Row(NamedTuple):
    name: str
    ms: float
    count: int


class NoDeviceEvents(ValueError):
    """The trace holds no device event."""


def find_trace(root) -> Path:
    """`root` if it is a file, else the newest *.json / *.json.gz under
    it."""
    root = Path(root)
    if root.is_file():
        return root
    paths = [p for pattern in ("*.json", "*.json.gz")
             for p in root.rglob(pattern)]
    if not paths:
        raise FileNotFoundError(f"no *.json or *.json.gz trace under {root}")
    return max(paths, key=lambda p: p.stat().st_mtime)


def device_events(path) -> list[dict]:
    """The complete events of the device categories in a Chrome trace."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]


def summarise(path, top_n: int | None = None) -> list[Row]:
    """The device ops of the trace at `path` (a file, or the newest trace
    under a directory) by total time, largest first, the first `top_n` of
    them (all for None). Raises NoDeviceEvents when it holds none."""
    path = find_trace(path)
    ms: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    events = device_events(path)
    if not events:
        raise NoDeviceEvents(
            f"{path}: no device events (categories "
            f"{', '.join(DEVICE_CATEGORIES)}): nothing of the card to "
            "summarise")
    for e in events:
        name = e.get("name", "?")
        ms[name] += e.get("dur", 0) / 1e3
        counts[name] += 1
    rows = [Row(name, t, counts[name]) for name, t in ms.most_common()]
    return rows if top_n is None else rows[:top_n]


def kernel_base(name: str) -> str:
    """The bare function name of a kernel as the profiler prints it:
    'void (anonymous namespace)::dw_tc_kernel<2, 16>(...)' ->
    'dw_tc_kernel'."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"\s*(?:void\s+)?(?:[\w]+::)*(\w+)", name)
    return m.group(1) if m else name


def kernel_counts(rows) -> collections.Counter:
    """Launches in `rows` by bare kernel name."""
    out: collections.Counter = collections.Counter()
    for row in rows:
        out[kernel_base(row.name)] += row.count
    return out


def entry_calls(launches: Mapping[str, int],
                routes: Mapping[tuple[str, int], int]) -> dict:
    """(entry point, route) -> calls, from `_build.LAUNCHES` and
    `_build.ROUTES`, for the entry points of PORT_KERNELS."""
    calls = {key: n for key, n in routes.items() if key in PORT_KERNELS}
    calls.update({(name, None): n for name, n in launches.items()
                  if (name, None) in PORT_KERNELS})
    return calls


def expected_kernels(calls: Mapping[tuple[str, int | None], int]) \
        -> collections.Counter:
    """The launches of each `__global__` kernel that `calls` ((entry point,
    route) -> calls) make."""
    out: collections.Counter = collections.Counter()
    for key, n in calls.items():
        for kernel, per_call in PORT_KERNELS[key].items():
            out[kernel] += n * per_call
    return out


def print_summary(path, top_n: int = 40) -> list[Row]:
    """Print the table; returns every row."""
    path = find_trace(path)
    rows = summarise(path)
    total = sum(r.ms for r in rows)
    print(f"trace: {path}")
    print(f"total device op time: {total:.2f} ms")
    print(f"{'ms':>9}  {'%':>5}  {'n':>4}  op")
    for r in rows[:top_n]:
        print(f"{r.ms:9.2f}  {100 * r.ms / max(total, 1e-9):5.1f}  "
              f"{r.count:4d}  {r.name[:110]}")
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m qagnn_tpu_torch.tools.trace_summary DIR "
              "[top_n]", file=sys.stderr)
        return 2
    top_n = int(argv[1]) if len(argv) > 1 else 40
    try:
        print_summary(argv[0], top_n)
    except (NoDeviceEvents, FileNotFoundError) as exc:
        print(f"trace_summary: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
