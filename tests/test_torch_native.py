"""The port's C++ edge packer (qagnn_tpu_torch/native) against the JAX
package's packing and the port's numpy version (CPU, exact).

`batch_edge_lists` packs through native/packer.cc. Its arrays must equal,
element for element and dtype for dtype, those of the port's `_pack_plain`
(a stable numpy argsort per graph) and those of the JAX package's
`batch_edge_lists` on both of its routes: its own C++ packer and, with
`_native_lib` patched to None, its numpy loop. Cases: random batches of
int64 and int32 arrays laid out contiguously, as columns of one array (the
graph cache's views) and with strided rows; graphs with no edges; a
truncating budget and its warning; sources up to 4000; graphs read through
the port's graph cache. And the build: into a fresh directory from two
processes at once, and a failed build raising with the compiler's output.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from qagnn_tpu.graph import batching as jax_batching

from qagnn_tpu_torch.data import graphs
from qagnn_tpu_torch.data.synthetic import write_synthetic_dataset
from qagnn_tpu_torch.graph import batching
from qagnn_tpu_torch.native import build

ROOT = Path(__file__).resolve().parents[1]
EDGE_FIELDS = ("edge_src", "edge_dst", "edge_type", "edge_mask")


def _lists(rng, sizes, n_nodes, dtype=np.int32, layout="contiguous",
           n_rel=38):
    """Per-graph (2, e) edge indices and (e,) types with e from `sizes`, in
    one of three layouts: each graph its own contiguous arrays; columns of
    one (2, total) array (the graph cache's views: contiguous rows, a
    block that is not); every other column of a wider array (strided
    rows)."""
    sizes = list(sizes)
    total = sum(sizes)
    src = rng.integers(0, n_nodes, total)
    dst = rng.integers(0, n_nodes, total)
    typ = rng.integers(0, n_rel, total)
    splits = np.cumsum(sizes)[:-1]
    if layout == "contiguous":
        eis = [np.stack([s, d]).astype(dtype)
               for s, d in zip(np.split(src, splits), np.split(dst, splits))]
        ets = [t.astype(dtype) for t in np.split(typ, splits)]
    elif layout == "cache_views":
        flat = np.stack([src, dst]).astype(dtype)
        eis = np.split(flat, splits, axis=1)
        ets = np.split(typ.astype(dtype), splits)
    else:
        wide = np.zeros((2, 2 * total), dtype)
        wide[:, ::2] = np.stack([src, dst])
        wide_t = np.zeros(2 * total, dtype)
        wide_t[::2] = typ
        eis = np.split(wide[:, ::2], splits, axis=1)
        ets = np.split(wide_t[::2], splits)
    return eis, ets


def _nodes(n_graphs, n_nodes):
    return (np.zeros((n_graphs, n_nodes), np.int32),
            np.zeros((n_graphs, n_nodes), np.int32),
            np.zeros((n_graphs, n_nodes), np.float32),
            np.full(n_graphs, n_nodes, np.int32))


def _jax_routes(eis, ets, n_nodes, budget, monkeypatch):
    """The JAX package's batch_edge_lists on its C++ route and on its
    numpy route (warnings off: the callers check them once)."""
    assert jax_batching._native_lib() is not None, "no JAX C++ packer"
    nodes = _nodes(len(eis), n_nodes)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        native = jax_batching.batch_edge_lists(
            eis, ets, *nodes, edges_per_graph=budget)
        with monkeypatch.context() as m:
            m.setattr(jax_batching, "_native_lib", lambda: None)
            plain = jax_batching.batch_edge_lists(
                eis, ets, *nodes, edges_per_graph=budget)
    return {"jax native": native, "jax numpy": plain}


def _check_all_equal(eis, ets, n_nodes, budget, monkeypatch):
    """The port's packed batch equals `_pack_plain` and both JAX routes,
    array for array; returns it."""
    got = batching.batch_edge_lists(eis, ets, *_nodes(len(eis), n_nodes),
                                    edges_per_graph=budget)
    budget = got.edge_src.shape[1]
    for name in EDGE_FIELDS:
        assert isinstance(getattr(got, name), torch.Tensor)
    assert got.edge_mask.dtype == torch.bool
    plain = batching._pack_plain(eis, ets, budget)
    for name, want in zip(EDGE_FIELDS, plain):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want,
                                      err_msg=f"{name} vs _pack_plain")
        assert getattr(got, name).numpy().dtype == want.dtype
    for route, want in _jax_routes(eis, ets, n_nodes, budget,
                                   monkeypatch).items():
        for name in EDGE_FIELDS:
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert g.dtype == w.dtype, f"{name} vs {route}"
            np.testing.assert_array_equal(g, w, err_msg=f"{name} vs {route}")
    return got


@pytest.mark.parametrize("layout", ["contiguous", "cache_views", "strided"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_random_batches_match_plain_and_jax(dtype, layout, monkeypatch):
    rng = np.random.default_rng(7)
    sizes = rng.integers(0, 700, 24)
    eis, ets = _lists(rng, sizes, 60, dtype, layout)
    if layout == "cache_views":
        assert not eis[1].flags.c_contiguous and eis[1][0].flags.c_contiguous
    if layout == "strided":
        assert not eis[1][0].flags.c_contiguous
    got = _check_all_equal(eis, ets, 60, None, monkeypatch)
    assert got.edge_src.shape == (24, 1024)
    # sorted by source within each graph; the padding is zero
    for g, e in enumerate(sizes):
        assert np.all(np.diff(got.edge_src[g, :e].numpy()) >= 0)
        assert not got.edge_mask[g, e:].any() and got.edge_mask[g, :e].all()
        assert not got.edge_src[g, e:].any() and not got.edge_type[g, e:].any()


def test_graphs_with_no_edges(monkeypatch):
    rng = np.random.default_rng(8)
    eis, ets = _lists(rng, [0, 40, 0, 0, 17, 0], 12)
    got = _check_all_equal(eis, ets, 12, None, monkeypatch)
    assert got.edge_src.shape == (6, 256)
    assert int(got.edge_mask.sum()) == 57


@pytest.mark.parametrize("budget", [None, 512])
def test_a_batch_with_no_edges(budget, monkeypatch):
    eis, ets = _lists(np.random.default_rng(9), [0] * 5, 4)
    got = _check_all_equal(eis, ets, 4, budget, monkeypatch)
    assert got.edge_src.shape == (5, budget or 256)
    assert not got.edge_mask.any() and not got.edge_src.any()


def test_truncation_keeps_the_lowest_index_edges_and_warns(monkeypatch):
    rng = np.random.default_rng(10)
    sizes = [300, 700, 1200, 0, 256]
    eis, ets = _lists(rng, sizes, 90, np.int64, "cache_views")
    nodes = _nodes(len(eis), 90)
    with pytest.warns(UserWarning, match="truncates") as w_got:
        batching.batch_edge_lists(eis, ets, *nodes, edges_per_graph=256)
    with pytest.warns(UserWarning, match="truncates") as w_want:
        jax_batching.batch_edge_lists(eis, ets, *nodes, edges_per_graph=256)
    assert str(w_got[0].message) == str(w_want[0].message)
    assert "truncates 1432 edges across 3/5 graphs" in str(w_got[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _check_all_equal(eis, ets, 90, 256, monkeypatch)
    assert got.edge_mask.sum(1).tolist() == [256, 256, 256, 0, 256]
    # graph 1 keeps its first 256 edges, sorted
    order = np.argsort(eis[1][0, :256], kind="stable")
    np.testing.assert_array_equal(got.edge_dst[1].numpy(),
                                  eis[1][1, :256][order])


def test_sources_up_to_4000_nodes(monkeypatch):
    rng = np.random.default_rng(11)
    eis, ets = _lists(rng, [5000, 3, 4096, 1], 4000, np.int32)
    eis[2][0, 7] = 3999                   # the largest source there is
    got = _check_all_equal(eis, ets, 4000, 8192, monkeypatch)
    assert int(got.edge_src.max()) == 3999


def test_graphs_read_through_the_cache(tmp_path, monkeypatch):
    root = str(tmp_path / "data")
    write_synthetic_dataset(root, n_questions=6)
    path = f"{root}/graph/train.graph.adj.pk"
    fresh = graphs.load_graph_pk(path, 200)          # writes the cache
    cached = graphs.load_graph_pk(path, 200)         # reads it
    assert os.path.exists(path + ".tpu_cache.npz")
    assert not all(ei.flags.c_contiguous for ei in cached.edge_indices)
    got = _check_all_equal(cached.edge_indices, cached.edge_types, 200, None,
                           monkeypatch)
    want = batching.batch_edge_lists(
        fresh.edge_indices, fresh.edge_types, fresh.concept_ids,
        fresh.node_types, fresh.node_scores, fresh.num_nodes)
    for name in EDGE_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_bad_inputs_raise():
    nodes = _nodes(2, 8)
    ei = np.array([[0, 1, 2], [1, 2, 0]], np.int32)
    with pytest.raises(ValueError, match="negative source"):
        batching.batch_edge_lists(
            [ei, np.array([[1, -1], [0, 0]])], [np.zeros(3), np.zeros(2)],
            *nodes)
    with pytest.raises(ValueError, match="need"):
        batching.batch_edge_lists([ei, ei], [np.zeros(3), np.zeros(2)],
                                  *nodes)


_BUILD_AND_PACK = """
import sys
from pathlib import Path
import numpy as np
sys.path.insert(0, {root!r})
from qagnn_tpu_torch.native import build
build.BUILD_DIR = Path({build_dir!r})
from qagnn_tpu_torch.graph import batching
ei = np.array([[2, 0, 1, 0], [0, 1, 2, 2]], np.int32)
src, dst, typ, mask = batching._pack_native([ei], [np.arange(4)], 8)
assert src.tolist() == [[0, 0, 1, 2, 0, 0, 0, 0]], src
assert dst.tolist() == [[1, 2, 2, 0, 0, 0, 0, 0]], dst
print(build.target().name)
"""


def test_two_processes_build_into_a_fresh_directory(tmp_path):
    build_dir = tmp_path / "native"
    code = _BUILD_AND_PACK.format(root=str(ROOT), build_dir=str(build_dir))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(names)
    assert names.pop().startswith("libpacker.")


def test_build_flags_and_path():
    assert "-march=native" not in build.CXX_FLAGS
    assert build.target().parent == ROOT / "build" / "native"
    assert build.target().name.startswith("libpacker.")
    assert build.target().suffix == ".so"


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "packer.cc"
    bad.write_text("int pack_edges_rows( {\n")
    monkeypatch.setattr(build, "SOURCE", bad)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        build.build_library()
    assert "error" in str(err.value)
    assert not list((tmp_path / "out").iterdir())
