"""The port's edge-partitioned ops and GNN on a grid of CPU ranks, against
the JAX package's sharded counterparts (tests/test_parallel.py's shapes).

Each grid, 2 x 4 and 1 x 2, is one spawn of gloo ranks on the CPU
(parallel/launch.py `run_ranks`, at most 120 s) whose ranks compute every
case on their slice: the projected op (`gat_projected_sharded`, rows 6-9),
the unprojected op (`edge_sharded_gat_nodes`, rows 1-5), the edge encoder's
sharded kernels (rows 10-12) and QAGNNMessagePassing(mesh=...) in train
mode. The parent assembles the slices: outputs and node cotangents by data
slice (each the same on every rank of its model group), edge cotangents by
data and edge slice, parameter gradients summed over the data slices (the
ops sum them over `model`; the train step sums over `data`).

The JAX side runs in this process on the 8-device CPU mesh of
tests/conftest.py: pallas_edge_sharded_projected and the encoder's sharded
kernels in interpret mode on make_mesh(2, 4), edge_sharded_gat_nodes, and
QAGNNMessagePassing(mesh=...) with the pallas backend; the model's
gradients are held against the single-device JAX model, as a grid that
summed a gradient twice, or missed a rank's part, would not match it.

Each case is also held against the port's own one-rank function on the
same inputs (gat_projected, the unprojected op, the encoder's kernels,
QAGNNMessagePassing without a mesh): max|grid - one rank| <= 1e-5 of the
largest value, f32 sums in another order.

Tolerances against JAX: tests/test_parallel.py's rtol 5e-4 with its atol
5e-5 taken of each array's largest value (these inputs are unscaled
normals, so cotangents reach 1e3 and an element near zero carries the
cancellation of its sums; the one-rank port differs from JAX by as much);
the model's output and BatchNorm statistics the same, its gradients at
tests/test_torch_gnn.py's rtol 1e-3 with a floor of 1e-4 of a leaf's
largest value (f32 sums of other orders through k layers and two
BatchNorms, the one-rank port against JAX already).

JAX is imported in the parent's fixtures only: the ranks import this
module, and load no JAX.
"""

import numpy as np
import pytest
import torch

from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.models.gnn import QAGNNMessagePassing
from qagnn_tpu_torch.parallel.edge_shard_kernels import (
    edge_feature_moments_sharded,
    edge_hidden_sharded,
    gat_projected_sharded,
)
from qagnn_tpu_torch.parallel.edge_shard_map import edge_sharded_gat_nodes
from qagnn_tpu_torch.parallel.graph_sharding import edge_slice, shard_graph
from qagnn_tpu_torch.parallel.launch import run_ranks
from qagnn_tpu_torch.parallel.mesh import data_slice, make_mesh
from qagnn_tpu_torch.utils.convert import (
    grads_to_flax,
    load_flax_variables,
    to_flax_variables,
)

RTOL, ATOL = 5e-4, 5e-5
ONE_RANK_TOL = 1e-5
GRIDS = [(2, 4), (1, 2)]
SPAWN_S = 120
N_NTYPE, N_ETYPE, K, D = 4, 6, 2, 8
N_REL = N_ETYPE + 1
HEADS = 2


# --------------------------------------------------------------------------
# inputs (numpy, from seeds)
# --------------------------------------------------------------------------

def _proj_case():
    rng = np.random.default_rng(5)
    G, N, E, HD, D_IN = 4, 8, 16, 8, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c = dict(nq=f(G, N, HD), nk=f(G, N, HD), nm=f(G, N, HD),
             emb=f(G, E, D_IN), wke=f(D_IN, HD), bke=f(HD),
             wme=f(D_IN, HD), bme=f(HD), skb=f(G, N, HD), smb=f(G, N, HD))
    c.update(src=rng.integers(0, N, (G, E)).astype(np.int32),
             dst=rng.integers(0, N, (G, E)).astype(np.int32),
             mask=rng.random((G, E)) > 0.25)
    c["mask"][1] = False                   # a graph with every slot masked
    return c


PROJ_NODE = ("nq", "nk", "nm", "skb", "smb")
PROJ_EDGE = ("emb",)
PROJ_PARAM = ("wke", "bke", "wme", "bme")
PROJ_DIFF = ("nq", "nk", "nm", "emb", "wke", "bke", "wme", "bme", "skb",
             "smb")


def _unproj_case():
    rng = np.random.default_rng(6)
    G, N, E, H, Dh = 4, 8, 16, 2, 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c = dict(nq=f(G, N, H, Dh), nk=f(G, N, H, Dh), nm=f(G, N, H, Dh),
             ekb=f(G, E, H, Dh), emb=f(G, E, H, Dh), skb=f(G, N, H, Dh),
             smb=f(G, N, H, Dh))
    c.update(src=rng.integers(0, N, (G, E)).astype(np.int32),
             dst=rng.integers(0, N, (G, E)).astype(np.int32),
             mask=rng.random((G, E)) > 0.25)
    return c


UNPROJ_DIFF = ("nq", "nk", "nm", "ekb", "emb", "skb", "smb")
UNPROJ_EDGE = ("ekb", "emb")


def _enc_case():
    """E is padded as the JAX encoder's sharded kernels need it (whole
    tiles a 4-way slice): both sides take the padded arrays."""
    from qagnn_tpu.ops.pallas_gat import pad_edges_to_tile
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    G, N, E = 4, 8, 16
    F = N_REL + 2 * N_NTYPE
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mask = rng.random((G, E)) > 0.25
    mask[2] = False
    _, src, dst, mask, etype = pad_edges_to_tile(
        jnp.asarray(rng.integers(0, N, (G, E)), jnp.int32),
        jnp.asarray(rng.integers(0, N, (G, E)), jnp.int32),
        jnp.asarray(mask, jnp.float32),
        jnp.asarray(rng.integers(0, N_REL, (G, E)), jnp.int32),
        dtype=jnp.float32, shards=4)
    Ep = src.shape[1]
    return dict(etype=np.asarray(etype), src=np.asarray(src),
                dst=np.asarray(dst), mask=np.asarray(mask) > 0,
                ntype=rng.integers(0, N_NTYPE, (G, N)).astype(np.int32),
                w0=f(F, D), b0=f(D), a=f(D), b=f(D), cot=f(G, Ep, D))


ENC_PARAM = ("w0", "b0", "a", "b")


def _model_case():
    import jax

    from qagnn_tpu.models.gnn import QAGNNMessagePassing as JaxMP

    rng = np.random.default_rng(0)
    G, N, E = 8, 8, 16
    num_nodes = rng.integers(2, N + 1, G)
    mask = rng.random((G, E)) < rng.integers(1, 12, G)[:, None] / E
    mask[3] = False
    graph = dict(
        concept_ids=rng.integers(1, 50, (G, N)).astype(np.int32),
        node_types=rng.integers(0, 3, (G, N)).astype(np.int32),
        node_scores=rng.standard_normal((G, N)).astype(np.float32),
        num_nodes=num_nodes.astype(np.int32),
        edge_src=(rng.integers(0, 1 << 20, (G, E)) % num_nodes[:, None])
        .astype(np.int32),
        edge_dst=(rng.integers(0, 1 << 20, (G, E)) % num_nodes[:, None])
        .astype(np.int32),
        edge_type=rng.integers(0, N_ETYPE, (G, E)).astype(np.int32),
        edge_mask=mask)
    H = rng.standard_normal((G, N, D)).astype(np.float32)
    jmp = JaxMP(k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=D,
                dropout=0.0, backend="scatter")
    v = jmp.init(jax.random.PRNGKey(0), H, graph["node_types"],
                 graph["node_scores"], graph["edge_src"], graph["edge_dst"],
                 graph["edge_type"], graph["edge_mask"], train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(
        lambda x: (rng.uniform(0.5, 2.0, x.shape) if np.all(
            np.asarray(x) == 1) else rng.standard_normal(x.shape) * 0.1)
        .astype(np.float32), jax.tree.map(np.asarray, v["batch_stats"]))
    return dict(graph=graph, H=H, params=params, stats=stats,
                cot=rng.standard_normal(H.shape).astype(np.float32))


# --------------------------------------------------------------------------
# the ranks (no JAX here)
# --------------------------------------------------------------------------

def _leaf(x, mesh, edge=False):
    t = data_slice(torch.from_numpy(np.ascontiguousarray(x)), mesh)
    return edge_slice(t, mesh) if edge else t


def _rank_proj(mesh, c):
    t = {k: _leaf(c[k], mesh, k in PROJ_EDGE or k in ("src", "dst", "mask"))
         for k in PROJ_NODE + PROJ_EDGE + ("src", "dst", "mask")}
    t.update({k: torch.from_numpy(c[k]) for k in PROJ_PARAM})
    leaves = [t[k].clone().requires_grad_() for k in PROJ_DIFF]
    out = gat_projected_sharded(*leaves, t["src"], t["dst"], t["mask"],
                                HEADS, mesh)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(),
            **{k: x.grad.numpy() for k, x in zip(PROJ_DIFF, leaves)}}


def _rank_unproj(mesh, c):
    leaves = [_leaf(c[k], mesh, k in UNPROJ_EDGE).requires_grad_()
              for k in UNPROJ_DIFF]
    idx = [_leaf(c[k], mesh, True) for k in ("src", "dst", "mask")]
    out = edge_sharded_gat_nodes(*leaves, *idx, mesh=mesh)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(),
            **{k: x.grad.numpy() for k, x in zip(UNPROJ_DIFF, leaves)}}


def _rank_enc(mesh, c):
    ints = [_leaf(c[k], mesh, True) for k in ("etype", "src", "dst")]
    ntype = _leaf(c["ntype"], mesh)
    mask = _leaf(c["mask"], mesh, True)
    hist, M, n = edge_feature_moments_sharded(*ints, ntype, mask, N_REL,
                                              N_NTYPE, mesh)
    params = [torch.from_numpy(c[k]).requires_grad_() for k in ENC_PARAM]
    h = edge_hidden_sharded(*ints, ntype, *params, N_REL, N_NTYPE,
                            torch.float32, mesh)
    (h * _leaf(c["cot"], mesh, True)).sum().backward()
    return {"hist": hist.numpy(), "M": M.numpy(), "n": n.numpy(),
            "h": h.detach().numpy(),
            **{k: p.grad.numpy() for k, p in zip(ENC_PARAM, params)}}


def _rank_model(mesh, c):
    graph = shard_graph(BatchedGraphs(**{
        k: torch.from_numpy(v) for k, v in c["graph"].items()}), mesh)
    mp = QAGNNMessagePassing(K, N_NTYPE, N_ETYPE, D, dropout=0.0,
                             backend="cuda", mesh=mesh).train()
    load_flax_variables(mp, c["params"], c["stats"])
    H = _leaf(c["H"], mesh).requires_grad_()
    out = mp(H, graph.node_types, graph.node_scores, graph.edge_src,
             graph.edge_dst, graph.edge_type, graph.edge_mask)
    (out * _leaf(c["cot"], mesh)).sum().backward()
    params, stats = to_flax_variables(mp)
    return {"out": out.detach().numpy(), "H": H.grad.numpy(),
            "grads": grads_to_flax(mp), "stats": stats}


def _rank_all(n_data, n_model, cases):
    mesh = make_mesh(n_data, n_model, "cpu")
    return {"proj": _rank_proj(mesh, cases["proj"]),
            "unproj": _rank_unproj(mesh, cases["unproj"]),
            "enc": _rank_enc(mesh, cases["enc"]),
            "model": _rank_model(mesh, cases["model"])}


# --------------------------------------------------------------------------
# assembling the slices
# --------------------------------------------------------------------------

def _by_data(results, n_data, n_model, get, edge=False):
    """The whole array from the ranks' slices: data slices stacked on axis 0;
    edge slices concatenated on axis 1 (edge=True), else the same on every
    rank of a model group (checked)."""
    rows = []
    for d in range(n_data):
        parts = [get(results[d * n_model + m]) for m in range(n_model)]
        if edge:
            rows.append(np.concatenate(parts, axis=1))
        else:
            for p in parts[1:]:
                np.testing.assert_array_equal(p, parts[0])
            rows.append(parts[0])
    return np.concatenate(rows, axis=0)


def _summed(results, n_data, n_model, get):
    """A parameter gradient: the same on every rank of a model group
    (checked), summed over the data slices."""
    total = 0
    for d in range(n_data):
        parts = [get(results[d * n_model + m]) for m in range(n_model)]
        for p in parts[1:]:
            np.testing.assert_array_equal(p, parts[0])
        total = total + parts[0]
    return total


@pytest.fixture(scope="module")
def cases():
    return {"proj": _proj_case(), "unproj": _unproj_case(),
            "enc": _enc_case(), "model": _model_case()}


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def grid(request, cases):
    n_data, n_model = request.param
    results = run_ranks(_rank_all, n_data * n_model, "gloo", "cpu", SPAWN_S,
                        n_data, n_model, cases)
    return n_data, n_model, results


@pytest.fixture(scope="module")
def one_rank(cases):
    """The port's one-rank functions on the whole inputs."""
    from qagnn_tpu_torch.ops.edge_encoder_kernels import (
        edge_feature_moments,
        edge_hidden,
    )
    from qagnn_tpu_torch.ops.gat_attention import (
        relational_gat_attention_nodes,
    )
    from qagnn_tpu_torch.ops.gat_kernels import gat_projected

    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    c = cases["proj"]
    leaves = [t(c[k]).requires_grad_() for k in PROJ_DIFF]
    out = gat_projected(*leaves, t(c["src"]), t(c["dst"]), t(c["mask"]),
                        HEADS)
    (out ** 2).sum().backward()
    proj = {"out": out.detach().numpy(),
            **{k: x.grad.numpy() for k, x in zip(PROJ_DIFF, leaves)}}

    c = cases["unproj"]
    leaves = [t(c[k]).requires_grad_() for k in UNPROJ_DIFF]
    out = relational_gat_attention_nodes(
        *leaves, t(c["src"]), t(c["dst"]), t(c["mask"]), backend="cuda")
    (out ** 2).sum().backward()
    unproj = {"out": out.detach().numpy(),
              **{k: x.grad.numpy() for k, x in zip(UNPROJ_DIFF, leaves)}}

    c = cases["enc"]
    ints = [t(c[k]) for k in ("etype", "src", "dst")]
    hist, M, n = edge_feature_moments(*ints, t(c["ntype"]), t(c["mask"]),
                                      N_REL, N_NTYPE)
    params = [t(c[k]).requires_grad_() for k in ENC_PARAM]
    h = edge_hidden(*ints, t(c["ntype"]), *params, N_REL, N_NTYPE,
                    torch.float32)
    (h * t(c["cot"])).sum().backward()
    enc = {"hist": hist.numpy(), "M": M.numpy(), "n": n.numpy(),
           "h": h.detach().numpy(),
           **{k: p.grad.numpy() for k, p in zip(ENC_PARAM, params)}}

    c = cases["model"]
    mp = QAGNNMessagePassing(K, N_NTYPE, N_ETYPE, D, dropout=0.0,
                             backend="cuda").train()
    load_flax_variables(mp, c["params"], c["stats"])
    g = {k: t(v) for k, v in c["graph"].items()}
    H = t(c["H"]).requires_grad_()
    out = mp(H, g["node_types"], g["node_scores"], g["edge_src"],
             g["edge_dst"], g["edge_type"], g["edge_mask"])
    (out * t(c["cot"])).sum().backward()
    model = {"out": out.detach().numpy(), "H": H.grad.numpy(),
             "grads": grads_to_flax(mp), "stats": to_flax_variables(mp)[1]}
    return {"proj": proj, "unproj": unproj, "enc": enc, "model": model}


# --------------------------------------------------------------------------
# the JAX side
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_proj(cases):
    import jax
    import jax.numpy as jnp

    from qagnn_tpu.parallel.edge_shard_pallas import (
        pallas_edge_sharded_projected)
    from qagnn_tpu.parallel.mesh import make_mesh as jax_mesh

    c = cases["proj"]
    diff = tuple(jnp.asarray(np.swapaxes(c[k], 1, 2) if k == "emb" else c[k])
                 for k in PROJ_DIFF)
    mesh = jax_mesh(2, 4)

    def loss(args):
        out = pallas_edge_sharded_projected(
            *args, jnp.asarray(c["src"]), jnp.asarray(c["dst"]),
            jnp.asarray(c["mask"], jnp.float32), HEADS, mesh, True)
        return jnp.sum(out ** 2), out

    with mesh:
        (_, out), grads = jax.value_and_grad(loss, has_aux=True)(diff)
    want = {"out": np.asarray(out)}
    for k, g in zip(PROJ_DIFF, grads):
        g = np.asarray(g)
        want[k] = np.swapaxes(g, 1, 2) if k == "emb" else g
    return want


@pytest.fixture(scope="module")
def jax_unproj(cases):
    import jax
    import jax.numpy as jnp

    from qagnn_tpu.ops.gat_attention import relational_gat_attention_nodes
    from qagnn_tpu.parallel.edge_shard_map import (
        edge_sharded_gat_nodes as jax_sharded)
    from qagnn_tpu.parallel.mesh import make_mesh as jax_mesh

    c = cases["unproj"]
    args = tuple(jnp.asarray(c[k]) for k in UNPROJ_DIFF)
    idx = (jnp.asarray(c["src"]), jnp.asarray(c["dst"]),
           jnp.asarray(c["mask"]))
    mesh = jax_mesh(2, 4)

    def loss(fn):
        def f(a):
            out = fn(*a, *idx)
            return jnp.sum(out ** 2), out
        return f

    with mesh:
        (_, out), grads = jax.jit(jax.value_and_grad(loss(
            lambda *a: jax_sharded(*a, mesh=mesh)), has_aux=True))(args)
    (_, oracle), oracle_grads = jax.value_and_grad(loss(
        lambda *a: relational_gat_attention_nodes(*a, backend="scatter")),
        has_aux=True)(args)
    return ({"out": np.asarray(out),
             **{k: np.asarray(g) for k, g in zip(UNPROJ_DIFF, grads)}},
            {"out": np.asarray(oracle),
             **{k: np.asarray(g) for k, g in zip(UNPROJ_DIFF,
                                                 oracle_grads)}})


@pytest.fixture(scope="module")
def jax_enc(cases):
    import jax
    import jax.numpy as jnp

    from qagnn_tpu.parallel.edge_shard_pallas import (
        edge_feature_moments_sharded as jax_moments,
        edge_hidden_sharded as jax_hidden)
    from qagnn_tpu.parallel.mesh import make_mesh as jax_mesh

    c = cases["enc"]
    ints = tuple(jnp.asarray(c[k]) for k in ("etype", "src", "dst"))
    ntype = jnp.asarray(c["ntype"])
    mesh = jax_mesh(2, 4)
    with mesh:
        hist, M, n = jax_moments(*ints, ntype, jnp.asarray(c["mask"]),
                                 N_REL, N_NTYPE, mesh, True)

        def loss(params):
            h = jax_hidden(*ints, ntype, *params, N_REL, N_NTYPE,
                           jnp.float32, mesh, True)
            h = jnp.swapaxes(h, 1, 2)
            return jnp.sum(h * jnp.asarray(c["cot"])), h

        (_, h), grads = jax.value_and_grad(loss, has_aux=True)(
            tuple(jnp.asarray(c[k]) for k in ENC_PARAM))
    return {"hist": np.asarray(hist), "M": np.asarray(M),
            "n": np.asarray(n), "h": np.asarray(h),
            **{k: np.asarray(g) for k, g in zip(ENC_PARAM, grads)}}


def _jax_model(c, mesh=None):
    """(out, H gradient, parameter gradients, running statistics) of
    sum(out * cot) in train mode: the pallas backend (interpret mode),
    single-device or on `mesh`."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qagnn_tpu.graph.container import BatchedGraphs as JaxGraphs
    from qagnn_tpu.models.gnn import QAGNNMessagePassing as JaxMP
    from qagnn_tpu.parallel.graph_sharding import shard_graph as jax_shard
    from qagnn_tpu.parallel.mesh import replicated

    jmp = JaxMP(k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=D,
                dropout=0.0, backend="pallas", mesh=mesh)
    g = JaxGraphs(**{k: jnp.asarray(v) for k, v in c["graph"].items()})
    H, cot = jnp.asarray(c["H"]), jnp.asarray(c["cot"])

    def loss(params, H, g):
        out, new = jmp.apply({"params": params, "batch_stats": c["stats"]},
                             H, g.node_types, g.node_scores, g.edge_src,
                             g.edge_dst, g.edge_type, g.edge_mask,
                             train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, new["batch_stats"])

    grad = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    if mesh is None:
        (_, (out, stats)), (gp, gH) = grad(c["params"], H, g)
    else:
        with mesh:
            params = jax.device_put(c["params"], replicated(mesh))
            Hs = jax.device_put(H, NamedSharding(mesh, P("data")))
            (_, (out, stats)), (gp, gH) = jax.jit(grad)(
                params, Hs, jax_shard(g, mesh, edge_partition=True))
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return np.asarray(out), np.asarray(gH), tree(gp), tree(stats)


@pytest.fixture(scope="module")
def jax_model(cases):
    from qagnn_tpu.parallel.mesh import make_mesh as jax_mesh
    return {"single": _jax_model(cases["model"]),
            "mesh": _jax_model(cases["model"], jax_mesh(2, 4))}


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()),
                               err_msg=err_msg)


def _same(got, want, what):
    """The grid against the port's one-rank function."""
    err = float(np.abs(got - want).max())
    assert err <= ONE_RANK_TOL * float(np.abs(want).max()), (what, err)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_close(got, want, what, rtol=1e-3, floor=1e-4):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name], w, rtol=rtol,
            atol=max(floor * float(np.abs(w).max()), 1e-6 * top),
            err_msg=f"{what}: {name}")


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------

def test_projected_op_matches_jax_sharded(grid, jax_proj, one_rank):
    n_data, n_model, results = grid
    get = lambda k: lambda r: r["proj"][k]  # noqa: E731
    for want, check in ((jax_proj, _close), (one_rank["proj"], _same)):
        check(_by_data(results, n_data, n_model, get("out")), want["out"],
              "out")
        for k in PROJ_NODE + PROJ_EDGE:
            check(_by_data(results, n_data, n_model, get(k),
                           edge=k in PROJ_EDGE), want[k], k)
        for k in PROJ_PARAM:
            check(_summed(results, n_data, n_model, get(k)), want[k], k)


def test_unprojected_op_matches_jax_sharded(grid, jax_unproj, one_rank):
    n_data, n_model, results = grid
    get = lambda k: lambda r: r["unproj"][k]  # noqa: E731
    # the JAX sharded op, the JAX scatter oracle, the port's one-rank op
    for want, check in ((jax_unproj[0], _close), (jax_unproj[1], _close),
                        (one_rank["unproj"], _same)):
        check(_by_data(results, n_data, n_model, get("out")), want["out"],
              "out")
        for k in UNPROJ_DIFF:
            check(_by_data(results, n_data, n_model, get(k),
                           edge=k in UNPROJ_EDGE), want[k], k)


def test_edge_encoder_kernels_match_jax_sharded(grid, jax_enc, one_rank):
    n_data, n_model, results = grid
    get = lambda k: lambda r: r["enc"][k]  # noqa: E731
    for k in ("hist", "M", "n"):             # summed over every rank
        for r in results:
            np.testing.assert_array_equal(r["enc"][k], jax_enc[k],
                                          err_msg=k)
            np.testing.assert_array_equal(r["enc"][k], one_rank["enc"][k],
                                          err_msg=k)
    for want, check in ((jax_enc, _close), (one_rank["enc"], _same)):
        check(_by_data(results, n_data, n_model, get("h"), edge=True),
              want["h"], "h")
        for k in ENC_PARAM:
            check(_summed(results, n_data, n_model, get(k)), want[k], k)


def test_message_passing_train_matches_jax_mesh(grid, jax_model, one_rank):
    """Output and BatchNorm running statistics against the JAX model on its
    2 x 4 mesh and the port's one-rank model; every rank's statistics
    alike."""
    n_data, n_model, results = grid
    out, _, _, stats = jax_model["mesh"]
    got = _by_data(results, n_data, n_model, lambda r: r["model"]["out"])
    _close(got, out, "out")
    _same(got, one_rank["model"]["out"], "out")
    for r in results:
        _assert_trees_close(r["model"]["stats"], stats, "running statistics",
                            rtol=RTOL, floor=ATOL)
        for k, w in _flat(one_rank["model"]["stats"]).items():
            _same(_flat(r["model"]["stats"])[k], w, k)


def test_message_passing_gradients_match_jax_single_device(grid, jax_model,
                                                          one_rank):
    """The gradients of every parameter (summed over the data slices, as the
    train step does) and of the input, against the single-device JAX
    model's and the port's one-rank model's: a gradient summed twice, or
    missing a rank's part, shows here."""
    n_data, n_model, results = grid
    out, gH, grads, _ = jax_model["single"]
    _close(_by_data(results, n_data, n_model, lambda r: r["model"]["out"]),
           out, "out")
    got_H = _by_data(results, n_data, n_model, lambda r: r["model"]["H"])
    _close(got_H, gH, "H")
    _same(got_H, one_rank["model"]["H"], "H")
    got = {k: _summed(results, n_data, n_model,
                      lambda r, k=k: _flat(r["model"]["grads"])[k])
           for k in _flat(grads)}
    _assert_trees_close(got, _flat(grads), "gradients")
    top = max(float(np.abs(w).max()) for w in got.values())
    for k, w in _flat(one_rank["model"]["grads"]).items():
        err = float(np.abs(got[k] - w).max())
        assert err <= ONE_RANK_TOL * top, (k, err)
