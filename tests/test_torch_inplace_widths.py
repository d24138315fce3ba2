"""Edge-sized operands read and written in place around the kernels (CPU).

Two places where the kernels used to be handed copies of (G, E, .) arrays:

  * the fused GNN at a width the GAT kernels do not take (the CLI's default
    gnn_dim 100: the kernels' 104; 36, 4 heads of 9: the kernels' 40). The
    edge encoder's rows 11-12 now emit the embedding at the kernels' width,
    zeros past D (`gat_kernels.kernel_d`), and the k layers carry it as it
    is: no pad, no slice and so no slice backward, no copy of an
    edge-sized array between the kernels. Here: QAGNNMessagePassing on the
    fused branch in train mode against flax's "pallas" branch, output and
    every parameter gradient, at tests/test_torch_gnn.py's tolerances; and
    a TorchDispatchMode over the same step's forward and backward that
    counts the edge-sized pads, slice backwards and copies made outside the
    kernels' single-launch bodies (their plain versions here), which must
    be none;
  * the unprojected op's rows 1, 3, 4 and 5 at a head group or a head wider
    than one launch (HD 1040 as 2 heads of 520, six launches; HD 320 as 10
    heads of 32, two launches): every (G, E, .) and (G, N, .) array a launch
    reads or writes is a column view of one array of the call (one storage,
    row stride HDk), each at its columns; and the call's results equal one
    unsliced call of each row's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from qagnn_tpu.models.gnn import QAGNNMessagePassing as JaxMP
from qagnn_tpu_torch.models import gnn
from qagnn_tpu_torch.models.gnn import QAGNNMessagePassing
from qagnn_tpu_torch.ops import edge_encoder_kernels as ek
from qagnn_tpu_torch.ops import gat_kernels as gk
from qagnn_tpu_torch.ops import gat_unproj_kernels as uk
from qagnn_tpu_torch.utils.convert import (
    grads_to_flax,
    load_flax_variables,
)

N_NTYPE, N_ETYPE, K, HEADS = 4, 7, 2, 4
G, N, E = 2, 9, 26


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _gnn_case(D, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((G, E)) > 0.3
    args = (rng.standard_normal((G, N, D)).astype(np.float32),
            rng.integers(0, N_NTYPE, (G, N)).astype(np.int32),
            rng.standard_normal((G, N)).astype(np.float32),
            rng.integers(0, N, (G, E)).astype(np.int32),
            rng.integers(0, N, (G, E)).astype(np.int32),
            rng.integers(0, N_ETYPE, (G, E)).astype(np.int32), mask)
    cot = rng.standard_normal((G, N, D)).astype(np.float32)
    return args, cot


def _port(D, variables):
    mp = QAGNNMessagePassing(K, N_NTYPE, N_ETYPE, D, dropout=0.0,
                             head_count=HEADS, backend="cuda").train()
    load_flax_variables(mp, variables["params"], variables["batch_stats"])
    return mp


# --------------------------------------------------------------------------
# (a) the fused GNN at D % 8 != 0 against flax
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D", [100, 36])
def test_fused_gnn_at_an_odd_width_matches_flax(D):
    args, cot = _gnn_case(D, seed=D)
    jargs = tuple(map(jnp.asarray, args))
    jmp = JaxMP(k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=D,
                dropout=0.0, head_count=HEADS, backend="pallas")
    v = jax.tree.map(np.asarray, jmp.init(jax.random.PRNGKey(D), *jargs,
                                          train=False))

    def loss(params):
        out, _ = jmp.apply({"params": params,
                            "batch_stats": v["batch_stats"]}, *jargs,
                           train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])

    mp = _port(D, v)
    got = mp(*map(torch.from_numpy, args))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    got_g, want_g = _flat(grads_to_flax(mp)), _flat(want_grads)
    assert sorted(got_g) == sorted(want_g)
    # parameters and their gradients keep width D
    assert got_g["gnn_layer_0/key_e/kernel"].shape == (D, D)
    top = max(float(np.abs(w).max()) for w in want_g.values())
    for name, w in want_g.items():
        np.testing.assert_allclose(
            got_g[name], w, rtol=1e-3,
            atol=max(1e-4 * float(np.abs(w).max()), 1e-6 * top),
            err_msg=name)


# --------------------------------------------------------------------------
# (b) no edge-sized pad, slice backward or copy between the kernels
# --------------------------------------------------------------------------

# what moves data without computing anything: a pad, a slice's backward (a
# zero fill and a copy), a copy in any of its forms, a concatenation
MOVES = {"constant_pad_nd", "slice_backward", "copy_", "clone", "_to_copy",
         "cat", "stack", "new_zeros", "zeros_like"}

# the single-launch bodies, which on the card are a kernel each and here
# run their plain versions: what they do inside is not counted
LAUNCH_BODIES = ((gk, "_pass_a_scores"), (gk, "pass_a_denoms"),
                 (gk, "_pass_c"), (gk, "_bwd_pass1"), (gk, "_bwd_pass2"),
                 (ek, "edge_hidden_forward"), (ek, "edge_hidden_backward"),
                 (gnn, "edge_feature_moments"))


class EdgeMoves(TorchDispatchMode):
    """Counts the ops of MOVES whose result is edge-sized, (G, E, c) with
    c >= D, made while no launch body runs."""

    def __init__(self, D):
        super().__init__()
        self.D, self.depth, self.seen = D, 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if self.depth == 0 and name in MOVES and torch.is_tensor(out) \
                and out.dim() == 3 and tuple(out.shape[:2]) == (G, E) \
                and out.shape[-1] >= self.D:
            self.seen.append((name, tuple(out.shape)))
        return out

    def quiet(self, fn):
        def body(*a, **k):
            self.depth += 1
            try:
                return fn(*a, **k)
            finally:
                self.depth -= 1
        return body


def _counted_step(D, monkeypatch, run):
    moves = EdgeMoves(D)
    for mod, name in LAUNCH_BODIES:
        monkeypatch.setattr(mod, name, moves.quiet(getattr(mod, name)))
    with moves:
        run()
    return moves.seen


@pytest.mark.parametrize("D", [100, 36])
def test_fused_gnn_step_moves_no_edge_sized_array(D, monkeypatch):
    args, cot = _gnn_case(D, seed=D)
    v = jax.tree.map(np.asarray, JaxMP(
        k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=D, dropout=0.0,
        head_count=HEADS, backend="scatter").init(
            jax.random.PRNGKey(0), *map(jnp.asarray, args), train=False))
    mp = _port(D, v)
    targs = list(map(torch.from_numpy, args))
    seen_emb = []
    hidden = ek.edge_hidden_forward

    def spy(*a, **k):
        out = hidden(*a, **k)
        seen_emb.append(tuple(out.shape))
        return out
    monkeypatch.setattr(ek, "edge_hidden_forward", spy)

    def step():
        out = mp(*targs)
        (out * torch.from_numpy(cot)).sum().backward()

    assert _counted_step(D, monkeypatch, step) == []
    # the encoder emitted the embedding at the kernels' width
    assert seen_emb == [(G, E, gk.kernel_d(D))]
    assert gk.kernel_d(D) != D


def test_the_count_sees_the_pads_of_a_d_wide_embedding(monkeypatch):
    """The op still takes a (G, E, D) embedding at such a D and pads it (its
    contract); the counter sees those pads, their backward and the slice's
    backward, so an empty count above is no blind spot."""
    D, HD = 100, 100
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen).requires_grad_()  # noqa
    floats = (r(G, N, HD), r(G, N, HD), r(G, N, HD), r(G, E, D), r(D, HD),
              r(HD), r(D, HD), r(HD), r(G, N, HD), r(G, N, HD))
    src = torch.randint(0, N, (G, E), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, N, (G, E), generator=gen, dtype=torch.int32)
    mask = torch.rand(G, E, generator=gen) > 0.3

    def step():
        out, emb = gk.gat_projected_chained(*floats, src, dst, mask, HEADS)
        (out.sum() + emb.sum()).backward()

    seen = {name for name, _ in _counted_step(D, monkeypatch, step)}
    assert {"constant_pad_nd", "slice_backward"} <= seen


# --------------------------------------------------------------------------
# (c) rows 1, 3, 4 and 5: every launch a view of the call's arrays
# --------------------------------------------------------------------------

# the (G, E, .) and (G, N, .) arguments of each single-launch body, by
# position, and its output by keyword
ROW_ARGS = {"_edge_scores": {0: "nq", 1: "nk", 2: "ekb"},
            "_aggregate": {0: "nm", 1: "emb", 7: "out"},
            "_bwd1": {0: "gout", 1: "nm", 2: "emb", 8: "dnm",
                      "demb": "demb"},
            "_bwd2": {0: "nq", 1: "nk", 2: "ekb", 10: "dnq", 11: "dnk",
                      "dekb": "dekb"}}


class ViewSpy:
    """Records, for each launch of rows 1, 3, 4 and 5, the storage, row
    stride and offset of every row array it is handed."""

    def __init__(self, monkeypatch):
        self.seen = {name: [] for name in ROW_ARGS}
        for name in ROW_ARGS:
            monkeypatch.setattr(uk, name, self._wrap(name, getattr(uk, name)))

    def _wrap(self, name, fn):
        def spy(*a, **k):
            got = {}
            for where, role in ROW_ARGS[name].items():
                t = k.get(where) if isinstance(where, str) else a[where]
                got[role] = None if t is None else (
                    t.untyped_storage().data_ptr(), t.stride(-2),
                    t.storage_offset() % t.stride(-2), t.shape[-1])
            self.seen[name].append(got)
            return fn(*a, **k)
        return spy

    def assert_views(self, name, HDk, plan):
        calls = self.seen[name]
        assert len(calls) == len(plan), name
        for role in ROW_ARGS[name].values():
            got = [c[role] for c in calls]
            assert all(g is not None for g in got), (name, role)
            assert len({g[0] for g in got}) == 1, (name, role, "storages")
            assert all(g[1] == HDk for g in got), (name, role, "strides")
            assert [(g[2], g[2] + g[3]) for g in got] \
                == [(c0, c1) for _, _, c0, c1 in plan], (name, role)


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=what)


@pytest.mark.parametrize("HD, heads", [(1040, 2), (320, 10)])
def test_split_launches_take_views_of_one_array(HD, heads, monkeypatch):
    Gs, Ns, Es = 2, 7, 24
    gen = torch.Generator().manual_seed(HD)
    r = lambda *s: torch.randn(s, generator=gen) * 0.5  # noqa: E731
    nq, nk, nm, gout = (r(Gs, Ns, HD) for _ in range(4))
    ekb, emb = r(Gs, Es, HD), r(Gs, Es, HD)
    scale = torch.rand((Gs, Ns, heads), generator=gen) + 0.5
    e_edge = torch.rand((Gs, heads, Es), generator=gen)
    dalpha, d_denom = r(Gs, heads, Es), r(Gs, Ns, heads)
    src = torch.randint(0, Ns, (Gs, Es), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, Ns, (Gs, Es), generator=gen, dtype=torch.int32)
    mask = torch.rand((Gs, Es), generator=gen) > 0.25
    seed = r(Gs, Ns, HD)
    HDk = uk._padded(HD, heads)
    plan = gk.launches(HDk, heads)
    assert HDk == HD and len(plan) > 1

    spy = ViewSpy(monkeypatch)
    a1 = (nq, nk, ekb, src, dst, mask, heads)
    got = uk.edge_scores(*a1)
    for g, w, what in zip(got, uk.edge_scores_plain(*a1), ("s", "max")):
        _close(g, w, f"row 1 {what}")
    a3 = (nm, emb, e_edge, scale, src, dst, mask)
    _close(uk.aggregate(*a3, seed.clone(), heads),
           uk.aggregate_plain(*a3, seed.clone(), heads), "row 3")
    a4 = (gout, nm, emb, e_edge, scale, src, dst, mask)
    ds0 = r(Gs, Ns, heads)
    got = uk.bwd1(*a4, seed.clone(), ds0.clone(), heads)
    want = uk.bwd1_plain(*a4, seed.clone(), ds0.clone(), heads)
    for g, w, what in zip(got, want, ("demb", "d_alpha", "dnm", "dscale")):
        _close(g, w, f"row 4 {what}")
    a5 = (nq, nk, ekb, e_edge, dalpha, scale, d_denom, src, dst, mask)
    got = uk.bwd2(*a5, seed.clone(), seed.clone(), heads)
    want = uk.bwd2_plain(*a5, seed.clone(), seed.clone(), heads)
    for g, w, what in zip(got, want, ("dekb", "dnq", "dnk")):
        _close(g, w, f"row 5 {what}")

    for name in ROW_ARGS:
        spy.assert_views(name, HDk, plan)
