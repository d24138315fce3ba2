"""The GAT ops at widths one kernel launch does not take (CPU, f32).

A launch of rows 1-9 takes at most 8 heads and 256 columns, and the
unprojected op's launches HD a multiple of 8. The wrappers pad each head
with zero features and run more heads, or wider rows, as groups of whole
heads, one launch a group, on every device; the backward passes of the
projected op run W's rows in slices above D = 256. Here, with the kernels'
plain versions on CPU tensors:

  * the unprojected op, `relational_gat_attention_nodes(backend="cuda")`,
    at (HD 100, 4 heads) and (HD 320, 10 heads) against the JAX op with
    backend "pallas" (interpret mode): value and the seven gradients within
    tests/test_torch_gat_unprojected.py's VAL_TOL / GRAD_TOL;
  * QAGNNMessagePassing at gnn_dim 512 (D = HD = 512, 4 heads) on the
    fused branch against flax's "pallas" branch in train mode, dropout
    off: the output within tests/test_torch_gnn.py's rtol/atol 2e-4 and
    every parameter gradient within its rtol 1e-3 (floors of 1e-4 of the
    leaf's largest value, 1e-6 of the tree's);
  * `cli.train --gnn_dim 512` on the fused branch against
    `qagnn_tpu.cli.train` on its "pallas" branch: the per-step losses
    within rtol 2e-4 (tests/test_torch_cli.py's tolerance);
  * a spy on every function that reaches a kernel's C entry point: every
    call's widths pass `_check_widths` (and `_check_bwd_widths` for
    backward passes 1 and 2), with the launches a head group each;
  * the plans as plain cases: the head groups, the D slices, the padded
    widths, the backward's scratch and the slice-major transposed weight.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import qagnn_tpu.cli as jax_cli
import qagnn_tpu.models.gnn as jax_gnn
import qagnn_tpu.utils.initialization as jax_init
from qagnn_tpu.models.gnn import QAGNNMessagePassing as JaxMP
from qagnn_tpu.ops.gat_attention import (
    relational_gat_attention_nodes as jax_gat_nodes,
)
from qagnn_tpu.utils import config as jax_config
from test_torch_cli import (  # noqa: F401  (fixtures by name)
    _cfg,
    _no_dropout,
    _with_tokenizer,
    tokenizer,
)

import qagnn_tpu_torch.cli as cli
from qagnn_tpu_torch.data.synthetic import write_synthetic_dataset
from qagnn_tpu_torch.models.gnn import QAGNNMessagePassing
from qagnn_tpu_torch.ops import gat_kernels as gk
from qagnn_tpu_torch.ops import gat_unproj_kernels as uk
from qagnn_tpu_torch.ops.gat_attention import relational_gat_attention_nodes
from qagnn_tpu_torch.utils import config
from qagnn_tpu_torch.utils.convert import grads_to_flax, load_flax_variables

VAL_TOL = dict(rtol=2e-4, atol=2e-5)      # test_torch_gat_unprojected.py
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
FLOATS = ("nq", "nk", "nm", "ekb", "emb", "skb", "smb")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Spy:
    """Wraps the functions that reach the kernels' C entry points (the
    plain version on the CPU): every call's widths must pass the launch
    checks as they stand; the calls are counted by name."""

    PROJECTED = ("_pass_a_scores", "_pass_c", "_bwd_pass1", "_bwd_pass2")
    UNPROJECTED = ("_edge_scores", "_edge_denoms", "_aggregate", "_bwd1",
                   "_bwd2")
    # the argument that holds the edge embedding (G, E, D)
    EMB_ARG = {"_pass_a_scores": 2, "_pass_c": 1, "_bwd_pass1": 2,
               "_bwd_pass2": 2}

    def __init__(self, monkeypatch):
        self.calls = {}
        for mod, names in ((gk, self.PROJECTED), (uk, self.UNPROJECTED)):
            for name in names:
                monkeypatch.setattr(mod, name, self._wrap(name,
                                                          getattr(mod, name)))

    def _wrap(self, name, fn):
        def spy(*args, **partial):
            self.calls[name] = self.calls.get(name, 0) + 1
            heads = args[-2]                  # (..., heads, _route)
            HD = args[0].shape[-1]            # the first argument's columns
            if name == "_edge_denoms":        # scores (G, H, E)
                assert args[0].shape[1] <= gk.MAX_HEADS, name
            elif name in self.PROJECTED:
                check = gk._check_bwd_widths if "bwd" in name \
                    else gk._check_widths
                check(args[self.EMB_ARG[name]].shape[-1], HD, heads)
            else:
                gk._check_widths(HD, HD, heads)
            return fn(*args, **partial)
        return spy


# --------------------------------------------------------------------------
# the unprojected op
# --------------------------------------------------------------------------

def _unproj_inputs(seed, G, N, E, HD):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = {k: f(G, N, HD) for k in ("nq", "nk", "nm", "skb", "smb")}
    a.update(ekb=f(G, E, HD), emb=f(G, E, HD), g=f(G, N, HD),
             src=rng.integers(0, N, (G, E)).astype(np.int32),
             dst=rng.integers(0, N, (G, E)).astype(np.int32),
             mask=rng.random((G, E)) > 0.25)
    a["mask"][1] = False                       # a graph with no live slot
    return a


@pytest.mark.parametrize("HD, heads, launches", [(100, 4, 1), (320, 10, 2)])
def test_unprojected_op_matches_jax_at_wide_heads(HD, heads, launches,
                                                  monkeypatch):
    a = _unproj_inputs(HD, 3, 9, 30, HD)
    split = lambda t: t.reshape(*t.shape[:2], heads, -1)  # noqa: E731
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in FLOATS]
    ints = [torch.from_numpy(a[k]) for k in ("src", "dst", "mask")]
    spy = Spy(monkeypatch)
    out = relational_gat_attention_nodes(*map(split, leaves), *ints,
                                         backend="cuda")
    out.backward(torch.from_numpy(a["g"]))
    assert spy.calls == {n: launches for n in Spy.UNPROJECTED}

    j_out, vjp = jax.vjp(
        lambda *f: jax_gat_nodes(*f, jnp.asarray(a["src"]),
                                 jnp.asarray(a["dst"]),
                                 jnp.asarray(a["mask"]), backend="pallas"),
        *[jnp.asarray(a[k]).reshape(*a[k].shape[:2], heads, -1)
          for k in FLOATS])
    want = vjp(jnp.asarray(a["g"]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **VAL_TOL)
    for name, t, w in zip(FLOATS, leaves, want):
        np.testing.assert_allclose(t.grad.numpy(),
                                   np.asarray(w).reshape(t.shape),
                                   err_msg=f"d{name}", **GRAD_TOL)


def test_unprojected_wrappers_add_into_their_accumulators_in_place():
    """The padded and grouped wrappers keep the in-place contract of the
    node accumulators (out, dnm, dscale, dnq, dnk)."""
    HD, heads = 320, 10
    a = {k: torch.from_numpy(v) for k, v in
         _unproj_inputs(1, 2, 7, 20, HD).items()}
    res = uk.gat_unprojected_forward(*[a[k] for k in FLOATS], a["src"],
                                     a["dst"], a["mask"], heads)
    e_edge, scale = res[1], res[3]
    seed = torch.randn(2, 7, HD)
    out = seed.clone()
    got = uk.aggregate(a["nm"], a["emb"], e_edge, scale, a["src"], a["dst"],
                       a["mask"], out, heads)
    assert got is out and not torch.equal(out, seed)
    dnm, dscale = seed.clone(), torch.zeros(2, 7, heads)
    demb, dalpha, dnm2, dscale2 = uk.bwd1(
        a["g"], a["nm"], a["emb"], e_edge, scale, a["src"], a["dst"],
        a["mask"], dnm, dscale, heads)
    assert dnm2 is dnm and dscale2 is dscale and dscale.abs().sum() > 0
    assert demb.shape == (2, 20, HD) and dalpha.shape == (2, heads, 20)
    dnq, dnk = seed.clone(), seed.clone()
    dekb, dnq2, dnk2 = uk.bwd2(a["nq"], a["nk"], a["ekb"], e_edge, dalpha,
                               scale, scale * 0.1, a["src"], a["dst"],
                               a["mask"], dnq, dnk, heads)
    assert dnq2 is dnq and dnk2 is dnk and dekb.shape == (2, 20, HD)
    assert not torch.equal(dnq, seed) and not torch.equal(dnk, seed)


# --------------------------------------------------------------------------
# the projected op at gnn_dim 512
# --------------------------------------------------------------------------

N_NTYPE, N_ETYPE, K, WIDE, HEADS = 4, 7, 2, 512, 4


class _TorchScoreBasis:
    """qagnn_tpu.models.gnn's jax.numpy with one change: the score
    embedding's basis 1.1^j (`jnp.power(1.1, jnp.arange(D / 2))`) as
    torch.pow rounds it, which the port computes. XLA's pow and torch's
    differ in the last bit of 1.1^j at a few j (32 and 184 below 256; see
    `test_score_basis_differs_from_jax_in_the_last_bit_only`), and
    sin(score * 1.1^j) turns one ulp of 1.1^184 = 4e7 into a different
    value: past gnn_dim 368 the two packages' score embeddings differ
    there, whatever the GAT path. The comparisons at gnn_dim 512 hold the
    GAT path, so both sides take one basis."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def power(x, y):
        basis = torch.pow(x, torch.arange(y.shape[0], dtype=torch.float32))
        return jnp.asarray(basis.numpy(), dtype=y.dtype)


@pytest.fixture
def _one_score_basis(monkeypatch):
    monkeypatch.setattr(jax_gnn, "jnp", _TorchScoreBasis())


def test_score_basis_differs_from_jax_in_the_last_bit_only():
    """The one difference the fixture above takes away: 1.1^j in f32 by
    XLA and by torch, at most one ulp apart over a gnn_dim 1024 model's
    512 terms, and equal below j = 32."""
    j = np.asarray(jnp.power(1.1, jnp.arange(512, dtype=jnp.float32)))
    t = torch.pow(1.1, torch.arange(512, dtype=torch.float32)).numpy()
    ulps = np.abs(j.view(np.int32) - t.view(np.int32))
    assert ulps.max() <= 1 and not ulps[:32].any()


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_message_passing_at_gnn_dim_512_matches_flax(monkeypatch,
                                                      _one_score_basis):
    G, N, E = 2, 8, 20
    rng = np.random.default_rng(0)
    mask = rng.random((G, E)) > 0.3
    args = (rng.standard_normal((G, N, WIDE)).astype(np.float32),
            rng.integers(0, N_NTYPE, (G, N)).astype(np.int32),
            rng.standard_normal((G, N)).astype(np.float32),
            rng.integers(0, N, (G, E)).astype(np.int32),
            rng.integers(0, N, (G, E)).astype(np.int32),
            rng.integers(0, N_ETYPE + 1, (G, E)).astype(np.int32), mask)
    jmp = JaxMP(k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=WIDE,
                dropout=0.0, head_count=HEADS, backend="pallas")
    v = jax.tree.map(np.asarray, jmp.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), train=False))
    cot = rng.standard_normal(args[0].shape).astype(np.float32)

    def loss(params):
        out, _ = jmp.apply({"params": params,
                            "batch_stats": v["batch_stats"]},
                           *map(jnp.asarray, args), train=True,
                           mutable=["batch_stats"])
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])

    mp = QAGNNMessagePassing(K, N_NTYPE, N_ETYPE, WIDE, dropout=0.0,
                             head_count=HEADS, backend="cuda").train()
    load_flax_variables(mp, v["params"], v["batch_stats"])
    spy = Spy(monkeypatch)
    got = mp(*map(torch.from_numpy, args))
    (got * torch.from_numpy(cot)).sum().backward()
    # k layers, two head groups of 256 columns each
    assert spy.calls == {n: 2 * K for n in Spy.PROJECTED}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    got_g, want_g = _flat(grads_to_flax(mp)), _flat(want_grads)
    assert sorted(got_g) == sorted(want_g)
    top = max(float(np.abs(w).max()) for w in want_g.values())
    for name, w in want_g.items():
        np.testing.assert_allclose(
            got_g[name], w, rtol=1e-3,
            atol=max(1e-4 * float(np.abs(w).max()), 1e-6 * top),
            err_msg=name)


def test_cli_train_at_gnn_dim_512_matches_the_jax_cli(
        tmp_path, tokenizer, monkeypatch, _no_dropout,  # noqa: F811
        _one_score_basis):
    root = str(tmp_path / "data")
    emb_path = write_synthetic_dataset(root, n_questions=8)
    kw = dict(n_epochs=1, unfreeze_epoch=0, gnn_dtype="float32", k=1,
              gnn_dim=WIDE, fc_dim=8, decoder_lr=3e-3, encoder_lr=1e-3,
              max_epochs_before_stop=10)

    seen = {}
    init = jax_init.init_variables

    def keep(*a, **k):
        seen["variables"] = init(*a, **k)
        return seen["variables"]
    monkeypatch.setattr(jax_init, "init_variables", keep)
    orig = jax_cli.build_model_and_data
    monkeypatch.setattr(
        jax_cli, "build_model_and_data",
        lambda cfg, tokenizer=None, gnn_mesh=None:
        orig(cfg, tokenizer=tok, gnn_mesh=gnn_mesh))
    tok = tokenizer
    want = jax_cli.train(_cfg(jax_config, root, emb_path, mesh_data=1,
                              gnn_backend="pallas",
                              save_dir=str(tmp_path / "jax"), **kw))

    v = {k: jax.tree.map(np.asarray, t)
         for k, t in seen["variables"].items()}
    monkeypatch.setattr(cli, "init_weights", lambda model, gen, std:
                        load_flax_variables(model, v["params"],
                                            v["batch_stats"]))
    _with_tokenizer(monkeypatch, tokenizer)
    spy = Spy(monkeypatch)
    got = cli.train(_cfg(config, root, emb_path, gnn_backend="cuda",
                         save_dir=str(tmp_path / "port"), **kw),
                    device="cpu")
    assert len(got["train_losses"]) == len(want["train_losses"]) == 2
    np.testing.assert_allclose(got["train_losses"], want["train_losses"],
                               rtol=2e-4)
    # two head groups a pass: the train steps' backward ran both passes
    assert spy.calls["_bwd_pass1"] == spy.calls["_bwd_pass2"] > 0
    assert spy.calls["_bwd_pass1"] % 2 == 0


# --------------------------------------------------------------------------
# the plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("HD, heads, groups", [
    (200, 4, [(0, 4)]), (256, 8, [(0, 8)]),
    (512, 4, [(0, 2), (2, 4)]),           # gnn_dim 512: two of 256 columns
    (320, 10, [(0, 5), (5, 10)]),         # more than 8 heads
    (1024, 4, [(0, 1), (1, 2), (2, 3), (3, 4)]),
    (80, 10, [(0, 5), (5, 10)]),
    (264, 3, [(0, 1), (1, 3)]),           # 88 a head: two fit a launch
    (24, 24, [(0, 8), (8, 16), (16, 24)])])
def test_head_groups(HD, heads, groups):
    assert gk.head_groups(HD, heads) == groups
    for h0, h1 in groups:
        gk._check_widths(8, (h1 - h0) * (HD // heads), h1 - h0)


def test_a_head_wider_than_a_launch_is_refused():
    """One launch refuses a head of more than 256 columns; the op's plan
    pads such a head to a multiple of 8 and runs it as column slices, each
    a launch that takes it (tests/test_torch_wide_head.py runs them)."""
    with pytest.raises(ValueError, match="256"):
        gk._check_widths(304, 304, 1)
    assert gk.kernel_widths(300, 300, 1) == (304, 304)
    assert gk.head_groups(264, 1) == [(0, 1)]
    assert gk.launches(304, 1) == [(0, 1, 0, 152), (0, 1, 152, 304)]
    for _, _, c0, c1 in gk.launches(304, 1):
        gk._check_bwd_widths(304, c1 - c0, 1)


@pytest.mark.parametrize("D, HD, heads, want", [
    (512, 512, 4, (512, 512)), (320, 320, 10, (320, 320)),
    (100, 100, 10, (104, 160)),           # 10 heads of 10 -> of 16
    (40, 40, 10, (40, 80)), (300, 200, 4, (304, 200)),
    (1000, 1024, 4, (1024, 1024))])
def test_kernel_widths_beyond_one_launch(D, HD, heads, want):
    assert gk.kernel_widths(D, HD, heads) == want
    Dk, HDk = want
    for h0, h1 in gk.head_groups(HDk, heads):
        gk._check_bwd_widths(Dk, (h1 - h0) * (HDk // heads), h1 - h0)
    n, width = gk.d_slices(Dk)
    assert n == -(-Dk // 256)             # the fewest slices


@pytest.mark.parametrize("D, slices", [
    (8, (1, 8)), (200, (1, 200)), (256, (1, 256)), (272, (2, 136)),
    (512, (2, 256)), (520, (5, 104)), (1024, (4, 256))])
def test_d_slices(D, slices):
    assert gk.d_slices(D) == slices
    n, width = slices
    assert n * width == D and width % 8 == 0 and width <= 256


@pytest.mark.parametrize("route, want", [(1, (8, 132, 0)),
                                         (0, (0, 0, 128))])
def test_backward_scratch_at_d_512(route, want):
    """At D = 512 the tensor-core plan is the streaming kernel's (eight
    warps beside the ring of W's chunks at 256 columns), handed W in bf16,
    and makes no dW (one `bwd_dw` launch a pass does); on CUDA cores the
    partial sums of dW keep every row of W."""
    warps, n_blocks, n_split = want
    got = gk._split_scratch(64, 4096, 512, 256, "cpu", route=route,
                            n_sm=132)
    assert got[:3] == (n_split, warps, n_blocks)
    if route == 1:
        assert got[3] is None
    else:
        assert got[3].shape == (n_split, 512, 256)
    if route == 1:
        assert got[1:3] == gk._tc_plan(64, 4096, 512, 256, 132)
        assert gk._tc_smem_bytes(512, 256, warps) <= gk.TC_SMEM_LIMIT
        assert gk._streamed_w(1, torch.zeros(512, 256),
                              gk._bwd_streams).dtype == torch.bfloat16
    assert gk._streamed_w(route, torch.zeros(256, 256),
                          gk._bwd_streams) is None
    assert gk._streamed_w(0, torch.zeros(512, 256), gk._bwd_streams) is None


def test_sliced_transpose_is_slice_major():
    w = torch.arange(16 * 24, dtype=torch.float32).reshape(16, 24)
    got = gk._sliced_transpose(w, 8)
    assert got.shape == (2, 24, 8) and got.is_contiguous()
    for z in range(2):
        assert torch.equal(got[z], w[8 * z:8 * z + 8].t())
    assert torch.equal(gk._sliced_transpose(w, 16)[0], w.t())
