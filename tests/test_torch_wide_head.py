"""A GAT head wider than one kernel launch (CPU).

A launch of rows 1-9 takes at most 256 columns. A head of more than 256
features is padded to a multiple of 8 and runs as column slices of at most
256 columns (`gat_kernels.col_slices`), one launch each; rows 1, 4, 6 and 8
sum over a head's columns, so each slice adds its f32 head sums to those of
the slices before it and only the last takes the max over the scores or adds
d_alpha * e into dscale (`gat_kernels.partial`). With the kernels' plain
versions on CPU tensors:

  * the unprojected op, `relational_gat_attention_nodes(backend="cuda")`,
    at (HD 300, 1 head) and (HD 1040, 2 heads of 520, three slices) against
    the JAX op with backend "pallas" (interpret mode): value and the seven
    gradients within tests/test_torch_wide_gat.py's VAL_TOL / GRAD_TOL, the
    atol taken of the largest value where that is above 1. Both sides shift
    the softmax by the graph's max (ROADMAP C7). The query arrives scaled
    by 1/sqrt(features a head), as the op takes it (`W_q x / sqrt(D)`):
    with a unit-normal query the scores of a 300-520 feature head lie at
    +-30-70, where the order of the f32 sums alone, unsliced as much as
    sliced, moves outputs of ~10 by 2.5e-5 and gradients of ~100 by 1e-4;
  * QAGNNMessagePassing at gnn_dim 1040 (4 heads of 260, padded to 264, two
    slices a head) on the fused branch against flax's "pallas" branch, in
    eval mode (the output) and train mode (the output and every parameter
    gradient), dropout off, both sides on torch's score basis
    (tests/test_torch_wide_gat.py `_one_score_basis`);
  * a spy on every function that reaches a kernel's C entry point: every
    launch takes at most 256 columns, and rows 1, 3-9 launch once a column
    slice of a wide head, rows 2 and 6's denominators once a head group;
  * each split row through its wrapper against the same row as one
    unsliced call of its plain version, and the first slice's partial mode;
  * the plans: `col_slices`, `kernel_widths`, `launches`;
  * the edge encoder's rows 11 and 12 past a launch's columns (D above
    1024 in the backward, which gnn_dim 1040 reaches): D's columns in
    slices, against one unsliced call of their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_wide_gat import (  # noqa: F401  (fixtures by name)
    FLOATS,
    GRAD_TOL,
    VAL_TOL,
    Spy,
    _flat,
    _one_score_basis,
    _one_torch_thread,
    _unproj_inputs,
)

from qagnn_tpu.models.gnn import QAGNNMessagePassing as JaxMP
from qagnn_tpu.ops.gat_attention import (
    relational_gat_attention_nodes as jax_gat_nodes,
)
from qagnn_tpu_torch.models.gnn import QAGNNMessagePassing
from qagnn_tpu_torch.ops import edge_encoder_kernels as ek
from qagnn_tpu_torch.ops import gat_kernels as gk
from qagnn_tpu_torch.ops import gat_unproj_kernels as uk
from qagnn_tpu_torch.ops.gat_attention import relational_gat_attention_nodes
from qagnn_tpu_torch.utils.convert import grads_to_flax, load_flax_variables

SPLIT_ROWS = ("_edge_scores", "_aggregate", "_bwd1", "_bwd2")


# --------------------------------------------------------------------------
# the plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dph, slices", [
    (8, [(0, 8)]), (256, [(0, 256)]), (100, [(0, 100)]),
    (264, [(0, 128), (128, 264)]),        # gnn_dim 1040 / 4 heads, padded
    (304, [(0, 152), (152, 304)]),        # HD 300 / 1 head, padded
    (520, [(0, 168), (168, 344), (344, 520)]),
    (1024, [(0, 256), (256, 512), (512, 768), (768, 1024)])])
def test_col_slices(dph, slices):
    assert gk.col_slices(dph) == slices
    widths = [c1 - c0 for c0, c1 in slices]
    assert slices[0][0] == 0 and slices[-1][1] == dph
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert max(widths) <= 256 and len(slices) == -(-dph // 256)
    if len(slices) > 1:
        assert all(w % 8 == 0 for w in widths)
        assert max(widths) - min(widths) <= 8


def test_col_slices_take_a_padded_head_only():
    with pytest.raises(ValueError, match="multiple of 8"):
        gk.col_slices(300)


@pytest.mark.parametrize("D, HD, heads, want, n_launches", [
    (300, 300, 1, (304, 304), 2),
    (1040, 1040, 2, (1040, 1040), 6),
    (1040, 1040, 4, (1040, 1056), 8),      # gnn_dim 1040: 4 x 264
    (2048, 2048, 4, (2048, 2048), 8),
    (520, 260, 1, (528, 264), 2),
    (200, 200, 4, (200, 200), 1)])
def test_kernel_widths_of_wide_heads(D, HD, heads, want, n_launches):
    assert gk.kernel_widths(D, HD, heads) == want
    Dk, HDk = want
    plan = gk.launches(HDk, heads)
    assert len(plan) == n_launches
    # the launches cover every column once, in order, at most 256 each
    assert [c for _, _, c0, c1 in plan for c in range(c0, c1)] \
        == list(range(HDk))
    for h0, h1, c0, c1 in plan:
        gk._check_bwd_widths(Dk, c1 - c0, h1 - h0)


# --------------------------------------------------------------------------
# the unprojected op against the JAX op
# --------------------------------------------------------------------------

def _assert_close(got, want, tol, what):
    """np.testing.assert_allclose at tol, its atol of the largest |want|
    where that is above 1."""
    top = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * top, err_msg=what)


@pytest.mark.parametrize("HD, heads, n_launches", [(300, 1, 2),
                                                   (1040, 2, 6)])
def test_unprojected_op_matches_jax_at_a_wide_head(HD, heads, n_launches,
                                                   monkeypatch):
    a = _unproj_inputs(HD, 2, 9, 30, HD)
    a["nq"] /= np.float32(np.sqrt(HD // heads))
    split = lambda t: t.reshape(*t.shape[:2], heads, -1)  # noqa: E731
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in FLOATS]
    ints = [torch.from_numpy(a[k]) for k in ("src", "dst", "mask")]
    spy = Spy(monkeypatch)
    out = relational_gat_attention_nodes(*map(split, leaves), *ints,
                                         backend="cuda")
    out.backward(torch.from_numpy(a["g"]))
    # a launch a column slice; the denominators once a head group
    assert spy.calls == dict({n: n_launches for n in SPLIT_ROWS},
                             _edge_denoms=1)

    j_out, vjp = jax.vjp(
        lambda *f: jax_gat_nodes(*f, jnp.asarray(a["src"]),
                                 jnp.asarray(a["dst"]),
                                 jnp.asarray(a["mask"]), backend="pallas"),
        *[jnp.asarray(a[k]).reshape(*a[k].shape[:2], heads, -1)
          for k in FLOATS])
    want = vjp(jnp.asarray(a["g"]))
    assert out.shape == (2, 9, HD)
    _assert_close(out.detach().numpy(), np.asarray(j_out), VAL_TOL, "out")
    for name, t, w in zip(FLOATS, leaves, want):
        _assert_close(t.grad.numpy(), np.asarray(w).reshape(t.shape),
                      GRAD_TOL, f"d{name}")


# --------------------------------------------------------------------------
# the message passing at gnn_dim 1040 against flax
# --------------------------------------------------------------------------

N_NTYPE, N_ETYPE, K, WIDE, HEADS = 4, 7, 2, 1040, 4


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_message_passing_at_gnn_dim_1040_matches_flax(train, monkeypatch,
                                                      _one_score_basis):
    G, N, E = 2, 8, 20
    rng = np.random.default_rng(1)
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
        jax.random.PRNGKey(1), *map(jnp.asarray, args), train=False))
    cot = rng.standard_normal(args[0].shape).astype(np.float32)

    def loss(params):
        out = jmp.apply({"params": params, "batch_stats": v["batch_stats"]},
                        *map(jnp.asarray, args), train=train,
                        mutable=["batch_stats"] if train else False)
        out = out[0] if train else out
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.value_and_grad(loss, has_aux=True)(
        v["params"])

    mp = QAGNNMessagePassing(K, N_NTYPE, N_ETYPE, WIDE, dropout=0.0,
                             head_count=HEADS, backend="cuda").train(train)
    load_flax_variables(mp, v["params"], v["batch_stats"])
    spy = Spy(monkeypatch)
    got = mp(*map(torch.from_numpy, args))
    # k layers, 4 heads of 264 padded features, two column slices each
    launches = 2 * HEADS * K
    if not train:
        assert spy.calls == {"_pass_a_scores": launches,
                             "_pass_c": launches}
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
        return
    (got * torch.from_numpy(cot)).sum().backward()
    assert spy.calls == {n: launches for n in Spy.PROJECTED}
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


# --------------------------------------------------------------------------
# each split row against one unsliced call of its plain version
# --------------------------------------------------------------------------

SPLIT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _close(got, want, dt, what):
    """|got - want| within SPLIT_TOL of max|want|: in f32 only the order of
    the f32 sums differs; in bf16 a rounding that sees an f32 sum one bit
    away may land one bf16 step away."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    assert err <= SPLIT_TOL[dt] * max(top, 1e-30), (what, err, top)


def _wide_inputs(seed, G, N, E, D, HD, heads, dt):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    t = {k: (r(G, N, HD) * 0.5).to(dt) for k in ("nq", "nk", "nm", "gout")}
    t.update(ekb=(r(G, E, HD) * 0.5).to(dt), emb=(r(G, E, HD) * 0.5).to(dt),
             edge_emb=torch.relu(r(G, E, D)).to(dt), w=r(D, HD) * 0.05,
             b=r(HD) * 0.1, carry=(r(G, E, D) * 0.1).to(dt),
             scale=torch.rand((G, N, heads), generator=gen) + 0.5,
             e_edge=torch.rand((G, heads, E), generator=gen),
             src=torch.randint(0, N, (G, E), generator=gen, dtype=torch.int32),
             dst=torch.randint(0, N, (G, E), generator=gen, dtype=torch.int32),
             mask=torch.rand((G, E), generator=gen) > 0.25)
    t["mask"][1] = False
    return t


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_rows_match_one_unsliced_plain_call(dt):
    G, N, E, D, HD, heads = 2, 7, 24, 40, 528, 2      # two heads of 264
    t = _wide_inputs(3, G, N, E, D, HD, heads, dt)
    src, dst, mask = t["src"], t["dst"], t["mask"]
    z = lambda *s: torch.zeros(s)  # noqa: E731

    # row 1: the unprojected scores and their max
    got = uk.edge_scores(t["nq"], t["nk"], t["ekb"], src, dst, mask, heads)
    want = uk.edge_scores_plain(t["nq"], t["nk"], t["ekb"], src, dst, mask,
                                heads)
    for g, w, what in zip(got, want, ("scores", "max")):
        _close(g, w, dt, f"row 1 {what}")
    # row 4: demb, d_alpha, dnm, dscale
    a4 = (t["gout"], t["nm"], t["emb"], t["e_edge"], t["scale"], src, dst,
          mask)
    seed_nm, seed_ds = torch.randn(G, N, HD), torch.randn(G, N, heads)
    got = uk.bwd1(*a4, seed_nm.clone(), seed_ds.clone(), heads)
    want = uk.bwd1_plain(*a4, seed_nm.clone(), seed_ds.clone(), heads)
    for g, w, what in zip(got, want, ("demb", "d_alpha", "dnm", "dscale")):
        _close(g, w, dt, f"row 4 {what}")

    # row 6: the projected scores and their max
    a6 = (t["nq"], t["nk"], t["edge_emb"], t["w"], t["b"], src, dst, mask,
          heads)
    got, want = gk.pass_a_scores(*a6), gk.pass_a_scores_plain(*a6)
    for g, w, what in zip(got, want, ("scores", "max")):
        _close(g, w, dt, f"row 6 {what}")
    # row 8: demb (with a carry), d_alpha, dnm, dscale, dW, db
    scores, gmax = want[0], want[1].clamp_min(0.0)
    a8 = (t["gout"], t["nm"], t["edge_emb"], t["w"], t["b"], scores, gmax,
          t["scale"], src, dst, mask, t["carry"])
    got = gk.bwd_pass1(*a8, z(G, N, HD), seed_ds.clone(), heads)
    want = gk.bwd_pass1_plain(*a8, z(G, N, HD), seed_ds.clone(), heads)
    for g, w, what in zip(got, want, ("demb", "d_alpha", "dnm", "dscale",
                                      "dW", "db")):
        _close(g, w, dt, f"row 8 {what}")


def test_a_first_slice_leaves_the_whole_sum_to_the_last():
    """The partial mode on its own: the first slice writes its own sums and
    no max, leaves dscale alone; the last adds the slices before it and
    takes the max / the dscale term of the whole sum."""
    G, N, E, HD, heads = 2, 7, 24, 264, 1
    t = _wide_inputs(4, G, N, E, 8, HD, heads, torch.float32)
    src, dst, mask = t["src"], t["dst"], t["mask"]
    (a, b), (c, d) = gk.col_slices(HD)
    part = lambda x, c0, c1: x[..., c0:c1].contiguous()  # noqa: E731
    rows = [part(t[k], a, b) for k in ("nq", "nk", "ekb")]
    first, m_first = uk._edge_scores(*rows, src, dst, mask, heads, None,
                                     acc=None, last=False)
    alone, _ = uk.edge_scores_plain(*rows, src, dst, mask, heads)
    assert torch.equal(first, alone)
    assert bool((m_first == gk.NEG).all())
    rows = [part(t[k], c, d) for k in ("nq", "nk", "ekb")]
    whole, m_whole = uk._edge_scores(*rows, src, dst, mask, heads, None,
                                     acc=first.clone(), last=True)
    want = uk.edge_scores_plain(t["nq"], t["nk"], t["ekb"], src, dst, mask,
                                heads)
    torch.testing.assert_close(whole, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m_whole, want[1], rtol=1e-5, atol=1e-5)

    ds0 = torch.randn(G, N, heads)
    a4 = (t["e_edge"], t["scale"], src, dst, mask)
    first = uk._bwd1(*[part(t[k], a, b) for k in ("gout", "nm", "emb")],
                     *a4, torch.zeros(G, N, b - a), ds0.clone(), heads, None,
                     acc=None, last=False)
    assert torch.equal(first[3], ds0)                 # dscale untouched
    last = uk._bwd1(*[part(t[k], c, d) for k in ("gout", "nm", "emb")],
                    *a4, torch.zeros(G, N, d - c), ds0.clone(), heads, None,
                    acc=first[1].clone(), last=True)
    want = uk.bwd1_plain(t["gout"], t["nm"], t["emb"], *a4,
                         torch.zeros(G, N, HD), ds0.clone(), heads)
    torch.testing.assert_close(last[1], want[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(last[3], want[3], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the edge encoder's rows 11 and 12 past a launch's columns
# --------------------------------------------------------------------------

@pytest.mark.parametrize("F, D, slices", [
    (47, 200, [(0, 200)]), (47, 1024, [(0, 1024)]),
    (47, 1040, [(0, 1024), (1024, 1040)]),         # gnn_dim 1040, OBQA
    (100, 1040, [(0, 512), (512, 1024), (1024, 1040)]),
    (16, 2048, [(0, 1024), (1024, 2048)])])
def test_edge_hidden_backward_slices(F, D, slices):
    """Route 0's backward takes 1024 columns and an F x width f32 dW0 in
    200 KiB a launch."""
    got = ek.bwd_col_slices(F, D)
    assert got == slices
    for c0, c1 in got:
        assert c1 - c0 <= 1024 and F * (c1 - c0) * 4 <= 200 * 1024


@pytest.mark.parametrize("D, dt, slices", [
    (1040, torch.bfloat16, [(0, 1040)]), (8200, torch.bfloat16,
                                          [(0, 8192), (8192, 8200)]),
    (4100, torch.float32, [(0, 4096), (4096, 4100)]),
    (1025, torch.float32, [(0, 1024), (1024, 1025)])])
def test_edge_hidden_forward_slices(D, dt, slices):
    assert ek.fwd_col_slices(D, dt) == slices


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_edge_hidden_split_columns_match_one_plain_call(dt):
    """Rows 11 and 12 at D = 1040 with F = 100 (three backward launches)
    and at D = 1025 in f32 (two forward launches) against one unsliced call
    of their plain versions: every quantity is per column."""
    gen = torch.Generator().manual_seed(5)
    G, N, E, n_rel, n_ntype = 2, 6, 40, 92, 4
    ints = (torch.randint(0, n_rel + 2, (G, E), generator=gen,
                          dtype=torch.int32),
            torch.randint(0, N, (G, E), generator=gen, dtype=torch.int32),
            torch.randint(0, N, (G, E), generator=gen, dtype=torch.int32),
            torch.randint(0, n_ntype, (G, N), generator=gen,
                          dtype=torch.int32))
    for D in (1040, 1025):
        F = n_rel + 2 * n_ntype
        p = (torch.randn(F, D, generator=gen) * 0.2,
             *(torch.randn(D, generator=gen) * 0.5 for _ in range(3)))
        got = ek.edge_hidden_forward(*ints, *p, n_rel, n_ntype, dt)
        want = ek.edge_hidden_plain(*ints, *p, n_rel, n_ntype, dt)
        assert torch.equal(got, want)
        dh = torch.randn(G, E, D, generator=gen).to(dt)
        got = ek.edge_hidden_backward(*ints, *p, dh, n_rel, n_ntype)
        want = ek.edge_hidden_backward_plain(*ints, *p, dh, n_rel, n_ntype)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
