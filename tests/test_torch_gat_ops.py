"""The port's GAT ops against the JAX package on the same inputs (CPU, f32).

`gat_projected_forward` (plain versions of the CUDA kernels on CPU tensors)
is held against `_proj_fwd_impl` with the Pallas kernels in interpret mode,
intermediates included; the port's scatter oracle against the JAX scatter
backend. Tolerance rtol/atol 2e-4, as tests/test_pallas_gat.py uses for the
projected kernel (f32 sums in another order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qagnn_tpu.ops.gat_attention import (
    relational_gat_attention_nodes as jax_gat_nodes,
)
from qagnn_tpu.ops.pallas_gat import _proj_fwd_impl

from qagnn_tpu_torch.ops import gat_kernels
from qagnn_tpu_torch.ops.gat_attention import relational_gat_attention_nodes

HEADS = 2
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the machine's cores: one intra-op thread keeps
    this file's torch ops from crowding out the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, G, N, E, HD, D, mask_kind):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = dict(
        nq=f(G, N, HD), nk=f(G, N, HD), nm=f(G, N, HD),
        edge_emb=f(G, E, D), w_ke=f(D, HD) * 0.3, b_ke=f(HD),
        w_me=f(D, HD) * 0.3, b_me=f(HD), skb=f(G, N, HD), smb=f(G, N, HD),
        src=rng.integers(0, N, (G, E)).astype(np.int32),
        dst=rng.integers(0, N, (G, E)).astype(np.int32))
    mask = rng.random((G, E)) > 0.25
    if mask_kind == "one_graph_empty":
        mask[1] = False
    elif mask_kind == "all_empty":
        mask[:] = False
    arrays["mask"] = mask
    return arrays


CASES = {
    "masked25": (0, 3, 8, 16, 8, 8, "masked25"),
    "one_graph_all_masked": (1, 3, 8, 16, 8, 8, "one_graph_empty"),
    "all_masked": (2, 2, 8, 16, 8, 8, "all_empty"),
    "ragged_e": (3, 2, 8, 13, 8, 6, "masked25"),
}


def _torch_forward(a):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    return gat_kernels.gat_projected_forward(
        t["nq"], t["nk"], t["nm"], t["edge_emb"], t["w_ke"], t["b_ke"],
        t["w_me"], t["b_me"], t["skb"], t["smb"], t["src"], t["dst"],
        t["mask"], HEADS)


def _jax_forward(a):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    out, scores, gmax, denom_raw, scale, e_self, _ = _proj_fwd_impl(
        j["nq"], j["nk"], j["nm"], jnp.swapaxes(j["edge_emb"], 1, 2),
        j["w_ke"], j["b_ke"], j["w_me"], j["b_me"], j["skb"], j["smb"],
        j["src"], j["dst"], j["mask"].astype(jnp.float32), HEADS, True)
    return out, scores, gmax, denom_raw, scale, e_self


@pytest.mark.parametrize("case", sorted(CASES))
def test_gat_projected_forward_matches_pallas(case):
    a = _inputs(*CASES[case])
    out, scores, gmax, denom_raw, scale, e_self = _torch_forward(a)
    j_out, j_scores, j_gmax, j_denom_raw, j_scale, j_e_self = _jax_forward(a)
    mask = a["mask"]
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    # scores of masked slots are never read; compare the live ones
    live = np.broadcast_to(mask[:, None, :], scores.shape)
    np.testing.assert_allclose(scores.numpy()[live],
                               np.asarray(j_scores)[live], **TOL)
    np.testing.assert_allclose(gmax.numpy(), np.asarray(j_gmax)[:, :], **TOL)
    np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale), **TOL)
    # the residuals that only the backward reads
    np.testing.assert_allclose(denom_raw.numpy(), np.asarray(j_denom_raw),
                               **TOL)
    np.testing.assert_allclose(e_self.numpy(), np.asarray(j_e_self), **TOL)
    assert np.isfinite(out.numpy()).all()


def _heads(x):
    return x.reshape(x.shape[0], x.shape[1], HEADS, -1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scatter_oracle_matches_jax_scatter(case):
    a = _inputs(*CASES[case])
    rng = np.random.default_rng(11)
    G, E = a["src"].shape
    ekb = rng.standard_normal(a["nq"].shape[:1] + (E,) + a["nq"].shape[2:])
    emb = rng.standard_normal(ekb.shape)
    ekb, emb = ekb.astype(np.float32), emb.astype(np.float32)
    node = [a["nq"], a["nk"], a["nm"], ekb, emb, a["skb"], a["smb"]]

    got, (ga, gs) = relational_gat_attention_nodes(
        *[_heads(torch.from_numpy(x)) for x in node],
        torch.from_numpy(a["src"]), torch.from_numpy(a["dst"]),
        torch.from_numpy(a["mask"]), return_alpha=True)
    want, (wa, ws) = jax_gat_nodes(
        *[_heads(jnp.asarray(x)) for x in node], jnp.asarray(a["src"]),
        jnp.asarray(a["dst"]), jnp.asarray(a["mask"]), backend="scatter",
        return_alpha=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


def test_fused_op_matches_scatter_oracle():
    """The fused op and the scatter oracle are one function: the edge
    projections done outside, the same weights, the same masked edges."""
    a = _inputs(*CASES["masked25"])
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    ekb = t["edge_emb"] @ t["w_ke"] + t["b_ke"]
    emb = t["edge_emb"] @ t["w_me"] + t["b_me"]
    want = relational_gat_attention_nodes(
        _heads(t["nq"]), _heads(t["nk"]), _heads(t["nm"]), _heads(ekb),
        _heads(emb), _heads(t["skb"]), _heads(t["smb"]), t["src"], t["dst"],
        t["mask"])
    got = _torch_forward(a)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_wrappers_take_plain_version_only_on_cpu():
    """On CPU tensors no kernel is launched and no launch is counted."""
    from qagnn_tpu_torch.ops import _build

    _build.reset_launch_counts()
    _torch_forward(_inputs(*CASES["masked25"]))
    assert sum(_build.LAUNCHES.values()) == 0
