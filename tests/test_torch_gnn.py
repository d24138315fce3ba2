"""The port's QAGNNMessagePassing against flax, eval and train mode (CPU,
f32).

The port's fused branch (backend "cuda": the kernels' plain versions on CPU
tensors) against flax with backend "pallas" (interpret mode), and its
reference branch against flax with backend "scatter", with non-trivial
BatchNorm running statistics and weights carried across by convert.py.
Tolerance rtol/atol 2e-4, as tests/test_gnn.py holds pallas against scatter.
In train mode (dropout 0): the output, the updated running statistics
(`num_updates=k` on the edge encoder's BatchNorm) and every parameter
gradient of sum(out * cotangent), at rtol 1e-3 with an absolute floor of
1e-4 of the leaf's largest value or 1e-6 of the tree's (f32 sums of other
orders through k layers and two BatchNorms).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qagnn_tpu.models.gnn import QAGNNMessagePassing as JaxMP

from qagnn_tpu_torch.models.gnn import QAGNNMessagePassing
from qagnn_tpu_torch.utils.convert import (
    grads_to_flax,
    load_flax_variables,
    to_flax_variables,
)

N_NTYPE, N_ETYPE, K, D, HEADS = 4, 7, 2, 16, 4
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the machine's cores: one intra-op thread keeps
    this file's torch ops from crowding out the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed_stats(stats, rng):
    return jax.tree.map(
        lambda x: (rng.uniform(0.5, 2.0, x.shape) if np.all(np.asarray(x) == 1)
                   else rng.standard_normal(x.shape) * 0.1).astype(np.float32),
        stats)


def _case(seed, G=3, N=10, E=24, empty_graph=False):
    rng = np.random.default_rng(seed)
    mask = rng.random((G, E)) > 0.3
    if empty_graph:
        mask[-1] = False
    args = (rng.standard_normal((G, N, D)).astype(np.float32),
            rng.integers(0, N_NTYPE, (G, N)).astype(np.int32),
            rng.standard_normal((G, N)).astype(np.float32),
            rng.integers(0, N, (G, E)).astype(np.int32),
            rng.integers(0, N, (G, E)).astype(np.int32),
            rng.integers(0, N_ETYPE, (G, E)).astype(np.int32),
            mask)
    jargs = tuple(jnp.asarray(a) for a in args)
    jmp = JaxMP(k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=D,
                dropout=0.0, head_count=HEADS, backend="scatter")
    v = jmp.init(jax.random.PRNGKey(seed), *jargs, train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = _perturbed_stats(jax.tree.map(np.asarray, v["batch_stats"]), rng)
    return args, jargs, {"params": params, "batch_stats": stats}


CASES = {"masked": dict(seed=0), "ragged_e": dict(seed=1, E=13),
         "empty_graph": dict(seed=2, empty_graph=True)}


def _port(variables, backend):
    mp = QAGNNMessagePassing(K, N_NTYPE, N_ETYPE, D, head_count=HEADS,
                             backend=backend).eval()
    load_flax_variables(mp, variables["params"], variables["batch_stats"])
    return mp


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backends", [("cuda", "pallas"),
                                      ("scatter", "scatter")])
def test_message_passing_matches_flax(case, backends):
    port_backend, jax_backend = backends
    args, jargs, variables = _case(**CASES[case])
    want = JaxMP(k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=D,
                 dropout=0.0, head_count=HEADS, backend=jax_backend).apply(
        variables, *jargs, train=False)
    with torch.no_grad():
        got = _port(variables, port_backend)(
            *[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_weights_match_flax():
    args, jargs, variables = _case(seed=3)
    _, (jedge, jself) = JaxMP(
        k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=D, dropout=0.0,
        head_count=HEADS, backend="scatter").apply(
        variables, *jargs, train=False, return_alpha=True)
    with torch.no_grad():
        _, (edge, self_a) = _port(variables, None)(
            *[torch.from_numpy(a) for a in args], return_alpha=True)
    np.testing.assert_allclose(edge.numpy(), np.asarray(jedge), **TOL)
    np.testing.assert_allclose(self_a.numpy(), np.asarray(jself), **TOL)


def test_default_backend_follows_device():
    args, _, variables = _case(seed=4)
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        auto = _port(variables, None)(*targs)
        ref = _port(variables, "scatter")(*targs)
    np.testing.assert_array_equal(auto.numpy(), ref.numpy())


def _assert_trees_close(got, want, what):
    flat_w = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(flat_g) == sorted(flat_w), what
    # a bias ahead of a BatchNorm has gradient zero: both sides then hold
    # only rounding noise, so the floor also counts 1e-6 of the tree's
    # largest value
    top = max(float(np.abs(w).max()) for w in flat_w.values())
    for name, w in flat_w.items():
        np.testing.assert_allclose(
            flat_g[name], w, rtol=1e-3,
            atol=max(1e-4 * float(np.abs(w).max()), 1e-6 * top),
            err_msg=f"{what}: {name}")


def _jax_train(variables, jargs, cot, backend):
    jmp = JaxMP(k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=D,
                dropout=0.0, head_count=HEADS, backend=backend)

    def loss(params):
        out, new = jmp.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *jargs, train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, new["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])
    return out, stats, grads


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backends", [("cuda", "pallas"),
                                      ("scatter", "scatter")])
def test_message_passing_train_matches_flax(case, backends):
    port_backend, jax_backend = backends
    args, jargs, variables = _case(**CASES[case])
    cot = np.random.default_rng(7).standard_normal(args[0].shape) \
        .astype(np.float32)
    want, want_stats, want_grads = _jax_train(variables, jargs,
                                              jnp.asarray(cot), jax_backend)

    mp = QAGNNMessagePassing(K, N_NTYPE, N_ETYPE, D, dropout=0.0,
                             head_count=HEADS, backend=port_backend).train()
    load_flax_variables(mp, variables["params"], variables["batch_stats"])
    got = mp(*[torch.from_numpy(a) for a in args])
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _assert_trees_close(to_flax_variables(mp)[1], want_stats,
                        "running statistics")
    _assert_trees_close(grads_to_flax(mp), want_grads, "gradients")


def test_train_mode_is_refused():
    """Train mode used to raise; it now runs, on batch statistics: the
    output differs from eval mode's and the running statistics move."""
    args, _, variables = _case(seed=5)
    mp = _port(variables, "scatter")
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        eval_out = mp(*targs)
        before = mp.edge_encoder.bn.mean.clone()
        train_out = mp.train()(*targs)
    assert train_out.shape == eval_out.shape
    assert not torch.allclose(train_out, eval_out)
    assert not torch.equal(mp.edge_encoder.bn.mean, before)
