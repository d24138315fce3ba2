"""Each encoder family's whole LMQAGNN against the JAX package's (CPU, f32).

The GPT, XLNet, ALBERT and LSTM encoders of tests/test_torch_encoders.py
(tiny configs, dropout 0) under a k=2 decoder, the flax variables carried
across by utils/convert.py (strictly), the port on its kernel path (the
kernels' plain versions here) and the JAX model on its scatter path:

  * eval logits, and in train mode the logits and every parameter gradient
    of the cross-entropy loss, at tests/test_torch_qagnn.py's rtol 3e-4 /
    atol 3e-5 (the gradients' absolute floor 3e-5 of the tree's largest);
  * one `make_train_step` (RAdam, clipping, the entity table frozen)
    against the JAX train step: the loss at rtol 2e-4, the parameters and
    BatchNorm statistics after it at tests/test_torch_train_step.py's rtol
    1e-3 / atol 2e-5;
  * the optimizer's decay mask and encoder/decoder groups over the port's
    trained parameters against the JAX masks over the flax leaves each one
    holds, and those leaves are the flax tree's, one for one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qagnn_tpu.graph.container import BatchedGraphs as JaxGraphs
from qagnn_tpu.train import optim as jax_optim
from qagnn_tpu.train import step as jax_step
from qagnn_tpu.train.losses import cross_entropy_loss as jax_ce
from qagnn_tpu.utils.initialization import init_variables

from qagnn_tpu_torch.train.losses import cross_entropy_loss
from qagnn_tpu_torch.train.optim import (
    build_train_optimizer,
    entity_table_names,
)
from qagnn_tpu_torch.train.step import Batch, make_eval_step, make_train_step
from qagnn_tpu_torch.utils.convert import (
    flax_paths,
    grads_to_flax,
    load_flax_variables,
    to_flax_variables,
)

from test_torch_encoders import (  # noqa: F401  (module-scoped fixtures)
    B,
    C,
    _flax_dropout_is_identity,
    _graph,
    _lm_inputs,
    _models,
    _one_torch_thread,
    _port_inputs,
)

FAMILIES = ("gpt", "xlnet", "albert", "lstm")
TOL = dict(rtol=3e-4, atol=3e-5)
OPT = dict(optim="radam", encoder_lr=3e-3, decoder_lr=1e-2,
           weight_decay=0.01, max_grad_norm=1.0)


@pytest.fixture(scope="module", params=FAMILIES)
def setup(request):
    """(family, flax model, port model with the flax variables, numpy
    inputs of two batches, the flax variables)."""
    family = request.param
    jmodel, model = _models(family)
    batches = [(_lm_inputs(family, (B, C), seed), _graph(seed),
                np.random.default_rng(seed).integers(0, C, B)
                .astype(np.int32)) for seed in (0, 1)]
    v = init_variables(jmodel, jax.random.PRNGKey(0),
                       *_jax_inputs(*batches[0][:2]))
    variables = {k: jax.tree.map(np.asarray, t) for k, t in v.items()}
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    return family, jmodel, model, batches, variables


def _jax_inputs(lm, graph):
    return ({k: jnp.asarray(v) for k, v in lm.items()},
            JaxGraphs(**{k: jnp.asarray(v) for k, v in graph.items()}))


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_lmqagnn_logits_and_gradients_match_flax(setup):
    family, jmodel, model, batches, variables = setup
    lm, graph, labels = batches[1]
    jlm, jgraph = _jax_inputs(lm, graph)

    want = jax.jit(lambda v, lm, g: jmodel.apply(v, lm, g, train=False))(
        variables, jlm, jgraph)
    got = make_eval_step(model, device="cpu")(*_port_inputs(lm, graph))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def loss(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jlm, jgraph, train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(labels)), logits

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    model.train()
    model.zero_grad()
    got = model(*_port_inputs(lm, graph))
    cross_entropy_loss(got, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got_grads, want_grads = _flat(grads_to_flax(model)), _flat(want_grads)
    assert sorted(got_grads) == sorted(want_grads)
    top = max(float(np.abs(w).max()) for w in want_grads.values())
    assert any(k.startswith("encoder/") and np.abs(w).max() > 1e-3 * top
               for k, w in want_grads.items())
    for name, w in want_grads.items():
        np.testing.assert_allclose(got_grads[name], w, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * top, err_msg=name)
    model.zero_grad()
    # train mode moved the BatchNorm running statistics
    load_flax_variables(model, variables["params"], variables["batch_stats"])


def test_train_step_matches_jax(setup):
    family, jmodel, model, batches, variables = setup
    lm, graph, labels = batches[1]
    jparams = jax.tree.map(jnp.asarray, variables["params"])
    frozen = jax.tree_util.tree_map_with_path(
        lambda path, _: "concept_emb" in jax_optim.path_str(path)
        and "embedding" in jax_optim.path_str(path), jparams)
    jopt = jax_optim.build_train_optimizer(jparams, frozen_param_mask=frozen,
                                           **OPT)
    state = jax_step.TrainState(
        params=jparams,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jopt.init(jparams), step=jnp.zeros([], jnp.int32),
        rng=jax.random.PRNGKey(0))
    jlm, jgraph = _jax_inputs(lm, graph)
    state, metrics = jax_step.make_train_step(jmodel, jopt)(
        state, jax_step.Batch(lm_inputs=jlm, graph=jgraph,
                              labels=jnp.asarray(labels)), True)

    load_flax_variables(model, variables["params"], variables["batch_stats"])
    opt = build_train_optimizer(model, frozen=entity_table_names(model),
                                **OPT)
    step = make_train_step(model, opt, device="cpu")
    out = step(Batch(*_port_inputs(lm, graph), torch.from_numpy(labels)))
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]),
                               rtol=2e-4)
    params, stats = to_flax_variables(model)
    got, want = _flat(params), _flat(state.params)
    assert sorted(got) == sorted(want)
    moved = 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-3, atol=2e-5,
                                   err_msg=name)
        moved += name.startswith("encoder/") and not np.array_equal(
            w, _flat(variables["params"])[name])
    assert moved > 0
    for name, w in _flat(state.batch_stats).items():
        np.testing.assert_allclose(_flat(stats)[name], w, rtol=1e-3,
                                   atol=2e-5, err_msg=name)
    load_flax_variables(model, variables["params"], variables["batch_stats"])


def test_decay_mask_and_groups_match_jax(setup):
    """The port's decay mask and encoder/decoder groups over its trained
    parameters equal the JAX masks over the flax leaves each one holds, and
    those leaves are the flax tree's, one for one."""
    family, _, model, _, variables = setup
    params = variables["params"]
    want_decay = _flat(jax_optim.no_decay_mask(params))
    want_enc = _flat(jax_optim.encoder_mask(params))
    opt = build_train_optimizer(model)
    paths = flax_paths(model)
    covered = []
    for name in opt.params:
        for path in paths[name]:
            leaf = "/".join(path)
            covered.append(leaf)
            assert opt.decays[name] == bool(want_decay[leaf]), (name, leaf)
            group = "encoder" if want_enc[leaf] else "decoder"
            assert name in opt.groups[group], (name, leaf)
    assert sorted(covered) == sorted(want_decay)
    spared = {"gpt": "encoder.block_0.c_attn.bias",
              "xlnet": "encoder.layer_0.rel_attn.r_w_bias",
              "albert": "encoder.layer_shared.output.bias",
              "lstm": "encoder.OptimizedLSTMCell_1.bias"}[family]
    assert not opt.decays[spared]


