"""The port's training optimizer against the JAX package's (CPU, f32).

A small encoder/decoder model, its parameters exported to the flax tree;
identical numpy gradients go through `build_train_optimizer` of both
packages step by step: 24 RAdam steps (crossing N_sma = 5 at step 6) with the
encoder frozen for five of them, the entity table frozen throughout and
clipping active on some steps and idle on others; a few steps of adamw, adam
and sgd; the three LR schedules; both masks. Parameters are compared after
every step at rtol 2e-5 / atol 1e-5, with steps of about 1e-2: the JAX
package computes the RAdam scalars in f32, where N_sma (a difference of
numbers near 2000) keeps four digits in the first rectified steps; the port
computes them in Python floats, as the reference does.

The step runs as multi-tensor passes (`torch._foreach_*`). More cases hold
it against the JAX optimizers with a weight decay large enough to matter on
the decayed tensors beside the undecayed ones, across a frozen -> unfrozen
switch, and across a checkpoint round trip of `TrainOptimizer.state`
(utils/checkpoint.py) in the middle of a run; and, bit for bit, against the
per-tensor loop it replaced (kept here as `_per_tensor_step`), also over a
model with a bfloat16 parameter, leaving every `.grad` as it was.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch import nn

from qagnn_tpu.train import optim as jax_optim

from qagnn_tpu_torch.models.layers import MLP, CustomizedEmbedding
from qagnn_tpu_torch.models.norm import MaskedBatchNorm
from qagnn_tpu_torch.train import optim
from qagnn_tpu_torch.utils import checkpoint
from qagnn_tpu_torch.utils.convert import (
    load_flax_variables,
    to_flax_variables,
)

TOL = dict(rtol=2e-5, atol=1e-5)


class _Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.word_embeddings = nn.Embedding(7, 4)
        self.embeddings_ln = nn.LayerNorm(4)
        self.pooler = nn.Linear(4, 3)


class _Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.concept_emb = CustomizedEmbedding(9, 5, 3)
        self.out_bn = MaskedBatchNorm(3)
        self.fc = MLP(3, 4, 1, 1, layer_norm=True)


class _Model(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = _Encoder()
        self.decoder = _Decoder()


def _model(seed=0):
    torch.manual_seed(seed)
    m = _Model()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape))
    return m


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _set_grads(model, grad_tree, stats):
    carrier = _Model()
    load_flax_variables(carrier, grad_tree, stats)
    for (_, p), (_, g) in zip(model.named_parameters(),
                              carrier.named_parameters()):
        p.grad = g.detach().clone()


def _frozen_tree(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, _: "concept_emb" in jax_optim.path_str(path)
        and "embedding" in jax_optim.path_str(path), params)


def _run(optim_name, n_steps, frozen_steps=(), restore_at=None,
         tmp_path=None, **kw):
    model = _model()
    params, stats = to_flax_variables(model)
    jparams = _tree_map(jnp.asarray, params)
    jopt = jax_optim.build_train_optimizer(
        jparams, optim=optim_name, frozen_param_mask=_frozen_tree(jparams),
        **kw)
    jstate = jopt.init(jparams)
    update = jax.jit(jopt.update, static_argnums=3)
    opt = optim.build_train_optimizer(
        model, optim=optim_name, frozen=optim.entity_table_names(model), **kw)
    assert optim.entity_table_names(model) == [
        "decoder.concept_emb.emb.weight"]
    rng = np.random.default_rng(1)
    clipped = []
    for step in range(n_steps):
        # large gradients (clipped) on even steps, small ones on odd steps
        size = 3.0 if step % 2 == 0 else 0.02
        grads = _tree_map(lambda x: (rng.standard_normal(x.shape) * size)
                          .astype(np.float32), params)
        trainable = step not in frozen_steps
        updates, jstate = update(_tree_map(jnp.asarray, grads), jstate,
                                 jparams, trainable)
        jparams = jax.tree.map(jnp.add, jparams, updates)
        if step == restore_at:
            # save, then go on in a new model and optimizer restored from it
            path = str(tmp_path / "ckpt")
            checkpoint.save_checkpoint(path, model, opt)
            model = _model(seed=5)
            opt = optim.build_train_optimizer(
                model, optim=optim_name,
                frozen=optim.entity_table_names(model), **kw)
            checkpoint.restore_into(checkpoint.load_checkpoint(path)[0],
                                    model, opt)
        _set_grads(model, grads, stats)
        opt.step(trainable)
        clipped.append(float(opt.last_grad_norm) > kw.get(
            "max_grad_norm", 1.0))
        got = to_flax_variables(model)[0]
        flat_w = jax.tree_util.tree_flatten_with_path(jparams)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (path, g), (_, w) in zip(flat_g, flat_w):
            np.testing.assert_allclose(
                g, np.asarray(w), err_msg=f"step {step} "
                f"{jax_optim.path_str(path)}", **TOL)
    return model, opt, params, clipped


def test_radam_matches_jax_over_24_steps_with_freeze_and_clipping():
    frozen_steps = (8, 9, 10, 11, 12)
    model, opt, start, clipped = _run(
        "radam", 24, frozen_steps, encoder_lr=3e-3, decoder_lr=1e-2,
        weight_decay=0.01, max_grad_norm=1.0)
    assert any(clipped) and not all(clipped)
    # the counts: the encoder group skipped its frozen steps
    assert int(opt.state["step"]) == 24
    assert int(opt.state["decoder.count"]) == 24
    assert int(opt.state["encoder.count"]) == 24 - len(frozen_steps)
    # the entity table never moved and has no moments
    np.testing.assert_array_equal(
        model.decoder.concept_emb.emb.weight.detach().numpy(),
        start["decoder"]["concept_emb"]["emb"]["embedding"])
    assert not any("concept_emb.emb" in k for k in opt.state)
    assert all(isinstance(v, torch.Tensor) for v in opt.state.values())


def test_radam_crosses_the_rectification_switch():
    rect = [optim._radam_scalars(t)[0] for t in range(1, 10)]
    assert rect == [False] * 5 + [True] * 4


def test_frozen_encoder_keeps_parameters_and_moments():
    model = _model()
    opt = optim.build_train_optimizer(model, optim="radam")
    params, stats = to_flax_variables(model)
    ones = _tree_map(np.ones_like, params)
    _set_grads(model, ones, stats)
    opt.step(True)
    enc = {n: p.detach().clone() for n, p in model.encoder.named_parameters()}
    moments = {k: v.clone() for k, v in opt.state.items()
               if k.startswith("encoder.")}
    dec = model.decoder.fc.linear_0.weight.detach().clone()
    _set_grads(model, ones, stats)
    opt.step(False)
    for n, p in model.encoder.named_parameters():
        assert torch.equal(p, enc[n]), n
    for k, v in moments.items():
        assert torch.equal(opt.state[k], v), k
    assert not torch.equal(model.decoder.fc.linear_0.weight, dec)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_other_optimizers_match_jax(name):
    _run(name, 4, (2,), encoder_lr=3e-3, decoder_lr=1e-2, weight_decay=0.01,
         max_grad_norm=1.0)


@pytest.mark.parametrize("kind", ["fixed", "warmup_constant",
                                  "warmup_linear"])
def test_lr_schedules_match_jax(kind):
    sched = optim.make_lr_schedule(kind, warmup_steps=4, total_steps=12)
    jsched = jax_optim.make_lr_schedule(kind, warmup_steps=4, total_steps=12)
    for step in range(0, 15):
        assert sched(step) == pytest.approx(
            float(jsched(jnp.asarray(step))), rel=1e-6, abs=1e-7), step


def test_schedule_is_shifted_by_one_step():
    """The first update applies multiplier(1), as the reference steps its
    scheduler before its optimizer."""
    model = _model()
    opt = optim.build_train_optimizer(
        model, optim="sgd", encoder_lr=1.0, decoder_lr=1.0, weight_decay=0.0,
        max_grad_norm=0.0, lr_schedule="warmup_constant", warmup_steps=4)
    params, stats = to_flax_variables(model)
    w = model.decoder.fc.linear_0.bias.detach().clone()
    _set_grads(model, _tree_map(np.ones_like, params), stats)
    opt.step(True)
    torch.testing.assert_close(model.decoder.fc.linear_0.bias, w - 0.25)


@pytest.mark.parametrize("which", ["no_decay", "encoder"])
def test_masks_match_jax(which):
    model = _model()
    names = [n for n, _ in model.named_parameters()]
    mask = (optim.no_decay_mask if which == "no_decay"
            else optim.encoder_mask)(names)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.fill_(1.0 if mask[n] else 0.0)
    got = to_flax_variables(model)[0]
    jmask = (jax_optim.no_decay_mask if which == "no_decay"
             else jax_optim.encoder_mask)(got)
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(jmask)[0]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert bool(g.reshape(-1)[0]) == bool(w), jax_optim.path_str(path)
    assert mask["decoder.fc.layernorm_0.weight"] is False \
        or which == "encoder"
    assert mask["decoder.out_bn.scale"] is True or which == "encoder"


@pytest.mark.parametrize("name", ["radam", "adamw", "adam", "sgd"])
def test_weight_decay_on_decayed_and_undecayed_tensors_matches_jax(name):
    model, opt, start, _ = _run(name, 8, (), encoder_lr=3e-3,
                                decoder_lr=1e-2, weight_decay=0.5,
                                max_grad_norm=1.0)
    assert {True, False} <= set(opt.decays.values())
    for group in ("encoder", "decoder"):
        assert {opt.decays[n] for n in opt.groups[group]} == {True, False}


@pytest.mark.parametrize("name", ["radam", "adamw", "adam", "sgd"])
def test_frozen_then_unfrozen_matches_jax(name):
    """The CLI's schedule: the encoder frozen for the first steps (its
    count stays at 0), then trained with the decoder."""
    _, opt, _, _ = _run(name, 10, (0, 1, 2, 3), encoder_lr=3e-3,
                        decoder_lr=1e-2, weight_decay=0.01,
                        max_grad_norm=1.0)
    assert int(opt.state["encoder.count"]) == 6
    assert int(opt.state["decoder.count"]) == 10


@pytest.mark.parametrize("name", ["radam", "adamw", "sgd"])
def test_checkpoint_round_trip_mid_run_matches_jax(name, tmp_path):
    """Saved after 7 steps (the encoder frozen for 2 of them, RAdam just
    past its rectification switch) and restored into a new model and
    optimizer, the run goes on as the JAX optimizer's unbroken one."""
    _, opt, _, _ = _run(name, 12, (3, 4), restore_at=7, tmp_path=tmp_path,
                        encoder_lr=3e-3, decoder_lr=1e-2, weight_decay=0.01,
                        max_grad_norm=1.0)
    assert int(opt.state["step"]) == 12
    assert int(opt.state["encoder.count"]) == 10


@torch.no_grad()
def _per_tensor_step(opt, encoder_trainable=True):
    """The update one tensor at a time, as TrainOptimizer.step ran before
    its multi-tensor passes: the plain version they are held against."""
    active = [g for g in ("encoder", "decoder")
              if g == "decoder" or encoder_trainable]
    grads = {}
    for g in active:
        for n in opt.groups[g]:
            p = opt.params[n]
            grads[n] = torch.zeros_like(p) if p.grad is None \
                else p.grad.float()
    if opt.max_grad_norm and opt.max_grad_norm > 0 and grads:
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()]))
        scale = torch.clamp_max(opt.max_grad_norm / (gnorm + 1e-6), 1.0)
        grads = {n: g * scale for n, g in grads.items()}
    for g in active:
        count = opt.state[f"{g}.count"]
        count += 1
        t = int(count)
        lr = opt.lr[g] * opt.sched(t)
        for n in opt.groups[g]:
            p, grad = opt.params[n], grads[n]
            if opt.optim == "sgd":
                d = grad
            else:
                mu, nu = (opt.state[f"{g}.{m}.{n}"] for m in ("mu", "nu"))
                mu.mul_(optim.B1).add_(grad, alpha=1.0 - optim.B1)
                nu.mul_(optim.B2).addcmul_(grad, grad, value=1.0 - optim.B2)
                if opt.optim == "radam":
                    use_rect, rect_step, sgd_step = optim._radam_scalars(t)
                    d = mu / (nu.sqrt() + opt.eps) * rect_step if use_rect \
                        else mu * sgd_step
                else:
                    mu_hat = mu / (1.0 - optim.B1 ** t)
                    nu_hat = nu / (1.0 - optim.B2 ** t)
                    d = mu_hat / (nu_hat.sqrt() + opt.eps)
            if opt.weight_decay and opt.decays[n]:
                d = d + opt.weight_decay * p
            p.add_(d.to(p.dtype), alpha=-lr)
    opt.state["step"] += 1


@pytest.mark.parametrize("bf16_param", [False, True])
@pytest.mark.parametrize("name", ["radam", "adamw", "adam", "sgd"])
def test_multi_tensor_step_equals_the_per_tensor_loop(name, bf16_param):
    """Bit for bit on the CPU, over 9 steps (RAdam crosses its switch at
    step 6) with the encoder frozen for two, one gradient left None and,
    in one case, a bfloat16 parameter among the float32 ones; parameters
    of about 1e-3, so that an update's last bits show in them. The step
    leaves `.grad` as it was."""
    models = [_model(), _model()]
    with torch.no_grad():      # updates near |p|, so no rounding hides
        for m in models:
            for p in m.parameters():
                p.mul_(1e-3)
    if bf16_param:
        for m in models:
            m.encoder.pooler.weight.data = \
                m.encoder.pooler.weight.data.to(torch.bfloat16)
    kw = dict(optim=name, encoder_lr=3e-3, decoder_lr=1e-2,
              weight_decay=0.1, max_grad_norm=1.0)
    opts = [optim.build_train_optimizer(
        m, frozen=optim.entity_table_names(m), **kw) for m in models]
    rng = np.random.default_rng(3)
    for step in range(9):
        size = 3.0 if step % 2 == 0 else 0.02
        grads = {n: rng.standard_normal(p.shape) * size
                 for n, p in models[0].named_parameters()}
        for m in models:
            for n, p in m.named_parameters():
                p.grad = None if n == "decoder.out_bn.bias" and step == 4 \
                    else torch.tensor(grads[n], dtype=p.dtype)
        seen = {n: None if p.grad is None else p.grad.clone()
                for n, p in models[0].named_parameters()}
        trainable = step not in (2, 3)
        opts[0].step(trainable)
        _per_tensor_step(opts[1], trainable)
        for (n, a), (_, b) in zip(models[0].named_parameters(),
                                  models[1].named_parameters()):
            assert a.dtype == b.dtype and torch.equal(a, b), (step, n)
            assert (a.grad is None and seen[n] is None) or torch.equal(
                a.grad, seen[n]), (step, n)
        assert set(opts[0].state) == set(opts[1].state)
        for k, v in opts[0].state.items():
            assert torch.equal(v, opts[1].state[k]), (step, k)
