"""The port's MaskedBatchNorm against the flax module (CPU).

Eval mode with non-trivial running statistics: one array, several parts,
the folded affine, and the bf16 folded normalize. Train mode: weighted
batch statistics, moment parts and the k-fold running-stat update.
f32 tolerance rtol/atol 1e-5 (same arithmetic); bf16 within 2 bf16 ulps
(rtol 1e-2), since the two frameworks may round the folded x * a + b at
different places.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qagnn_tpu.models.norm import MaskedBatchNorm as JaxBN, MomentPart as JMP

from qagnn_tpu_torch.models.norm import MaskedBatchNorm, MomentPart
from qagnn_tpu_torch.utils.convert import load_flax_variables

FEAT = 12
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the machine's cores: one intra-op thread keeps
    this file's torch ops from crowding out the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x1 = (rng.standard_normal((20, FEAT)) * 2 + 0.5).astype(np.float32)
    x2 = rng.standard_normal((7, FEAT)).astype(np.float32)
    w1 = (rng.random(20) > 0.3).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, FEAT).astype(np.float32),
              "bias": rng.standard_normal(FEAT).astype(np.float32)}
    stats = {"mean": rng.standard_normal(FEAT).astype(np.float32),
             "var": rng.uniform(0.3, 3.0, FEAT).astype(np.float32)}
    return x1, x2, w1, params, stats


def _pair(params, stats, num_updates=1):
    jbn = JaxBN(features=FEAT, num_updates=num_updates)
    bn = MaskedBatchNorm(FEAT, num_updates=num_updates)
    load_flax_variables(bn, params, stats)
    return jbn, {"params": params, "batch_stats": stats}, bn


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("form", ["single", "weighted", "multi", "affine"])
def test_eval_matches_flax(setup, form):
    x1, x2, w1, params, stats = setup
    jbn, v, bn = _pair(params, stats)
    bn.eval()
    with torch.no_grad():
        if form == "single":
            got = [bn(_t(x1))]
            want = [jbn.apply(v, jnp.asarray(x1), use_running_average=True)]
        elif form == "weighted":
            got = [bn(_t(x1), _t(w1))]
            want = [jbn.apply(v, jnp.asarray(x1), jnp.asarray(w1),
                              use_running_average=True)]
        elif form == "multi":
            got = bn([(_t(x1), _t(w1)), (_t(x2), None)])
            want = jbn.apply(v, [(jnp.asarray(x1), jnp.asarray(w1)),
                                 (jnp.asarray(x2), None)],
                             use_running_average=True)
        else:
            out, (a, b) = bn([(_t(x2), None)], return_affine=True)
            jout, (ja, jb) = jbn.apply(v, [(jnp.asarray(x2), None)],
                                       use_running_average=True,
                                       return_affine=True)
            got, want = out + [a, b], list(jout) + [ja, jb]
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


def test_eval_bf16_folded_normalize(setup):
    x1, _, _, params, stats = setup
    jbn, v, bn = _pair(params, stats)
    bn.eval()
    with torch.no_grad():
        got = bn(_t(x1).to(torch.bfloat16))
    want = jbn.apply(v, jnp.asarray(x1, jnp.bfloat16),
                     use_running_average=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("moments", [False, True])
def test_train_stats_and_running_update(setup, moments):
    x1, x2, w1, params, stats = setup
    jbn, v, bn = _pair(params, stats, num_updates=3)
    bn.train()
    if moments:
        s1 = (x1 * w1[:, None]).sum(0)
        s2 = (x1 ** 2 * w1[:, None]).sum(0)
        n = np.float32(w1.sum())
        got = bn([MomentPart(_t(s1), _t(s2), _t(n)), (_t(x2), None)])
        want, upd = jbn.apply(
            v, [JMP(jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(n)),
                (jnp.asarray(x2), None)],
            use_running_average=False, mutable=["batch_stats"])
    else:
        got = bn([(_t(x1), _t(w1)), (_t(x2), None)])
        want, upd = jbn.apply(v, [(jnp.asarray(x1), jnp.asarray(w1)),
                                  (jnp.asarray(x2), None)],
                              use_running_average=False,
                              mutable=["batch_stats"])
    for x, y in zip(got, want):
        if y is None:
            assert x is None
        else:
            np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                       rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bn.mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), **TOL)
    np.testing.assert_allclose(bn.var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-4, atol=1e-5)
