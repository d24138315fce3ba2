"""The port's GPT, XLNet, ALBERT and LSTM encoders against the JAX package's
(CPU).

Each family's tiny config (dropout 0), flax variables carried across by
utils/convert.py (strictly), on numpy-seeded inputs: the pooled output and
every hidden state, within 1e-5 of max|want| in f32 and 2e-2 in bf16 (the
LSTM computes in f32 whatever the dtype: its one-way and mean-pooled
variants instead). Also: the LSTM's reverse direction runs over each row's
own length, and LMQAGNN unpacks an encoder that returns (pooled, hidden
states).

The helpers here also serve tests/test_torch_encoders_model.py (each
family's whole LMQAGNN, train step and decay masks against the JAX
package's) and tests/test_torch_encoders_cli.py (`cli.train` against the
JAX CLI). The encoders' HF conversions are held against HF's models in
tests/test_torch_hf_loading.py.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qagnn_tpu.models import gpt_encoder as jax_gpt
from qagnn_tpu.models import lstm_encoder as jax_lstm
from qagnn_tpu.models import text_encoder as jax_text
from qagnn_tpu.models import xlnet_encoder as jax_xlnet
from qagnn_tpu.models.qagnn import LMQAGNN as JaxLMQAGNN

from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.models import gpt_encoder, lstm_encoder, text_encoder
from qagnn_tpu_torch.models import xlnet_encoder
from qagnn_tpu_torch.models.qagnn import LMQAGNN
from qagnn_tpu_torch.train.step import make_eval_step
from qagnn_tpu_torch.utils.convert import load_flax_variables

B, C, L, N, E = 2, 2, 12, 10, 20
G = B * C
K, D, N_NTYPE, N_ETYPE, N_CONCEPT, CIN, FC = 2, 16, 4, 7, 40, 24, 8
VOCAB = 97
ENC_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ALBERT = dict(vocab_size=VOCAB, hidden_size=32, num_layers=3, num_heads=2,
              intermediate_size=64, max_position_embeddings=L + 4,
              embedding_size=8, share_layers=True, hidden_act="gelu_new",
              raw_cls_pool=True, hidden_dropout=0.0, attention_dropout=0.0)
LSTM_VARIANTS = {"lstm": {}, "lstm-one-way": {"bidirectional": False},
                 "lstm-mean-3-layers": {"pool_function": "mean",
                                        "num_layers": 3}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the machine's cores: one intra-op thread keeps
    this file's torch ops from crowding out the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _flax_dropout_is_identity():
    """The flax pooler's dropout rate (0.1) is not a constructor argument
    of the flax model: dropout off on the JAX side while this module runs
    (the port's models are built with every rate 0)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    yield
    mp.undo()


def _encoders(family, dtype="float32"):
    """(flax module, port module) of `family`'s tiny config, dropout 0."""
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    if family == "gpt":
        drop = dict(embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)
        return (jax_gpt.GPTTextEncoder(jax_gpt.GPTConfig.tiny(
                    dtype=jdt, **drop)),
                gpt_encoder.GPTTextEncoder(gpt_encoder.GPTConfig.tiny(
                    dtype=pdt, **drop)))
    if family == "xlnet":
        return (jax_xlnet.XLNetTextEncoder(jax_xlnet.XLNetConfig.tiny(
                    dtype=jdt, dropout=0.0)),
                xlnet_encoder.XLNetTextEncoder(xlnet_encoder.XLNetConfig.tiny(
                    dtype=pdt, dropout=0.0)))
    if family == "albert":
        return (jax_text.TextEncoder(jax_text.TextEncoderConfig(
                    dtype=jdt, **ALBERT)),
                text_encoder.TextEncoder(text_encoder.TextEncoderConfig(
                    dtype=pdt, **ALBERT)))
    kw = LSTM_VARIANTS[family]
    return (jax_lstm.LSTMTextEncoder.from_config(
                jax_lstm.LSTMConfig.tiny(**kw)),
            lstm_encoder.LSTMTextEncoder.from_config(
                lstm_encoder.LSTMConfig.tiny(**kw)))


def _lm_inputs(family, shape, seed):
    """`family`'s statement-layout inputs of leading shape `shape`, as
    numpy int32 arrays: padding on the right (left for XLNet), the lengths
    drawn from [3, L]."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, L + 1, shape).astype(np.int32)
    pos = np.arange(L)
    if family.startswith("lstm"):
        ids = rng.integers(0, 64, shape + (L,)).astype(np.int32)
        return {"input_ids": ids, "lengths": lengths}
    ids = rng.integers(3, VOCAB, shape + (L,)).astype(np.int32)
    if family == "gpt":
        return {"input_ids": ids, "cls_token_ids": lengths - 1,
                "lm_labels": np.where(pos < lengths[..., None], ids, -1)
                .astype(np.int32)}
    if family == "xlnet":
        real = pos >= (L - lengths)[..., None]
        types = np.where(pos < L - lengths[..., None] // 2, 0, 1)
        types[..., -1] = 2
        return {"input_ids": np.where(real, ids, 0).astype(np.int32),
                "attention_mask": real.astype(np.int32),
                "token_type_ids": np.where(real, types, 4).astype(np.int32),
                "special_tokens_mask": (~real).astype(np.int32)}
    real = pos < lengths[..., None]
    return {"input_ids": np.where(real, ids, 0).astype(np.int32),
            "attention_mask": real.astype(np.int32),
            "token_type_ids": np.zeros(shape + (L,), np.int32)}


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    ref = float(np.abs(want).max())
    assert err <= tol * ref, f"{what}: max|d| {err:.3e} of max|want| {ref:.3e}"


# the LSTM computes in f32 whatever the dtype: its variants instead
ENCODER_CASES = [(f, dt) for f in ("gpt", "xlnet", "albert")
                 for dt in ("float32", "bfloat16")] \
    + [(v, "float32") for v in LSTM_VARIANTS]


@pytest.mark.parametrize("family,dtype", ENCODER_CASES)
def test_encoder_matches_flax(family, dtype):
    jenc, enc = _encoders(family, dtype)
    lm = _lm_inputs(family, (5,), seed=1)
    lm.pop("lm_labels", None)
    jlm = {k: jnp.asarray(v) for k, v in lm.items()}
    params = jax.tree.map(np.asarray, jax.jit(
        lambda lm: jenc.init(jax.random.PRNGKey(0), **lm))(jlm)["params"])
    load_flax_variables(enc, params)
    tol = ENC_TOL[dtype]
    for layer in (-1, 1):
        want, want_hidden = jax.jit(lambda p, lm: jenc.apply(
            {"params": p}, **lm, layer_id=layer, return_all_hidden=True))(
            params, jlm)
        with torch.no_grad():
            got, hidden = enc.eval()(
                **{k: torch.from_numpy(v) for k, v in lm.items()},
                layer_id=layer, return_all_hidden=True)
        _assert_close(got.float(), want, tol, f"pooled, layer {layer}")
        assert len(hidden) == len(want_hidden)
        for i, (g, w) in enumerate(zip(hidden, want_hidden)):
            _assert_close(g.float(), w, tol, f"hidden state {i}")
    if family.startswith("lstm"):
        # the pooled vector alone, whatever `layer_id` says
        with torch.no_grad():
            alone = enc(**{k: torch.from_numpy(v) for k, v in lm.items()},
                        layer_id=1)
        assert torch.equal(alone, got)


def test_lstm_reverse_direction_runs_over_each_rows_length():
    """A row's outputs depend on its real tokens alone: the same tokens with
    other padding behind them give the same hidden states, in both
    directions."""
    _, enc = _encoders("lstm")
    torch.manual_seed(0)
    for p in enc.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3)
    ids = torch.randint(0, 64, (2, L))
    ids[1, :5] = ids[0, :5]
    lengths = torch.tensor([5, 5])
    with torch.no_grad():
        _, hidden = enc.eval()(ids, lengths, return_all_hidden=True)
        one, hidden_one = enc(ids[:1, :5], lengths[:1],
                              return_all_hidden=True)
    for h, h1 in zip(hidden[1:], hidden_one[1:]):
        torch.testing.assert_close(h[0], h[1])
        torch.testing.assert_close(h[0, :5], h1[0])
        assert (h[:, 5:] == 0).all()


def _graph(seed):
    rng = np.random.default_rng(seed)
    num_nodes = rng.integers(4, N + 1, G).astype(np.int32)
    concept_ids = rng.integers(1, N_CONCEPT, (G, N)).astype(np.int32)
    concept_ids[:, 0] = 0
    node_types = rng.integers(0, 3, (G, N)).astype(np.int32)
    node_types[:, 0] = 3
    mask = rng.random((G, E)) > 0.3
    mask[1] = False                    # a graph with every edge masked
    return dict(
        concept_ids=concept_ids, node_types=node_types,
        node_scores=rng.standard_normal((G, N)).astype(np.float32),
        num_nodes=num_nodes,
        edge_src=np.stack([rng.integers(0, n, E) for n in num_nodes])
        .astype(np.int32),
        edge_dst=np.stack([rng.integers(0, n, E) for n in num_nodes])
        .astype(np.int32),
        edge_type=rng.integers(0, N_ETYPE, (G, E)).astype(np.int32),
        edge_mask=mask)


def _port_inputs(lm, graph):
    return ({k: torch.from_numpy(v) for k, v in lm.items()},
            BatchedGraphs(**{k: torch.from_numpy(v)
                             for k, v in graph.items()}))


def _models(family):
    jenc, enc = _encoders(family)
    sent = 16 if family.startswith("lstm") else 32
    common = dict(sent_dim=sent, k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE,
                  n_concept=N_CONCEPT, concept_dim=D, concept_in_dim=CIN,
                  n_attention_head=2, fc_dim=FC, n_fc_layer=1, p_emb=0.0,
                  p_gnn=0.0, p_fc=0.0)
    model = LMQAGNN(enc, gnn_backend="cuda", **common)
    model.decoder.pooler.dropout = 0.0
    model.decoder.pooler.attention.attn_dropout = 0.0
    return JaxLMQAGNN(encoder=jenc, gnn_backend="scatter", **common), model


def test_encoder_returning_a_tuple_is_unpacked():
    """LMQAGNN takes the pooled vector of an encoder that returns
    (pooled, hidden states), as the JAX LMQAGNN does: the LSTM's logits
    are the same either way."""
    from qagnn_tpu_torch.utils.initialization import init_weights
    _, model = _models("lstm")
    init_weights(model, torch.Generator().manual_seed(0))
    lm, graph = _port_inputs(_lm_inputs("lstm", (B, C), 0), _graph(0))
    step = make_eval_step(model, device="cpu")
    want = step(lm, graph)
    forward = model.encoder.forward
    model.encoder.forward = lambda *a, **k: forward(
        *a, return_all_hidden=True, **k)
    try:
        got = step(lm, graph)
    finally:
        del model.encoder.forward
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
