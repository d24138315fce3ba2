"""The port's data layer against the JAX package's (CPU, exact).

Graph loading (`load_graph_pk`, its .npz cache read across packages and
refused at another max_node_num), edge
packing (`batch_edge_lists`, `pick_edge_bucket`; both sides run their C++
packers here, tests/test_torch_native.py holds them against the numpy
versions), statement tokenization (the fast-tokenizer path, the manual
pair assembly for the bert, roberta and xlnet layouts, and the GPT and LSTM
layouts) and whole
loader batches (train with the last batch filled, dev and test padded, the
in-house split, subsampling): every array, dtype, qid and the shuffle order
must be equal. Two datasets: `write_synthetic_dataset`'s, and one written
here with 3 choices and graphs of up to 230 concepts (pruned to 200 nodes)
with more than 4096 edges each.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from qagnn_tpu.data import graphs as jax_graphs
from qagnn_tpu.data import statements as jax_statements
from qagnn_tpu.data.loader import QAGNNDataLoader as JaxLoader
from qagnn_tpu.graph import batching as jax_batching

import chip_smoke
from qagnn_tpu_torch.data import graphs, statements
from qagnn_tpu_torch.data.loader import QAGNNDataLoader
from qagnn_tpu_torch.data.synthetic import VOCAB, write_synthetic_dataset
from qagnn_tpu_torch.graph import batching

GRAPH_FIELDS = ("concept_ids", "node_types", "node_scores", "num_nodes",
                "edge_src", "edge_dst", "edge_type", "edge_mask")
WORDS = VOCAB[5:]


def _write_big_dataset(root, n_questions=(7, 5, 3), n_choices=3, seed=3):
    """Reference-format splits with long stems and 200-node graphs: 17
    relations in the (17 n, n) adjacency layout, 2,100-2,600 stored edges
    (> 4096 after the context edges and inverses), some graphs with more
    concepts than max_node_num."""
    rng = np.random.default_rng(seed)
    os.makedirs(f"{root}/statement", exist_ok=True)
    os.makedirs(f"{root}/graph", exist_ok=True)
    for split, n in zip(("train", "dev", "test"), n_questions):
        with open(f"{root}/statement/{split}.statement.jsonl", "w") as f:
            for i in range(n):
                stem = " ".join(rng.choice(WORDS, int(rng.integers(3, 14))))
                choices = [{"label": "ABC"[j], "text": " ".join(
                    rng.choice(WORDS, int(rng.integers(1, 6))))}
                    for j in range(n_choices)]
                d = {"id": f"{split}-{i}", "answerKey": "ABC"[i % n_choices],
                     "question": {"stem": stem, "choices": choices}}
                if i % 3 == 1:
                    d["fact1"] = "the cat sat"
                f.write(json.dumps(d) + "\n")
        rows = []
        for _ in range(n * n_choices):
            nn_ = int(rng.integers(150, 231))
            concepts = rng.choice(5000, nn_, replace=False).astype(np.int64)
            qm = rng.random(nn_) < 0.05
            am = rng.random(nn_) < 0.05
            nnz = int(rng.integers(2100, 2600))
            flat = rng.choice(17 * nn_ * nn_, nnz, replace=False)
            adj = sp.coo_matrix(
                (np.ones(nnz, bool), (flat // nn_, flat % nn_)),
                shape=(17 * nn_, nn_))
            cid2score = {int(c): float(rng.standard_normal())
                         for c in concepts}
            cid2score[-1] = 0.0
            rows.append({"adj": adj, "concepts": concepts, "qmask": qm,
                         "amask": am, "cid2score": cid2score})
        with open(f"{root}/graph/{split}.graph.adj.pk", "wb") as f:
            pickle.dump(rows, f)
    with open(f"{root}/inhouse.txt", "w") as f:
        f.write("\n".join(f"train-{i}" for i in (0, 2, 3, 6)) + "\n")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_synthetic_dataset(str(root / "small"), n_questions=5)
    _write_big_dataset(str(root / "big"))
    with open(root / "small" / "inhouse.txt", "w") as f:
        f.write("train-1\ntrain-4\n")
    return {"small": str(root / "small"), "big": str(root / "big")}


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    from transformers import BertTokenizerFast
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB))
    return BertTokenizerFast(vocab_file=str(path), do_lower_case=True)


def _assert_same(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} vs {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=what)


def _assert_graph_data_equal(got, want):
    for name in ("concept_ids", "node_types", "node_scores", "num_nodes"):
        _assert_same(getattr(got, name), getattr(want, name), name)
    assert got.n_relations == want.n_relations
    assert len(got.edge_indices) == len(want.edge_indices)
    for a, b, c, d in zip(got.edge_indices, want.edge_indices,
                          got.edge_types, want.edge_types):
        _assert_same(a, b, "edge_indices")
        _assert_same(c, d, "edge_types")


@pytest.mark.parametrize("name", ["small", "big"])
@pytest.mark.parametrize("split", ["train", "dev"])
def test_load_graph_pk_matches_jax(datasets, name, split):
    path = f"{datasets[name]}/graph/{split}.graph.adj.pk"
    got = graphs.load_graph_pk(path, 200, use_cache=False)
    want = jax_graphs.load_graph_pk(path, 200, use_cache=False)
    _assert_graph_data_equal(got, want)
    if name == "big":
        assert max(e.shape[1] for e in got.edge_indices) > 4096
        assert max(got.num_nodes) == 200 and got.n_relations == 38


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_cache_reads_across_packages(datasets, tmp_path, writer):
    path = str(tmp_path / "train.graph.adj.pk")
    shutil.copy(f"{datasets['big']}/graph/train.graph.adj.pk", path)
    write, read = (jax_graphs, graphs) if writer == "jax" \
        else (graphs, jax_graphs)
    fresh = write.load_graph_pk(path, 200)
    assert os.path.exists(path + ".tpu_cache.npz")
    os.remove(path)                    # only the cache is left to read
    _assert_graph_data_equal(read.load_graph_pk(path, 200), fresh)


def test_graph_cache_of_another_max_node_num_raises(datasets, tmp_path):
    """The cache's file name does not hold max_node_num: a cache written at
    N = 200 and read at N = 8 raises, naming the file, instead of handing
    back 200-node graphs; without the cache N = 8 reads as it should."""
    path = str(tmp_path / "train.graph.adj.pk")
    shutil.copy(f"{datasets['big']}/graph/train.graph.adj.pk", path)
    assert graphs.load_graph_pk(path, 200).concept_ids.shape[1] == 200
    with pytest.raises(ValueError, match=r"train\.graph\.adj\.pk\.tpu_cache"
                       r"\.npz holds graphs of 200 nodes, not max_node_num=8"):
        graphs.load_graph_pk(path, 8)
    small = graphs.load_graph_pk(path, 8, use_cache=False)
    assert small.concept_ids.shape[1] == 8
    assert graphs.load_graph_pk(path, 200).concept_ids.shape[1] == 200


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 4096, 4097, 16384, 20000])
def test_pick_edge_bucket_matches_jax(n):
    assert batching.EDGE_BUCKETS == jax_batching.EDGE_BUCKETS
    assert batching.pick_edge_bucket(n) == jax_batching.pick_edge_bucket(n)


@pytest.mark.parametrize("budget", [None, 4096, 1000])
def test_batch_edge_lists_matches_jax(datasets, budget):
    gd = graphs.load_graph_pk(f"{datasets['big']}/graph/train.graph.adj.pk",
                              200, use_cache=False)
    args = (gd.edge_indices, gd.edge_types, gd.concept_ids, gd.node_types,
            gd.node_scores, gd.num_nodes)
    if budget is None:
        got = batching.batch_edge_lists(*args)
        want = jax_batching.batch_edge_lists(*args)
        assert got.edge_src.shape[1] == 8192
    else:   # truncating budgets warn on both sides, with one message
        with pytest.warns(UserWarning, match="truncates") as w_got:
            got = batching.batch_edge_lists(*args, edges_per_graph=budget)
        with pytest.warns(UserWarning, match="truncates") as w_want:
            want = jax_batching.batch_edge_lists(*args,
                                                 edges_per_graph=budget)
        assert str(w_got[0].message) == str(w_want[0].message)
    for name in GRAPH_FIELDS:
        _assert_same(getattr(got, name), getattr(want, name), name)


def _loaders(root, tokenizer, **kw):
    paths = dict(
        train_statements=f"{root}/statement/train.statement.jsonl",
        train_adj=f"{root}/graph/train.graph.adj.pk",
        dev_statements=f"{root}/statement/dev.statement.jsonl",
        dev_adj=f"{root}/graph/dev.graph.adj.pk",
        test_statements=f"{root}/statement/test.statement.jsonl",
        test_adj=f"{root}/graph/test.graph.adj.pk",
        model_name="bert-base-uncased", max_seq_len=20, tokenizer=tokenizer)
    if kw.pop("inhouse", False):
        kw.update(is_inhouse=True,
                  inhouse_train_qids_path=f"{root}/inhouse.txt")
    return QAGNNDataLoader(**paths, **kw), JaxLoader(**paths, **kw)


def _assert_batches_equal(got, want, what):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0, what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], f"{what} {i}: qids"
        assert g[2:] == w[2:], f"{what} {i}: pad"
        gb, wb = g[1], w[1]
        assert sorted(gb.lm_inputs) == sorted(wb.lm_inputs)
        for k in wb.lm_inputs:
            _assert_same(gb.lm_inputs[k], wb.lm_inputs[k], f"{what} {i} {k}")
        for name in GRAPH_FIELDS:
            _assert_same(getattr(gb.graph, name), getattr(wb.graph, name),
                         f"{what} {i} {name}")
        _assert_same(gb.labels, wb.labels, f"{what} {i} labels")


@pytest.mark.parametrize("name,kw", [
    ("small", dict(batch_size=2, eval_batch_size=3)),
    ("small", dict(batch_size=4, eval_batch_size=2, inhouse=True)),
    ("big", dict(batch_size=3, eval_batch_size=2, seed=5)),
    ("big", dict(batch_size=2, eval_batch_size=4, inhouse=True,
                 subsample=0.5, seed=1)),
])
def test_loader_batches_match_jax(datasets, tokenizer, name, kw):
    port, jax_ = _loaders(datasets[name], tokenizer, **kw)
    assert (port.train_size(), port.dev_size(), port.test_size()) == \
        (jax_.train_size(), jax_.dev_size(), jax_.test_size())
    for epoch in range(2):   # the generator carries over between epochs
        _assert_batches_equal(port.train(), jax_.train(), f"train {epoch}")
    _assert_batches_equal(port.dev(), jax_.dev(), "dev")
    _assert_batches_equal(port.test(), jax_.test(), "test")


def test_pin_memory_pins_every_tensor_of_a_batch(datasets, tokenizer,
                                                 monkeypatch):
    """With pin_memory (the CLI sets it for a CUDA target) every tensor
    of a batch is copied into page-locked memory; without it none is. This
    host has no CUDA runtime to pin with, so the copy is recorded."""
    pinned = []

    def pin(t):
        pinned.append(t)
        return t.clone()
    monkeypatch.setattr(torch.Tensor, "pin_memory", pin)
    for flag in (False, True):
        root = datasets["small"]
        port = QAGNNDataLoader(
            train_statements=f"{root}/statement/train.statement.jsonl",
            train_adj=f"{root}/graph/train.graph.adj.pk",
            dev_statements=f"{root}/statement/dev.statement.jsonl",
            dev_adj=f"{root}/graph/dev.graph.adj.pk",
            model_name="bert-base-uncased", max_seq_len=16, batch_size=2,
            tokenizer=tokenizer, pin_memory=flag)
        pinned.clear()
        _, batch = next(port.train())
        _, dev_batch, _ = next(port.dev())
        tensors = [*batch.lm_inputs.values(), batch.labels,
                   *(getattr(batch.graph, f) for f in GRAPH_FIELDS)]
        assert len(pinned) == (2 * len(tensors) if flag else 0)
        assert all(t.device.type == "cpu" for t in tensors)


@pytest.mark.parametrize("name", ["small", "big"])
@pytest.mark.parametrize("model_name,max_len", [("bert-base-uncased", 12),
                                                ("roberta-large", 24)])
def test_load_statements_fast_path_matches_jax(datasets, tokenizer, name,
                                               model_name, max_len):
    path = f"{datasets[name]}/statement/train.statement.jsonl"
    got = statements.load_statements(path, model_name, max_len, tokenizer)
    want = jax_statements.load_statements(path, model_name, max_len,
                                          tokenizer)
    assert got.qids == want.qids and got.n_choices == want.n_choices
    _assert_same(got.labels, want.labels, "labels")
    assert sorted(got.inputs) == sorted(want.inputs)
    for k in want.inputs:
        _assert_same(got.inputs[k], want.inputs[k], k)


@pytest.mark.parametrize("layout", ["bert", "roberta", "xlnet"])
@pytest.mark.parametrize("max_len", [10, 32])
def test_load_pair_statements_matches_jax(datasets, tokenizer, layout,
                                          max_len):
    path = f"{datasets['big']}/statement/dev.statement.jsonl"
    got = statements.load_pair_statements(path, layout, max_len, tokenizer)
    want = jax_statements.load_pair_statements(path, layout, max_len,
                                               tokenizer)
    assert got.qids == want.qids
    for k in want.inputs:
        _assert_same(got.inputs[k], want.inputs[k], f"{layout} {k}")


def test_slow_tokenizer_takes_the_manual_path(datasets, tmp_path):
    """A tokenizer that is not a fast HF tokenizer goes through
    load_pair_statements, in the layout of the model's family."""
    from transformers import BertTokenizer
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB))
    slow = BertTokenizer(vocab_file=str(vocab), do_lower_case=True)
    path = f"{datasets['small']}/statement/train.statement.jsonl"
    got = statements.load_statements(path, "roberta-large", 16, slow)
    want = jax_statements.load_pair_statements(path, "roberta", 16, slow)
    for k in want.inputs:
        _assert_same(got.inputs[k], want.inputs[k], k)


def _layout_tokenizers(model_name, datasets, tmp_path):
    """(port's, JAX package's) tokenizers of a layout: fresh fast BERT
    tokenizers over the synthetic vocabulary for openai-gpt (the GPT layout
    adds its special tokens to each), each package's WordTokenizer over a
    vocabulary `make_word_vocab` wrote from both datasets for lstm."""
    if model_name == "openai-gpt":
        from transformers import BertTokenizerFast
        path = tmp_path / "vocab.txt"
        path.write_text("\n".join(VOCAB))
        return tuple(BertTokenizerFast(vocab_file=str(path),
                                       do_lower_case=True) for _ in "pj")
    from qagnn_tpu.data.word_tokenizer import WordTokenizer as JaxWords

    from qagnn_tpu_torch.data.word_tokenizer import (
        WordTokenizer,
        make_word_vocab,
    )
    path = str(tmp_path / "words.json")
    make_word_vocab([f"{datasets[n]}/statement/{s}.statement.jsonl"
                     for n in ("small", "big") for s in ("train", "dev")],
                    path, freq_cutoff=2)
    return WordTokenizer(path), JaxWords(path)


@pytest.mark.parametrize("model_name", ["openai-gpt", "lstm"])
def test_gpt_and_lstm_layouts_match_jax(datasets, tmp_path, model_name):
    """load_statements in the GPT layout (special tokens, cls positions,
    lm labels, the question cut in place across choices) and in the LSTM's
    (word ids, lengths) equals the JAX package's arrays exactly, also cut
    short; so do whole loader batches."""
    port_tok, jax_tok = _layout_tokenizers(model_name, datasets, tmp_path)
    for name in ("small", "big"):
        path = f"{datasets[name]}/statement/train.statement.jsonl"
        for max_len in (9, 32):
            got = statements.load_statements(path, model_name, max_len,
                                             port_tok)
            want = jax_statements.load_statements(path, model_name, max_len,
                                                  jax_tok)
            assert got.qids == want.qids and got.n_choices == want.n_choices
            _assert_same(got.labels, want.labels, "labels")
            assert sorted(got.inputs) == sorted(want.inputs)
            for k in want.inputs:
                _assert_same(got.inputs[k], want.inputs[k],
                             f"{name} {max_len} {k}")
    root = datasets["big"]
    paths = {f"{s}_{kind}": f"{root}/{d}/{s}.{ext}"
             for s in ("train", "dev", "test")
             for kind, d, ext in (("statements", "statement",
                                   "statement.jsonl"),
                                  ("adj", "graph", "graph.adj.pk"))}
    kw = dict(paths, model_name=model_name, max_seq_len=20, batch_size=3,
              eval_batch_size=2, seed=4)
    port = QAGNNDataLoader(**kw, tokenizer=port_tok)
    jax_ = JaxLoader(**kw, tokenizer=jax_tok)
    _assert_batches_equal(port.train(), jax_.train(), "train")
    _assert_batches_equal(port.dev(), jax_.dev(), "dev")


@pytest.mark.parametrize("layout", ["bert", "roberta"])
def test_chip_smoke_word_tokenizer_matches_bert(datasets, tokenizer, layout):
    """chip_smoke.py's word-level tokenizer gives the ids of
    BertTokenizerFast over the same vocabulary through the manual path."""
    words = chip_smoke.WordTokenizer(VOCAB, cls_token="[CLS]",
                                     sep_token="[SEP]", unk_token="[UNK]")
    for name in ("small", "big"):
        path = f"{datasets[name]}/statement/train.statement.jsonl"
        got = statements.load_pair_statements(path, layout, 24, words)
        want = statements.load_pair_statements(path, layout, 24, tokenizer)
        for k in want.inputs:
            _assert_same(got.inputs[k], want.inputs[k], f"{name} {k}")
