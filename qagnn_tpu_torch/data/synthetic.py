"""Synthetic reference-format dataset + checkpoint generators.

A copy of qagnn_tpu/data/synthetic.py. It writes the on-disk layout the
reference's preprocessing produces (`statement/*.statement.jsonl` +
`graph/*.graph.adj.pk` rows of {adj, concepts, qmask, amask, cid2score},
reference utils/data_utils.py:79, utils/graph.py:114-129) and a tiny
HF-format BERT checkpoint directory, so the CLI (tokenization, graph
loading, pretrained-encoder loading, training) runs on small local files.
The checkpoint writer draws the weights with torch as HF's BertModel
initialises them and writes config.json itself (no `transformers` model
class); its tokenizer files need `transformers`' BertTokenizerFast.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "a", "cat", "dog", "sat", "on", "mat", "ran", "fast",
         "what", "did", "do", "?", "animal", "says", "meow", "woof"]

SUBJECTS = ["cat", "dog", "animal", "mat"]


def write_synthetic_dataset(root, n_questions=4, n_choices=2, n_concept=50,
                            dev_equals_train=False):
    """Synthetic dataset; stems are distinguishable per question so a model
    CAN overfit. dev_equals_train makes dev a copy of train (used by the
    overfit test: train-set memorization shows up as dev_acc == 1).
    Returns the entity-embedding .npy path."""
    import scipy.sparse as sp
    rng = np.random.default_rng(0)
    os.makedirs(f"{root}/statement", exist_ok=True)
    os.makedirs(f"{root}/graph", exist_ok=True)

    train_lines = None
    for split, n in [("train", n_questions), ("dev", 2), ("test", 2)]:
        lines = []
        if dev_equals_train and split == "dev" and train_lines:
            lines = [json.loads(l) for l in train_lines]
            for i, d in enumerate(lines):
                d["id"] = f"dev-{i}"
        else:
            for i in range(n):
                subj = SUBJECTS[i % len(SUBJECTS)]
                d = {"id": f"{split}-{i}",
                     "answerKey": "AB"[int(rng.integers(0, n_choices))],
                     "question": {
                         "stem": f"what did the {subj} do ?",
                         "choices": [{"label": "A", "text": "sat on the mat"},
                                     {"label": "B", "text": "ran fast"}]}}
                lines.append(d)
        with open(f"{root}/statement/{split}.statement.jsonl", "w") as f:
            serialized = [json.dumps(d) + "\n" for d in lines]
            f.writelines(serialized)
            if split == "train":
                train_lines = serialized
        if dev_equals_train and split == "dev":
            # graphs must also match train's for memorization to transfer
            import shutil
            shutil.copy(f"{root}/graph/train.graph.adj.pk",
                        f"{root}/graph/dev.graph.adj.pk")
            continue
        rows = []
        for _ in range(len(lines) * n_choices):
            nn_ = int(rng.integers(2, 6))
            concepts = rng.choice(n_concept - 1, nn_,
                                  replace=False).astype(np.int64)
            qm = np.zeros(nn_, bool)
            qm[0] = True
            am = np.zeros(nn_, bool)
            if nn_ > 1:
                am[1] = True
            dense = rng.random((3 * nn_, nn_)) < 0.4
            cid2score = {int(c): float(rng.standard_normal())
                         for c in concepts}
            cid2score[-1] = 0.0
            rows.append({"adj": sp.coo_matrix(dense), "concepts": concepts,
                         "qmask": qm, "amask": am, "cid2score": cid2score})
        with open(f"{root}/graph/{split}.graph.adj.pk", "wb") as f:
            pickle.dump(rows, f)

    emb_path = f"{root}/ent_emb.npy"
    np.save(emb_path, rng.standard_normal((n_concept, 24)).astype(np.float32))
    return emb_path


def write_tiny_bert_checkpoint(out_dir, hidden_size=32, num_layers=2,
                               num_heads=2, seed=0):
    """A real HF save_pretrained-style directory (config.json +
    pytorch_model.bin under BertModel's key names + vocab) for a tiny
    randomly-initialized BERT — a stand-in for the blocked roberta-large
    download so --encoder_load paths execute in CI. The weights follow HF's
    BertModel init (normal(0, 0.02) matrices and tables with the pad row
    zeroed, zero biases, unit LayerNorm scales), drawn from `seed`."""
    import torch
    from transformers import BertTokenizerFast

    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    d, ffn, n_pos = hidden_size, hidden_size * 4, 64
    sd = {}

    def normal(key, *shape):
        sd[key] = torch.randn(*shape, generator=gen) * 0.02

    def linear(key, n_out, n_in):
        normal(key + ".weight", n_out, n_in)
        sd[key + ".bias"] = torch.zeros(n_out)

    def layer_norm(key):
        sd[key + ".weight"], sd[key + ".bias"] = torch.ones(d), torch.zeros(d)

    normal("embeddings.word_embeddings.weight", len(VOCAB), d)
    sd["embeddings.word_embeddings.weight"][0] = 0.0     # [PAD]
    normal("embeddings.position_embeddings.weight", n_pos, d)
    normal("embeddings.token_type_embeddings.weight", 2, d)
    layer_norm("embeddings.LayerNorm")
    for i in range(num_layers):
        h = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            linear(f"{h}.attention.self.{name}", d, d)
        linear(f"{h}.attention.output.dense", d, d)
        layer_norm(f"{h}.attention.output.LayerNorm")
        linear(f"{h}.intermediate.dense", ffn, d)
        linear(f"{h}.output.dense", d, ffn)
        layer_norm(f"{h}.output.LayerNorm")
    linear("pooler.dense", d, d)
    torch.save(sd, os.path.join(out_dir, "pytorch_model.bin"))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "model_type": "bert", "architectures": ["BertModel"],
            "vocab_size": len(VOCAB), "hidden_size": d,
            "num_hidden_layers": num_layers,
            "num_attention_heads": num_heads, "intermediate_size": ffn,
            "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
            "attention_probs_dropout_prob": 0.1,
            "max_position_embeddings": n_pos, "type_vocab_size": 2,
            "initializer_range": 0.02, "layer_norm_eps": 1e-12,
            "pad_token_id": 0}, f)
    vpath = os.path.join(out_dir, "vocab.txt")
    with open(vpath, "w") as f:
        f.write("\n".join(VOCAB))
    BertTokenizerFast(vocab_file=vpath,
                      do_lower_case=True).save_pretrained(out_dir)
    return out_dir
