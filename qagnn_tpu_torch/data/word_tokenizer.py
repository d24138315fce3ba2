"""Word-level tokenizer and vocabulary for the LSTM encoder family.

Counterpart of qagnn_tpu/data/word_tokenizer.py (reference
utils/tokenization_utils.py:15-226, WordTokenizer / WordVocab /
make_word_vocab). spaCy's rule tokenizer is replaced, as the JAX package
replaces it, by a lower-casing regular expression over words and numbers
(`_base_tokenize`, a copy of qagnn_tpu/preprocess/lemma.py `tokenize`).
The LSTM statement layout that reads it is data/statements.py
`load_lstm_statements`.
"""

from __future__ import annotations

import json
import os
import re


def _base_tokenize(text: str) -> list[str]:
    """Lower-cased words (with an optional 's-style suffix) and digit runs,
    as qagnn_tpu/preprocess/lemma.py `tokenize` splits them."""
    return re.findall(r"[a-zA-Z]+(?:'[a-z]+)?|[0-9]+", text.lower())


EOS_TOK = "<EOS>"
UNK_TOK = "<UNK>"
PAD_TOK = "<PAD>"
SEP_TOK = "<SEP>"
EXTRA_TOKS = [EOS_TOK, UNK_TOK, PAD_TOK, SEP_TOK]


def tokenize_sentence(text: str, lower_case: bool = True,
                      convert_num: bool = False) -> list[str]:
    """reference tokenize_sentence_spacy (tokenization_utils.py:170-176)."""
    tokens = _base_tokenize(text)
    if lower_case:
        tokens = [t.lower() for t in tokens]
    if convert_num:
        tokens = ["<NUM>" if t.isdigit() else t for t in tokens]
    return tokens


class WordVocab:
    """Frequency-sorted vocabulary (reference tokenization_utils.py:69-166)."""

    def __init__(self, sents=None, path=None, freq_cutoff=5,
                 encoding="utf-8", verbose=False):
        if sents is not None:
            counts: dict[str, int] = {}
            for text in sents:
                for w in text.split():
                    counts[w] = counts.get(w, 0) + 1
            self._idx2w = [t[0] for t in
                           sorted(counts.items(), key=lambda x: -x[1])]
            self._counts = counts
        elif path is not None:
            self._idx2w, self._counts = [], {}
            with open(path, encoding=encoding) as fin:
                for line in fin:
                    w, c = line.rstrip().split(" ")
                    self._idx2w.append(w)
                    self._counts[w] = int(c)
        else:
            self._idx2w, self._counts = [], {}

        if freq_cutoff > 1:
            kept = [w for w in self._idx2w
                    if int(self._counts[w]) >= freq_cutoff]
            if verbose and self._counts:
                in_sum = sum(int(self._counts[w]) for w in kept)
                total = sum(int(c) for c in self._counts.values())
                print(f"vocab oov rate: {1 - in_sum / max(total, 1):.4f}")
            self._idx2w = kept
            self._counts = {w: self._counts[w] for w in kept}
        self._w2idx = {w: i for i, w in enumerate(self._idx2w)}

    def add_word(self, w, count=1):
        if w not in self._w2idx:
            self._w2idx[w] = len(self._idx2w)
            self._idx2w.append(w)
            self._counts[w] = count
        else:
            self._counts[w] += count
        return self

    def top_k_cutoff(self, size):
        if size < len(self._idx2w):
            for w in self._idx2w[size:]:
                self._w2idx.pop(w)
                self._counts.pop(w)
            self._idx2w = self._idx2w[:size]
        return self

    def save(self, path, encoding="utf-8"):
        with open(path, "w", encoding=encoding) as fout:
            for w in self._idx2w:
                fout.write(f"{w} {self._counts[w]}\n")

    def __len__(self):
        return len(self._idx2w)

    def __contains__(self, word):
        return word in self._w2idx

    def __iter__(self):
        return iter(self._idx2w)

    @property
    def w2idx(self):
        return self._w2idx

    @property
    def idx2w(self):
        return self._idx2w

    @property
    def counts(self):
        return self._counts


def make_word_vocab(statement_path_list, output_path, lower_case=True,
                    convert_num=True, freq_cutoff=5):
    """Build a w2idx json from statement jsonl files (reference
    tokenization_utils.py:189-209); EXTRA_TOKS appended at the end."""
    docs = []
    for path in statement_path_list:
        with open(path, encoding="utf-8") as fin:
            for line in fin:
                d = json.loads(line)
                docs.append(d["question"]["stem"])
                docs.extend(c["text"] for c in d["question"]["choices"])

    counts: dict[str, int] = {}
    for doc in docs:
        for w in tokenize_sentence(doc, lower_case, convert_num):
            counts[w] = counts.get(w, 0) + 1
    idx2w = [t[0] for t in sorted(counts.items(), key=lambda x: -x[1])]
    idx2w = [w for w in idx2w if counts[w] >= freq_cutoff]
    idx2w += EXTRA_TOKS
    w2idx = {w: i for i, w in enumerate(idx2w)}
    with open(output_path, "w", encoding="utf-8") as fout:
        json.dump(w2idx, fout)
    return w2idx


class WordTokenizer:
    """Vocab-file-backed word tokenizer (reference
    tokenization_utils.py:15-67). Accepts either the reference's
    line-per-token vocab.txt or make_word_vocab's w2idx json."""

    def __init__(self, vocab_file: str, lower_case: bool = True,
                 convert_num: bool = False):
        with open(vocab_file, encoding="utf-8") as fin:
            head = fin.read(1)
            fin.seek(0)
            if head == "{":
                self.vocab = {k: int(v) for k, v in json.load(fin).items()}
            else:
                self.vocab = {line.rstrip("\n"): i
                              for i, line in enumerate(fin)}
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.lower_case = lower_case
        self.convert_num = convert_num
        for t in EXTRA_TOKS:
            if t not in self.vocab:
                self.vocab[t] = len(self.vocab)
                self.ids_to_tokens[self.vocab[t]] = t

    @property
    def vocab_size(self):
        return len(self.vocab)

    def __len__(self):
        return len(self.vocab)

    @property
    def unk_token_id(self):
        return self.vocab[UNK_TOK]

    @property
    def pad_token_id(self):
        return self.vocab[PAD_TOK]

    @property
    def sep_token_id(self):
        return self.vocab[SEP_TOK]

    @property
    def eos_token_id(self):
        return self.vocab[EOS_TOK]

    def tokenize(self, text: str) -> list[str]:
        return tokenize_sentence(text, self.lower_case, self.convert_num)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, int):
            return self.ids_to_tokens.get(ids, UNK_TOK)
        return [self.ids_to_tokens.get(i, UNK_TOK) for i in ids]

    def encode(self, text: str) -> list[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def save_vocabulary(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "vocab.txt")
        with open(path, "w", encoding="utf-8") as fout:
            for i in range(len(self.ids_to_tokens)):
                fout.write(self.ids_to_tokens[i] + "\n")
        return path
