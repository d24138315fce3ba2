"""The port's word tokenizer and vocabulary against the JAX package's
(qagnn_tpu.data.word_tokenizer), exactly: the tokenizing regex (the port's
own copy of qagnn_tpu/preprocess/lemma.py `tokenize`), `tokenize_sentence`
with and without lower-casing and number conversion, `WordVocab` from
sentences and from a file with its cut-offs, `make_word_vocab`'s file, and
`WordTokenizer` over both vocabulary formats.
"""

import json

import numpy as np
import pytest

from qagnn_tpu.data import word_tokenizer as jax_words
from qagnn_tpu.preprocess.lemma import tokenize as jax_tokenize

from qagnn_tpu_torch.data import word_tokenizer as words
from qagnn_tpu_torch.data.synthetic import write_synthetic_dataset

TEXTS = ["What did the cat do?", "The dog's 2 bones, and 3 cats' toys.",
         "It's 1999 -- isn't it?  MIXED case Words", "", "a-b c_d e.f 42x",
         "Numbers 007 and 12,345; O'Brien's"]


def _random_texts(n=200, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = list("abcXYZ019 '.,?-_") + ["it's", "don't", " 12 "]
    return ["".join(rng.choice(alphabet, int(rng.integers(0, 30))))
            for _ in range(n)]


def test_base_tokenize_is_the_lemma_regex():
    for text in TEXTS + _random_texts():
        assert words._base_tokenize(text) == jax_tokenize(text), text


@pytest.mark.parametrize("lower_case,convert_num",
                         [(True, False), (False, False), (True, True)])
def test_tokenize_sentence_matches_jax(lower_case, convert_num):
    for text in TEXTS + _random_texts(seed=1):
        assert words.tokenize_sentence(text, lower_case, convert_num) == \
            jax_words.tokenize_sentence(text, lower_case, convert_num)


def _same_vocab(got, want):
    assert got.idx2w == want.idx2w
    assert got.w2idx == want.w2idx
    assert got.counts == want.counts
    assert len(got) == len(want) and list(got) == list(want)


def test_word_vocab_matches_jax(tmp_path):
    sents = [" ".join(words.tokenize_sentence(t)) for t in
             TEXTS * 3 + _random_texts(seed=2)]
    for cutoff in (1, 2, 5):
        got = words.WordVocab(sents=sents, freq_cutoff=cutoff)
        want = jax_words.WordVocab(sents=sents, freq_cutoff=cutoff)
        _same_vocab(got, want)
    got.add_word("zebra").add_word("the", 2).top_k_cutoff(6)
    want.add_word("zebra").add_word("the", 2).top_k_cutoff(6)
    _same_vocab(got, want)
    assert ("zebra" in got) == ("zebra" in want)
    path = tmp_path / "vocab.txt"
    got.save(str(path))
    _same_vocab(words.WordVocab(path=str(path), freq_cutoff=1),
                jax_words.WordVocab(path=str(path), freq_cutoff=1))
    _same_vocab(words.WordVocab(), jax_words.WordVocab())


@pytest.mark.parametrize("lower_case,convert_num,cutoff",
                         [(True, True, 5), (False, False, 1)])
def test_make_word_vocab_matches_jax(tmp_path, lower_case, convert_num,
                                     cutoff):
    write_synthetic_dataset(str(tmp_path / "data"), n_questions=6)
    paths = [str(tmp_path / "data" / "statement" / f"{s}.statement.jsonl")
             for s in ("train", "dev")]
    got = words.make_word_vocab(paths, str(tmp_path / "port.json"),
                                lower_case, convert_num, cutoff)
    want = jax_words.make_word_vocab(paths, str(tmp_path / "jax.json"),
                                     lower_case, convert_num, cutoff)
    assert got == want
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert list(got)[-4:] == words.EXTRA_TOKS == jax_words.EXTRA_TOKS


@pytest.mark.parametrize("fmt", ["json", "lines"])
def test_word_tokenizer_matches_jax(tmp_path, fmt):
    vocab = ["the", "cat", "dog", "<UNK>", "did", "what", "1999"]
    path = tmp_path / f"vocab.{fmt}"
    if fmt == "json":
        path.write_text(json.dumps({w: i for i, w in enumerate(vocab)}))
    else:
        path.write_text("\n".join(vocab) + "\n")
    got, want = words.WordTokenizer(str(path)), \
        jax_words.WordTokenizer(str(path))
    assert got.vocab == want.vocab and len(got) == len(want)
    assert got.vocab_size == want.vocab_size == len(vocab) + 3
    for prop in ("unk_token_id", "pad_token_id", "sep_token_id",
                 "eos_token_id"):
        assert getattr(got, prop) == getattr(want, prop), prop
    for text in TEXTS + _random_texts(seed=3):
        assert got.tokenize(text) == want.tokenize(text)
        assert got.encode(text) == want.encode(text)
    ids = list(range(-1, len(vocab) + 5))
    assert got.convert_ids_to_tokens(ids) == want.convert_ids_to_tokens(ids)
    assert got.convert_ids_to_tokens(2) == want.convert_ids_to_tokens(2)
    assert got.convert_tokens_to_ids("cat") == \
        want.convert_tokens_to_ids("cat")
    out = tmp_path / "saved"
    out.mkdir()
    saved = got.save_vocabulary(str(out))
    assert saved == str(out / "vocab.txt")
    assert words.WordTokenizer(saved).vocab == got.vocab
