"""Statement (question/choices) loading + tokenization.

Counterpart of qagnn_tpu/data/statements.py (reference
utils/data_utils.py:283-478): the same on-disk format (statement .jsonl, one
question per line with question.stem, question.choices, answerKey, optional
para/fact1 prefixes), the same pair layouts ([CLS] context [SEP] (x2 for
roberta/albert) question+choice [SEP], xlnet's CLS at the end and left pad,
longest-first truncation; the GPT layout with its special tokens and the
LSTM's word ids with lengths), emitted as fixed-shape int32 numpy arrays:
(n_questions, n_choices, max_seq_len), and (n_questions, n_choices) for
GPT's `cls_token_ids` and the LSTM's `lengths`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np


@dataclass
class StatementData:
    qids: list[str]
    labels: np.ndarray                 # (n,) int64
    inputs: dict[str, np.ndarray]      # each (n, n_choices, max_seq_len)
    n_choices: int

    def __len__(self):
        return len(self.qids)


def read_statement_jsonl(path: str):
    """[(qid, label, context, endings)] per question (reference read_examples,
    utils/data_utils.py:308-325): context is the stem, prefixed by
    para/fact1 when present; label from answerKey."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            d = json.loads(line)
            label = ord(d["answerKey"]) - ord("A") if "answerKey" in d else 0
            context = d["question"]["stem"]
            if "para" in d:
                context = d["para"] + " " + context
            if "fact1" in d:
                context = d["fact1"] + " " + context
            endings = [c["text"] for c in d["question"]["choices"]]
            out.append((d["id"], label, context, endings))
    return out


def _truncate_seq_pair(tokens_a: list, tokens_b: list, max_length: int):
    """Longest-first pair truncation, IN PLACE (reference
    utils/data_utils.py:204-212 / :436-448)."""
    while len(tokens_a) + len(tokens_b) > max_length:
        if len(tokens_a) > len(tokens_b):
            tokens_a.pop()
        else:
            tokens_b.pop()


GPT_SPECIAL_TOKENS = ["_start_", "_delimiter_", "_classify_"]


def load_gpt_statements(path: str, max_seq_len: int,
                        tokenizer=None) -> StatementData:
    """The GPT layout (reference utils/data_utils.py:203-281):

        input_ids[i, j] = [_start_] q [_delimiter_] choice_j [_classify_] 0..
        cls_token_ids[i, j] = position of _classify_
        lm_labels[i, j, :len-1] = qa[1:], the rest -1

    The tokenizer needs `get_vocab`, `add_tokens`, `tokenize` and
    `convert_tokens_to_ids`; with none given, `transformers` loads
    openai-gpt's. Two quirks of the reference are kept: the question's
    tokens are truncated IN PLACE by `_truncate_seq_pair`, so a cut forced
    by choice j stays for choices j+1.. (reference :204-212, 240 mutate
    `q`); and the stem gets no para/fact1 prefix (reference load_qa_dataset
    :214-222 reads only question.stem)."""
    if tokenizer is None:
        from transformers import OpenAIGPTTokenizer
        tokenizer = OpenAIGPTTokenizer.from_pretrained("openai-gpt")
    if not set(GPT_SPECIAL_TOKENS) <= set(tokenizer.get_vocab()):
        tokenizer.add_tokens(GPT_SPECIAL_TOKENS)
    start, delim, clf = tokenizer.convert_tokens_to_ids(GPT_SPECIAL_TOKENS)

    def enc(text):
        return tokenizer.convert_tokens_to_ids(tokenizer.tokenize(text))

    qids, labels, rows = [], [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            d = json.loads(line)
            qids.append(d["id"])
            labels.append(ord(d.get("answerKey", "A")) - ord("A"))
            rows.append((enc(d["question"]["stem"]),
                         [enc(c["text"]) for c in d["question"]["choices"]]))

    n = len(rows)
    n_choices = max(len(r[1]) for r in rows)
    input_ids = np.zeros((n, n_choices, max_seq_len), np.int32)
    cls_token_ids = np.zeros((n, n_choices), np.int32)
    lm_labels = np.full((n, n_choices, max_seq_len), -1, np.int32)
    for i, (q, choices) in enumerate(rows):
        for j in range(n_choices):
            choice = list(choices[min(j, len(choices) - 1)])
            _truncate_seq_pair(q, choice, max_seq_len - 3)   # q mutated
            qa = [start] + q + [delim] + choice + [clf]
            input_ids[i, j, :len(qa)] = qa
            cls_token_ids[i, j] = len(qa) - 1
            lm_labels[i, j, :len(qa) - 1] = qa[1:]

    return StatementData(
        qids=qids, labels=np.asarray(labels, np.int64),
        inputs={"input_ids": input_ids, "cls_token_ids": cls_token_ids,
                "lm_labels": lm_labels},
        n_choices=n_choices)


def load_lstm_statements(path: str, max_seq_len: int,
                         tokenizer) -> StatementData:
    """The LSTM layout: ids = q <SEP> choice (longest-first truncation),
    filled with the tokenizer's pad id, and each pair's real length (at
    least 1): the (input_ids, lengths) inputs of LSTMTextEncoder (reference
    modeling/modeling_encoder.py:63-67; the reference's own loader is
    unimplemented, utils/data_utils.py:478-480). `tokenizer` is a
    data/word_tokenizer.py WordTokenizer."""
    examples = read_statement_jsonl(path)
    n = len(examples)
    n_choices = max(len(e[3]) for e in examples)
    input_ids = np.full((n, n_choices, max_seq_len),
                        tokenizer.pad_token_id, np.int32)
    lengths = np.ones((n, n_choices), np.int32)
    for i, (_, _, context, endings) in enumerate(examples):
        q = tokenizer.encode(context)
        for j in range(n_choices):
            a = list(q)
            b = tokenizer.encode(endings[min(j, len(endings) - 1)])
            _truncate_seq_pair(a, b, max_seq_len - 1)
            ids = a + [tokenizer.sep_token_id] + b
            input_ids[i, j, :len(ids)] = ids
            lengths[i, j] = max(len(ids), 1)

    return StatementData(
        qids=[e[0] for e in examples],
        labels=np.asarray([e[1] for e in examples], np.int64),
        inputs={"input_ids": input_ids, "lengths": lengths},
        n_choices=n_choices)


def model_type_for(model_name: str) -> str:
    """Family classification (reference modeling/modeling_encoder.py:16-32
    MODEL_NAME_TO_CLASS, keyed by name substring; SapBERT is bert)."""
    n = model_name.lower()
    for t in ("roberta", "xlnet", "albert", "lstm"):
        if t in n:
            return t
    if "gpt" in n:
        return "gpt"
    return "bert"


def load_pair_statements(path: str, model_type: str, max_seq_len: int,
                         tokenizer) -> StatementData:
    """Manual CLS/SEP assembly, the reference algorithm (reference
    utils/data_utils.py:283-430 convert_examples_to_features). The tokenizer
    needs `cls_token`, `sep_token`, `tokenize` and `convert_tokens_to_ids`.

    Layouts by family:
      bert:            [CLS] a [SEP] b [SEP]          seg 0..0 1..1, right pad
      roberta/albert:  [CLS] a [SEP][SEP] b [SEP]     seg all 0,   right pad
      xlnet:           a [SEP] b [SEP] [CLS]          seg 0..0 1..1 2,
                       LEFT pad with pad_token_segment_id=4
    input_ids are padded with 0 whatever the tokenizer's pad id (reference
    pad_token=0); special_tokens_mask marks CLS/SEP *and* padding positions
    with 1 (reference :404-405,415-421).
    """
    cls_t, sep_t = tokenizer.cls_token, tokenizer.sep_token
    cls_at_end = model_type == "xlnet"
    sep_extra = model_type in ("roberta", "albert")
    cls_seg_id = 2 if model_type == "xlnet" else 0
    pad_on_left = model_type == "xlnet"
    pad_seg_id = 4 if model_type == "xlnet" else 0
    seq_b_seg_id = 0 if model_type in ("roberta", "albert") else 1
    special_ids = set(tokenizer.convert_tokens_to_ids([cls_t, sep_t]))

    examples = read_statement_jsonl(path)
    n = len(examples)
    n_choices = max(len(e[3]) for e in examples)
    out = {k: np.zeros((n, n_choices, max_seq_len), np.int32)
           for k in ("input_ids", "attention_mask", "token_type_ids",
                     "special_tokens_mask")}

    for i, (_, _, context, endings) in enumerate(examples):
        for j in range(n_choices):
            ending = endings[min(j, len(endings) - 1)]
            tokens_a = tokenizer.tokenize(context)
            # reference prepends the (empty) question field + " "
            tokens_b = tokenizer.tokenize(" " + ending)
            special_count = 4 if sep_extra else 3
            _truncate_seq_pair(tokens_a, tokens_b,
                               max_seq_len - special_count)

            tokens = tokens_a + [sep_t]
            if sep_extra:
                tokens += [sep_t]
            segs = [0] * len(tokens)
            tokens += tokens_b + [sep_t]
            segs += [seq_b_seg_id] * (len(tokens_b) + 1)
            if cls_at_end:
                tokens, segs = tokens + [cls_t], segs + [cls_seg_id]
            else:
                tokens, segs = [cls_t] + tokens, [cls_seg_id] + segs

            ids = tokenizer.convert_tokens_to_ids(tokens)
            mask = [1] * len(ids)
            omask = [1 if t in special_ids else 0 for t in ids]
            pad = max_seq_len - len(ids)
            if pad_on_left:
                ids = [0] * pad + ids
                mask = [0] * pad + mask
                omask = [1] * pad + omask
                segs = [pad_seg_id] * pad + segs
            else:
                ids += [0] * pad
                mask += [0] * pad
                omask += [1] * pad
                segs += [pad_seg_id] * pad
            out["input_ids"][i, j] = ids
            out["attention_mask"][i, j] = mask
            out["token_type_ids"][i, j] = segs
            out["special_tokens_mask"][i, j] = omask

    return StatementData(
        qids=[e[0] for e in examples],
        labels=np.asarray([e[1] for e in examples], np.int64),
        inputs=out, n_choices=n_choices)


def load_statements(path: str, model_name: str, max_seq_len: int,
                    tokenizer=None) -> StatementData:
    """Tokenize all questions x choices to fixed-shape arrays.

    A fast HF tokenizer (`is_fast`) encodes the pairs itself, which
    reproduces the reference's manual token assembly (CLS/SEP placement incl.
    RoBERTa's double SEP, longest-first truncation); xlnet, and any other
    tokenizer, goes through `load_pair_statements`; gpt and lstm take their
    own layouts. With no tokenizer given, `transformers` loads the one named
    `model_name` (openai-gpt's for gpt); lstm needs a WordTokenizer.
    """
    mtype = model_type_for(model_name)
    if mtype == "lstm":
        if tokenizer is None:
            raise ValueError(
                "encoder 'lstm' needs a WordTokenizer: pass tokenizer= or "
                "set --lstm_vocab to a vocabulary file (build one with "
                "qagnn_tpu_torch.data.word_tokenizer.make_word_vocab)")
        return load_lstm_statements(path, max_seq_len, tokenizer)
    if mtype == "gpt":
        return load_gpt_statements(path, max_seq_len, tokenizer)
    if tokenizer is None:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(model_name)
    if mtype == "xlnet" or getattr(tokenizer, "is_fast", False) is not True:
        return load_pair_statements(path, mtype, max_seq_len, tokenizer)

    examples = read_statement_jsonl(path)
    n_choices = max(len(e[3]) for e in examples)

    texts_a, texts_b = [], []
    for _, _, context, endings in examples:
        for c in range(n_choices):
            ending = endings[min(c, len(endings) - 1)]
            texts_a.append(context)
            # reference prepends the (empty) question field + " "
            texts_b.append(" " + ending)

    enc = tokenizer(texts_a, texts_b, max_length=max_seq_len,
                    truncation="longest_first", padding="max_length",
                    return_token_type_ids=True,
                    return_special_tokens_mask=True)

    n = len(examples)

    def shape(key):
        return np.asarray(enc[key], dtype=np.int32).reshape(n, n_choices,
                                                            max_seq_len)

    attention_mask = shape("attention_mask")
    # the reference pads input_ids with a HARDCODED 0 regardless of the
    # tokenizer's pad id (utils/data_utils.py:341 pad_token=0): for RoBERTa
    # that is `<s>`, not `<pad>`
    input_ids = np.where(attention_mask > 0, shape("input_ids"), 0)
    inputs = {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "token_type_ids": shape("token_type_ids"),
        # 1 marks special tokens: the reference's `output_mask`
        # (utils/data_utils.py:404-405)
        "special_tokens_mask": shape("special_tokens_mask"),
    }
    return StatementData(
        qids=[e[0] for e in examples],
        labels=np.asarray([e[1] for e in examples], np.int64),
        inputs=inputs,
        n_choices=n_choices,
    )
