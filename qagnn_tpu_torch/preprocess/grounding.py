"""Concept grounding: statements -> mentioned q/a concept sets.

Counterpart of qagnn_tpu/preprocess/grounding.py, line for line: a port of
reference utils/grounding.py with the spaCy Matcher replaced by a built-in
n-gram matcher over normalized-token sequences (see
qagnn_tpu_torch.preprocess.lemma). Same pipeline contract:

  statement jsonl (with "statements" per choice)
    -> {"sent", "ans", "qc": [...], "ac": [...]} jsonl, one row per
       (statement, answer) pair, with the reference's span-selection rules,
       blacklist, hard-ground fallback and stopword prune.

The worker pool is started from a process that may hold a CUDA context (the
driver builds the LM scorer on the card first), so its workers come from
`worker_pool`, which never forks that process.
"""

from __future__ import annotations

import json
import multiprocessing
from dataclasses import dataclass

from qagnn_tpu_torch.preprocess.lemma import (
    GROUND_BLACKLIST,
    PRONOUNS,
    STOPWORDS,
    normalize,
    tokenize,
)

MAX_PATTERN_LEN = 4  # reference drops concepts of >= 5 tokens (grounding.py:42)


@dataclass
class Matcher:
    """n-gram matcher: normalized token tuples -> concept names."""
    patterns: dict[tuple[str, ...], set[str]]
    vocab: set[str]              # concept names with underscores
    max_len: int = MAX_PATTERN_LEN

    def match(self, tokens: list[str]) -> list[tuple[int, int, str]]:
        """All (start, end, concept) matches of normalized n-grams."""
        norm = [normalize(t) for t in tokens]
        out = []
        n = len(norm)
        for i in range(n):
            for l in range(1, self.max_len + 1):
                if i + l > n:
                    break
                key = tuple(norm[i: i + l])
                for concept in self.patterns.get(key, ()):
                    out.append((i, i + l, concept))
        return out


def create_matcher(cpnet_vocab_path: str) -> Matcher:
    """Build patterns from the concept vocabulary
    (reference create_matcher_patterns, grounding.py:56-80): skip concepts
    longer than 4 tokens, pronoun-first/last concepts, and all-stopword
    concepts."""
    with open(cpnet_vocab_path, encoding="utf8") as f:
        vocab = [l.strip() for l in f if l.strip()]

    patterns: dict[tuple[str, ...], set[str]] = {}
    for concept in vocab:
        toks = concept.split("_")
        if len(toks) >= 5 or toks[0] in PRONOUNS or toks[-1] in PRONOUNS:
            continue
        if all(t in STOPWORDS or normalize(t) in STOPWORDS
               or normalize(t) in GROUND_BLACKLIST for t in toks):
            continue
        key = tuple(normalize(t) for t in toks)
        patterns.setdefault(key, set()).add(concept)
    return Matcher(patterns=patterns, vocab=set(vocab))


def ground_mentioned_concepts(matcher: Matcher, sent: str,
                              ans: str | None = None) -> set[str]:
    """Reference ground_mentioned_concepts (grounding.py:134-216): collect
    matched concepts per span, keep the 3 shortest non-blacklisted per span
    plus exact matches; spans that exactly cover the answer text are skipped
    when grounding the question."""
    tokens = tokenize(sent)
    matches = matcher.match(tokens)

    ans_spans = set()
    if ans is not None:
        ans_toks = tokenize(ans)
        la = len(ans_toks)
        if la:
            for i in range(len(tokens) - la + 1):
                if tokens[i: i + la] == ans_toks:
                    ans_spans.add((i, i + la))

    span_to_concepts: dict[tuple[int, int], set[str]] = {}
    for start, end, concept in matches:
        if (start, end) in ans_spans:
            continue
        span_to_concepts.setdefault((start, end), set()).add(concept)

    mentioned: set[str] = set()
    for (start, end), concepts in span_to_concepts.items():
        span_text = " ".join(tokens[start:end])
        by_len = sorted(concepts, key=len)
        for c in by_len[:3]:
            if c in GROUND_BLACKLIST:
                continue
            mentioned.add(c)
        mentioned.update(c for c in by_len
                         if c.replace("_", " ") == span_text)
    return mentioned


def hard_ground(matcher: Matcher, sent: str) -> set[str]:
    """Fallback when nothing matched (reference grounding.py:219-233):
    single-token normalized forms present in the vocab, plus the whole
    sentence as one concept."""
    toks = tokenize(sent)
    res = {normalize(t) for t in toks} & matcher.vocab
    joined = "_".join(toks)
    if joined in matcher.vocab:
        res.add(joined)
    return res


def ground_qa_pair(matcher: Matcher, sent: str, ans: str) -> dict:
    """Reference ground_qa_pair (grounding.py:110-131)."""
    all_concepts = ground_mentioned_concepts(matcher, sent, ans)
    answer_concepts = ground_mentioned_concepts(matcher, ans)
    question_concepts = all_concepts - answer_concepts
    if not question_concepts:
        question_concepts = hard_ground(matcher, sent)
    if not answer_concepts:
        answer_concepts = hard_ground(matcher, ans)
    return {"sent": sent, "ans": ans,
            "qc": sorted(question_concepts), "ac": sorted(answer_concepts)}


def prune(rows: list[dict], vocab: set[str]) -> list[dict]:
    """Reference prune (grounding.py:243-295): drop -er/-e suffix variants
    whose base is present, concepts containing (qc) / consisting only of (ac)
    stopwords, and anything not in the vocabulary."""
    out = []
    for item in rows:
        qc = item["qc"]
        pruned_qc = []
        for c in qc:
            if c.endswith("er") and c[:-2] in qc:
                continue
            if c.endswith("e") and c[:-1] in qc:
                continue
            if any(t in STOPWORDS for t in c.split("_")):
                continue
            if c in vocab:
                pruned_qc.append(c)
        ac = item["ac"]
        pruned_ac = []
        for c in ac:
            if c.endswith("er") and c[:-2] in ac:
                continue
            if c.endswith("e") and c[:-1] in ac:
                continue
            if all(t in STOPWORDS for t in c.split("_")):
                continue
            if c in vocab:
                pruned_ac.append(c)
        item = dict(item)
        item["qc"], item["ac"] = pruned_qc, pruned_ac
        out.append(item)
    return out


_WORKER_MATCHER: Matcher | None = None


def worker_pool(processes: int, initializer, initargs):
    """A Pool whose workers are forked from a forkserver process (started
    fresh, without CUDA), not from this one: a fork of a process holding a
    CUDA context must not touch CUDA. Unlike `spawn`, a worker starts no
    new interpreter; it still imports the caller's main module again, as
    every non-fork worker does."""
    return multiprocessing.get_context("forkserver").Pool(
        processes, initializer=initializer, initargs=initargs)


def _worker_init(vocab_path: str):
    global _WORKER_MATCHER
    _WORKER_MATCHER = create_matcher(vocab_path)


def _worker_ground(pair):
    return ground_qa_pair(_WORKER_MATCHER, *pair)


def ground(statement_path: str, cpnet_vocab_path: str, output_path: str,
           num_processes: int = 1) -> None:
    """Driver (reference ground, grounding.py:298-344): one output row per
    (statement, answer-choice) pair across the statement file."""
    sents, answers = [], []
    with open(statement_path) as f:
        for line in f:
            if not line.strip():
                continue
            j = json.loads(line)
            for st in j["statements"]:
                sents.append(st["statement"])
            for choice in j["question"]["choices"]:
                answers.append(choice["text"])

    if num_processes > 1:
        with worker_pool(num_processes, _worker_init,
                         (cpnet_vocab_path,)) as p:
            rows = list(p.imap(_worker_ground, zip(sents, answers),
                               chunksize=32))
    else:
        matcher = create_matcher(cpnet_vocab_path)
        rows = [ground_qa_pair(matcher, s, a)
                for s, a in zip(sents, answers)]

    with open(cpnet_vocab_path, encoding="utf8") as f:
        vocab = {l.strip() for l in f if l.strip()}
    rows = prune(rows, vocab)

    with open(output_path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
