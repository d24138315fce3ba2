"""Per-question subgraph extraction: grounded concepts -> schema graph .pk.

Counterpart of qagnn_tpu/preprocess/graph_extraction.py. A port of reference
utils/graph.py:250-519 (the 2-hop-all-pair + LM-relevance pipeline): for
each (question, choice)

  1. extra nodes = common neighbors of every pair of grounded q/a nodes
     (reference Part1, utils/graph.py:315-324),
  2. every node scored by an LM ("question + concept-name" relevance;
     reference get_LM_score, utils/graph.py:281-313) — pluggable: the
     reference's RoBERTa MLM scorer is `make_torch_mlm_scorer`, which runs
     the port's TextEncoder and MLM head on the card,
  3. schema graph = qc + ac + extra sorted by score desc; adjacency among the
     selected nodes over the BASE (non-inverse) relations as a (R*N, N) bool
     COO matrix (reference concepts2adj, utils/graph.py:114-129; inverse
     relations are added downstream by the data loader).

Output pickle rows {'adj', 'concepts', 'qmask', 'amask', 'cid2score'} are
byte-compatible with what qagnn_tpu_torch.data.graphs.load_graph_pk (and the
reference loader) consume. Parts 1 and 3 run in `worker_pool`s, which never
fork this process: it may hold the scorer's CUDA context.
"""

from __future__ import annotations

import json
import pickle
import time
from typing import Callable, Sequence

import numpy as np
from scipy.sparse import coo_matrix

from qagnn_tpu_torch.preprocess.grounding import worker_pool
from qagnn_tpu_torch.preprocess.kg import KG

# scorer: (question_text, concept_names) -> list of float scores
Scorer = Callable[[str, Sequence[str]], Sequence[float]]

_KG: KG | None = None


def extra_nodes_2hop_all_pair(kg: KG, qa_nodes: set[int]) -> list[int]:
    """Common neighbors of every ordered pair of grounded nodes
    (reference utils/graph.py:318-323)."""
    extra: set[int] = set()
    nodes = [n for n in qa_nodes if 0 <= n < kg.n_nodes]
    nbrs = {n: kg.neighbors(n) for n in nodes}
    for i, q in enumerate(nodes):
        for a in nodes:
            if q == a:
                continue
            common = np.intersect1d(nbrs[q], nbrs[a], assume_unique=True)
            extra.update(int(x) for x in common)
    return sorted(extra - qa_nodes)


def concepts_to_adj(kg: KG, node_ids: Sequence[int]):
    """(R*N, N) bool COO over base relations among `node_ids`
    (reference concepts2adj, utils/graph.py:114-129)."""
    cids = np.asarray(node_ids, dtype=np.int32)
    n_rel, n_node = kg.n_base_rels, len(cids)
    adj = np.zeros((n_rel, n_node, n_node), dtype=np.uint8)
    pos = {int(c): i for i, c in enumerate(cids)}
    for s_i, c in enumerate(cids):
        dsts, rels = kg.out_edges(int(c))
        for d, r in zip(dsts, rels):
            t_i = pos.get(int(d))
            if t_i is not None and 0 <= r < n_rel:
                adj[r][s_i][t_i] = 1
    return coo_matrix(adj.reshape(-1, n_node)), cids


def default_uniform_scorer(question: str, names: Sequence[str]):
    """No-LM fallback: all-zero scores (like the reference's MedQA pipeline,
    which sets cid2score=None — utils_biomed notebook cells 22-23)."""
    return [0.0] * len(names)


class MLMScorer:
    """score(concept) = -MLM loss of 'question concept.' (reference
    utils/graph.py:254-313): per chunk of `batch_size` sentences, the
    per-token cross-entropy of the logits against `input_ids` (which
    include the tokenizer's start and end tokens), masked by
    `attention_mask`, summed per sentence and negated. `model` is a
    models/mlm_head.py MaskedLM on `device`; `tokenizer` answers the HF
    batch call tok(list, padding=True, return_tensors="pt")."""

    def __init__(self, model, tokenizer, device, batch_size: int = 50):
        self.model, self.tokenizer = model, tokenizer
        self.device, self.batch_size = device, batch_size

    def __call__(self, question: str, names: Sequence[str | None]):
        sents = [question.lower() if n is None
                 else f"{question.lower()} {' '.join(n.split('_'))}."
                 for n in names]
        scores = []
        for a in range(0, len(sents), self.batch_size):
            enc = self.tokenizer(sents[a: a + self.batch_size], padding=True,
                                 return_tensors="pt")
            scores += self.sentence_scores(enc).cpu().tolist()
        return scores

    def sentence_scores(self, enc):
        """(B,) scores of one tokenized chunk, on the device. The chunk's
        (B, L, V) logits are freed before this returns."""
        import torch
        import torch.nn.functional as F

        ids = enc["input_ids"].to(self.device)
        mask = enc["attention_mask"].to(self.device)
        types = enc.get("token_type_ids")
        with torch.no_grad():
            logits = self.model(ids, mask, None if types is None
                                else types.to(self.device))
            loss = F.cross_entropy(logits.view(-1, logits.size(-1)),
                                   ids.view(-1), reduction="none")
            return -(loss.view(ids.shape) * mask).sum(1)


def make_torch_mlm_scorer(model_name_or_path: str, device=None,
                          batch_size: int = 50, tokenizer=None) -> MLMScorer:
    """The reference's scorer (reference utils/graph.py:254-313) on the
    port's TextEncoder and MLM head, read from an HF RobertaForMaskedLM
    checkpoint (`models.hf_loading.load_mlm_checkpoint`; no download is
    attempted). It runs on the card unless `device` names another, and
    raises when there is no card. `tokenizer=None` loads
    transformers.AutoTokenizer from the same path."""
    from qagnn_tpu_torch.models.mlm_head import load_masked_lm
    from qagnn_tpu_torch.utils.config import resolve_device

    dev = resolve_device(device)
    if tokenizer is None:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
    model = load_masked_lm(model_name_or_path).to(dev)
    return MLMScorer(model, tokenizer, dev, batch_size)


def score_nodes(kg: KG, question: str, node_ids: Sequence[int],
                scorer: Scorer) -> dict[int, float]:
    """cid2score including the context node under key -1
    (reference get_LM_score, utils/graph.py:281-313)."""
    names: list[str | None] = [None] + [kg.id2concept[i] for i in node_ids]
    scores = scorer(question, names)
    pairs = list(zip([-1] + list(node_ids), scores))
    return dict(sorted(pairs, key=lambda x: -x[1]))


def _worker_init(kg_path: str):
    global _KG
    _KG = KG.load(kg_path)
    _KG.build_indices()


def _worker_part1(item):
    q_ids, a_ids, question = item
    extra = extra_nodes_2hop_all_pair(_KG, set(q_ids) | set(a_ids))
    return (sorted(q_ids), sorted(a_ids), question, extra)


def _worker_part3(item):
    q_ids, a_ids, question, extra, cid2score = item
    if cid2score is not None:
        extra = sorted(extra, key=lambda x: -cid2score[x])
    schema = list(q_ids) + list(a_ids) + list(extra)
    ar = np.arange(len(schema))
    qmask = ar < len(q_ids)
    amask = (ar >= len(q_ids)) & (ar < len(q_ids) + len(a_ids))
    adj, concepts = concepts_to_adj(_KG, schema)
    return {"adj": adj, "concepts": concepts, "qmask": qmask,
            "amask": amask, "cid2score": cid2score}


def generate_adj_data_from_grounded_concepts(
        grounded_path: str, kg_path: str, output_path: str,
        statement_path: str | None = None,
        scorer: Scorer | None = default_uniform_scorer,
        num_processes: int = 1,
        fallback_q: str | None = None,
        fallback_a: str | None = None) -> dict[str, float]:
    """Driver (reference generate_adj_data_from_grounded_concepts__use_LM,
    utils/graph.py:463-519). `scorer=None` emits cid2score=None rows (the
    DDB/MedQA variant). `fallback_q`/`fallback_a` name concepts substituted
    for empty question/answer sets (the MedQA notebook's
    concept2id['31770']/['325'] fallbacks, cell 23). Returns the host
    seconds of each part ({"part1", "part2", "part3"})."""
    kg = KG.load(kg_path)
    kg.build_indices()
    global _KG
    _KG = kg

    if statement_path is None:
        statement_path = grounded_path.replace("grounded", "statement")
    with open(grounded_path, encoding="utf-8") as f:
        grounded = [json.loads(l) for l in f if l.strip()]
    with open(statement_path, encoding="utf-8") as f:
        statements = [json.loads(l) for l in f if l.strip()]
    assert len(grounded) % len(statements) == 0
    n_choices = len(grounded) // len(statements)

    c2i = kg.concept2id
    qa_data = []
    for j, dic in enumerate(grounded):
        q_ids = {c2i[c] for c in dic["qc"] if c in c2i}
        a_ids = {c2i[c] for c in dic["ac"] if c in c2i}
        if not q_ids and fallback_q is not None:
            q_ids = {c2i[fallback_q]}
        if not a_ids and fallback_a is not None:
            a_ids = {c2i[fallback_a]}
        q_ids -= a_ids
        stem = statements[j // n_choices]["question"]["stem"]
        qa_data.append((q_ids, a_ids, f"{stem} {dic['ans']}."))

    seconds = {}
    t0 = time.perf_counter()
    if num_processes > 1:
        with worker_pool(num_processes, _worker_init, (kg_path,)) as p:
            res1 = list(p.imap(_worker_part1, qa_data, chunksize=8))
    else:
        res1 = [_worker_part1(x) for x in qa_data]
    seconds["part1"] = time.perf_counter() - t0

    # Part 2 (LM scoring) is serial like the reference (GPU-bound there)
    t0 = time.perf_counter()
    res2 = []
    for q_ids, a_ids, question, extra in res1:
        cid2score = (None if scorer is None else
                     score_nodes(kg, question,
                                 list(q_ids) + list(a_ids) + list(extra),
                                 scorer))
        res2.append((q_ids, a_ids, question, extra, cid2score))
    seconds["part2"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if num_processes > 1:
        with worker_pool(num_processes, _worker_init, (kg_path,)) as p:
            res3 = list(p.imap(_worker_part3, res2, chunksize=8))
    else:
        res3 = [_worker_part3(x) for x in res2]
    seconds["part3"] = time.perf_counter() - t0

    with open(output_path, "wb") as f:
        pickle.dump(res3, f)
    return seconds
