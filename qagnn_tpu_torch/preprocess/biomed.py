"""MedQA-USMLE biomedical preprocessing: DDB knowledge graph + grounding.

Counterpart of qagnn_tpu/preprocess/biomed.py. A port of the reference's
utils_biomed/preprocess_medqa_usmle.ipynb (30 cells) as importable, testable
functions:

  * convert_medqa_statements   — raw MedQA jsonl -> statement jsonl (cell 4)
  * load_ddb / build_ddb_vocab — DiseaseDatabase+DrugBank name/relation tables
                                 -> vocab.txt + ptrs.txt (cells 14-16)
  * construct_ddb_kg           — 15 merged relations + inverses -> KG (17-18)
  * load_umls_to_ddb           — UMLS CUI -> DDB pointer table (cell 11)
  * ground_umls_linked         — UMLS-linked statements -> grounded jsonl
                                 (cell 11)
  * DictionaryEntityLinker     — scispacy-free fallback linker (the reference
                                 uses scispacy's UMLS linker, cells 7-10, which
                                 needs a 1GB model download; this matcher links
                                 directly against DDB surface names instead)
  * generate_medqa_adj_data    — 2-hop-all-pair subgraphs with cid2score=None
                                 and the reference's fallback concepts for
                                 empty q/a sets (cells 22-23)
  * sapbert_entity_embeddings  — SapBERT pooled-CLS entity embedding table
                                 (cells 26-28) through the port's
                                 TextEncoder, on the card unless told
                                 otherwise

The scispacy path is kept behind `make_scispacy_linker` for environments that
have it installed.
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import defaultdict
from typing import Callable, Sequence

import numpy as np

from qagnn_tpu_torch.preprocess.graph_extraction import (
    generate_adj_data_from_grounded_concepts,
)
from qagnn_tpu_torch.preprocess.kg import KG

# 15 merged DDB relations (reference notebook cell 17); edge files store raw
# DDB relation codes which collapse onto these via DDB_RELATION_CODE_MAP.
DDB_MERGED_RELATIONS = (
    "belongs_to_the_category_of",
    "is_a_category",
    "may_cause",
    "is_a_subtype_of",
    "is_a_risk_factor_of",
    "is_associated_with",
    "may_contraindicate",
    "interacts_with",
    "belongs_to_the_drug_family_of",
    "belongs_to_drug_super-family",
    "is_a_vector_for",
    "may_be_allelic_with",
    "see_also",
    "is_an_ingradient_of",
    "may_treat",
)

DDB_RELATION_CODE_MAP = {
    "0": 0, "1": 1, "2": 2, "3": 3, "4": 4, "6": 5, "10": 6, "12": 7,
    "16": 8, "17": 9, "18": 10, "20": 11, "26": 12, "30": 13, "233": 14,
}

# Reference fallback DDB pointers for questions/answers that ground to
# nothing (notebook cell 23: concept2id['31770'] / concept2id['325']).
FALLBACK_Q_PTR = "31770"
FALLBACK_A_PTR = "325"


def convert_medqa_statements(raw_path: str, output_path: str,
                             id_prefix: str = "train") -> None:
    """Raw MedQA 4-option jsonl -> statement jsonl (notebook cell 4).

    Statements are simply 'question + choice-text' (no wh-word blanking like
    CSQA's convert_to_entailment)."""
    examples = []
    with open(raw_path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            row = json.loads(line)
            stem = row["question"]
            choices = [{"label": k, "text": row["options"][k]}
                       for k in sorted(row["options"])]
            examples.append({
                "id": f"{id_prefix}-{i:05d}",
                "question": {"stem": stem, "choices": choices},
                "answerKey": row["answer_idx"],
                "statements": [{"statement": f"{stem} {c['text']}"}
                               for c in choices],
            })
    with open(output_path, "w", encoding="utf-8") as f:
        for ex in examples:
            f.write(json.dumps(ex) + "\n")


# ---- DDB tables ------------------------------------------------------------

def load_ddb(names_json_path: str, relas_json_path: str):
    """Parse ddb_names.json / ddb_relas.json (notebook cell 14).

    names json: {surface_name: [ptr, preferred_flag]}
    relas json: {key: [subj_ptr, obj_ptr, relation_code]}
    Returns (relations, ptr_to_names, name_to_ptr, ptr_to_preferred_name)."""
    with open(names_json_path, encoding="utf-8") as f:
        all_names = json.load(f)
    with open(relas_json_path, encoding="utf-8") as f:
        all_relas = json.load(f)

    relations = list(all_relas.values())
    ptr_to_preferred: dict[str, str] = {}
    ptr_to_names: dict[str, list[str]] = defaultdict(list)
    name_to_ptr: dict[str, str] = {}
    for name, (ptr, preferred) in all_names.items():
        if preferred == "1":
            ptr_to_preferred[ptr] = name
        name_to_ptr[name] = ptr
        ptr_to_names[ptr].append(name)
    return relations, dict(ptr_to_names), name_to_ptr, ptr_to_preferred


def build_ddb_vocab(names_json_path: str, relas_json_path: str,
                    vocab_path: str, ptrs_path: str) -> list[str]:
    """Write vocab.txt (preferred names) + ptrs.txt; return the ptr list
    (the entity id space, notebook cells 14-16)."""
    _, _, _, ptr_to_preferred = load_ddb(names_json_path, relas_json_path)
    ptrs = list(ptr_to_preferred)
    with open(vocab_path, "w", encoding="utf-8") as f:
        for p in ptrs:
            f.write(ptr_to_preferred[p] + "\n")
    with open(ptrs_path, "w", encoding="utf-8") as f:
        for p in ptrs:
            f.write(p + "\n")
    return ptrs


def construct_ddb_kg(names_json_path: str, relas_json_path: str,
                     output_path: str | None = None) -> KG:
    """DDB MultiDiGraph equivalent: directed edges over the 15 merged
    relations plus inverses at rel+15 (notebook cell 18). Node ids index the
    preferred-name pointer list; KG.id2concept holds the POINTER strings
    (matching the reference's id2concept = ddb_ptr_lst)."""
    relations, _, _, ptr_to_preferred = load_ddb(
        names_json_path, relas_json_path)
    ptrs = list(ptr_to_preferred)
    ptr_to_id = {p: i for i, p in enumerate(ptrs)}

    n_rel = len(DDB_MERGED_RELATIONS)
    src, dst, rel = [], [], []
    for subj, obj, code in relations:
        if subj not in ptr_to_id or obj not in ptr_to_id:
            continue
        r = DDB_RELATION_CODE_MAP.get(str(code))
        if r is None:
            continue
        s, o = ptr_to_id[subj], ptr_to_id[obj]
        src += [s, o]
        dst += [o, s]
        rel += [r, r + n_rel]

    kg = KG(n_nodes=len(ptrs), n_base_rels=n_rel,
            edge_src=np.asarray(src, np.int32),
            edge_dst=np.asarray(dst, np.int32),
            edge_rel=np.asarray(rel, np.int16),
            id2concept=ptrs)
    if output_path is not None:
        kg.save(output_path)
    return kg


# ---- entity linking --------------------------------------------------------

def load_umls_to_ddb(path: str) -> dict[str, str]:
    """ddb_to_umls_cui.txt (tab-separated, header row) -> {CUI: ddb_ptr}
    (notebook cell 11)."""
    out: dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f.readlines()[1:]:
            cols = line.rstrip("\n").split("\t")
            if len(cols) >= 3:
                out[cols[2]] = cols[1]
    return out


def make_scispacy_linker(threshold: float = 0.90):
    """The reference's linker (scispacy en_core_sci_sm + UMLS KB, notebook
    cells 7-8). Returns sentence -> [{'Concept ID', 'Canonical Name',
    'Score'}, ...]; raises ImportError without scispacy installed."""
    import scispacy  # noqa: F401
    import spacy
    from scispacy.linking import EntityLinker  # noqa: F401

    nlp = spacy.load("en_core_sci_sm")
    nlp.add_pipe("scispacy_linker",
                 config={"resolve_abbreviations": True, "linker_name": "umls",
                         "threshold": threshold})
    linker = nlp.get_pipe("scispacy_linker")

    def link(sentence: str):
        doc = nlp(sentence[:3500])
        results = []
        for ent in doc.ents:
            for cui, score in ent._.kb_ents:
                kb_ent = linker.kb.cui_to_entity[cui]
                results.append({"Concept ID": cui,
                                "Canonical Name": kb_ent.canonical_name,
                                "Score": score})
        return results
    return link


class DictionaryEntityLinker:
    """Surface-form matcher against the DDB name table — a dependency-free
    stand-in for the scispacy UMLS linker. Greedy longest-match over
    lowercased token n-grams (up to `max_len` tokens)."""

    _token_re = re.compile(r"[a-z0-9]+(?:[-'][a-z0-9]+)*")

    def __init__(self, name_to_ptr: dict[str, str], max_len: int = 6):
        self.max_len = max_len
        self.name_to_ptr = {}
        for name, ptr in name_to_ptr.items():
            key = " ".join(self._token_re.findall(name.lower()))
            if key:
                self.name_to_ptr[key] = (ptr, name)

    def link(self, sentence: str) -> list[dict]:
        toks = self._token_re.findall(sentence.lower())
        results, i = [], 0
        while i < len(toks):
            match = None
            for ln in range(min(self.max_len, len(toks) - i), 0, -1):
                key = " ".join(toks[i:i + ln])
                if key in self.name_to_ptr:
                    match = (ln, *self.name_to_ptr[key])
                    break
            if match:
                ln, ptr, name = match
                results.append({"Concept ID": ptr, "Canonical Name": name,
                                "Score": 1.0})
                i += ln
            else:
                i += 1
        return results


def link_statements(statement_path: str, output_path: str,
                    linker: Callable[[str], list[dict]]) -> None:
    """Attach stem_ents / text_ents to every statement row (cell 10). The
    linker returns flat candidate lists; each is wrapped in the reference's
    {'linking_results': [...]} envelope."""
    with open(statement_path, encoding="utf-8") as f:
        stmts = [json.loads(l) for l in f if l.strip()]
    for stmt in stmts:
        q = stmt["question"]
        q["stem_ents"] = [{"linking_results": linker(q["stem"])}]
        for choice in q["choices"]:
            choice["text_ents"] = [{"linking_results": linker(choice["text"])}]
    with open(output_path, "w", encoding="utf-8") as f:
        for stmt in stmts:
            f.write(json.dumps(stmt) + "\n")


def ground_umls_linked(linked_path: str, umls_to_ddb: dict[str, str] | None,
                       output_path: str) -> None:
    """UMLS-linked statement jsonl -> grounded jsonl with DDB pointers in
    qc/ac (cell 11). With umls_to_ddb=None the 'Concept ID's are taken to be
    DDB pointers already (the DictionaryEntityLinker case)."""

    def to_ddb(ent_obj):
        out = []
        for cand in ent_obj["linking_results"]:
            cui, name = cand["Concept ID"], cand["Canonical Name"]
            if umls_to_ddb is None:
                out.append((cui, name))
            elif cui in umls_to_ddb:
                out.append((umls_to_ddb[cui], name))
        return out

    with open(linked_path, encoding="utf-8") as f:
        stmts = [json.loads(l) for l in f if l.strip()]
    with open(output_path, "w", encoding="utf-8") as f:
        for stmt in stmts:
            q = stmt["question"]
            qc, qc_names = [], []
            for ent_obj in q["stem_ents"]:
                for ptr, name in to_ddb(ent_obj):
                    qc.append(ptr)
                    qc_names.append(name)
            for choice in q["choices"]:
                ac, ac_names = [], []
                for ent_obj in choice["text_ents"]:
                    for ptr, name in to_ddb(ent_obj):
                        ac.append(ptr)
                        ac_names.append(name)
                f.write(json.dumps({
                    "sent": q["stem"], "ans": choice["text"],
                    "qc": qc, "qc_names": qc_names,
                    "ac": ac, "ac_names": ac_names}) + "\n")


# ---- subgraphs + embeddings ------------------------------------------------

def generate_medqa_adj_data(grounded_path: str, kg_path: str,
                            output_path: str, statement_path: str,
                            num_processes: int = 1,
                            fallback_q: str | None = FALLBACK_Q_PTR,
                            fallback_a: str | None = FALLBACK_A_PTR) -> None:
    """2-hop-all-pair subgraphs over the DDB KG, cid2score=None (cells
    22-23). Empty question/answer concept sets fall back to the reference's
    designated pointers."""
    generate_adj_data_from_grounded_concepts(
        grounded_path, kg_path, output_path, statement_path=statement_path,
        scorer=None, num_processes=num_processes,
        fallback_q=fallback_q, fallback_a=fallback_a)


def sapbert_entity_embeddings(
        vocab_path: str, output_npy_path: str,
        model_name_or_path: str =
        "cambridgeltl/SapBERT-from-PubMedBERT-fulltext",
        batch_size: int = 64, device=None, tokenizer=None) -> np.ndarray:
    """Entity table = SapBERT pooler output tanh(W h[-1][:, 0]) of each
    preferred name (cells 26-28), through the port's TextEncoder read by
    `load_encoder_checkpoint` (no download is attempted). It runs on the
    card unless `device` names another, and raises when there is no card.
    `tokenizer=None` loads transformers.AutoTokenizer from the same path;
    a given one answers tok(list, padding=True, truncation=True,
    return_tensors="pt")."""
    import torch

    from qagnn_tpu_torch.models.hf_loading import load_encoder_checkpoint
    from qagnn_tpu_torch.models.text_encoder import TextEncoder
    from qagnn_tpu_torch.utils.config import resolve_device

    dev = resolve_device(device)
    with open(vocab_path, encoding="utf-8") as f:
        names = [line.strip() for line in f]

    if tokenizer is None:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
    cfg, params = load_encoder_checkpoint(model_name_or_path)
    model = TextEncoder(cfg)
    missing, unexpected = model.load_state_dict(params, strict=False)
    if missing or unexpected:
        raise ValueError(f"{model_name_or_path!r}: encoder weights missing "
                         f"{missing[:5]}, unexpected {unexpected[:5]}")
    model.to(dev).eval()

    chunks = []
    with torch.no_grad():
        for a in range(0, len(names), batch_size):
            enc = tokenizer(names[a:a + batch_size], padding=True,
                            truncation=True, return_tensors="pt")
            pooled = model(enc["input_ids"].to(dev),
                           enc["attention_mask"].to(dev), layer_id=-1)
            chunks.append(pooled.cpu().numpy())   # pooler output
    embs = np.concatenate(chunks).astype(np.float32)
    np.save(output_npy_path, embs)
    return embs


def run_medqa(root: str, nprocs: int = 1,
              linker: Callable[[str], list[dict]] | None = None,
              sapbert_path: str | None = None, device=None,
              tokenizer=None) -> dict[str, float]:
    """End-to-end MedQA routine (raw -> statement -> linked -> grounded ->
    graph), wired into qagnn_tpu_torch.preprocess.driver. Uses the
    dictionary linker against DDB names unless a scispacy linker is
    supplied. With `sapbert_path` it also writes the entity table
    `{root}/ddb/ent_emb.npy` from `{root}/ddb/vocab.txt`
    (`sapbert_entity_embeddings` with `device` and `tokenizer`). Returns
    the host seconds of the KG build, of each split and of the table."""
    seconds = {}
    medqa = f"{root}/medqa_usmle"
    ddb = f"{root}/ddb"
    for sub in ("statement", "grounded", "graph"):
        os.makedirs(f"{medqa}/{sub}", exist_ok=True)

    names_json = f"{ddb}/ddb_names.json"
    relas_json = f"{ddb}/ddb_relas.json"
    kg_npz = f"{ddb}/ddb.kg.npz"
    t0 = time.perf_counter()
    if not os.path.exists(kg_npz):
        construct_ddb_kg(names_json, relas_json, kg_npz)
        build_ddb_vocab(names_json, relas_json,
                        f"{ddb}/vocab.txt", f"{ddb}/ptrs.txt")
    seconds["kg"] = time.perf_counter() - t0

    if linker is None:
        _, _, name_to_ptr, _ = load_ddb(names_json, relas_json)
        linker = DictionaryEntityLinker(name_to_ptr).link
        umls_map = None
    else:
        umls_map = load_umls_to_ddb(f"{ddb}/ddb_to_umls_cui.txt")

    for split in ("train", "dev", "test"):
        raw = (f"{medqa}/raw/questions/US/4_options/"
               f"phrases_no_exclude_{split}.jsonl")
        if not os.path.exists(raw):
            continue
        t0 = time.perf_counter()
        st = f"{medqa}/statement/{split}.statement.jsonl"
        linked = f"{medqa}/statement/{split}.statement.umls_linked.jsonl"
        gr = f"{medqa}/grounded/{split}.grounded.jsonl"
        pk = f"{medqa}/graph/{split}.graph.adj.pk"
        convert_medqa_statements(raw, st, id_prefix=split)
        link_statements(st, linked, linker)
        ground_umls_linked(linked, umls_map, gr)
        generate_medqa_adj_data(gr, kg_npz, pk, statement_path=st,
                                num_processes=nprocs)
        seconds[split] = time.perf_counter() - t0

    if sapbert_path is not None:
        t0 = time.perf_counter()
        sapbert_entity_embeddings(f"{ddb}/vocab.txt", f"{ddb}/ent_emb.npy",
                                  sapbert_path, device=device,
                                  tokenizer=tokenizer)
        seconds["sapbert"] = time.perf_counter() - t0
    return seconds
