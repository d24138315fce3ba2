"""ConceptNet ETL: raw assertions CSV -> English triples -> merged-relation KG.

Counterpart of qagnn_tpu/preprocess/conceptnet.py, line for line: a port of
reference utils/conceptnet.py:16-213 (extract_english, construct_graph) with
identical relation merging, blacklist, inverse-edge and dedup semantics,
emitting a qagnn_tpu_torch.preprocess.kg.KG (.npz, the JAX package's format)
instead of a networkx gpickle, and the GloVe pooling of the reference's
glove_init tail, bug for bug.
"""

from __future__ import annotations

import json

import numpy as np

from qagnn_tpu_torch.preprocess.kg import KG

# reference utils/conceptnet.py:16-34
RELATION_GROUPS = [
    "atlocation/locatednear",
    "capableof",
    "causes/causesdesire/*motivatedbygoal",
    "createdby",
    "desires",
    "antonym/distinctfrom",
    "hascontext",
    "hasproperty",
    "hassubevent/hasfirstsubevent/haslastsubevent/hasprerequisite/entails/mannerof",
    "isa/instanceof/definedas",
    "madeof",
    "notcapableof",
    "notdesires",
    "partof/*hasa",
    "relatedto/similarto/synonym",
    "usedfor",
    "receivesaction",
]

# reference utils/conceptnet.py:36-54 (order matters: relation ids)
MERGED_RELATIONS = [
    "antonym", "atlocation", "capableof", "causes", "createdby", "isa",
    "desires", "hassubevent", "partof", "hascontext", "hasproperty",
    "madeof", "notcapableof", "notdesires", "receivesaction", "relatedto",
    "usedfor",
]

# reference utils/conceptnet.py:57-75 — used by LM scoring prompts
RELATION_TEXT = [
    "is the antonym of", "is at location of", "is capable of", "causes",
    "is created by", "is a kind of", "desires", "has subevent",
    "is part of", "has context", "has property", "is made of",
    "is not capable of", "does not desires", "is", "is related to",
    "is used for",
]

# reference utils/conceptnet.py:165 (construct_graph blacklist)
GRAPH_BLACKLIST = frozenset(
    ["uk", "us", "take", "make", "object", "person", "people"])


def load_merge_relation() -> dict[str, str]:
    """rel-name -> merged name; '*' prefix means swap head/tail
    (reference utils/conceptnet.py:78-88)."""
    mapping = {}
    for line in RELATION_GROUPS:
        ls = line.strip().split("/")
        rel = ls[0]
        for l in ls:
            if l.startswith("*"):
                mapping[l[1:]] = "*" + rel
            else:
                mapping[l] = rel
    return mapping


def del_pos(s: str) -> str:
    """Strip /n /a /v /r part-of-speech suffix (reference :91-99)."""
    if s.endswith(("/n", "/a", "/v", "/r")):
        return s[:-2]
    return s


def extract_english(conceptnet_path: str, output_csv_path: str,
                    output_vocab_path: str) -> None:
    """English triples with merged relations (reference :102-153).

    Output lines: rel \t head \t tail \t weight. Vocabulary in first-seen
    order (this order IS the concept-id assignment downstream).
    """
    relation_mapping = load_merge_relation()
    seen = set()
    vocab = []
    with open(conceptnet_path, encoding="utf8") as fin, \
            open(output_csv_path, "w", encoding="utf8") as fout:
        for line in fin:
            toks = line.strip().split("\t")
            if len(toks) < 5:
                continue
            if not (toks[2].startswith("/c/en/")
                    and toks[3].startswith("/c/en/")):
                continue
            rel = toks[1].split("/")[-1].lower()
            head = del_pos(toks[2]).split("/")[-1].lower()
            tail = del_pos(toks[3]).split("/")[-1].lower()
            if not head.replace("_", "").replace("-", "").isalpha():
                continue
            if not tail.replace("_", "").replace("-", "").isalpha():
                continue
            if rel not in relation_mapping:
                continue
            rel = relation_mapping[rel]
            if rel.startswith("*"):
                head, tail, rel = tail, head, rel[1:]
            weight = json.loads(toks[4])["weight"]
            fout.write(f"{rel}\t{head}\t{tail}\t{weight}\n")
            for w in (head, tail):
                if w not in seen:
                    seen.add(w)
                    vocab.append(w)
    with open(output_vocab_path, "w", encoding="utf8") as f:
        f.write("\n".join(vocab) + "\n")


def construct_graph(cpnet_csv_path: str, cpnet_vocab_path: str,
                    output_path: str, prune: bool = True) -> KG:
    """Build the directed multigraph with inverse relations rel+17
    (reference :156-213): dedup (subj, obj, rel), drop self-loops, and when
    pruning drop blacklisted concepts and 'hascontext' edges."""
    with open(cpnet_vocab_path, encoding="utf8") as f:
        id2concept = [w.strip() for w in f if w.strip()]
    concept2id = {w: i for i, w in enumerate(id2concept)}
    relation2id = {r: i for i, r in enumerate(MERGED_RELATIONS)}
    n_rel = len(MERGED_RELATIONS)

    srcs, dsts, rels = [], [], []
    attrs = set()
    with open(cpnet_csv_path, encoding="utf8") as fin:
        for line in fin:
            ls = line.strip().split("\t")
            if len(ls) < 4:
                continue
            rel = relation2id[ls[0]]
            subj = concept2id[ls[1]]
            obj = concept2id[ls[2]]
            if prune and (ls[1] in GRAPH_BLACKLIST or ls[2] in GRAPH_BLACKLIST
                          or MERGED_RELATIONS[rel] == "hascontext"):
                continue
            if subj == obj:
                continue
            if (subj, obj, rel) not in attrs:
                srcs.append(subj); dsts.append(obj); rels.append(rel)
                attrs.add((subj, obj, rel))
                srcs.append(obj); dsts.append(subj); rels.append(rel + n_rel)
                attrs.add((obj, subj, rel + n_rel))

    kg = KG(n_nodes=len(id2concept), n_base_rels=n_rel,
            edge_src=np.asarray(srcs, np.int32),
            edge_dst=np.asarray(dsts, np.int32),
            edge_rel=np.asarray(rels, np.int16),
            id2concept=id2concept)
    if output_path:
        kg.save(output_path)
    return kg


def glove_init(glove_txt_path: str, output_npy_path: str,
               vocab_path: str) -> None:
    """GloVe text table -> .npy + vocab (reference utils/conceptnet.py:
    216-246 head of glove_init)."""
    words, vectors = [], []
    with open(glove_txt_path, "rb") as f:
        for line in f:
            fields = line.split()
            if len(fields) <= 2:
                continue
            words.append(fields[0].decode("utf-8"))
            vectors.append(np.fromiter((float(x) for x in fields[1:]),
                                       dtype=np.float64))
    np.save(output_npy_path, np.asarray(vectors, dtype=np.float32))
    with open(vocab_path, "w", encoding="utf-8") as f:
        f.write("\n".join(words))


def create_embeddings_glove(triple_corpus_path: str, glove_npy_path: str,
                            glove_vocab_path: str, output_dir: str,
                            output_prefix: str, pooling: str = "max",
                            dim: int = 100):
    """Concept/relation embeddings pooled from a triple-string corpus —
    the tail of the reference's glove_init (utils/conceptnet.py:262-384
    create_embeddings_glove), exact math:

      * OOV words embed as zeros
      * concepts: running max-pool ("max") or overwrite-with-avg ("avg")
        of their word vectors per mention
      * relations: weighted running average of per-mention encodings;
        "max" pools the non-subject/object context words per mention;
        "avg" uses obj-avg minus subj-avg (or full-string residual for the
        symmetric relations relatedto/antonym)

    Writes concept.{prefix}.{pooling}.npy / relation.{prefix}.{pooling}.npy
    plus tab-separated count vocab files, in corpus first-seen order.
    Returns (concept_emb dict, rel_emb dict).
    """
    import json as _json

    vectors = np.load(glove_npy_path)
    with open(glove_vocab_path, encoding="utf-8") as f:
        vocab = [l.strip() for l in f]
    glove = {w: vectors[i] for i, w in enumerate(vocab)}
    zero = np.zeros((dim,))

    with open(triple_corpus_path, encoding="utf-8") as f:
        triples = _json.load(f)

    c_emb: dict[str, np.ndarray] = {}
    c_cnt: dict[str, int] = {}
    r_emb: dict[str, np.ndarray] = {}
    r_cnt: dict[str, int] = {}

    for data in triples:
        words = data["string"].strip().split(" ")
        rel = data["rel"]
        ss, se = data["subj_start"], data["subj_end"]
        os_, oe = data["obj_start"], data["obj_end"]
        subj_words, obj_words = words[ss:se], words[os_:oe]
        subj, obj = " ".join(subj_words), " ".join(obj_words)

        for k, d, c in ((subj, c_emb, c_cnt), (obj, c_emb, c_cnt),
                        (rel, r_emb, r_cnt)):
            if k not in d:
                d[k] = np.zeros((dim,))
                c[k] = 0
            c[k] += 1

        if pooling == "avg":
            # NOTE: the reference iterates CHARACTERS of the joined string
            # here (`for word in subj` where subj is a str) — reproduced
            # bug-for-bug since the output is a data contract
            subj_sum = sum((glove.get(w, zero) for w in subj), zero)
            obj_sum = sum((glove.get(w, zero) for w in obj), zero)
            if rel in ("relatedto", "antonym"):   # symmetric relation
                rel_sum = sum((glove.get(w, zero) for w in words),
                              zero) - subj_sum - obj_sum
            else:
                rel_sum = obj_sum - subj_sum
            subj_len, obj_len = se - ss, oe - os_
            c_emb[subj] = subj_sum / subj_len
            c_emb[obj] = obj_sum / obj_len
            rel_enc = rel_sum / (len(words) - subj_len - obj_len)
            n = r_cnt[rel]
            r_emb[rel] = ((n - 1) / n) * r_emb[rel] + rel_enc / n
        elif pooling == "max":
            subj_enc = np.amax([glove.get(w, zero) for w in subj_words],
                               axis=0)
            obj_enc = np.amax([glove.get(w, zero) for w in obj_words],
                              axis=0)
            ctx = [glove.get(words[j], zero) for j in range(len(words))
                   if not (ss <= j < se or os_ <= j < oe)]
            rel_enc = np.amax(ctx, axis=0)
            c_emb[subj] = np.maximum(c_emb[subj], subj_enc)
            c_emb[obj] = np.maximum(c_emb[obj], obj_enc)
            n = r_cnt[rel]
            r_emb[rel] = ((n - 1) / n) * r_emb[rel] + rel_enc / n
        else:
            raise ValueError(f"unknown pooling {pooling!r}")

    def write(emb, cnt, npy_path, vocab_path):
        np.save(npy_path, np.array(list(emb.values()), dtype="float32"))
        with open(vocab_path, "w", encoding="utf-8") as f:
            f.write("\n".join(f"{w}\t{cnt[w]}" for w in emb))

    write(c_emb, c_cnt,
          f"{output_dir}/concept.{output_prefix}.{pooling}.npy",
          f"{output_dir}/concept.glove.{pooling}.txt")
    write(r_emb, r_cnt,
          f"{output_dir}/relation.{output_prefix}.{pooling}.npy",
          f"{output_dir}/relation.glove.{pooling}.txt")
    return c_emb, r_emb
