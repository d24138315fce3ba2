"""The port's preprocessing vertical against the JAX package's (CPU).

qagnn_tpu_torch.preprocess is host numpy / Python where qagnn_tpu.preprocess
is, and its outputs are data contracts (the English triples and vocabulary,
the .npz KG, statement and grounded jsonl, GloVe tables, the .pk rows the
loaders read), so every module is held to EXACT equality with the JAX
package's on the same seeded inputs: files byte for byte, arrays value for
value and dtype for dtype, pickled rows field for field (cid2score in
order). The whole vertical runs under one deterministic scorer (ties
included) in both packages, and the port's with 1 and with 2 worker
processes. The fixtures' raw assertions are `tests/test_preprocess.py`'s.
"""

import json
import pickle

import numpy as np
import pytest

from qagnn_tpu.preprocess import conceptnet as jax_conceptnet
from qagnn_tpu.preprocess import convert as jax_convert
from qagnn_tpu.preprocess import driver as jax_driver
from qagnn_tpu.preprocess import graph_extraction as jax_graphs
from qagnn_tpu.preprocess import grounding as jax_grounding
from qagnn_tpu.preprocess import kg as jax_kg
from qagnn_tpu.preprocess import lemma as jax_lemma

import qagnn_tpu_torch.preprocess as port_package
from qagnn_tpu_torch.data.graphs import load_graph_pk
from qagnn_tpu_torch.preprocess import conceptnet, convert, driver, grounding
from qagnn_tpu_torch.preprocess import graph_extraction as graphs
from qagnn_tpu_torch.preprocess import kg as port_kg
from qagnn_tpu_torch.preprocess import lemma

RAW_ASSERTIONS = [
    # (uri-rel, head, tail) — weight 1.0
    ("/r/AtLocation", "/c/en/lantern", "/c/en/antique_shop"),
    ("/r/AtLocation", "/c/en/lantern", "/c/en/house"),
    ("/r/AtLocation", "/c/en/lantern", "/c/en/dark_place"),
    ("/r/UsedFor", "/c/en/lantern/n", "/c/en/light"),
    ("/r/RelatedTo", "/c/en/house", "/c/en/light"),
    ("/r/RelatedTo", "/c/en/antique_shop", "/c/en/light"),
    ("/r/IsA", "/c/en/house", "/c/en/building"),
    ("/r/HasA", "/c/en/house", "/c/en/roof"),       # *partof swap
    ("/r/MotivatedByGoal", "/c/en/run", "/c/en/health"),  # *causes swap
    ("/r/HasContext", "/c/en/light", "/c/en/physics"),    # pruned edge
    ("/r/IsA", "/c/en/cat", "/c/en/animal"),
    ("/r/NotARelation", "/c/en/cat", "/c/en/dog"),        # dropped rel
    ("/r/IsA", "/c/en/voiture", "/c/fr/vehicule"),        # non-English tail
    # beyond tests/test_preprocess.py: duplicates, a self-loop, a
    # blacklisted concept, a part-of-speech suffix on the tail, a
    # non-alphabetic head, and a second relation between one pair
    ("/r/AtLocation", "/c/en/lantern", "/c/en/house"),
    ("/r/RelatedTo", "/c/en/cat", "/c/en/cat"),
    ("/r/IsA", "/c/en/person", "/c/en/animal"),
    ("/r/RelatedTo", "/c/en/dog", "/c/en/animal/n"),
    ("/r/RelatedTo", "/c/en/r2d2", "/c/en/dog"),
    ("/r/UsedFor", "/c/en/house", "/c/en/light"),
    ("/r/Synonym", "/c/en/dark_place", "/c/en/cave"),
    ("/r/PartOf", "/c/en/roof", "/c/en/building"),
]

CSQA = [
    {"id": "q1", "answerKey": "B",
     "question": {"stem": "If a lantern is not for sale, where is it likely "
                          "to be?",
                  "choices": [{"label": "A", "text": "antique shop"},
                              {"label": "B", "text": "house"},
                              {"label": "C", "text": "dark place"}]}},
    {"id": "q2", "answerKey": "A",
     "question": {"stem": "What is a cat?",
                  "choices": [{"label": "A", "text": "animal"},
                              {"label": "B", "text": "building"},
                              {"label": "C", "text": "roof"}]}},
    {"id": "q3", "answerKey": "C",
     "question": {"stem": "The lanterns lit the dark place of the house "
                          "where people run",
                  "choices": [{"label": "A", "text": "cave"},
                              {"label": "B", "text": "light"},
                              {"label": "C", "text": "health"}]}},
]

QUESTIONS = [
    "Where would you find a lantern?",
    "If a lantern is not for sale, where is it likely to be?",
    "What's the best way to light a dark place?",
    "Which of the following is a kind of building?",
    "Who is the person who runs the antique shop?",
    "The people who make lanterns are called what?",
    "What do you call them called?",
    "He was a lantern maker, meaning he was not?",
    "The U.S. houses are mostly one of these?",
    "The sky is blue",
    "A roof is part of this ?",
    "how does a cat see in the dark.",
    "When did the house get its roof?",
    "John went to the store, why?",
    "whats in the box",
]


def _write_raw(path, assertions=RAW_ASSERTIONS):
    with open(path, "w") as f:
        for rel, h, t in assertions:
            f.write("\t".join(["/a/x", rel, h, t,
                               json.dumps({"weight": 1.0})]) + "\n")


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _build(mod, root):
    en_csv, vocab, kg_npz = (str(root / n) for n in
                             ("en.csv", "concept.txt", "kg.npz"))
    mod.extract_english(str(root.parent / "assertions.csv"), en_csv, vocab)
    kg = mod.construct_graph(en_csv, vocab, kg_npz, prune=True)
    return en_csv, vocab, kg_npz, kg


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The raw assertions through each package's extract_english and
    construct_graph, in directories of their own."""
    root = tmp_path_factory.mktemp("prep")
    _write_raw(root / "assertions.csv")
    (root / "jax").mkdir()
    (root / "port").mkdir()
    return {"jax": _build(jax_conceptnet, root / "jax"),
            "port": _build(conceptnet, root / "port")}


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def _same_kg(a, b):
    assert (a.n_nodes, a.n_base_rels) == (b.n_nodes, b.n_base_rels)
    assert a.id2concept == b.id2concept
    for name in ("edge_src", "edge_dst", "edge_rel"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _same_rows(a, b):
    """Pickled schema-graph rows, field for field."""
    assert len(a) == len(b)
    for i, (r, s) in enumerate(zip(a, b)):
        assert r.keys() == s.keys(), i
        assert type(r["adj"]) is type(s["adj"]), i
        assert r["adj"].shape == s["adj"].shape, i
        for f in ("row", "col", "data"):
            x, y = getattr(r["adj"], f), getattr(s["adj"], f)
            assert x.dtype == y.dtype, (i, f)
            np.testing.assert_array_equal(x, y, err_msg=f"{i} {f}")
        for f in ("concepts", "qmask", "amask"):
            assert r[f].dtype == s[f].dtype, (i, f)
            np.testing.assert_array_equal(r[f], s[f], err_msg=f"{i} {f}")
        if r["cid2score"] is None:
            assert s["cid2score"] is None, i
        else:
            assert list(r["cid2score"].items()) == \
                list(s["cid2score"].items()), i


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_package_exports_match_jax():
    from qagnn_tpu import preprocess as jax_package
    assert port_package.__all__ == jax_package.__all__
    assert conceptnet.MERGED_RELATIONS == jax_conceptnet.MERGED_RELATIONS
    assert conceptnet.RELATION_TEXT == jax_conceptnet.RELATION_TEXT
    assert conceptnet.load_merge_relation() == \
        jax_conceptnet.load_merge_relation()


@pytest.mark.parametrize("name", ["en.csv", "concept.txt"])
def test_extract_english_writes_the_jax_files(pipeline, name):
    jax_dir = pipeline["jax"][0].rsplit("/", 1)[0]
    port_dir = pipeline["port"][0].rsplit("/", 1)[0]
    _same_file(f"{jax_dir}/{name}", f"{port_dir}/{name}")


def test_extract_english_merges_and_swaps(pipeline):
    en_csv = pipeline["port"][0]
    rows = [l.split("\t") for l in open(en_csv).read().splitlines()]
    rels = {r[0] for r in rows}
    assert "atlocation" in rels and "usedfor" in rels
    assert "hasa" not in rels and "partof" in rels       # merged+swapped
    assert ["partof", "roof", "house", "1.0"] in rows
    assert ["causes", "health", "run", "1.0"] in rows    # *motivatedbygoal
    assert not any("voiture" in r for r in rows)
    assert not any(r[0] == "notarelation" for r in rows)
    assert not any("r2d2" in r for r in rows)             # non-alphabetic
    assert ["relatedto", "dog", "animal", "1.0"] in rows  # /n stripped


@pytest.mark.parametrize("prune", [True, False])
def test_construct_graph_matches_jax(pipeline, tmp_path, prune):
    en_csv, vocab = pipeline["port"][:2]
    a = jax_conceptnet.construct_graph(en_csv, vocab, str(tmp_path / "j"),
                                       prune=prune)
    b = conceptnet.construct_graph(en_csv, vocab, str(tmp_path / "p"),
                                   prune=prune)
    _same_kg(a, b)
    c2i = b.concept2id
    n = len(conceptnet.MERGED_RELATIONS)
    has_context = b.rels_between(c2i["light"], c2i["physics"]).tolist()
    assert has_context == ([] if prune else
                           [conceptnet.MERGED_RELATIONS.index("hascontext")])
    fr = b.rels_between(c2i["lantern"], c2i["house"]).tolist()
    assert fr == [conceptnet.MERGED_RELATIONS.index("atlocation")]  # dedup
    inv = b.rels_between(c2i["house"], c2i["lantern"]).tolist()
    assert inv == [conceptnet.MERGED_RELATIONS.index("atlocation") + n]
    assert len(b.rels_between(c2i["cat"], c2i["cat"])) == 0  # self-loop
    if prune:
        assert len(b.rels_between(c2i["person"], c2i["animal"])) == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_kg_npz_loads_in_both_packages(pipeline, writer):
    kg_npz = pipeline[writer][2]
    for mod in (jax_kg, port_kg):
        _same_kg(mod.KG.load(kg_npz), pipeline["jax"][3])


def _random_kg(seed, n_nodes, n_edges):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, max(n_nodes // 2, 1), n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    rel = rng.integers(0, 34, n_edges).astype(np.int16)
    return dict(n_nodes=n_nodes, n_base_rels=17, edge_src=src, edge_dst=dst,
                edge_rel=rel, id2concept=[f"c{i}" for i in range(n_nodes)])


@pytest.mark.parametrize("case", ["pipeline", "random", "dense", "no_edges",
                                  "no_nodes"])
def test_build_indices_matches_jax(pipeline, case):
    """The port's whole-array build_indices against the JAX per-node loop:
    every CSR array, dtype for dtype (nodes without edges, duplicate
    edges, repeated neighbors included)."""
    if case == "pipeline":
        kw = {f: getattr(pipeline["jax"][3], f) for f in
              ("n_nodes", "n_base_rels", "edge_src", "edge_dst", "edge_rel",
               "id2concept")}
    else:
        kw = _random_kg(*{"random": (0, 300, 2000), "dense": (1, 12, 500),
                          "no_edges": (2, 7, 0), "no_nodes": (3, 0, 0)}[case])
    a, b = jax_kg.KG(**kw), port_kg.KG(**kw)
    a.build_indices()
    b.build_indices()
    for name in ("_csr_offsets", "_csr_dst", "_csr_rel", "_nbr_offsets",
                 "_nbr_ids"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for u in range(0, kw["n_nodes"], 7):
        np.testing.assert_array_equal(a.neighbors(u), b.neighbors(u))


@pytest.mark.parametrize("question", QUESTIONS)
def test_wh_word_blanking_matches_jax(question):
    for fn in ("replace_wh_word_with_blank", "get_fitb_from_question"):
        assert getattr(convert, fn)(question) == \
            getattr(jax_convert, fn)(question), fn
    fitb = jax_convert.get_fitb_from_question(question)
    for choice in ("antique shop", "House.", "a dark place"):
        assert convert.create_hypothesis(fitb, choice) == \
            jax_convert.create_hypothesis(fitb, choice)


def test_convert_to_entailment_matches_jax(tmp_path):
    raw = tmp_path / "raw.jsonl"
    _write_jsonl(raw, CSQA + [{"id": f"w{i}", "question": {
        "stem": q, "choices": [{"label": "A", "text": "lantern"},
                               {"label": "B", "text": "Dark place."}]}}
        for i, q in enumerate(QUESTIONS)])
    jax_convert.convert_to_entailment(str(raw), str(tmp_path / "j.jsonl"))
    convert.convert_to_entailment(str(raw), str(tmp_path / "p.jsonl"))
    _same_file(tmp_path / "j.jsonl", tmp_path / "p.jsonl")


@pytest.mark.parametrize("two_outputs", [False, True])
def test_convert_to_obqa_statement_matches_jax(tmp_path, two_outputs):
    raw = tmp_path / "raw.jsonl"
    _write_jsonl(raw, CSQA)
    outs = {}
    for tag, mod in (("j", jax_convert), ("p", convert)):
        second = str(tmp_path / f"{tag}2.jsonl") if two_outputs else None
        mod.convert_to_obqa_statement(str(raw), str(tmp_path / f"{tag}.jsonl"),
                                      second)
        outs[tag] = [tmp_path / f"{tag}.jsonl"] + (
            [tmp_path / f"{tag}2.jsonl"] if two_outputs else [])
    for a, b in zip(outs["j"], outs["p"]):
        _same_file(a, b)


def _word_list(seed=0, n_random=3000):
    """Words that reach every rule of `normalize`: the tables, suffix
    cases, and seeded letter strings ending in the rules' suffixes."""
    words = sorted(jax_lemma.IRREGULARS) + sorted(jax_lemma.STOPWORDS) + [
        "cats", "running", "houses", "went", "cities", "boxes", "classes",
        "buses", "basis", "making", "baking", "lived", "hopped", "filled",
        "fizzed", "kissed", "caring", "sing", "bed", "used", "hoping",
        "hopping", "agreed", "flies", "dies", "ties", "wishes", "churches",
        "axes", "quizzes", "glasses", "corpus", "is", "as", "CAT", "Dogs",
        "a", "an", "I", "", "seeing", "fixed", "played", "rowing"]
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    suffixes = ["", "s", "es", "ies", "ing", "ed", "ss", "us", "is", "sses",
                "shes", "ches", "xes", "zes", "e", "er"]
    for _ in range(n_random):
        stem = "".join(rng.choice(letters, int(rng.integers(1, 8))))
        words.append(stem + suffixes[int(rng.integers(len(suffixes)))])
    return words


def test_normalize_matches_jax():
    words = _word_list()
    assert [lemma.normalize(w) for w in words] == \
        [jax_lemma.normalize(w) for w in words]
    for name in ("STOPWORDS", "EXTRA_STOPWORDS", "GROUND_BLACKLIST",
                 "PRONOUNS", "IRREGULARS"):
        assert getattr(lemma, name) == getattr(jax_lemma, name), name


@pytest.mark.parametrize("text", QUESTIONS + [
    "Where's the Cat? It's 42 o'clock, isn't it -- the lanterns' light!",
    "antique_shop dark-place U.S.A. 3.14 don't",
    " ".join(_word_list(1, 200))])
def test_tokenize_matches_jax(text):
    assert lemma.tokenize(text) == jax_lemma.tokenize(text)


def test_matcher_matches_jax(pipeline):
    vocab = pipeline["port"][1]
    a = jax_grounding.create_matcher(vocab)
    b = grounding.create_matcher(vocab)
    assert a.patterns == b.patterns and a.vocab == b.vocab
    for text in QUESTIONS:
        toks = lemma.tokenize(text)
        assert a.match(toks) == b.match(toks)
        for ans in ("antique shop", "house", "dark place", "nothing"):
            assert jax_grounding.ground_qa_pair(a, text, ans) == \
                grounding.ground_qa_pair(b, text, ans)


@pytest.fixture(scope="module")
def statements(tmp_path_factory):
    root = tmp_path_factory.mktemp("statements")
    _write_jsonl(root / "raw.jsonl", CSQA)
    st = str(root / "train.statement.jsonl")
    convert.convert_to_entailment(str(root / "raw.jsonl"), st)
    return st


@pytest.mark.parametrize("nprocs", [1, 2])
def test_ground_matches_jax(pipeline, statements, tmp_path, nprocs):
    vocab = pipeline["port"][1]
    jax_grounding.ground(statements, vocab, str(tmp_path / "j.jsonl"),
                         num_processes=1)
    grounding.ground(statements, vocab, str(tmp_path / "p.jsonl"),
                     num_processes=nprocs)
    _same_file(tmp_path / "j.jsonl", tmp_path / "p.jsonl")
    rows = [json.loads(l) for l in open(tmp_path / "p.jsonl")]
    assert len(rows) == 9 and all(r["ac"] for r in rows[:3])


def deterministic_scorer(question, names):
    """Scores from the text alone, with ties (a scorer both packages run
    alike, so the rows must be equal)."""
    return [-float(len(question) % 3) if n is None else -float(len(n) % 4)
            for n in names]


@pytest.mark.parametrize("scorer", ["deterministic", "uniform", "none"])
@pytest.mark.parametrize("nprocs", [1, 2])
def test_graph_rows_match_jax(pipeline, statements, tmp_path, scorer, nprocs):
    vocab, kg_npz = pipeline["port"][1], pipeline["port"][2]
    gr = str(tmp_path / "train.grounded.jsonl")
    grounding.ground(statements, vocab, gr, num_processes=1)
    fn = {"deterministic": deterministic_scorer,
          "uniform": graphs.default_uniform_scorer, "none": None}[scorer]
    jax_graphs.generate_adj_data_from_grounded_concepts(
        gr, kg_npz, str(tmp_path / "j.pk"), statement_path=statements,
        scorer=fn, num_processes=1)
    seconds = graphs.generate_adj_data_from_grounded_concepts(
        gr, kg_npz, str(tmp_path / "p.pk"), statement_path=statements,
        scorer=fn, num_processes=nprocs)
    assert set(seconds) == {"part1", "part2", "part3"}
    rows = _load(tmp_path / "p.pk")
    _same_rows(_load(tmp_path / "j.pk"), rows)
    assert any(len(r["concepts"]) > r["qmask"].sum() + r["amask"].sum()
               for r in rows)                   # some rows have extra nodes
    if fn is not None:
        for r in rows:
            assert set(r["cid2score"]) == set(r["concepts"].tolist()) | {-1}


def test_graph_helpers_match_jax(pipeline):
    kg = pipeline["port"][3]
    kg.build_indices()
    c2i = kg.concept2id
    nodes = {c2i[c] for c in ("lantern", "house", "light", "dark_place")}
    extra = graphs.extra_nodes_2hop_all_pair(kg, nodes)
    assert extra == jax_graphs.extra_nodes_2hop_all_pair(kg, nodes)
    assert extra
    ids = sorted(nodes) + extra
    a, ca = jax_graphs.concepts_to_adj(kg, ids)
    b, cb = graphs.concepts_to_adj(kg, ids)
    np.testing.assert_array_equal(a.toarray(), b.toarray())
    np.testing.assert_array_equal(ca, cb)
    assert graphs.score_nodes(kg, "q", ids, deterministic_scorer) == \
        jax_graphs.score_nodes(kg, "q", ids, deterministic_scorer)


def _write_dataset_root(root, dataset):
    (root / "cpnet").mkdir(parents=True)
    _write_raw(root / "cpnet" / "conceptnet-assertions-5.6.0.csv")
    names = driver.DATASET_RAW[dataset]
    (root / dataset).mkdir()
    for split, rows in (("train", CSQA), ("dev", CSQA[:1])):
        _write_jsonl(root / dataset / names[split], rows)


@pytest.mark.parametrize("dataset", ["csqa", "obqa"])
def test_driver_writes_the_jax_files(tmp_path, dataset):
    """run_common + run_dataset with the uniform scorer against the JAX
    driver: every file each writes, byte for byte (the .pk rows field for
    field), the splits present only."""
    assert driver.DATASET_RAW == jax_driver.DATASET_RAW
    for tag, mod, nprocs in (("jax", jax_driver, 1), ("port", driver, 2)):
        _write_dataset_root(tmp_path / tag, dataset)
        mod.run_common(str(tmp_path / tag), nprocs)
        mod.run_dataset(dataset, str(tmp_path / tag), nprocs)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*")
                           if p.is_file())
    assert {f.as_posix() for f in files} >= {
        f"{dataset}/graph/train.graph.adj.pk",
        f"{dataset}/graph/dev.graph.adj.pk", "cpnet/conceptnet.en.kg.npz"}
    for f in files:
        if f.suffix == ".pk":
            _same_rows(_load(tmp_path / "jax" / f),
                       _load(tmp_path / "port" / f))
        elif f.suffix == ".npz":
            _same_kg(jax_kg.KG.load(str(tmp_path / "jax" / f)),
                     port_kg.KG.load(str(tmp_path / "port" / f)))
        else:
            _same_file(tmp_path / "jax" / f, tmp_path / "port" / f)
    data = load_graph_pk(str(tmp_path / "port" / dataset / "graph" /
                             "train.graph.adj.pk"), max_node_num=10,
                         use_cache=False)
    assert len(data) == 9
    assert data.n_relations == 2 * (len(conceptnet.MERGED_RELATIONS) + 2)


def test_driver_main_runs_host_routines_without_a_card(tmp_path, monkeypatch):
    """Without --lm-scorer / --sapbert nothing runs a model, so the driver
    needs no card and no --device."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _write_dataset_root(tmp_path, "obqa")
    driver.main(["--run", "common", "obqa", "--data-root", str(tmp_path)])
    assert (tmp_path / "obqa" / "graph" / "dev.graph.adj.pk").exists()


GLOVE_WORDS = ["the", "cat", "big", "dog", "chases", "is", "a", "of", "b",
               "i", "g", "t"]
CORPUS = [
    {"string": "the big cat chases a dog", "rel": "atlocation",
     "subj_start": 1, "subj_end": 3, "obj_start": 5, "obj_end": 6},
    {"string": "a dog is a zebra friend", "rel": "relatedto",
     "subj_start": 1, "subj_end": 2, "obj_start": 4, "obj_end": 6},
    {"string": "the big cat is big", "rel": "atlocation",
     "subj_start": 1, "subj_end": 3, "obj_start": 4, "obj_end": 5},
    {"string": "dog is the antonym of cat", "rel": "antonym",
     "subj_start": 0, "subj_end": 1, "obj_start": 5, "obj_end": 6},
    {"string": "the cat is a kind of big dog", "rel": "isa",
     "subj_start": 0, "subj_end": 2, "obj_start": 6, "obj_end": 8},
]


@pytest.mark.parametrize("pooling", ["max", "avg"])
def test_glove_embeddings_match_jax(tmp_path, pooling):
    """glove_init and create_embeddings_glove (the "avg" pooling's
    character iteration included) against the JAX package, file for file,
    on a local GloVe table with an OOV word and single-letter rows."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((len(GLOVE_WORDS), 4)).round(3)
    glove_txt = tmp_path / "glove.txt"
    with open(glove_txt, "w") as f:
        for w, v in zip(GLOVE_WORDS, table):
            f.write(w + " " + " ".join(str(x) for x in v) + "\n")
        f.write("short 1.0\n")                   # skipped: <= 2 fields
    corpus = tmp_path / "tp_str_corpus.json"
    corpus.write_text(json.dumps(CORPUS))
    results = {}
    for tag, mod in (("jax", jax_conceptnet), ("port", conceptnet)):
        d = tmp_path / tag
        d.mkdir()
        mod.glove_init(str(glove_txt), str(d / "emb.npy"),
                       str(d / "emb.vocab.txt"))
        results[tag] = mod.create_embeddings_glove(
            str(corpus), str(d / "emb.npy"), str(d / "emb.vocab.txt"),
            str(d), "emb", pooling=pooling, dim=4)
    for name in ("emb.npy", f"concept.emb.{pooling}.npy",
                 f"relation.emb.{pooling}.npy"):
        a, b = np.load(tmp_path / "jax" / name), np.load(
            tmp_path / "port" / name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("emb.vocab.txt", f"concept.glove.{pooling}.txt",
                 f"relation.glove.{pooling}.txt"):
        _same_file(tmp_path / "jax" / name, tmp_path / "port" / name)
    for j, p in zip(results["jax"], results["port"]):
        assert list(j) == list(p)
        for k in j:
            np.testing.assert_array_equal(j[k], p[k])


def test_glove_unknown_pooling_raises(tmp_path):
    (tmp_path / "c.json").write_text(json.dumps(CORPUS[:1]))
    np.save(tmp_path / "g.npy", np.zeros((1, 4), np.float32))
    (tmp_path / "g.txt").write_text("the")
    with pytest.raises(ValueError, match="unknown pooling"):
        conceptnet.create_embeddings_glove(
            str(tmp_path / "c.json"), str(tmp_path / "g.npy"),
            str(tmp_path / "g.txt"), str(tmp_path), "x", pooling="sum",
            dim=4)
