"""The port's MedQA / DDB preprocessing against the JAX package's (CPU).

Every host function of qagnn_tpu_torch.preprocess.biomed is held to EXACT
equality with qagnn_tpu.preprocess.biomed on the `ddb_dir` tables of
`tests/test_biomed.py` (files byte for byte, KG arrays, pickled rows field
for field), `run_medqa` end to end with 1 and 2 worker processes. The
SapBERT entity table runs the port's TextEncoder against the JAX function's
HF BertModel on a tiny random BERT whose tokenizer truncates, within
1e-5 x max|emb| (f32; the two sum the same products in other orders).
"""

import json
import pickle

import numpy as np
import pytest
import torch

from qagnn_tpu.preprocess import biomed as jax_biomed

from qagnn_tpu_torch.data.graphs import load_graph_pk
from qagnn_tpu_torch.preprocess import biomed

EMB_TOL = 1e-5

NAMES = {
    "Ethanol": ["100", "1"],
    "alcohol": ["100", "0"],
    "Cirrhosis": ["200", "1"],
    "Liver disease": ["300", "1"],
    "Aspirin": ["400", "1"],
    "Fallback Q": ["31770", "1"],
    "Fallback A": ["325", "1"],
}
RELAS = {
    "r1": ["100", "200", "2"],    # ethanol may_cause cirrhosis
    "r2": ["200", "300", "3"],    # cirrhosis is_a_subtype_of liver disease
    "r3": ["100", "300", "4"],    # ethanol is_a_risk_factor_of liver dis.
    "r4": ["400", "100", "12"],   # aspirin interacts_with ethanol
    "bad": ["100", "999", "2"],   # dangling pointer -> dropped
    "odd": ["200", "400", "99"],  # unknown relation code -> dropped
}
MEDQA = [
    {"question": "A patient with cirrhosis drinks alcohol daily. "
                 "Which drug interacts?",
     "options": {"A": "Aspirin", "B": "Water", "C": "Sugar", "D": "Salt"},
     "answer_idx": "A"},
    {"question": "Totally ungroundable question?",
     "options": {"A": "nothing", "B": "here", "C": "at", "D": "all"},
     "answer_idx": "B"},
    {"question": "Ethanol use is a risk factor of which liver disease?",
     "options": {"A": "Cirrhosis", "B": "Liver disease", "C": "Aspirin",
                 "D": "Ethanol"},
     "answer_idx": "A"},
]


@pytest.fixture
def ddb_dir(tmp_path):
    ddb = tmp_path / "ddb"
    ddb.mkdir()
    (ddb / "ddb_names.json").write_text(json.dumps(NAMES))
    (ddb / "ddb_relas.json").write_text(json.dumps(RELAS))
    return ddb


def _paths(ddb):
    return str(ddb / "ddb_names.json"), str(ddb / "ddb_relas.json")


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_rows(a, b):
    assert len(a) == len(b)
    for r, s in zip(a, b):
        assert r.keys() == s.keys()
        np.testing.assert_array_equal(r["adj"].toarray(), s["adj"].toarray())
        assert r["adj"].shape == s["adj"].shape
        for f in ("concepts", "qmask", "amask"):
            assert r[f].dtype == s[f].dtype
            np.testing.assert_array_equal(r[f], s[f])
        assert r["cid2score"] == s["cid2score"]


def test_constants_match_jax():
    assert biomed.DDB_MERGED_RELATIONS == jax_biomed.DDB_MERGED_RELATIONS
    assert biomed.DDB_RELATION_CODE_MAP == jax_biomed.DDB_RELATION_CODE_MAP
    assert (biomed.FALLBACK_Q_PTR, biomed.FALLBACK_A_PTR) == \
        (jax_biomed.FALLBACK_Q_PTR, jax_biomed.FALLBACK_A_PTR)


def test_load_ddb_matches_jax(ddb_dir):
    assert biomed.load_ddb(*_paths(ddb_dir)) == \
        jax_biomed.load_ddb(*_paths(ddb_dir))


def test_build_ddb_vocab_matches_jax(ddb_dir, tmp_path):
    out = {}
    for tag, mod in (("j", jax_biomed), ("p", biomed)):
        out[tag] = mod.build_ddb_vocab(*_paths(ddb_dir),
                                       str(tmp_path / f"{tag}.vocab.txt"),
                                       str(tmp_path / f"{tag}.ptrs.txt"))
    assert out["j"] == out["p"]
    for name in ("vocab", "ptrs"):
        _same_file(tmp_path / f"j.{name}.txt", tmp_path / f"p.{name}.txt")


def test_construct_ddb_kg_matches_jax(ddb_dir, tmp_path):
    a = jax_biomed.construct_ddb_kg(*_paths(ddb_dir), str(tmp_path / "j"))
    b = biomed.construct_ddb_kg(*_paths(ddb_dir), str(tmp_path / "p.npz"))
    assert (a.n_nodes, a.n_base_rels, a.id2concept) == \
        (b.n_nodes, b.n_base_rels, b.id2concept)
    for name in ("edge_src", "edge_dst", "edge_rel"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert len(b.edge_src) == 8                 # 4 valid relations x 2
    c2i = b.concept2id
    assert 2 in b.rels_between(c2i["100"], c2i["200"])
    assert 17 in b.rels_between(c2i["200"], c2i["100"])


def test_umls_to_ddb_matches_jax(tmp_path):
    p = tmp_path / "ddb_to_umls_cui.txt"
    p.write_text("header\tddb\tcui\nx\t100\tC0001975\nx\t200\tC0023890\n"
                 "short\n")
    assert biomed.load_umls_to_ddb(str(p)) == \
        jax_biomed.load_umls_to_ddb(str(p)) == \
        {"C0001975": "100", "C0023890": "200"}


@pytest.mark.parametrize("sentence", [
    "Chronic alcohol use causes liver disease.",
    "ETHANOL and aspirin; cirrhosis-like liver disease liver",
    "nothing to link here", ""])
def test_dictionary_linker_matches_jax(ddb_dir, sentence):
    _, _, name_to_ptr, _ = biomed.load_ddb(*_paths(ddb_dir))
    for max_len in (1, 6):
        assert biomed.DictionaryEntityLinker(name_to_ptr, max_len).link(
            sentence) == jax_biomed.DictionaryEntityLinker(
                name_to_ptr, max_len).link(sentence)


def _write_raw(root, split="dev", rows=MEDQA):
    raw_dir = root / "medqa_usmle" / "raw" / "questions" / "US" / "4_options"
    raw_dir.mkdir(parents=True, exist_ok=True)
    with open(raw_dir / f"phrases_no_exclude_{split}.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return raw_dir / f"phrases_no_exclude_{split}.jsonl"


@pytest.mark.parametrize("umls", [False, True])
def test_statements_linking_grounding_match_jax(ddb_dir, tmp_path, umls):
    raw = _write_raw(tmp_path)
    _, _, name_to_ptr, _ = biomed.load_ddb(*_paths(ddb_dir))
    linker = biomed.DictionaryEntityLinker(name_to_ptr).link
    umls_map = {"100": "100", "300": "300"} if umls else None
    for tag, mod in (("j", jax_biomed), ("p", biomed)):
        mod.convert_medqa_statements(str(raw), str(tmp_path / f"{tag}.st"),
                                     id_prefix="dev")
        mod.link_statements(str(tmp_path / f"{tag}.st"),
                            str(tmp_path / f"{tag}.linked"), linker)
        mod.ground_umls_linked(str(tmp_path / f"{tag}.linked"), umls_map,
                               str(tmp_path / f"{tag}.gr"))
    for ext in ("st", "linked", "gr"):
        _same_file(tmp_path / f"j.{ext}", tmp_path / f"p.{ext}")


@pytest.mark.parametrize("nprocs", [1, 2])
def test_run_medqa_matches_jax(ddb_dir, tmp_path, nprocs):
    """run_medqa end to end in each package on the same tables (the port's
    with `nprocs` workers): every file each writes, and the assertions of
    tests/test_biomed.py on the port's rows."""
    roots = {}
    for tag, mod, n in (("jax", jax_biomed, 1), ("port", biomed, nprocs)):
        root = tmp_path / tag
        (root / "ddb").mkdir(parents=True)
        for f in ("ddb_names.json", "ddb_relas.json"):
            (root / "ddb" / f).write_bytes((ddb_dir / f).read_bytes())
        _write_raw(root)
        _write_raw(root, "train", MEDQA[::-1])
        seconds = mod.run_medqa(str(root), nprocs=n)
        roots[tag] = root
    assert set(seconds) == {"kg", "train", "dev"}
    files = sorted(p.relative_to(roots["jax"])
                   for p in roots["jax"].rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(roots["port"])
                           for p in roots["port"].rglob("*") if p.is_file())
    for f in files:
        if f.suffix == ".pk":
            _same_rows(_load(roots["jax"] / f), _load(roots["port"] / f))
        elif f.suffix != ".npz":
            _same_file(roots["jax"] / f, roots["port"] / f)

    medqa = roots["port"] / "medqa_usmle"
    gr = [json.loads(l) for l in open(medqa / "grounded/dev.grounded.jsonl")]
    assert len(gr) == 12
    assert "100" in gr[0]["qc"] and "200" in gr[0]["qc"]
    assert gr[0]["ac"] == ["400"]
    rows = _load(medqa / "graph/dev.graph.adj.pk")
    assert rows[0]["cid2score"] is None
    assert rows[0]["qmask"].sum() >= 2 and rows[0]["amask"].sum() == 1
    kg = biomed.construct_ddb_kg(*_paths(ddb_dir))
    c2i = kg.concept2id
    assert c2i["31770"] in rows[4]["concepts"]
    assert c2i["325"] in rows[4]["concepts"]
    data = load_graph_pk(str(medqa / "graph/dev.graph.adj.pk"),
                         max_node_num=20, use_cache=False)
    assert len(data) == 12 and data.n_relations == 34


def test_scispacy_linker_is_a_lazy_import():
    try:
        import scispacy  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            biomed.make_scispacy_linker()
    else:
        pytest.skip("scispacy is installed here")


# ---- SapBERT ---------------------------------------------------------------

SAP_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "ethanol",
             "alcohol", "cirrhosis", "liver", "disease", "aspirin", "acute",
             "chronic", "of", "the", "type", "2", "-", "fallback", "q", "a"]
SAP_NAMES = ["Ethanol", "Liver disease", "acute chronic liver disease of "
             "the liver type 2", "Aspirin", "cirrhosis - type 2 - acute",
             "unknown words here", "Fallback Q", "Fallback A", "a",
             "chronic alcohol liver cirrhosis disease of type 2 liver"]


@pytest.fixture(scope="module")
def sapbert_dir(tmp_path_factory):
    """A tiny random BertModel saved by HF beside a fast tokenizer whose
    model_max_length (8) truncates the longer names."""
    transformers = pytest.importorskip("transformers")
    out = tmp_path_factory.mktemp("sapbert")
    torch.manual_seed(5)
    cfg = transformers.BertConfig(
        vocab_size=len(SAP_VOCAB), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=48,
        max_position_embeddings=16)
    transformers.BertModel(cfg).eval().save_pretrained(str(out))
    (out / "vocab.txt").write_text("\n".join(SAP_VOCAB))
    transformers.BertTokenizerFast(
        vocab_file=str(out / "vocab.txt"), do_lower_case=True,
        model_max_length=8).save_pretrained(str(out))
    return out


def _vocab_file(tmp_path, names=SAP_NAMES):
    p = tmp_path / "vocab.txt"
    p.write_text("\n".join(names) + "\n")
    return str(p)


@pytest.mark.parametrize("batch_size", [4, 64])
def test_sapbert_table_matches_jax(sapbert_dir, tmp_path, batch_size):
    vocab = _vocab_file(tmp_path)
    want = jax_biomed.sapbert_entity_embeddings(
        vocab, str(tmp_path / "j.npy"), str(sapbert_dir),
        batch_size=batch_size, device="cpu")
    got = biomed.sapbert_entity_embeddings(
        vocab, str(tmp_path / "p.npy"), str(sapbert_dir),
        batch_size=batch_size, device="cpu")
    assert got.dtype == np.float32 and got.shape == (len(SAP_NAMES), 32)
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"), got)
    err = np.abs(got - want).max()
    assert err <= EMB_TOL * np.abs(want).max(), err


def test_sapbert_tokenizer_truncates(sapbert_dir):
    from transformers import AutoTokenizer
    tok = AutoTokenizer.from_pretrained(str(sapbert_dir))
    enc = tok(SAP_NAMES, padding=True, truncation=True, return_tensors="pt")
    assert enc["input_ids"].shape[1] == 8
    assert len(tok(SAP_NAMES[2])["input_ids"]) > 8


def test_sapbert_takes_a_tokenizer_object(sapbert_dir, tmp_path):
    from transformers import AutoTokenizer
    vocab = _vocab_file(tmp_path)
    a = biomed.sapbert_entity_embeddings(
        vocab, str(tmp_path / "a.npy"), str(sapbert_dir), device="cpu")
    b = biomed.sapbert_entity_embeddings(
        vocab, str(tmp_path / "b.npy"), str(sapbert_dir), device="cpu",
        tokenizer=AutoTokenizer.from_pretrained(str(sapbert_dir)))
    np.testing.assert_array_equal(a, b)


def test_sapbert_without_a_device_needs_a_card(sapbert_dir, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        biomed.sapbert_entity_embeddings(
            _vocab_file(tmp_path), str(tmp_path / "x.npy"), str(sapbert_dir))
    assert not (tmp_path / "x.npy").exists()


def test_sapbert_refuses_a_checkpoint_without_pooler(tmp_path):
    from qagnn_tpu_torch.data.synthetic import write_tiny_bert_checkpoint
    d = write_tiny_bert_checkpoint(str(tmp_path / "bert"))
    sd = torch.load(f"{d}/pytorch_model.bin", weights_only=True)
    torch.save({k: v for k, v in sd.items() if not k.startswith("pooler.")},
               f"{d}/pytorch_model.bin")
    with pytest.raises(ValueError, match="pooler"):
        biomed.sapbert_entity_embeddings(
            _vocab_file(tmp_path, ["cat", "dog"]), str(tmp_path / "x.npy"),
            d, device="cpu")


def test_run_medqa_writes_the_sapbert_table(ddb_dir, sapbert_dir, tmp_path):
    """run_medqa with `sapbert_path` writes ddb/ent_emb.npy: the table of
    ddb/vocab.txt, one row a KG node."""
    root = ddb_dir.parent
    _write_raw(root)
    seconds = biomed.run_medqa(str(root), sapbert_path=str(sapbert_dir),
                               device="cpu")
    assert "sapbert" in seconds
    table = np.load(root / "ddb" / "ent_emb.npy")
    want = biomed.sapbert_entity_embeddings(
        str(root / "ddb" / "vocab.txt"), str(tmp_path / "w.npy"),
        str(sapbert_dir), device="cpu")
    np.testing.assert_array_equal(table, want)
    kg = biomed.construct_ddb_kg(*_paths(ddb_dir))
    assert table.shape == (kg.n_nodes, 32)


def test_driver_writes_the_sapbert_table(ddb_dir, sapbert_dir, tmp_path):
    """`--run medqa_usmle --sapbert DIR --device cpu` writes the graphs and
    ddb/ent_emb.npy, the table sapbert_entity_embeddings computes."""
    from qagnn_tpu_torch.preprocess import driver
    root = ddb_dir.parent
    _write_raw(root)
    driver.main(["--run", "medqa_usmle", "--data-root", str(root),
                 "--sapbert", str(sapbert_dir), "--device", "cpu", "-p", "2"])
    assert (root / "medqa_usmle" / "graph" / "dev.graph.adj.pk").exists()
    want = biomed.sapbert_entity_embeddings(
        str(root / "ddb" / "vocab.txt"), str(tmp_path / "w.npy"),
        str(sapbert_dir), device="cpu")
    np.testing.assert_array_equal(np.load(root / "ddb" / "ent_emb.npy"), want)


def test_driver_sapbert_without_a_device_needs_a_card(sapbert_dir, tmp_path,
                                                      monkeypatch):
    from qagnn_tpu_torch.preprocess import driver
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(["--run", "medqa_usmle", "--data-root", str(tmp_path),
                     "--sapbert", str(sapbert_dir)])
    assert not (tmp_path / "medqa_usmle").exists()
