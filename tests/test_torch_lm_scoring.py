"""The port's RoBERTa MLM relevance scorer against the JAX package's (CPU).

`qagnn_tpu_torch.preprocess.graph_extraction.make_torch_mlm_scorer` runs
the port's TextEncoder and MLM head (models/mlm_head.py) read by
`load_mlm_checkpoint`; `qagnn_tpu.preprocess.graph_extraction.
make_torch_mlm_scorer` runs HF's RobertaForMaskedLM from the same
directory. Both score the same sentences ('question' for the context node,
'question concept words.' for a concept) as -(summed token cross-entropy),
held within 1e-5 x max|score| (f32; the two sum the same products in other
orders). The checkpoints are tiny random RobertaForMaskedLMs (2 layers, 32
wide) written by HF's save_pretrained, with the decoder tied to the word
embeddings (so no lm_head.decoder.weight) and untied, beside a word-level
fast tokenizer that pads on the right with id 1 and adds <s> / </s>; the
chunks mix sentence lengths. The JAX side needs `transformers`.
"""

import json

import numpy as np
import pytest
import torch

from qagnn_tpu.preprocess import graph_extraction as jax_graphs

from qagnn_tpu_torch.models import hf_loading
from qagnn_tpu_torch.models.mlm_head import MaskedLM, load_masked_lm
from qagnn_tpu_torch.models.text_encoder import TextEncoderConfig
from qagnn_tpu_torch.preprocess import driver
from qagnn_tpu_torch.preprocess import graph_extraction as graphs

SCORE_TOL = 1e-5
WORDS = ["where", "would", "you", "find", "a", "lantern", "antique", "shop",
         "house", "dark", "place", "light", "cat", "animal", "is", "the",
         "of", "building", "roof", "run", "health", "what"]
SPECIAL = ["<s>", "<pad>", "</s>", "<unk>", ".", "?", ","]
QUESTION = "Where would you find a lantern? antique shop."
NAMES = [None, "lantern", "antique_shop", "dark_place", "house", "light",
         "building_of_the_dark_antique_shop", "cat", "zebra", "roof",
         "health", "run_of_the_house"]


def _tokenizer(out, token_types: bool):
    """A word-level fast tokenizer (<s> $A </s>, pad id 1 on the right)
    saved beside the model, so AutoTokenizer loads it from the same path."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    vocab = {w: i for i, w in enumerate(SPECIAL + WORDS)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    names = ["input_ids", "attention_mask"] + (
        ["token_type_ids"] if token_types else [])
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
        unk_token="<unk>", pad_token="<pad>", model_input_names=names)
    fast.save_pretrained(str(out))
    return fast


def _write_mlm(out, tied: bool, token_types: bool, seed=7):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.RobertaConfig(
        vocab_size=len(SPECIAL) + len(WORDS), hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=48,
        max_position_embeddings=40, type_vocab_size=1, pad_token_id=1,
        bos_token_id=0, eos_token_id=2, tie_word_embeddings=tied)
    model = transformers.RobertaForMaskedLM(cfg).eval()
    with torch.no_grad():      # HF inits the vocabulary bias at zero
        model.lm_head.bias.normal_(0.0, 0.5)
    model.save_pretrained(str(out))
    _tokenizer(out, token_types)
    return out


@pytest.fixture(scope="module", params=["tied", "untied"])
def mlm_dir(request, tmp_path_factory):
    tied = request.param == "tied"
    return _write_mlm(tmp_path_factory.mktemp(request.param), tied,
                      token_types=not tied)


def _stored_keys(path):
    from safetensors import safe_open
    with safe_open(str(path / "model.safetensors"), "pt") as f:
        return set(f.keys())


def test_checkpoints_store_the_decoder_as_hf_ties_it(mlm_dir):
    keys = _stored_keys(mlm_dir)
    assert "lm_head.bias" in keys and "lm_head.dense.weight" in keys
    tied = mlm_dir.name.startswith("tied")
    assert ("lm_head.decoder.weight" in keys) is not tied


def _hf_model(path):
    from transformers import RobertaForMaskedLM
    return RobertaForMaskedLM.from_pretrained(str(path)).eval()


def _inputs(pad_id=1):
    rng = np.random.default_rng(0)
    ids = rng.integers(4, len(SPECIAL) + len(WORDS), (3, 12))
    ids[:, 0] = 0
    mask = np.ones((3, 12), np.int64)
    for row, n in ((0, 12), (1, 4), (2, 9)):
        ids[row, n - 1] = 2
        mask[row, n:] = 0
    ids[mask == 0] = pad_id
    return torch.from_numpy(ids), torch.from_numpy(mask)


def test_masked_lm_logits_match_hf(mlm_dir):
    ids, mask = _inputs()
    with torch.no_grad():
        want = _hf_model(mlm_dir)(input_ids=ids, attention_mask=mask).logits
        got = load_masked_lm(str(mlm_dir))(ids, mask)
    real = mask.bool()
    err = (got - want)[real].abs().max().item()
    assert err <= 1e-5 * want[real].abs().max().item(), err


def test_tied_decoder_shares_the_word_embeddings(mlm_dir):
    model = load_masked_lm(str(mlm_dir))
    tied = mlm_dir.name.startswith("tied")
    shared = model.head.decoder.weight is model.encoder.word_embeddings.weight
    assert shared is tied
    hf = _hf_model(mlm_dir)
    np.testing.assert_array_equal(model.head.decoder.weight.detach().numpy(),
                                  hf.lm_head.decoder.weight.detach().numpy())
    np.testing.assert_array_equal(model.head.decoder.bias.detach().numpy(),
                                  hf.lm_head.bias.detach().numpy())


@pytest.mark.parametrize("batch_size", [3, 50])
def test_scorer_matches_jax(mlm_dir, batch_size):
    """Scores of a None name and concepts of 1-7 words (chunks of mixed
    lengths) against the JAX package's HF scorer; the untied checkpoint's
    tokenizer also returns token_type_ids."""
    want = jax_graphs.make_torch_mlm_scorer(
        str(mlm_dir), device="cpu", batch_size=batch_size)(QUESTION, NAMES)
    scorer = graphs.make_torch_mlm_scorer(str(mlm_dir), device="cpu",
                                          batch_size=batch_size)
    got = scorer(QUESTION, NAMES)
    assert isinstance(got, list) and len(got) == len(NAMES)
    want, got = np.asarray(want), np.asarray(got)
    err = np.abs(got - want).max()
    assert err <= SCORE_TOL * np.abs(want).max(), err
    enc = scorer.tokenizer(["a b"], padding=True, return_tensors="pt")
    assert ("token_type_ids" in enc) is mlm_dir.name.startswith("untied")


def test_scorer_takes_a_tokenizer_object(mlm_dir):
    """A tokenizer passed in (the card's machine may lack transformers) is
    used through the same batch call; the sentence forms are the JAX
    scorer's."""
    calls = []

    class Spy:
        def __init__(self, tok):
            self.tok = tok

        def __call__(self, texts, **kw):
            calls.append((list(texts), kw))
            return self.tok(texts, **kw)

    from transformers import AutoTokenizer
    tok = Spy(AutoTokenizer.from_pretrained(str(mlm_dir)))
    scorer = graphs.make_torch_mlm_scorer(str(mlm_dir), device="cpu",
                                          batch_size=5, tokenizer=tok)
    got = scorer(QUESTION, NAMES)
    assert [len(c[0]) for c in calls] == [5, 5, 2]
    assert all(kw == {"padding": True, "return_tensors": "pt"}
               for _, kw in calls)
    assert calls[0][0][:2] == [QUESTION.lower(),
                               f"{QUESTION.lower()} lantern."]
    assert calls[1][0][1] == \
        f"{QUESTION.lower()} building of the dark antique shop."
    want = graphs.make_torch_mlm_scorer(str(mlm_dir), device="cpu",
                                        batch_size=5)(QUESTION, NAMES)
    assert got == want


def test_scores_rank_the_graph_like_jax(mlm_dir, tmp_path):
    """score_nodes with each package's MLM scorer: the same node set, values
    within the tolerance, and the same order wherever two scores differ by
    more than it."""
    from qagnn_tpu_torch.preprocess.kg import KG
    kg = KG(n_nodes=len(NAMES) - 1, n_base_rels=17,
            edge_src=np.zeros(0, np.int32), edge_dst=np.zeros(0, np.int32),
            edge_rel=np.zeros(0, np.int16), id2concept=NAMES[1:])
    ids = list(range(kg.n_nodes))
    want = jax_graphs.score_nodes(kg, QUESTION, ids,
                                  jax_graphs.make_torch_mlm_scorer(
                                      str(mlm_dir), device="cpu"))
    got = graphs.score_nodes(kg, QUESTION, ids, graphs.make_torch_mlm_scorer(
        str(mlm_dir), device="cpu"))
    assert set(got) == set(want) == set(ids) | {-1}
    tol = SCORE_TOL * max(abs(v) for v in want.values())
    assert max(abs(got[k] - want[k]) for k in want) <= tol
    pos = {k: i for i, k in enumerate(got)}
    order = list(want)
    for a, b in zip(order, order[1:]):
        if want[a] - want[b] > tol:
            assert pos[a] < pos[b], (a, b)


def _state_dict_file(path, head_bias_keys, drop_decoder):
    """A torch.save'd RobertaForMaskedLM state dict with the vocabulary
    bias under `head_bias_keys`."""
    from transformers import RobertaConfig, RobertaForMaskedLM
    torch.manual_seed(1)
    cfg = RobertaConfig(vocab_size=30, hidden_size=16, num_hidden_layers=1,
                        num_attention_heads=2, intermediate_size=24,
                        max_position_embeddings=20, type_vocab_size=1,
                        pad_token_id=1, layer_norm_eps=1e-5)
    model = RobertaForMaskedLM(cfg).eval()
    with torch.no_grad():
        model.lm_head.bias.normal_()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    bias = sd.pop("lm_head.bias")
    sd.pop("lm_head.decoder.bias", None)
    if drop_decoder:
        sd.pop("lm_head.decoder.weight")
    for k in head_bias_keys:
        sd[k] = bias
    torch.save(sd, path)
    return model, cfg


@pytest.mark.parametrize("bias_keys", [
    ("lm_head.bias",), ("lm_head.decoder.bias",),
    ("lm_head.bias", "lm_head.decoder.bias")])
@pytest.mark.parametrize("drop_decoder", [False, True])
def test_load_mlm_checkpoint_reads_the_head(tmp_path, bias_keys,
                                            drop_decoder):
    path = str(tmp_path / "mlm.bin")
    model, cfg = _state_dict_file(path, bias_keys, drop_decoder)
    fallback = TextEncoderConfig(
        vocab_size=30, hidden_size=16, num_layers=1, num_heads=2,
        intermediate_size=24, max_position_embeddings=20, type_vocab_size=1,
        layer_norm_eps=1e-5, pad_token_id=1, roberta_style_positions=True)
    _, enc, head = hf_loading.load_mlm_checkpoint(path,
                                                  fallback_config=fallback)
    assert "pooler.weight" not in enc
    assert set(head) == {"dense.weight", "dense.bias", "layer_norm.weight",
                         "layer_norm.bias", "decoder.bias"} | (
        set() if drop_decoder else {"decoder.weight"})
    torch.testing.assert_close(head["decoder.bias"], model.lm_head.bias,
                               rtol=0, atol=0)
    lm = load_masked_lm(path, fallback_config=fallback)
    ids, mask = torch.tensor([[0, 5, 9, 2, 1]]), torch.tensor([[1, 1, 1, 1,
                                                                0]])
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask).logits[:, :4]
        got = lm(ids, mask)[:, :4]
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_load_mlm_checkpoint_refuses_a_bare_encoder(tmp_path):
    from qagnn_tpu_torch.data.synthetic import write_tiny_bert_checkpoint
    d = write_tiny_bert_checkpoint(str(tmp_path / "bert"))
    with pytest.raises(ValueError, match="lm_head"):
        hf_loading.load_mlm_checkpoint(d)


def test_masked_lm_module_shapes():
    cfg = TextEncoderConfig.tiny(vocab_size=50, pad_token_id=1,
                                 roberta_style_positions=True)
    model = MaskedLM(cfg, tied=False).eval()
    assert model.head.decoder.weight is not \
        model.encoder.word_embeddings.weight
    ids = torch.randint(3, 50, (2, 7))
    out = model(ids, torch.ones_like(ids), torch.zeros_like(ids))
    assert out.shape == (2, 7, 50)


def test_scorer_without_a_device_needs_a_card(mlm_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graphs.make_torch_mlm_scorer(str(mlm_dir))


def test_driver_without_a_device_needs_a_card(mlm_dir, tmp_path,
                                              monkeypatch):
    """--lm-scorer with no --device on a host without a card exits before
    any routine runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(["--run", "common", "--data-root", str(tmp_path),
                     "--lm-scorer", str(mlm_dir)])
    assert not (tmp_path / "cpnet").exists()


def test_driver_scores_with_the_mlm_on_the_named_device(mlm_dir, tmp_path):
    """The driver's obqa routine with --lm-scorer and --device cpu: every
    row's cid2score holds its schema nodes plus -1, scored like the JAX
    scorer."""
    import pickle

    from test_torch_preprocess import CSQA, _write_raw

    root = tmp_path / "data"
    (root / "cpnet").mkdir(parents=True)
    _write_raw(root / "cpnet" / "conceptnet-assertions-5.6.0.csv")
    (root / "obqa").mkdir()
    with open(root / "obqa" / "dev.jsonl", "w") as f:
        for q in CSQA:
            f.write(json.dumps(q) + "\n")
    driver.main(["--run", "common", "obqa", "--data-root", str(root),
                 "--lm-scorer", str(mlm_dir), "--device", "cpu", "-p", "2"])
    with open(root / "obqa" / "graph" / "dev.graph.adj.pk", "rb") as f:
        rows = pickle.load(f)
    assert len(rows) == 9
    jax_scorer = jax_graphs.make_torch_mlm_scorer(str(mlm_dir), device="cpu")
    stems = [q["question"]["stem"] for q in CSQA]
    grounded = [json.loads(l) for l in
                open(root / "obqa" / "grounded" / "dev.grounded.jsonl")]
    for j, r in enumerate(rows):
        nodes = r["concepts"].tolist()
        assert set(r["cid2score"]) == set(nodes) | {-1}
        if j < 2:
            from qagnn_tpu_torch.preprocess.kg import KG
            kg = KG.load(str(root / "cpnet" / "conceptnet.en.kg.npz"))
            question = f"{stems[j // 3]} {grounded[j]['ans']}."
            want = jax_graphs.score_nodes(kg, question, nodes, jax_scorer)
            tol = SCORE_TOL * max(abs(v) for v in want.values())
            assert max(abs(r["cid2score"][k] - want[k]) for k in want) <= tol
