"""Offline preprocessing pipeline: raw data -> model-ready artifacts.

Counterpart of qagnn_tpu/preprocess, with the same modules and exports.
Ports of the reference's preprocessing vertical (reference preprocess.py,
utils/conceptnet.py, utils/convert_csqa.py, utils/convert_obqa.py,
utils/grounding.py, utils/graph.py) with two deliberate departures, shared
with the JAX package and its file formats:

  * the KG is stored as numpy CSR arrays (.npz), not a networkx gpickle —
    faster to load, no networkx version coupling;
  * concept grounding uses a built-in rule lemmatizer + n-gram matcher
    instead of spaCy (unavailable offline); same matching contract
    (lemma-sequence patterns over the concept vocabulary, stopword pruning,
    hard-ground fallback).

Everything is host numpy / Python except the two steps that run a model:
the RoBERTa MLM relevance scorer (graph_extraction.make_torch_mlm_scorer)
and the SapBERT entity table (biomed.sapbert_entity_embeddings), which run
the port's TextEncoder on the card. No module imports torch at its top, so
the worker pools' processes start without it.
"""

from qagnn_tpu_torch.preprocess.conceptnet import (
    MERGED_RELATIONS,
    construct_graph,
    extract_english,
)
from qagnn_tpu_torch.preprocess.kg import KG
from qagnn_tpu_torch.preprocess.convert import (
    convert_to_entailment,
    convert_to_obqa_statement,
)
from qagnn_tpu_torch.preprocess.grounding import create_matcher, ground
from qagnn_tpu_torch.preprocess.graph_extraction import (
    generate_adj_data_from_grounded_concepts,
)

__all__ = [
    "MERGED_RELATIONS", "construct_graph", "extract_english", "KG",
    "convert_to_entailment", "convert_to_obqa_statement",
    "create_matcher", "ground", "generate_adj_data_from_grounded_concepts",
]
