"""Preprocessing driver: routine tables per dataset.

Counterpart of qagnn_tpu/preprocess/driver.py (a port of reference
preprocess.py:89-146). Usage:

    python -m qagnn_tpu_torch.preprocess.driver --run common csqa obqa -p 8 \
        --data-root data/ --lm-scorer DIR

Expects the reference's raw-data layout under --data-root (see the
reference's download_raw_data.sh): cpnet/conceptnet-assertions-5.6.0.csv and
{dataset}/{train,dev,test}_rand_split.jsonl (CSQA) / OBQA equivalents.
`--lm-scorer` (a local RobertaForMaskedLM directory) and `--sapbert` (a
local SapBERT directory, for medqa_usmle) run on the CUDA card unless
`--device` names another device; with either and no card, it exits with an
error before any routine runs.
"""

from __future__ import annotations

import argparse
import os
import time

from qagnn_tpu_torch.preprocess.conceptnet import (
    construct_graph,
    extract_english,
)
from qagnn_tpu_torch.preprocess.convert import (
    convert_to_entailment,
    convert_to_obqa_statement,
)
from qagnn_tpu_torch.preprocess.grounding import ground
from qagnn_tpu_torch.preprocess.graph_extraction import (
    default_uniform_scorer,
    generate_adj_data_from_grounded_concepts,
    make_torch_mlm_scorer,
)


def run_common(root: str, nprocs: int) -> dict[str, float]:
    """ConceptNet extraction (skipped when its output exists) and the KG.
    Returns the host seconds of each stage."""
    cpnet_csv = f"{root}/cpnet/conceptnet-assertions-5.6.0.csv"
    en_csv = f"{root}/cpnet/conceptnet.en.csv"
    vocab = f"{root}/cpnet/concept.txt"
    kg_npz = f"{root}/cpnet/conceptnet.en.kg.npz"
    t0 = time.perf_counter()
    if not os.path.exists(en_csv):
        extract_english(cpnet_csv, en_csv, vocab)
    t1 = time.perf_counter()
    construct_graph(en_csv, vocab, kg_npz, prune=True)
    return {"extract": t1 - t0, "construct": time.perf_counter() - t1}


# (raw file name per split, needs-conversion style)
DATASET_RAW = {
    "csqa": {"train": "train_rand_split.jsonl",
             "dev": "dev_rand_split.jsonl",
             "test": "test_rand_split_no_answers.jsonl",
             "style": "csqa"},
    "obqa": {"train": "train.jsonl", "dev": "dev.jsonl",
             "test": "test.jsonl", "style": "obqa"},
}


def run_dataset(dataset: str, root: str, nprocs: int,
                lm_scorer_path: str | None = None, device=None,
                tokenizer=None) -> dict[str, dict[str, float]]:
    """Statements, grounding and graphs of each split present. With
    `lm_scorer_path` the nodes are scored by `make_torch_mlm_scorer` on
    `device` (the card unless another is named), tokenized by `tokenizer`
    (None: transformers.AutoTokenizer from the same directory). Returns the
    host seconds of each stage of each split."""
    info = DATASET_RAW[dataset]
    vocab = f"{root}/cpnet/concept.txt"
    kg_npz = f"{root}/cpnet/conceptnet.en.kg.npz"
    os.makedirs(f"{root}/{dataset}/statement", exist_ok=True)
    os.makedirs(f"{root}/{dataset}/grounded", exist_ok=True)
    os.makedirs(f"{root}/{dataset}/graph", exist_ok=True)

    scorer = (make_torch_mlm_scorer(lm_scorer_path, device=device,
                                    tokenizer=tokenizer)
              if lm_scorer_path else default_uniform_scorer)

    seconds = {}
    for split in ("train", "dev", "test"):
        raw = f"{root}/{dataset}/{info[split]}"
        if not os.path.exists(raw):
            continue
        st = f"{root}/{dataset}/statement/{split}.statement.jsonl"
        gr = f"{root}/{dataset}/grounded/{split}.grounded.jsonl"
        pk = f"{root}/{dataset}/graph/{split}.graph.adj.pk"
        t0 = time.perf_counter()
        if info["style"] == "csqa":
            convert_to_entailment(raw, st)
        else:
            convert_to_obqa_statement(raw, st)
        t1 = time.perf_counter()
        ground(st, vocab, gr, num_processes=nprocs)
        t2 = time.perf_counter()
        seconds[split] = {"convert": t1 - t0, "ground": t2 - t1} | \
            generate_adj_data_from_grounded_concepts(
                gr, kg_npz, pk, statement_path=st, scorer=scorer,
                num_processes=nprocs)
    return seconds


def main(argv=None):
    ap = argparse.ArgumentParser("qagnn_tpu_torch.preprocess")
    ap.add_argument("--run", nargs="+", default=["common", "csqa", "obqa"])
    ap.add_argument("-p", "--nprocs", type=int, default=1)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--lm-scorer", default=None,
                    help="local path to a RoBERTa MLM for relevance scoring")
    ap.add_argument("--sapbert", default=None,
                    help="local path to a SapBERT model: medqa_usmle then "
                         "also writes the entity table ddb/ent_emb.npy")
    ap.add_argument("--device", default=None,
                    help="torch device of the LM scorer and SapBERT (e.g. "
                         "cpu); default: the CUDA card, and an error when "
                         "there is none")
    args = ap.parse_args(argv)

    device = args.device
    if args.lm_scorer or args.sapbert:
        from qagnn_tpu_torch.utils.config import resolve_device
        device = resolve_device(args.device)

    for routine in args.run:
        if routine == "common":
            run_common(args.data_root, args.nprocs)
        elif routine == "medqa_usmle":
            from qagnn_tpu_torch.preprocess.biomed import run_medqa
            run_medqa(args.data_root, args.nprocs,
                      sapbert_path=args.sapbert, device=device)
        else:
            run_dataset(routine, args.data_root, args.nprocs, args.lm_scorer,
                        device=device)


if __name__ == "__main__":
    main()
