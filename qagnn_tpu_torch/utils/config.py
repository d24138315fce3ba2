"""Run configuration: the TrainConfig dataclass, per-dataset presets and
CLI parsing.

A copy of qagnn_tpu/utils/config.py (same fields, defaults, presets and
flags) plus the device and dtype resolution the port's entry points share.
The parser adds two flags of its own, `--device` and `--dist_backend` (the
torch.distributed backend of a grid of ranks: nccl, one rank a card, or
gloo, which lets ranks share a card or run on the CPU), which are not
TrainConfig fields, so a run's config.json keeps the JAX package's fields.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, fields

import torch

DATASETS = ["csqa", "obqa", "socialiqa", "medqa_usmle"]

# reference utils/parser_utils.py:5-24
ENCODER_DEFAULT_LR = {
    "default": 1e-3,
    "csqa": {"lstm": 3e-4, "openai-gpt": 1e-4, "bert-base-uncased": 3e-5,
             "bert-large-uncased": 2e-5, "roberta-large": 1e-5},
    "obqa": {"lstm": 3e-4, "openai-gpt": 3e-5, "bert-base-cased": 1e-4,
             "bert-large-cased": 1e-4, "roberta-large": 1e-5},
    "medqa_usmle": {"cambridgeltl/SapBERT-from-PubMedBERT-fulltext": 5e-5},
}

# reference qagnn.py:14-19
DECODER_DEFAULT_LR = {
    "csqa": 1e-3,
    "obqa": 3e-4,
    "medqa_usmle": 1e-3,
    "socialiqa": 1e-3,
}

# reference utils/parser_utils.py:28-33
DATASET_SETTING = {"csqa": "inhouse", "obqa": "official",
                   "socialiqa": "official", "medqa_usmle": "official"}
DATASET_NO_TEST = ["socialiqa"]

# reference utils/parser_utils.py:37-43
EMB_PATHS = {
    "transe": "data/transe/glove.transe.sgd.ent.npy",
    "lm": "data/transe/glove.transe.sgd.ent.npy",
    "numberbatch": "data/transe/concept.nb.npy",
    "tzw": "data/cpnet/tzw.ent.npy",
    "ddb": "data/ddb/ent_emb.npy",
}


@dataclass
class TrainConfig:
    # run
    mode: str = "train"                  # train | eval_detail
    save_dir: str = "./saved_models/qagnn/"
    save_model: bool = False
    prng_impl: str = "auto"
    detail_batches: int = 1
    load_model_path: str | None = None
    seed: int = 0
    log_interval: int = 10
    debug: bool = False

    # data
    dataset: str = "csqa"
    ent_emb: tuple[str, ...] = ("tzw",)
    ent_emb_paths: tuple[str, ...] = ()
    inhouse: bool = True
    inhouse_train_qids: str = "data/{dataset}/inhouse_split_qids.txt"
    train_statements: str = "data/{dataset}/statement/train.statement.jsonl"
    dev_statements: str = "data/{dataset}/statement/dev.statement.jsonl"
    test_statements: str | None = "data/{dataset}/statement/test.statement.jsonl"
    train_adj: str = "data/{dataset}/graph/train.graph.adj.pk"
    dev_adj: str = "data/{dataset}/graph/dev.graph.adj.pk"
    test_adj: str | None = "data/{dataset}/graph/test.graph.adj.pk"
    max_seq_len: int = 100
    max_node_num: int = 200
    num_relation: int = 38
    subsample: float = 1.0
    use_cache: bool = True

    # encoder
    encoder: str = "roberta-large"
    encoder_load: str | None = None
    encoder_layer: int = -1
    encoder_lr: float | None = None      # resolved per dataset+encoder
    encoder_dtype: str = "float32"       # float32 | bfloat16
    lstm_vocab: str | None = None

    # device mesh
    mesh_data: int = 0
    mesh_model: int = 1

    # observability
    profile_dir: str | None = None
    profile_start_step: int = 10
    profile_num_steps: int = 5

    # gnn / decoder architecture (reference qagnn.py:58-69)
    gnn_backend: str | None = None       # scatter | cuda | None (follow the device)
    gnn_dtype: str = "auto"              # float32 | bfloat16 | auto
    k: int = 5
    att_head_num: int = 2                # pooler heads; GATConvE is 4 (hard)
    gnn_dim: int = 100
    fc_dim: int = 200
    fc_layer_num: int = 0
    freeze_ent_emb: bool = True
    simple: bool = False                 # => k = 1
    init_range: float = 0.02

    # regularization
    dropouti: float = 0.2
    dropoutg: float = 0.2
    dropoutf: float = 0.2

    # optimization (reference parser_utils.py:83-92, qagnn.py:78-85)
    loss: str = "cross_entropy"
    optim: str = "radam"
    lr_schedule: str = "fixed"
    batch_size: int = 32
    mini_batch_size: int = 1
    eval_batch_size: int = 2
    warmup_steps: int = 150
    max_grad_norm: float = 1.0
    weight_decay: float = 1e-2
    n_epochs: int = 100
    max_epochs_before_stop: int = 10
    decoder_lr: float | None = None      # resolved per dataset
    unfreeze_epoch: int = 4
    refreeze_epoch: int = 10000

    def resolved(self) -> "TrainConfig":
        """Fill dataset-dependent defaults (reference parser_utils two-pass)."""
        c = dataclasses.replace(self)
        ds = c.dataset
        if c.encoder_lr is None:
            table = ENCODER_DEFAULT_LR.get(ds, {})
            c.encoder_lr = table.get(c.encoder, ENCODER_DEFAULT_LR["default"])
        if c.decoder_lr is None:
            c.decoder_lr = DECODER_DEFAULT_LR.get(ds, 1e-3)
        if not c.ent_emb_paths:
            c.ent_emb_paths = tuple(EMB_PATHS[s] for s in c.ent_emb)
        c.inhouse = DATASET_SETTING.get(ds) == "inhouse" if c.inhouse is None \
            else c.inhouse
        for name in ("inhouse_train_qids", "train_statements", "dev_statements",
                     "test_statements", "train_adj", "dev_adj", "test_adj"):
            v = getattr(c, name)
            if isinstance(v, str):
                setattr(c, name, v.format(dataset=ds))
        if ds in DATASET_NO_TEST:
            c.test_statements = None
            c.test_adj = None
        if c.simple:
            c.k = 1
        if c.debug:
            c.batch_size, c.log_interval = 1, 1
        return c

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)


def preset(dataset: str, **overrides) -> TrainConfig:
    """Per-dataset run-script presets (reference run_qagnn__*.sh)."""
    base: dict = {"dataset": dataset}
    if dataset == "csqa":
        base.update(encoder="roberta-large", k=5, gnn_dim=200, batch_size=64,
                    mini_batch_size=2, n_epochs=15, inhouse=True)
    elif dataset == "obqa":
        base.update(encoder="roberta-large", k=5, gnn_dim=200, batch_size=128,
                    mini_batch_size=2, n_epochs=100, inhouse=False)
    elif dataset == "medqa_usmle":
        base.update(encoder="cambridgeltl/SapBERT-from-PubMedBERT-fulltext",
                    k=5, gnn_dim=200, batch_size=128, mini_batch_size=8,
                    n_epochs=15, inhouse=False, max_seq_len=512,
                    num_relation=34, unfreeze_epoch=0, ent_emb=("ddb",))
    base.update(overrides)
    return TrainConfig(**base).resolved()


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI exposing every TrainConfig field as --flag, --device (the card
    unless a device is named, see `resolve_device`) and --dist_backend."""
    p = argparse.ArgumentParser("qagnn_tpu_torch")
    for f in fields(TrainConfig):
        name = "--" + f.name
        default = f.default
        if f.type in ("bool", bool) or isinstance(default, bool):
            p.add_argument(name, type=_bool_flag, default=None)
        elif isinstance(default, int) and not isinstance(default, bool):
            p.add_argument(name, type=int, default=None)
        elif isinstance(default, float):
            p.add_argument(name, type=float, default=None)
        elif isinstance(default, tuple):
            p.add_argument(name, nargs="+", default=None)
        else:
            p.add_argument(name, type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (e.g. cpu); default: the "
                        "CUDA card, and an error when there is none")
    p.add_argument("--dist_backend", choices=("nccl", "gloo"),
                   default="nccl",
                   help="collective backend of a --mesh_data x --mesh_model "
                        "grid of ranks: nccl (one rank a card) or gloo "
                        "(ranks may share a card, or run on the CPU)")
    return p


def _bool_flag(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"invalid bool {s!r}")


def config_from_namespace(ns: argparse.Namespace) -> TrainConfig:
    """The resolved TrainConfig of parsed flags (`--device` and
    `--dist_backend` left out)."""
    overrides = {k: v for k, v in vars(ns).items()
                 if v is not None and k not in ("device", "dist_backend")}
    if isinstance(overrides.get("ent_emb"), list):
        overrides["ent_emb"] = tuple(overrides["ent_emb"])
    return TrainConfig(**overrides).resolved()


def config_from_argv(argv=None) -> TrainConfig:
    return config_from_namespace(build_arg_parser().parse_args(argv))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no card and no explicit device this raises rather than
    carrying on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def resolve_gnn_dtype(name: str, device) -> torch.dtype:
    """'auto' -> bfloat16 on CUDA (the analog of the reference's fp16 amp,
    reference qagnn.py:232-234), float32 elsewhere."""
    if name == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" \
            else torch.float32
    if name not in ("bfloat16", "float32"):
        raise ValueError(
            f"gnn_dtype must be one of auto/bfloat16/float32, got {name!r}")
    return getattr(torch, name)
