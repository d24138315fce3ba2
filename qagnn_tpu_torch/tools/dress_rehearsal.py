"""The accuracy-parity dress rehearsal: the real-data run as one command,
with a synthetic mode that runs hermetically.

Counterpart of tools/dress_rehearsal.py. The accuracy target (CSQA dev
0.7707, REFERENCE_DEV_ACC) needs the preprocessed datasets and a pretrained
roberta-large checkpoint, which the repository does not hold. With them:

    python -m qagnn_tpu_torch.tools.dress_rehearsal --dataset csqa \
        --data_root data --encoder_load /path/to/roberta-large --train

In order, on the card unless --device names another device:
  1. builds the driver's TrainConfig for the dataset (the presets of
     `python -m qagnn_tpu_torch.cli --dataset csqa`);
  2. loads the first train batch through the driver's data pipeline
     (statements, graph .pk files, entity embeddings), initialises the model
     and merges the pretrained encoder and the entity table as cli.train
     does;
  3. step-0 encoder check: the pooled sent_vecs of the model's encoder on
     the device against those of the same checkpoint read into the port's
     encoder in float32 on the CPU, max |d| / max(|want|, 1) < 2e-3 (on the
     CPU the two coincide; tests/test_torch_dress_rehearsal.py holds them
     against HF's AutoModel, the reference's encoder);
  4. prints the step-0 logits and loss of the batch (make_eval_step and the
     configured loss);
  5. with --train: cli.train and its dev / test accuracy against the
     reference's.

The last line is a JSON report; its status is FAIL, and the exit code 1,
when step 3 fails. --synthetic writes a tiny dataset and a tiny BERT
checkpoint (qagnn_tpu_torch.data.synthetic) into a temporary directory and
runs the steps on them. The real-data mode refuses missing files and
fetches nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from qagnn_tpu_torch import cli
from qagnn_tpu_torch.models.hf_loading import load_encoder_checkpoint
from qagnn_tpu_torch.ops import _build
from qagnn_tpu_torch.train.losses import LOSSES
from qagnn_tpu_torch.train.step import _merge_pretrained, make_eval_step
from qagnn_tpu_torch.utils.config import TrainConfig, preset, resolve_device
from qagnn_tpu_torch.utils.initialization import init_weights

SENT_VEC_TOL = 2e-3    # the device's encoder against f32 on the CPU

REFERENCE_DEV_ACC = {"csqa": 0.7707, "obqa": 0.686, "medqa_usmle": 0.38}
SYNTHETIC_RELATIONS = 7


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="csqa",
                    choices=["csqa", "obqa", "medqa_usmle"])
    ap.add_argument("--data_root", default="data",
                    help="reference data layout root (README 'Data "
                         "acquisition'): {root}/{dataset}/statement/... ")
    ap.add_argument("--encoder_load", default=None,
                    help="HF save_pretrained dir (e.g. roberta-large)")
    ap.add_argument("--encoder", default=None,
                    help="encoder family override (default: dataset preset)")
    ap.add_argument("--train", action="store_true",
                    help="run full training and report dev/test accuracy "
                         "vs the reference targets")
    ap.add_argument("--synthetic", action="store_true",
                    help="generate a tiny dataset+checkpoint and rehearse "
                         "the pipeline hermetically")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (e.g. cpu); default: the CUDA card, "
                         "and an error when there is none")
    return ap.parse_args(argv)


def build_cfg(args, root, encoder_load, tmp) -> TrainConfig:
    overrides = {"encoder": args.encoder} if args.encoder else {}
    cfg = preset(args.dataset, **overrides)
    cfg.encoder_load = encoder_load
    cfg.save_dir = os.path.join(tmp, "saved")
    if args.batch_size:
        cfg.batch_size = args.batch_size
        cfg.mini_batch_size = min(cfg.mini_batch_size, args.batch_size)
    d = args.dataset
    cfg.train_statements = f"{root}/{d}/statement/train.statement.jsonl"
    cfg.dev_statements = f"{root}/{d}/statement/dev.statement.jsonl"
    cfg.test_statements = f"{root}/{d}/statement/test.statement.jsonl"
    cfg.train_adj = f"{root}/{d}/graph/train.graph.adj.pk"
    cfg.dev_adj = f"{root}/{d}/graph/dev.graph.adj.pk"
    cfg.test_adj = f"{root}/{d}/graph/test.graph.adj.pk"
    cfg.inhouse_train_qids = f"{root}/{d}/inhouse_split_qids.txt"
    return cfg


def synthetic_cfg(droot, emb_path, enc_dir, save_dir) -> TrainConfig:
    """The JAX tool's synthetic run configuration (:86-103) over a dataset
    at `droot` and a checkpoint at `enc_dir`, num_relation 7 included. The
    synthetic graphs hold relation ids 0-9 (3 relations and the 2 context
    ones, each with its inverse), so ids 8 and 9 lie past the 8 relation
    features: both packages give them no relation feature (a zero row of
    jax.nn.one_hot; the port's kernels and scatter branch alike)."""
    cfg = TrainConfig(dataset="csqa", encoder="bert-base-uncased",
                      encoder_load=enc_dir, inhouse=False,
                      batch_size=4, mini_batch_size=4, eval_batch_size=4,
                      n_epochs=1, max_seq_len=24, max_node_num=8,
                      num_relation=SYNTHETIC_RELATIONS,
                      save_dir=save_dir).resolved()
    cfg.train_statements = f"{droot}/statement/train.statement.jsonl"
    cfg.dev_statements = f"{droot}/statement/dev.statement.jsonl"
    cfg.test_statements = f"{droot}/statement/test.statement.jsonl"
    cfg.train_adj = f"{droot}/graph/train.graph.adj.pk"
    cfg.dev_adj = f"{droot}/graph/dev.graph.adj.pk"
    cfg.test_adj = f"{droot}/graph/test.graph.adj.pk"
    cfg.ent_emb_paths = (emb_path,)
    return cfg


def build_synthetic(tmp) -> TrainConfig:
    from qagnn_tpu_torch.data.synthetic import (
        write_synthetic_dataset,
        write_tiny_bert_checkpoint,
    )

    droot = os.path.join(tmp, "data")
    emb_path = write_synthetic_dataset(droot, n_questions=4)
    enc_dir = write_tiny_bert_checkpoint(os.path.join(tmp, "bert_tiny"))
    return synthetic_cfg(droot, emb_path, enc_dir,
                         os.path.join(tmp, "saved"))


def sent_vecs(encoder, lm_inputs: dict, layer_id: int,
              device) -> np.ndarray:
    """The encoder's pooled sent_vecs of (B, C, L) inputs on `device`,
    (B * C, hidden) float32."""
    flat = {k: v.reshape(-1, v.shape[-1]).to(device)
            for k, v in lm_inputs.items()}
    with torch.inference_mode():
        out = encoder.eval()(**flat, layer_id=layer_id)
    if isinstance(out, tuple):
        out = out[0]
    return out.float().cpu().numpy()


def cpu_sent_vecs(cfg: TrainConfig, lm_inputs: dict) -> np.ndarray:
    """The same checkpoint read into the port's encoder in float32 on the
    CPU."""
    try:
        fallback = cli.encoder_config_for(cfg)
    except ValueError:
        fallback = None
    enc_cfg, params = load_encoder_checkpoint(
        cfg.encoder_load, dtype=torch.float32, fallback_config=fallback)
    encoder = cli.make_encoder(enc_cfg)
    _merge_pretrained(encoder, params)
    return sent_vecs(encoder, lm_inputs, cfg.encoder_layer, "cpu")


def rehearse(cfg: TrainConfig, device=None, train: bool = False,
             init=None, synthetic: bool = False) -> tuple[dict, dict]:
    """Steps 2-5 on `device` (the card unless the caller names another).
    `init(model, generator)` replaces cli.train's initialisation when
    given. Returns (the report, {"lm_inputs": the first batch's LM inputs,
    "sent_vecs": its pooled sent_vecs and "logits" its step-0 logits from
    the device})."""
    dev = resolve_device(device)
    report = {"dataset": cfg.dataset, "encoder": cfg.encoder,
              "synthetic": bool(synthetic), "device": str(dev)}

    # ---- steps 1-2: the driver's pipeline up to the first batch ----------
    dataset, model, cp_emb, pretrained_encoder = cli.build_model_and_data(
        cfg, dev)
    qids, batch = next(dataset.train())
    print(f"| loaded first batch: {len(qids)} questions, graph "
          f"{tuple(batch.graph.concept_ids.shape)} edges "
          f"{tuple(batch.graph.edge_src.shape)} |", flush=True)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    if init is None:
        init_weights(model, generator, cfg.init_range)
    else:
        init(model, generator)
    pretrained = {cli.ENTITY_TABLE: cp_emb}
    if pretrained_encoder is not None:
        pretrained.update({"encoder." + k: v
                           for k, v in pretrained_encoder.items()})
    _merge_pretrained(model, pretrained)
    arrays = {"lm_inputs": batch.lm_inputs}

    # ---- step 3: step-0 sent_vecs, the device against f32 on the CPU -----
    if pretrained_encoder is not None:
        ours = sent_vecs(model.encoder, batch.lm_inputs, cfg.encoder_layer,
                         dev)
        want = cpu_sent_vecs(cfg, batch.lm_inputs)
        arrays["sent_vecs"] = ours
        scale = np.maximum(np.abs(want), 1.0)
        rel = float((np.abs(ours - want) / scale).max())
        report["sent_vec_max_rel"] = rel
        ok = rel < SENT_VEC_TOL
        print(f"| step-0 sent_vecs on {dev.type} vs f32 on the CPU: max rel "
              f"{rel:.2e} {'OK' if ok else 'FAIL'} |", flush=True)
        if not ok:
            report["status"] = "FAIL"
            return report, arrays
    else:
        print("| encoder check skipped (no pretrained encoder loaded) |")

    # ---- step 4: step-0 logits and loss ----------------------------------
    eval_step = make_eval_step(model, dev, encoder_layer_id=cfg.encoder_layer)
    logits = eval_step(batch.lm_inputs, batch.graph).float()
    loss = LOSSES[cfg.loss](logits, batch.labels.to(dev))
    arrays["logits"] = logits.cpu().numpy()
    report["step0_loss"] = loss.item()
    report["step0_logits_mean"] = logits.mean().item()
    print(f"| step-0 loss {report['step0_loss']:.6f} | logits mean "
          f"{report['step0_logits_mean']:.6f} |", flush=True)
    del model, eval_step

    # ---- step 5: the real run --------------------------------------------
    if train:
        result = cli.train(cfg, dev)
        target = REFERENCE_DEV_ACC.get(cfg.dataset)
        report.update(result)
        report["reference_dev_acc"] = target
        print(f"| final dev_acc {result.get('best_dev_acc')} vs reference "
              f"{target} |", flush=True)
    if dev.type == "cuda":
        report["launches"] = dict(_build.LAUNCHES)
    report.setdefault("status", "OK")
    return report, arrays


def main(argv=None) -> int:
    args = parse_args(argv)
    tmp = tempfile.mkdtemp(prefix="qagnn_rehearsal_")
    try:
        if args.synthetic:
            cfg = build_synthetic(tmp)
        else:
            if not args.encoder_load:
                raise SystemExit("--encoder_load is required (or "
                                 "--synthetic)")
            cfg = build_cfg(args, args.data_root, args.encoder_load, tmp)
            for p in (cfg.train_statements, cfg.train_adj):
                if not os.path.exists(p):
                    raise SystemExit(
                        f"missing {p} — fetch per README 'Data acquisition'")
            print(f"| run directory {tmp} |", flush=True)
        report, _ = rehearse(cfg, args.device, train=args.train,
                             synthetic=args.synthetic)
    finally:
        if args.synthetic:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(report))
    return 0 if report["status"] == "OK" else 1


if __name__ == "__main__":
    sys.exit(main())
