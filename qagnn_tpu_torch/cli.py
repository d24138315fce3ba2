"""Training / evaluation entry point: the CLI.

Counterpart of qagnn_tpu/cli.py (reference qagnn.py:41-433, main / train /
eval_detail): the epoch loop with the encoder freeze schedule, per-epoch
dev/test accuracy, best-dev checkpointing, early stopping, log.csv and
per-epoch test-prediction CSVs, over the dataset files the JAX CLI reads.
Checkpoints carry parameters, BatchNorm statistics, the optimizer's state
and step and the dropout generator (utils/checkpoint.py); the reference
saves weights only (reference qagnn.py:317-333).

Run:  python -m qagnn_tpu_torch.cli --dataset obqa --encoder roberta-large \
          --encoder_load DIR ...

It runs on the CUDA card, and raises when there is none, unless `--device`
names another device (`--device cpu`).
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from qagnn_tpu_torch.data.loader import QAGNNDataLoader
from qagnn_tpu_torch.data.word_tokenizer import WordTokenizer
from qagnn_tpu_torch.models.gpt_encoder import GPTConfig, GPTTextEncoder
from qagnn_tpu_torch.models.hf_loading import load_encoder_checkpoint
from qagnn_tpu_torch.models.lstm_encoder import LSTMConfig, LSTMTextEncoder
from qagnn_tpu_torch.models.qagnn import LMQAGNN
from qagnn_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from qagnn_tpu_torch.models.xlnet_encoder import (
    XLNetConfig,
    XLNetTextEncoder,
)
from qagnn_tpu_torch.train.optim import (
    build_train_optimizer,
    entity_table_names,
)
from qagnn_tpu_torch.train.step import (
    _merge_pretrained,
    make_detail_step,
    make_eval_step,
    make_train_step,
)
from qagnn_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_into,
    save_checkpoint,
)
from qagnn_tpu_torch.utils.config import (
    TrainConfig,
    build_arg_parser,
    config_from_namespace,
    resolve_device,
    resolve_gnn_dtype,
)
from qagnn_tpu_torch.utils.initialization import init_weights

ENTITY_TABLE = "decoder.concept_emb.emb.weight"


def build_model_and_data(cfg: TrainConfig, device, tokenizer=None):
    """The dataloader and the model, built on `device` (weights not yet
    initialised), from a resolved TrainConfig. Returns (dataset, model,
    entity table (numpy), pretrained encoder parameters or None)."""
    dev = torch.device(device)
    if tokenizer is None and cfg.lstm_vocab and "lstm" in cfg.encoder:
        tokenizer = WordTokenizer(cfg.lstm_vocab)
    if tokenizer is None and cfg.encoder_load \
            and os.path.isdir(cfg.encoder_load):
        # offline hosts: an HF save_pretrained checkpoint dir ships its
        # tokenizer; prefer it over a hub lookup by encoder name
        try:
            from transformers import AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(cfg.encoder_load)
        except (ImportError, OSError, ValueError):
            tokenizer = None

    dataset = QAGNNDataLoader(
        train_statements=cfg.train_statements, train_adj=cfg.train_adj,
        dev_statements=cfg.dev_statements, dev_adj=cfg.dev_adj,
        test_statements=cfg.test_statements, test_adj=cfg.test_adj,
        model_name=cfg.encoder, max_node_num=cfg.max_node_num,
        max_seq_len=cfg.max_seq_len, batch_size=cfg.batch_size,
        eval_batch_size=cfg.eval_batch_size, is_inhouse=cfg.inhouse,
        inhouse_train_qids_path=cfg.inhouse_train_qids,
        subsample=cfg.subsample, seed=cfg.seed, tokenizer=tokenizer,
        pin_memory=dev.type == "cuda")

    # entity embeddings (reference qagnn.py:124-125)
    cp_emb = np.concatenate([np.load(p) for p in cfg.ent_emb_paths],
                            axis=1).astype(np.float32, copy=False)
    n_concept, concept_in_dim = cp_emb.shape

    enc_cfg, pretrained_encoder = load_pretrained_encoder(cfg)
    with torch.device(dev):
        model = LMQAGNN(
            encoder=make_encoder(enc_cfg), sent_dim=enc_cfg.hidden_size,
            k=cfg.k, n_ntype=4, n_etype=cfg.num_relation,
            n_concept=n_concept, concept_dim=cfg.gnn_dim,
            concept_in_dim=concept_in_dim, n_attention_head=cfg.att_head_num,
            fc_dim=cfg.fc_dim, n_fc_layer=cfg.fc_layer_num,
            p_emb=cfg.dropouti, p_gnn=cfg.dropoutg, p_fc=cfg.dropoutf,
            gnn_backend=cfg.gnn_backend,
            gnn_dtype=resolve_gnn_dtype(cfg.gnn_dtype, dev))
    return dataset, model, cp_emb, pretrained_encoder


def _encoder_dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.encoder_dtype == "bfloat16" \
        else torch.float32


def load_pretrained_encoder(cfg: TrainConfig):
    """(encoder config, pretrained parameters or None) for --encoder_load.

    The reference always starts from HF pretrained weights (reference
    modeling/modeling_encoder.py:102-108); here the source is the explicit
    --encoder_load path (an HF save_pretrained dir, a torch state-dict file,
    or a cached hub name). A config.json beside the weights wins over the
    name-based preset, so shapes always match the checkpoint."""
    if not cfg.encoder_load:
        return encoder_config_for(cfg), None
    try:
        fallback = encoder_config_for(cfg)
    except ValueError:
        fallback = None
    return load_encoder_checkpoint(cfg.encoder_load,
                                   dtype=_encoder_dtype(cfg),
                                   fallback_config=fallback)


def make_encoder(enc_cfg) -> torch.nn.Module:
    """The encoder module for a resolved config (reference
    modeling/modeling_encoder.py:16-32 MODEL_NAME_TO_CLASS)."""
    if isinstance(enc_cfg, GPTConfig):
        return GPTTextEncoder(enc_cfg)
    if isinstance(enc_cfg, XLNetConfig):
        return XLNetTextEncoder(enc_cfg)
    if isinstance(enc_cfg, LSTMConfig):
        return LSTMTextEncoder.from_config(enc_cfg)
    return TextEncoder(enc_cfg)


def encoder_config_for(cfg: TrainConfig):
    """The preset encoder config of `cfg.encoder` in `cfg.encoder_dtype`
    (the LSTM computes in f32 whatever it says)."""
    dtype = _encoder_dtype(cfg)
    name = cfg.encoder
    if name == "lstm":
        if not cfg.lstm_vocab:
            raise ValueError("--encoder lstm requires --lstm_vocab (build "
                             "one with word_tokenizer.make_word_vocab)")
        return LSTMConfig(vocab_size=WordTokenizer(cfg.lstm_vocab).vocab_size)
    if name == "tiny-lstm":
        vocab_size = WordTokenizer(cfg.lstm_vocab).vocab_size \
            if cfg.lstm_vocab else 256
        return LSTMConfig.tiny(vocab_size=vocab_size)
    if name == "tiny-gpt":
        return GPTConfig.tiny(dtype=dtype)
    if name == "tiny-xlnet":
        return XLNetConfig.tiny(dtype=dtype)
    if "gpt" in name:
        return GPTConfig.openai_gpt(dtype=dtype)
    if name.startswith("xlnet-large"):
        return XLNetConfig.xlnet_large(dtype=dtype)
    if name.startswith("xlnet"):
        return XLNetConfig(dtype=dtype)
    if name == "roberta-large":
        return TextEncoderConfig.roberta_large(dtype=dtype)
    if name == "roberta-base":
        return TextEncoderConfig.roberta_base(dtype=dtype)
    if "SapBERT" in name or name.startswith("bert-base"):
        return TextEncoderConfig.bert_base(dtype=dtype)
    if name in ("bert-large-uncased", "bert-large-cased"):
        return TextEncoderConfig.bert_base(hidden_size=1024, num_layers=24,
                                           num_heads=16,
                                           intermediate_size=4096,
                                           dtype=dtype)
    if name.startswith("albert-xxlarge"):
        return TextEncoderConfig.albert_xxlarge(dtype=dtype)
    if name.startswith("albert"):
        return TextEncoderConfig.albert_base(dtype=dtype)
    if name == "tiny":  # tests / smoke runs
        return TextEncoderConfig.tiny(dtype=dtype)
    raise ValueError(
        f"unsupported encoder {name!r} (roberta/bert/SapBERT/albert/gpt/"
        "xlnet families; lstm via --encoder lstm)")


def _logits(out: torch.Tensor) -> np.ndarray:
    return out.float().cpu().numpy()


def train(cfg: TrainConfig, device=None) -> dict:
    """Train from the dataset files of `cfg` on `device` (the card unless
    the caller names another; raises when there is none)."""
    dev = resolve_device(device)
    if max(1, cfg.mesh_data) * max(1, cfg.mesh_model) > 1:
        raise NotImplementedError(
            f"a {cfg.mesh_data} x {cfg.mesh_model} device mesh is not ported "
            "(ROADMAP A7); the port trains on one card")

    os.makedirs(cfg.save_dir, exist_ok=True)
    cfg.export(os.path.join(cfg.save_dir, "config.json"))
    log_path = os.path.join(cfg.save_dir, "log.csv")
    with open(log_path, "w") as f:
        f.write("step,dev_acc,test_acc\n")

    dataset, model, cp_emb, pretrained_encoder = build_model_and_data(cfg, dev)
    if pretrained_encoder is None and cfg.encoder != "tiny":
        print(f"WARNING: encoder {cfg.encoder!r} starts from RANDOM weights "
              "— pass --encoder_load for the reference's pretrained-LM "
              "behavior", flush=True)

    # one generator, seeded from --seed on the device: the initial weights,
    # then every dropout mask; its state is part of the checkpoint
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    init_weights(model, generator, cfg.init_range)
    # qagnn_tpu.cli draws one permutation here (its init sample); drawing
    # it too keeps both packages' epochs on one shuffle
    dataset.rng.permutation(dataset.inhouse_train_idx)
    steps_per_epoch = max(1, dataset.train_size() // cfg.batch_size)
    optimizer = build_train_optimizer(
        model, optim=cfg.optim, encoder_lr=cfg.encoder_lr,
        decoder_lr=cfg.decoder_lr, weight_decay=cfg.weight_decay,
        max_grad_norm=cfg.max_grad_norm, lr_schedule=cfg.lr_schedule,
        warmup_steps=int(cfg.warmup_steps),
        total_steps=cfg.n_epochs * steps_per_epoch,
        # the frozen entity table (reference --freeze_ent_emb, qagnn.py:63)
        frozen=entity_table_names(model) if cfg.freeze_ent_emb else ())

    pretrained = {ENTITY_TABLE: cp_emb}
    if pretrained_encoder is not None:
        pretrained.update({"encoder." + k: v
                           for k, v in pretrained_encoder.items()})
    _merge_pretrained(model, pretrained)
    del pretrained, cp_emb, pretrained_encoder

    # warm start / resume (reference qagnn.py:163-166 --load_model_path, but
    # restoring the full state: parameters, BN statistics, optimizer, step,
    # generator)
    if cfg.load_model_path:
        state, _ = load_checkpoint(cfg.load_model_path)
        restore_into(state, model, optimizer, generator)
        del state
        print(f"resumed from {cfg.load_model_path} at step "
              f"{int(optimizer.state['step'])}", flush=True)

    # parameter inventory (reference qagnn.py:199-206)
    def count(prefix):
        return sum(p.numel() for n, p in model.named_parameters()
                   if n.startswith(prefix))
    enc_params, dec_params = count("encoder."), count("decoder.")
    print(f"| encoder params {enc_params:,} | decoder params {dec_params:,} "
          f"| total {enc_params + dec_params:,} |", flush=True)

    num_mb = max(1, cfg.batch_size // cfg.mini_batch_size) \
        if cfg.mini_batch_size > 0 else 1
    train_step = make_train_step(model, optimizer, dev, loss_name=cfg.loss,
                                 num_microbatches=num_mb,
                                 encoder_layer_id=cfg.encoder_layer)
    eval_step = make_eval_step(model, dev, encoder_layer_id=cfg.encoder_layer)

    def evaluate(split_iter):
        correct, total = 0, 0
        preds = []
        for qids, batch, pad in split_iter:
            logits = _logits(eval_step(batch.lm_inputs, batch.graph))
            n = logits.shape[0] - pad
            correct += int((logits[:n].argmax(1) ==
                            batch.labels[:n].numpy()).sum())
            total += n
            preds.extend(zip(qids, logits[:n].argmax(1).tolist()))
        return (correct / max(total, 1)), preds

    best_dev_acc, final_test_acc, best_dev_epoch = 0.0, 0.0, 0
    global_step, total_loss, interval_edges = 0, 0.0, 0
    loss_history: list[float] = []
    start = time.time()

    # edges aggregated per train step, printed per log interval, counted
    # over REAL (mask-true) edges: the padded edge budget would inflate
    # edges/s, whereas the reference's dynamic edge list counts only real
    # edges (reference modeling/modeling_qagnn.py:244-251)
    profiler = None
    for epoch in range(cfg.n_epochs):
        encoder_trainable = (epoch >= cfg.unfreeze_epoch
                             and epoch < cfg.refreeze_epoch)
        for qids, batch in dataset.train():
            if cfg.profile_dir and global_step == cfg.profile_start_step:
                profiler = _start_profiler(dev)
            interval_edges += int(batch.graph.edge_mask.sum()) * cfg.k
            metrics = train_step(batch, encoder_trainable, generator)
            loss = float(metrics["loss"])
            total_loss += loss
            loss_history.append(loss)
            if profiler is not None and global_step >= (
                    cfg.profile_start_step + cfg.profile_num_steps - 1):
                _stop_profiler(profiler, cfg.profile_dir)
                profiler = None
            if (global_step + 1) % cfg.log_interval == 0:
                dt = (time.time() - start) / cfg.log_interval
                print(f"| step {global_step:5} | loss "
                      f"{total_loss / cfg.log_interval:7.4f} | ms/batch "
                      f"{1000 * dt:7.2f} | edges/s "
                      f"{interval_edges / (dt * cfg.log_interval):10.3g} |",
                      flush=True)
                total_loss, interval_edges, start = 0.0, 0, time.time()
            global_step += 1

        dev_acc, _ = evaluate(dataset.dev())
        test_acc, test_preds = (0.0, [])
        if dataset.test_size() > 0:
            test_acc, test_preds = evaluate(dataset.test())
        print(f"| epoch {epoch:3} | dev_acc {dev_acc:7.4f} | test_acc "
              f"{test_acc:7.4f} |", flush=True)
        with open(log_path, "a") as f:
            f.write(f"{global_step},{dev_acc},{test_acc}\n")

        if cfg.save_model and test_preds:
            ppath = os.path.join(cfg.save_dir,
                                 f"predictions_test_e{epoch}.csv")
            with open(ppath, "w") as f:
                for qid, p in test_preds:
                    f.write(f"{qid},{chr(ord('A') + int(p))}\n")

        if dev_acc >= best_dev_acc:
            best_dev_acc, final_test_acc, best_dev_epoch = (
                dev_acc, test_acc, epoch)
            if cfg.save_model:
                save_checkpoint(os.path.join(cfg.save_dir, "checkpoint"),
                                model, optimizer, generator, cfg)
        if epoch > cfg.unfreeze_epoch and \
                epoch - best_dev_epoch >= cfg.max_epochs_before_stop:
            break
    if profiler is not None:     # the run ended inside the traced window
        _stop_profiler(profiler, cfg.profile_dir)

    print(f"| best dev_acc {best_dev_acc:.4f} (epoch {best_dev_epoch}) | "
          f"final test_acc {final_test_acc:.4f} |")
    return {"best_dev_acc": best_dev_acc, "final_test_acc": final_test_acc,
            "best_dev_epoch": best_dev_epoch, "train_losses": loss_history}


def _start_profiler(dev: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir: str) -> None:
    """End the trace (the step's loss was read, so the device is done) and
    write it as a Chrome trace into `profile_dir`."""
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    profiler.export_chrome_trace(path)
    print(f"| profiler trace written to {path} |", flush=True)


def eval_detail(cfg: TrainConfig, device=None) -> dict:
    """Evaluation from the checkpoint at cfg.load_model_path (reference
    qagnn.py:343-430) on `device` (the card unless the caller names
    another; raises when there is none)."""
    dev = resolve_device(device)
    state, saved_cfg = load_checkpoint(cfg.load_model_path)
    if saved_cfg is None:
        raise FileNotFoundError(
            f"no {cfg.load_model_path}.config.json beside the checkpoint")
    # encoder_load is kept when the path still exists: the checkpoint
    # supplies the weights, but on offline hosts the encoder_load directory
    # is also the only tokenizer source
    if saved_cfg.encoder_load and not os.path.exists(
            str(saved_cfg.encoder_load)):
        saved_cfg.encoder_load = None
    dataset, model, _, _ = build_model_and_data(saved_cfg, dev)
    restore_into(state, model)
    del state
    eval_step = make_eval_step(model, dev,
                               encoder_layer_id=saved_cfg.encoder_layer)

    # Detail mode (reference qagnn.py:407-424 + modeling_qagnn.py:236-241):
    # beyond the prediction CSV, dump the pooler attention, the per-layer
    # GNN edge and self-loop attention weights and the graph tensors for the
    # first `detail_batches` test batches (the full split's are TB-scale).
    detail_batches = cfg.detail_batches
    detail_step = make_detail_step(
        model, dev, encoder_layer_id=saved_cfg.encoder_layer) \
        if detail_batches else None

    def evaluate(split_iter, out_csv=None, detail_path=None):
        correct, total, rows, detailed = 0, 0, [], 0
        for qids, batch, pad in split_iter:
            if detail_path and detailed < detail_batches:
                logits, pool_attn, (edge_a, self_a) = detail_step(
                    batch.lm_inputs, batch.graph)
                logits = _logits(logits)
                g = batch.graph
                np.savez_compressed(
                    f"{detail_path}.{detailed}.npz",
                    qids=np.asarray(qids), logits=logits,
                    pool_attn=_logits(pool_attn),
                    gnn_edge_alpha=_logits(edge_a),
                    gnn_self_alpha=_logits(self_a),
                    concept_ids=g.concept_ids.numpy(),
                    node_types=g.node_types.numpy(),
                    edge_src=g.edge_src.numpy(),
                    edge_dst=g.edge_dst.numpy(),
                    edge_type=g.edge_type.numpy(),
                    edge_mask=g.edge_mask.numpy())
                detailed += 1
            else:
                logits = _logits(eval_step(batch.lm_inputs, batch.graph))
            n = logits.shape[0] - pad
            labels = batch.labels[:n].numpy()
            correct += int((logits[:n].argmax(1) == labels).sum())
            total += n
            rows.extend((q, chr(ord("A") + int(p)))
                        for q, p in zip(qids, logits[:n].argmax(1)))
        if out_csv:
            with open(out_csv, "w") as f:
                csv.writer(f).writerows(rows)
        return correct / max(total, 1)

    dev_acc = evaluate(dataset.dev())
    test_acc = evaluate(
        dataset.test(), os.path.join(cfg.save_dir, "predictions_test.csv"),
        detail_path=os.path.join(cfg.save_dir, "test_detail")) \
        if dataset.test_size() else 0.0
    print(f"| dev_acc {dev_acc:.4f} | test_acc {test_acc:.4f} |")
    return {"dev_acc": dev_acc, "test_acc": test_acc}


def main(argv=None):
    ns = build_arg_parser().parse_args(argv)
    cfg = config_from_namespace(ns)
    if cfg.mode == "train":
        return train(cfg, ns.device)
    if cfg.mode == "eval_detail":
        return eval_detail(cfg, ns.device)
    raise ValueError(f"invalid mode {cfg.mode!r}")


if __name__ == "__main__":
    main()
