"""One epoch of the CLI's training on a grid of ranks, on a synthetic set.

Counterpart of `dryrun_multichip` in __graft_entry__.py:77-172, which jits
the JAX CLI's train step over a virtual n-device mesh: here `cli.train`
itself starts n ranks (parallel/launch.py) on an (n / 2, 2) grid (n / 1
for odd or small n), each training on its data and edge slice with the
entity table's rows split over `model`, 2 microbatches a step, the tiny
BERT that data/synthetic.py writes read through --encoder_load.

    python -c "from qagnn_tpu_torch.parallel.dryrun import *; \\
        dryrun_multichip(4)"

runs it on the card, one rank a card over NCCL (raising where there is
none, or fewer cards than ranks); device="cpu" runs the ranks on the CPU
over gloo, as the tests do.
"""

from __future__ import annotations

import os
import tempfile

import torch


def dryrun_multichip(n_devices: int = 4, device=None) -> dict:
    """Train one epoch on `n_devices` ranks on `device` (the cards unless
    the caller names the CPU) and return cli.train's result (rank 0's)."""
    from qagnn_tpu_torch import cli
    from qagnn_tpu_torch.data.synthetic import (
        write_synthetic_dataset,
        write_tiny_bert_checkpoint,
    )
    from qagnn_tpu_torch.utils.config import TrainConfig

    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // n_model
    bs = max(2, n_data) * 2
    with tempfile.TemporaryDirectory(prefix="qagnn_dryrun_") as tmp:
        emb_path = write_synthetic_dataset(tmp, n_questions=bs, n_choices=2,
                                           n_concept=64)
        bert = write_tiny_bert_checkpoint(os.path.join(tmp, "bert"))
        cfg = TrainConfig(
            dataset="csqa", encoder="bert-base-uncased", encoder_load=bert,
            inhouse=False, save_dir=os.path.join(tmp, "out"),
            save_model=False, n_epochs=1, batch_size=bs,
            mini_batch_size=bs // 2, eval_batch_size=bs, max_seq_len=16,
            max_node_num=8, num_relation=10, k=2, gnn_dim=8, fc_dim=8,
            att_head_num=2, unfreeze_epoch=0, log_interval=1,
            mesh_data=n_data, mesh_model=n_model).resolved()
        # resolved() formats the paths with {dataset}; these are absolute
        for split in ("train", "dev", "test"):
            setattr(cfg, f"{split}_statements",
                    f"{tmp}/statement/{split}.statement.jsonl")
            setattr(cfg, f"{split}_adj", f"{tmp}/graph/{split}.graph.adj.pk")
        cfg.ent_emb_paths = (emb_path,)
        on_cpu = device is not None and torch.device(device).type == "cpu"
        result = cli.train(cfg, device,
                           dist_backend="gloo" if on_cpu else "nccl")
    print(f"dryrun_multichip({n_devices}): {n_data} x {n_model} ranks, "
          f"loss={result['train_losses'][0]:.4f}")
    return result
