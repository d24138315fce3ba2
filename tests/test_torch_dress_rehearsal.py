"""The port's dress rehearsal (qagnn_tpu_torch/tools/dress_rehearsal.py)
on the CPU.

  * `python -m qagnn_tpu_torch.tools.dress_rehearsal --synthetic --device
    cpu` exits 0 with status OK (the JAX tool's test,
    tests/test_dress_rehearsal.py, for the port);
  * on one synthetic set and tiny BERT directory: the port's pooled
    step-0 sent_vecs equal HF AutoModel's (the reference's encoder) within
    2e-3 by the JAX tool's measure, and its step-0 loss equals the JAX
    rehearsal's (qagnn_tpu.cli's pipeline, init_variables, make_eval_step)
    on the same first batch, from the JAX variables carried across by
    utils/convert.py, within rtol 2e-4, and so do its logits (rtol 2e-4 of
    the largest: at random weights the loss sits near ln 2 whatever the
    logits are);
  * that comparison runs at the JAX tool's num_relation=7 on graphs whose
    first batch holds relation ids 8 and 9, past the 8 relation features,
    which both packages give no relation feature.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import qagnn_tpu.cli as jax_cli
from qagnn_tpu.train.losses import LOSSES as JAX_LOSSES
from qagnn_tpu.train.step import _merge_pretrained as jax_merge
from qagnn_tpu.train.step import make_eval_step as jax_eval_step
from qagnn_tpu.utils import config as jax_config
from qagnn_tpu.utils.initialization import init_variables
from tools.dress_rehearsal import torch_sent_vecs

from qagnn_tpu_torch import cli
from qagnn_tpu_torch.data.synthetic import (
    write_synthetic_dataset,
    write_tiny_bert_checkpoint,
)
from qagnn_tpu_torch.tools import dress_rehearsal
from qagnn_tpu_torch.utils.convert import load_flax_variables

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_synthetic_rehearsal_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "qagnn_tpu_torch.tools.dress_rehearsal",
         "--synthetic", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "HF_HUB_OFFLINE": "1",
             "TRANSFORMERS_OFFLINE": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["status"] == "OK" and report["device"] == "cpu"
    assert report["sent_vec_max_rel"] < 2e-3
    assert np.isfinite(report["step0_loss"])


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rehearsal")
    droot = str(tmp / "data")
    emb_path = write_synthetic_dataset(droot, n_questions=4)
    enc_dir = write_tiny_bert_checkpoint(str(tmp / "bert_tiny"))
    cfg = dress_rehearsal.synthetic_cfg(droot, emb_path, enc_dir,
                                        str(tmp / "saved"))
    return cfg, enc_dir


def _jax_step0(cfg):
    """The JAX rehearsal's steps 1-2 and 4 (tools/dress_rehearsal.py
    :171-215) on the same files: (step-0 loss, logits, merged variables as
    numpy)."""
    jcfg = jax_config.TrainConfig(**{
        f: getattr(cfg, f) for f in jax_config.TrainConfig.__dataclass_fields__
        if hasattr(cfg, f)})
    dataset, model, cp_emb, pretrained_encoder = \
        jax_cli.build_model_and_data(jcfg)
    _, batch = next(dataset.train())
    variables = init_variables(model, jax.random.PRNGKey(cfg.seed),
                               batch.lm_inputs, batch.graph)
    pretrained = {"decoder": {"concept_emb": {"emb": {
        "embedding": np.asarray(cp_emb)}}},
        "encoder": pretrained_encoder}
    params = jax_merge(variables["params"], pretrained)
    logits = jax_eval_step(model, encoder_layer_id=cfg.encoder_layer)(
        params, variables["batch_stats"], batch.lm_inputs, batch.graph)
    loss = float(JAX_LOSSES[cfg.loss](logits, batch.labels))
    return loss, np.asarray(logits), jax.tree.map(np.asarray, {
        "params": params, "batch_stats": variables["batch_stats"]})


def test_step0_matches_hf_and_the_jax_rehearsal(synthetic):
    cfg, enc_dir = synthetic
    want_loss, want_logits, v = _jax_step0(cfg)

    report, arrays = dress_rehearsal.rehearse(
        cfg, "cpu", init=lambda model, gen: load_flax_variables(
            model, v["params"], v["batch_stats"]))
    assert report["status"] == "OK"
    assert report["step0_loss"] == pytest.approx(want_loss, rel=2e-4)
    # near ln 2 at random weights, so the logits are held too
    err = np.abs(arrays["logits"] - want_logits).max()
    assert err <= 2e-4 * np.abs(want_logits).max(), err

    # the JAX tool's measure against HF's torch model on the same inputs
    want = torch_sent_vecs(enc_dir, {k: t.numpy() for k, t in
                                     arrays["lm_inputs"].items()},
                           cfg.encoder_layer)
    diff = np.abs(arrays["sent_vecs"] - want)
    assert float((diff / np.maximum(np.abs(want), 1.0)).max()) < 2e-3


def test_rehearsal_runs_the_jax_tools_relation_count(synthetic):
    """num_relation is the JAX tool's 7 (tools/dress_rehearsal.py:103), and
    the batch the step-0 comparison takes holds live edges of relation ids
    at or above its 8 relation features."""
    cfg, _ = synthetic
    assert cfg.num_relation == dress_rehearsal.SYNTHETIC_RELATIONS == 7
    dataset, *_ = cli.build_model_and_data(cfg, "cpu")
    _, batch = next(dataset.train())
    live = batch.graph.edge_type[batch.graph.edge_mask]
    assert int(live.max()) >= cfg.num_relation + 1
