"""Drive the PyTorch/CUDA port (qagnn_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card. It

  1. prints the card's name and power limit and turns TF32 off;
  2. builds the hand-written kernels of qagnn_tpu_torch/csrc with nvcc, and
     the loader's C++ edge packer (qagnn_tpu_torch/native) with g++;
  3. holds each kernel against its plain PyTorch version on the card, at the
     slices' shapes (G=64 graphs, N=200 nodes, E=4096 edge slots, D=HD=200,
     4 heads) with about 25% of edge slots masked, one graph with every edge
     masked, and a ragged-E case, in float32 and bfloat16 (backward pass 1
     with and without a carry), and times both with CUDA events; the GAT
     forward passes A and C and the two backward passes also at other widths
     (D=24, HD=40, which need padding; 96 x 128; 256 x 256; the forward
     also at 264 x 200, 520 x 64 with 8 heads and 1040 x 136 with one head,
     where W's rows stream through shared memory), on both of their routes
     in both dtypes (the backward passes in bf16 also on route 2, the
     wgmma edge kernel, logged in turns with route 1 at the main shapes),
     with their masked slots held exactly, their
     tensor-core kernels timed in turns with the CUDA-core ones on the
     same inputs, and torch.profiler's device time by kernel name (all four
     passes run on tensor cores in f32 too, split-TF32 products, timed at
     the main shapes in turns with their CUDA-core kernels on the same f32
     inputs, their bound at a third of the tf32 rate); the
     streaming kernel of the forward passes also at 200 x 200 and 256 x 256,
     against the plain versions and timed in turns with the resident
     kernel that route 1 runs there; the
     edge encoder's hidden pass and its backward on both of their routes in
     both dtypes (also at D=24 x F=16, D=256 x F=64, the CLI's default
     D=100, odd D=37 and D=512 and 1040, where route 1 runs D's columns as
     slices), route 1 timed in turns with route 0 at the main shapes in
     both dtypes and at D=100; the
     feature moments exactly, also for the MedQA relations, 7 node types and
     unaligned arrays, beside an empty kernel's time, with the CUDA kernels
     of one call listed (one launch); the unprojected op's five kernels
     (scores, denominators, aggregation, backward passes 1 and 2) on both
     of their routes in f32 and bf16, their masked slots held exactly, the
     degrees exactly and an all-masked graph's max at -1e30 (also at HD=96
     and HD=256 with 8 heads, and at N=4000, where backward pass 2 runs
     route 0 alone), route 1 timed in turns with route 0 in both dtypes and
     listed by torch.profiler;
  4. holds the gradients of the autograd Functions on the kernels (the
     projected op, the train-mode edge encoder, the unprojected op) against
     torch.autograd through the plain scatter path, in float32;
  5. drives the op-level entry point `relational_gat_attention_nodes` on
     CUDA tensors with no backend named, forward and backward, checks that
     each of the unprojected op's five kernels ran exactly once (each on
     its route 1 in bf16) and
     that the scatter backend launched none,
     compares both backends, and times
     them beside the projected op at the same shapes;
  6. serves the OBQA roberta-large LMQAGNN (random weights from a seed,
     perturbed BatchNorm running statistics) through `make_eval_step` on the
     kernel path, checks that every kernel ran the expected number of times
     (the GAT forward passes on their tensor-core route), and compares the
     logits with the same model on the scatter path; and measures the
     encoder computing in bf16 against f32 (logits and times; the default
     stays f32);
  7. runs the same model through `make_detail_step` (logits, pooler
     attention, per-layer attention weights; by design no GAT kernel) and
     checks shapes, the logits and that every softmax sums to 1;
  8. trains the same model through `make_train_step` (RAdam, clipping, the
     entity table frozen): one step on the kernel path against one on the
     scatter path from the same state, then steps on a fixed batch with the
     preset's dropout, the same masks at every step (loss finite and
     falling), steps with the encoder
     frozen, and a step in two microbatches, counting the launches of every
     kernel per step and the route of the six entry points that have two;
     then the optimizer alone, trained and frozen, under torch.profiler
     (the kernels its multi-tensor passes launch, which must be fewer than
     two a tensor), and one optimizer step on the card against the same
     step on CPU copies of the same state (max|dp| / max|p| within 1e-6);
  9. drives the CLI, qagnn_tpu_torch.cli, at the same widths from a
     dataset it writes to a temporary directory (reference-format
     statements and ConceptNet-like graphs of 100-199 concepts in the
     4096-edge bucket, 48 / 16 / 16 questions x 4 choices, the 799,273 x 1024
     entity table as .npy) and a random roberta-large it writes as an
     HF-format directory (`--encoder_load`), tokenized by a word-level
     tokenizer: `train` (one frozen epoch, one trained, checkpointed),
     `eval_detail` from the checkpoint and a resumed epoch. It checks the
     losses, the encoder as loaded, the restored optimizer state and step,
     eval_detail's logits against the trained model's, the loader's pinned
     batches, and the launches and routes of rows 6-12 per train step and
     of rows 6, 7 and 11 per eval batch; and prints the CLI's per-step
     log lines, the host gather (by parts: the C++ pack and its rows'
     setup, numpy's argsort beside them) and H2D copy of a batch, the
     device span of a step, checkpoint bytes and seconds, and eval_detail's
     batch times;
 10. trains through the CLI at the production GNN widths (k=5, gnn_dim
     200, 200-node graphs, 38 relations, bf16) with a 4-layer BERT read
     through --encoder_load on the 4-question synthetic set whose dev split
     is its train split: the best dev accuracy must reach 1.0, the last
     loss fall under half the first, and eval_detail from the checkpoint
     score dev 1.0 (the `overfit` phase);
 11. serves, trains and drives the CLI with each of the other encoder
     families at its published width under the same OBQA decoder (the
     `encoders` phase): albert-xxlarge-v2, openai-gpt (its table grown by
     the GPT layout's three special tokens) and xlnet-large-cased from
     random weights written as HF-format directories and read back through
     `load_encoder_checkpoint`, and the LSTM (300 wide, 2 bidirectional
     layers) over a word vocabulary written by `make_word_vocab`. For each:
     the encoder on the card against the same module on the CPU (f32, TF32
     off); requests through `make_eval_step` (rows 6, 7 and 11 counted per
     forward, the logits against the scatter path, the request time and
     the encoder's and decoder's device spans); steps through
     `make_train_step`, trained then frozen (rows 6-12 per step, the loss
     falling, the step time and peak memory); and `cli.train` (one frozen
     epoch, one trained, checkpointed) and `eval_detail` on a dataset it
     writes (16 questions x 4 choices a split, an entity table of 100,000
     rows x 1024), the launches per call counted;
 12. runs the grid of ranks (qagnn_tpu_torch/parallel; the `mesh` phase),
     every rank a process on this one card over gloo: first a probe that
     the port's collectives (all_reduce SUM and MAX, all_gather, broadcast)
     take CUDA tensors there; then rows 1-12 on E/2 and E/4 edge slices
     (1 x 2 and 1 x 4 grids): each rank's sharded forward and backward of
     the projected op, the unprojected op and the train-mode edge encoder
     against the unsharded kernels on rank 0, in f32 and bf16, one launch
     of each entry point a rank on E/P slots, each entry point timed alone
     on its slice beside its whole-E time, and each collective's time; then
     cli.train on a 2 x 2 grid (OBQA's GNN widths, the whole entity table
     split over 2, the overfit phase's BERT, dropout on) against the same
     command at 1 x 1: the per-step losses, each rank's launches and peak
     memory, and rank 0's checkpoint in a one-card eval_detail whose dev
     logits must be the grid's;
 13. runs the preprocessing vertical (qagnn_tpu_torch/preprocess; the
     `preprocess` phase, no kernel of rows 1-12) on inputs it writes:
     extract_english on a small raw ConceptNet file (merges, swaps, a
     dropped relation, a non-English tail); run_common's construct_graph
     and KG.build_indices on an English CSV at ConceptNet's scale (799,273
     concepts, 2.5 M triples, heavy-tailed degrees); run_dataset("obqa")
     with 4 worker processes on 32 questions x 4 choices (the train split
     alone), scored by
     make_torch_mlm_scorer's random roberta-large MLM (decoder tied) on the
     card, the first statements' scores held against the same model on
     the CPU; run_medqa on a DDB-sized graph (10,000 entities) with the
     SapBERT table of a random BERT-base on the card, its first 256 names
     held against the CPU. It prints host seconds by stage, Part 2's
     sentences/s, device ms a chunk and idle share, SapBERT's names/s and
     the peak memory;
 14. runs the port's tools (qagnn_tpu_torch/tools; the `tools` phase):
     parity_check's bf16 bands at their full shapes (rows 1-5 through the
     op, rows 6-12 through QAGNNMessagePassing in train mode, each band
     against the f32 value of its own function on the CPU; PARITY OK and
     each row's launches); profile_step at its full shapes, its trace read
     by trace_summary, which must list rows 6-12's __global__ kernels as
     often as the traced steps launched them (an empty trace taken again
     once); `dress_rehearsal --synthetic --train` as a command (status OK,
     the step-0 encoder on the card within 2e-3 of the CPU's, rows 6-12
     launched); and `python -m qagnn_tpu_torch.cli` on a synthetic set with
     --profile_dir over two train steps, its trace.json read the same way;
 15. runs the port at widths one kernel launch does not take and at
     relation ids past the relation features (the `widths` phase): rows
     10-12 at the OBQA preset's F = 47 with ids n_rel and n_rel + 1 on a
     tenth of the live slots, both routes, against their plain versions
     (which give such a slot no relation feature, as the JAX package's
     one-hot does); rows 1-5 through `relational_gat_attention_nodes` at
     (HD 100, 4 heads: heads padded), (HD 320, 10 heads: two head groups),
     (HD 300, 1 head) and (HD 1040, 2 heads), the last two a head wider
     than a launch run in column slices, forward and backward against the
     scatter backend, each row launched once a head group or slice, every
     split launch against its plain version, with their times (a call's
     beside its launches' alone: the launches read and write column views
     in place); passes A
     and C at D = 200 with one head of 304 features on both routes; rows
     6-12 through QAGNNMessagePassing in train mode at gnn_dim 512 (two
     head groups a pass) and 1040 (four heads of 264 features, two column
     slices each, every launch against its plain version) against the
     scatter path, the output, and every parameter gradient against one
     reference, the scatter path in float64 under deterministic algorithms
     (f32: each of nine draws of the kernel path under 2e-3, their mean
     under twice the mean of nine f32 scatter draws, ROADMAP C14), with the
     launches and routes (every launch of rows 6-9 on tensor cores in both
     dtypes, backward passes 1 and 2 streaming W's rows past D = 256); the
     passes alone at both widths on both routes against their plain
     versions, at E and E - 3, every launch of rows 6-9 held against its
     plain version in both dtypes, and the times of rows 6-9 and 11-12
     there beside their bounds, by call and by launch (one edge kernel a
     column launch of rows 8 and 9), rows 6 and 7 and 11 and 12 in both
     dtypes and rows 8 and 9 in f32 in turns with their CUDA-core route on
     the same inputs, rows 8 and 9 in bf16 in turns with the mma.sync edge
     kernel (route 1) that route 2's wgmma kernel replaced there; rows 11
     and 12 with relation ids past n_rel at D =
     200 and 100; `python -m qagnn_tpu_torch.cli --gnn_dim 512` and
     `--gnn_dim 1040`, side by side, for two train steps each, and beside
     them `cli.main` at the default gnn_dim and at --gnn_dtype float32,
     rows 11 and 12 on route 1 alone; and the fused GNN at gnn_dim 100
     (the kernels' 104, which the edge encoder emits and the layers carry)
     and 200 in both dtypes, its served forward and train step timed and
     no edge-sized pad or copy in a step (torch.profiler). The `overfit` phase
     also logs, per GAT layer of the trained model, the largest gap between
     a graph's max score and a source's, and the denominators under
     DENOM_EPS (ROADMAP C7);
 16. stops every process it started that is still running (the forkserver
     of the preprocess phase's pools, multiprocessing's resource tracker,
     and any process a child left behind: the script takes its orphans as
     a subreaper), naming each one it had to stop;
 17. prints one JSON line of per-kernel numbers, the card's name and power
     limit, and as its last line {"ok": true, "device": {...}}.

`--only kernels,grads,op,serve,detail,train,cli,overfit,encoders,mesh,
preprocess,tools,widths` runs
a subset of the phases (for work on one of them; `fwd`, `bwd`, `enc`,
`moments` and `unproj` are the kernel phase's parts for the GAT forward
passes A and C,
for the two GAT backward passes, for the edge encoder's three kernels (rows
10-12), for its feature moments (row 10) and for the unprojected op's five
kernels (rows 1-5) alone; `scores` runs rows 1 and 2 alone at the main
shapes, which no other phase repeats; `inplace`, of the widths phase
alone, the fused GNN at gnn_dim 100 and 200 and rows 1-5's call times
beside their launches' at HD 300 and 1040);
with no arguments everything runs. `--csrc DIR` builds the kernels from a
copy of the sources in DIR.

It exits non-zero, printing no result, when there is no CUDA device or any
check fails. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import dataclasses
import gc
import hashlib
import io
import json
import math
import multiprocessing
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import os
import pathlib
import pickle
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from unittest import mock

import numpy as np
import torch

from qagnn_tpu_torch.cli import make_encoder
from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.models.gnn import EdgeEncoder, QAGNNMessagePassing
from qagnn_tpu_torch.models.norm import MaskedBatchNorm
from qagnn_tpu_torch.models.qagnn import LMQAGNN
from qagnn_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from qagnn_tpu_torch.native import build as native_build
from qagnn_tpu_torch.ops import _build
from qagnn_tpu_torch.ops import edge_encoder_kernels as ek
from qagnn_tpu_torch.ops import gat_kernels as gk
from qagnn_tpu_torch.ops import gat_unproj_kernels as uk
from qagnn_tpu_torch.ops.gat_attention import relational_gat_attention_nodes
from qagnn_tpu_torch.train.optim import (
    build_train_optimizer,
    entity_table_names,
)
from qagnn_tpu_torch.train.step import (
    Batch,
    make_detail_step,
    make_eval_step,
    make_train_step,
)
from qagnn_tpu_torch.utils.config import preset
from qagnn_tpu_torch.utils.initialization import init_weights

SEED = 0
DEVICE = "cuda"
# both slices: the batch bench.py times end to end (B=16 x C=4)
B, C, L = 16, 4, 100
G, N, E = B * C, 200, 4096
HEADS = 4
N_NTYPE = 4
N_CONCEPT, CONCEPT_IN = 799_273, 1024        # ConceptNet entity table
# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the f32 route of backward passes 1 and 2 (rows 8 and 9) runs on the tf32
# tensor cores (495e12 dense), each f32 product as three tf32 products of
# split operands (hi hi + hi lo + lo hi): f32-accurate operations at a
# third of the tf32 rate, the least time of that work
SPLIT_TF32_FLOPS = 495e12 / 3

# kernel vs plain: max|got - want| <= TOL * max|want|. The GAT passes sum in
# f32 in another order (and with atomics); edge_hidden's bf16 output may
# round the other way at one ulp (2^-7 relative).
TOL = {"edge_hidden": {torch.float32: 1e-5, torch.bfloat16: 2 ** -7},
       "gat": 1e-4,
       # pass C and the forward's output: in bf16 alpha and each weighted
       # message are rounded to bf16 before the sum and may round the other
       # way at one ulp (2^-8 relative)
       "gat_c": {torch.float32: 1e-4, torch.bfloat16: 2 ** -7},
       # backward: sums over all G*E slots in f32 in another order; in bf16
       # the stored d_edge_emb and the rounded cotangents may round the other
       # way at one ulp (2^-8 relative)
       "bwd": {torch.float32: 1e-4, torch.bfloat16: 2 ** -7},
       # the unprojected op's kernels: f32 sums in another order (warp
       # shuffles, atomics); in bf16 the weighted message, d_msg, dekb and
       # the dnq term are rounded to bf16 before they are stored or summed
       # and may round the other way at one ulp (2^-8 relative)
       "unproj": {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}}
# gradients of the Functions on the kernels vs autograd through the scatter
# path, f32, same relative form: sums of other orders, exp by another routine
GRAD_TOL = 2e-4
# kernel path vs scatter path, logits and GNN output, same relative form: in
# f32 the paths differ by summation order; in bf16 they round at different
# places (the kernel path composes linear_1 into key_e / msg_e in f32), which
# reached 2.2e-4 on the logits and 8.1e-3 on the GNN output on an H100.
# the op-level entry point, "cuda" against "scatter" run in f32 on the same
# inputs, same relative form. f32: summation order. bf16 inputs: the kernels
# keep f32 between their rounding points (weighted message, cotangents), a
# few bf16 ulps of the largest value after the sums; the gradients come back
# in bf16, one more rounding.
OP_TOL = {torch.float32: {"out": 1e-4, "grad": 2e-4},
          torch.bfloat16: {"out": 2 ** -7, "grad": 2e-2}}
# every softmax of the detail step sums to 1: the pooler's in f32; the GNN's
# attention weights in the GNN's compute dtype, where in bf16 each weight is
# rounded (2^-9 relative) and the denominators are summed in bf16
ALPHA_SUM_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
LOGIT_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}
GNN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# one train step, kernel path vs scatter path, f32 GNN, dropout 0: the loss
# and the global gradient norm relative to themselves, named parameter
# gradients relative to their largest value (the kernel path composes
# linear_1 into key_e / msg_e and takes the edge rows' BatchNorm moments in
# closed form)
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-3, "grad": 2e-3}
TRAIN_STEPS = 10                 # timed steps on the fixed batch
OPT = dict(optim="radam", encoder_lr=1e-5, decoder_lr=1e-3,
           weight_decay=0.01, max_grad_norm=1.0)

FAILURES: list[str] = []


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


PR_SET_CHILD_SUBREAPER = 36   # linux/prctl.h


def take_orphans() -> None:
    """Make this process the subreaper of its descendants: a process whose
    parent exits (a rank's, a pool's, a tool's child) is handed to this
    one, not to init, so `stop_children` still finds it."""
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(
            PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)


def _children_of(pids: set[int]) -> set[int]:
    """The live processes whose parent is in `pids`, read from /proc."""
    out = set()
    for entry in pathlib.Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
        except OSError:
            continue
        # pid (comm) state ppid ...: comm may hold spaces and parentheses
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if int(ppid) in pids and state != "Z":
            out.add(int(entry.name))
    return out


def _descendants() -> set[int]:
    found, front = set(), {os.getpid()}
    while front:
        front = _children_of(front) - found
        found |= front
    return found


def _cmdline(pid: int) -> str:
    try:
        raw = pathlib.Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return "?"
    return raw.replace(b"\0", b" ").decode(errors="replace").strip()[:160]


def _reap() -> None:
    """Collect the exit status of every child that has ended."""
    with contextlib.suppress(ChildProcessError):
        while os.waitpid(-1, os.WNOHANG)[0]:
            pass


def _stop_helpers() -> None:
    """Close the pipes that keep multiprocessing's forkserver and resource
    tracker alive and wait for both to exit (each a no-op when it never
    started)."""
    with contextlib.suppress(Exception):
        multiprocessing.forkserver._forkserver._stop()
    with contextlib.suppress(Exception):
        multiprocessing.resource_tracker._resource_tracker._stop()


def stop_children(grace_s: float = 10.0) -> list[str]:
    """Stop every process this one started that is still running, and wait
    for each: the forkserver and the resource tracker, which multiprocessing
    keeps until the interpreter exits, by their own shutdown; whatever is
    left after `grace_s` seconds of that by SIGTERM, then SIGKILL. Returns
    "pid: command line" of each process that was running."""
    # multiprocessing objects already dropped release their semaphores
    # before the tracker that holds their names stops
    gc.collect()
    named = [f"{pid}: {_cmdline(pid)}" for pid in sorted(_descendants())]
    if not named:
        return named
    # the helpers' own shutdown waits on their exit without a time limit:
    # it runs beside the deadline, and the signals below end that wait
    helpers = threading.Thread(target=_stop_helpers, daemon=True)
    helpers.start()
    helpers.join(grace_s)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        left = sorted(_descendants())
        for pid in left:
            with contextlib.suppress(ProcessLookupError, PermissionError):
                os.kill(pid, sig)
        deadline = time.monotonic() + grace_s
        while left and time.monotonic() < deadline:
            time.sleep(0.1)
            _reap()
            left = sorted(_descendants())
        if not left:
            break
    helpers.join(grace_s)
    _reap()
    return named


class WordTokenizer:
    """A word-level tokenizer over a fixed vocabulary, for the cli,
    encoders and preprocess phases (tokenizers are built here, not read
    from a hub): lower-cases, splits on whitespace and punctuation as BERT's
    basic tokenizer does, maps unknown words to `unk_token`. Not a fast HF
    tokenizer, so the loader assembles the pairs itself (data/statements.py
    `load_pair_statements`); `get_vocab` and `add_tokens` serve the GPT
    layout (`load_gpt_statements`), whose special tokens are added whole;
    the batch call serves the MLM scorer and the SapBERT table."""

    is_fast = False

    def __init__(self, vocab, cls_token="<s>", sep_token="</s>",
                 unk_token="<unk>", pad_token="<pad>",
                 model_max_length=512):
        self.ids = {w: i for i, w in enumerate(vocab)}
        self.cls_token, self.sep_token = cls_token, sep_token
        self.pad_token, self.model_max_length = pad_token, model_max_length
        self.unk_id = self.ids[unk_token]

    def tokenize(self, text: str) -> list[str]:
        return re.findall(r"\w+|[^\w\s]", text.lower())

    def convert_tokens_to_ids(self, tokens) -> list[int]:
        return [self.ids.get(t, self.unk_id) for t in tokens]

    def get_vocab(self) -> dict[str, int]:
        return dict(self.ids)

    def add_tokens(self, tokens) -> int:
        new = [t for t in tokens if t not in self.ids]
        for t in new:
            self.ids[t] = len(self.ids)
        return len(new)

    def __call__(self, texts, padding=True, truncation=False,
                 return_tensors="pt"):
        """The HF batch call of the preprocess phase's model steps
        (qagnn_tpu_torch.preprocess: tok(list, padding=True[,
        truncation=True], return_tensors="pt")): `cls_token` words
        `sep_token` per text, cut to `model_max_length` when truncating,
        padded on the right with `pad_token`'s id; torch tensors."""
        cls_id, sep_id = self.ids[self.cls_token], self.ids[self.sep_token]
        rows = []
        for text in texts:
            ids = self.convert_tokens_to_ids(self.tokenize(text))
            if truncation:
                ids = ids[:self.model_max_length - 2]
            rows.append([cls_id] + ids + [sep_id])
        width = max(map(len, rows))
        input_ids = np.full((len(rows), width), self.ids[self.pad_token])
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            input_ids[i, :len(r)], mask[i, :len(r)] = r, 1
        return {"input_ids": torch.from_numpy(input_ids),
                "attention_mask": torch.from_numpy(mask)}


def compare(what: str, got, want, tol: float, scale=None) -> float:
    """max|got - want| <= tol * max|want| (or tol * scale, for an array
    whose true value is zero)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        FAILURES.append(f"{what}: shape {tuple(got.shape)} vs "
                        f"{tuple(want.shape)}")
        return float("inf")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    ref = want.abs().max().item() if want.numel() else 0.0
    if scale is not None:
        ref = float(scale)
    rel = err / ref if ref > 0 else err
    ok = bool(torch.isfinite(got).all()) and rel <= tol
    log(f"  {what:<44} max_abs_err {err:.3e}  max_rel_err {rel:.3e} "
        f"(of max|ref| {ref:.3e})  tol {tol:.1e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(what)
    return err


def bf16_steps(what: str, got, want) -> None:
    """Every element of got within one bf16 step of want's: |got - want| <=
    2^-7 |want| + 1e-6 max|want| (a rounding that sees an f32 sum one bit
    away lands one bf16 step away; the second term allows for the order of
    the f32 sums before it). A failure names the share of elements
    further."""
    got, want = got.float(), want.float()
    top = want.abs().max().item() if want.numel() else 0.0
    gap = (got - want).abs()
    far = gap > 2 ** -7 * want.abs() + 1e-6 * top
    n_far = int(far.sum().item())
    ok = n_far == 0 and bool(torch.isfinite(got).all())
    log(f"  {what:<44} elements beyond one bf16 step {n_far} of "
        f"{want.numel()}, differing {(gap > 0).float().mean().item():.2e}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{what}: one bf16 step")


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `iters` launches, by CUDA events.
    A spin kernel ahead of the timed launches keeps the host's launch
    overhead out of the device timeline."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def device_spans(modules: dict):
    """CUDA events around every forward of each named module. Returns the
    per-name lists of [start, end] events and the hook handles."""
    spans = {name: [] for name in modules}
    handles = []
    for name, mod in modules.items():
        def pre(mod, args, name=name):
            spans[name].append([torch.cuda.Event(enable_timing=True), None])
            spans[name][-1][0].record()

        def post(mod, args, out, name=name):
            spans[name][-1][1] = torch.cuda.Event(enable_timing=True)
            spans[name][-1][1].record()
        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    return spans, handles


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, flops: float, dtype,
          peak: float | None = None) -> tuple[float, str]:
    """The least time of the work in ms, bytes at HBM_BYTES_PER_S or
    operations at `peak` (PEAK_FLOPS[dtype] unless given), the larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_peak(dt) -> float:
    """The operations' peak of the projected op's passes A, C, 1 and 2 on
    route 1 in dt: bf16 products on tensor cores, or split-TF32 ones in
    f32."""
    return SPLIT_TF32_FLOPS if dt == torch.float32 else PEAK_FLOPS[dt]


def measure(reports, name, err, kernel, plain, n_bytes, flops, dtype,
            previous=None,
            previous_is="the CUDA-core kernels on the same bf16 inputs",
            peak=None, card=None):
    """Time a kernel and its plain version at the main path's inputs and
    file them, with the bound (operations at `peak`, `bound`), under
    `name`. No PyTorch call computes any of these functions whole, so
    library_ms is None. `previous`: the kernel's earlier version on the
    same inputs (`previous_is` says which), timed in turns with it (kernel,
    previous, previous, kernel) and printed as previous_ms. `card`: the
    card's line, printed beside the times."""
    if previous is None:
        ms = device_ms(kernel)
    else:
        ms = faster_than_previous(name, kernel, previous, previous_is)
    plain_ms = device_ms(plain)
    bound_ms, by = bound(n_bytes, flops, dtype, peak)
    log(f"  time {name:<18} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"bound {bound_ms:.4f} ms ({by})" + (f"  [{card}]" if card else ""))
    reports[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=by, library_ms=None)


def faster_than_previous(name, kernel, previous, previous_is, iters=20,
                         warmup=3, held=True):
    """Time a kernel in turns with its earlier version on the same inputs
    (kernel, previous, previous, kernel; medians of `iters` calls after
    `warmup`); a failure unless both of the kernel's times lie below both of
    the earlier version's, where `held` (else the two are only logged side
    by side). Returns the kernel's mean time."""
    timed = lambda fn: device_ms(fn, iters, warmup)  # noqa: E731
    ms = timed(kernel)
    prev = (timed(previous), timed(previous))
    again = timed(kernel)
    faster = max(ms, again) < min(prev)
    log(f"  time {name:<18} kernel {ms:.4f} and {again:.4f} ms  "
        f"previous_ms {sum(prev) / 2:.4f} ({prev[0]:.4f} and {prev[1]:.4f}:"
        f" {previous_is})  {'faster' if faster else 'NOT FASTER'}"
        + ("" if held else " (logged, not held)"))
    if held and not faster:
        FAILURES.append(f"{name}: the kernel on the main path is not "
                        "faster than its previous version")
    return (ms + again) / 2


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def graph_inputs(gen, dev, n_edges):
    mask = torch.rand((G, n_edges), generator=gen, device=dev) > 0.25
    mask[1] = False                        # a graph with every edge masked
    idx = lambda hi: torch.randint(0, hi, (G, n_edges), generator=gen,
                                   device=dev, dtype=torch.int32)
    return idx(N), idx(N), mask


def hidden_routes(dt, D, n_rel, n_ntype):
    """The routes of edge_hidden and its backward at this dtype and width:
    both where route 1 takes the width (F <= 64), else route 0."""
    return (0, 1) if ek._hidden_route(dt, D, n_rel, n_ntype) else (0,)


def hidden_times(name, tag, kernel, route0, plain, n_bytes, flops, card,
                 iters=20):
    """Route 1 of row 11 or 12 in turns with route 0 on the same inputs
    (route 1 must be the faster), beside its plain version and the bound
    (bytes, or f32 operations on CUDA cores)."""
    ms = faster_than_previous(f"{name} {tag}", kernel, route0,
                              "route 0 on the same inputs", iters=iters,
                              warmup=2)
    plain_ms = device_ms(plain, iters, 2)
    bound_ms, by = bound(n_bytes, flops, torch.float32)
    log(f"  time {name} {tag}: route 1 {ms:.4f} ms a call  plain "
        f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({by})  [{card}]")


def edge_hidden_case(reports, args, dt, tag, main, card=None):
    """edge_hidden on each route against its plain version; at the main
    shapes in bf16 also its time, route 1's beside route 0's on the same
    inputs, filed in `reports`; in f32, and wherever `card` is given, its
    times logged."""
    want = ek.edge_hidden_plain(*args, dt)
    for route in hidden_routes(dt, args[4].shape[1], *args[8:10]):
        got = ek.edge_hidden_forward(*args, dt, _route=route)
        err = compare(f"edge_hidden {tag} route {route}", got, want,
                      TOL["edge_hidden"][dt])
    # three row sums, bias, affine, relu per output element
    etype, src, dst, ntype, w0, b0, a, b = args[:8]
    n_bytes = nbytes(etype, src, dst, ntype, w0, b0, a, b, got)
    kernel = lambda: ek.edge_hidden_forward(*args, dt)  # noqa: E731
    route0 = lambda: ek.edge_hidden_forward(*args, dt, _route=0)  # noqa
    plain = lambda: ek.edge_hidden_plain(*args, dt)  # noqa: E731
    if main and dt == torch.bfloat16:
        measure(reports, "edge_hidden", err, kernel, plain, n_bytes,
                6.0 * got.numel(), torch.float32, previous=route0)
        profile_kernels("edge_hidden", kernel)
    elif card is not None:
        hidden_times("edge_hidden", tag, kernel, route0, plain, n_bytes,
                     6.0 * got.numel(), card)


def phase_edge_hidden(gen, dev, reports, card):
    n_rel = 39                             # 38 relations + the self loop
    F = n_rel + 2 * N_NTYPE
    D = 200
    w0 = torch.randn((F, D), generator=gen, device=dev) * 0.2
    b0, a, b = (torch.randn(D, generator=gen, device=dev) * 0.5
                for _ in range(3))
    ntype = torch.randint(0, N_NTYPE, (G, N), generator=gen, device=dev,
                          dtype=torch.int32)
    for n_edges in (E, E - 3):
        src, dst, _ = graph_inputs(gen, dev, n_edges)
        etype = torch.randint(0, n_rel, (G, n_edges), generator=gen,
                              device=dev, dtype=torch.int32)
        args = (etype, src, dst, ntype, w0, b0, a, b, n_rel, N_NTYPE)
        for dt in (torch.float32, torch.bfloat16):
            edge_hidden_case(reports, args, dt, f"E={n_edges} {dt}",
                             n_edges == E, card if n_edges == E else None)


def gat_fwd_case(reports, gen, dev, D, HD, heads, src, dst, mask, dt, tag,
                 main, card=None):
    """Passes A and C on every route their widths take in this dtype
    against their plain versions, masked slots' scores and the empty
    graph's max exactly, and the whole forward; at the main shapes also
    their times beside the plain versions' and the bound (operations at
    `tc_peak`), the tensor-core route's in turns with the CUDA-core
    kernels' (route 0) on the same inputs, which must be slower: filed in
    `reports` in bf16, the main path's dtype, and logged in f32 with the
    card's line."""
    sink, suffix = (reports, "") if dt == torch.bfloat16 \
        else (collections.defaultdict(dict), " f32")
    previous_is = f"the CUDA-core kernels on the same {dt} inputs"
    n_edges = src.shape[1]
    live = mask.float().mean().item()
    has_edge = mask.any(1)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    nq = (r(G, N, HD) / (HD // heads) ** 0.5).to(dt)
    nk, nm, skb, smb = ((r(G, N, HD) * 0.5).to(dt) for _ in range(4))
    emb = torch.relu(r(G, n_edges, D)).to(dt)
    w_ke, w_me = r(D, HD) * 0.05, r(D, HD) * 0.05
    b_ke, b_me = r(HD) * 0.1, r(HD) * 0.1
    # the routes its launches take (a head group or a column slice each)
    h0, h1, c0, c1 = gk.launches(HD, heads)[0]
    routes = (0, 1) if gk._fwd_route(dt, D, c1 - c0, h1 - h0, None) \
        else (0,)

    a_args = (nq, nk, emb, w_ke, b_ke, src, dst, mask, heads)
    scores_p, m_edge_p = gk.pass_a_scores_plain(*a_args)
    for route in routes:
        rtag = f"{tag} route {route}"
        scores, m_edge = gk.pass_a_scores(*a_args, _route=route)
        err = compare(f"gat_pass_a_scores scores {rtag}", scores, scores_p,
                      TOL["gat"])
        compare(f"gat_pass_a_scores max {rtag}", m_edge[has_edge],
                m_edge_p[has_edge], TOL["gat"])
        if not bool((m_edge[~has_edge] == gk.NEG).all()):
            FAILURES.append(f"gat_pass_a_scores max of empty graph {rtag}")
        if bool((scores.transpose(1, 2)[~mask] != 0).any()):
            FAILURES.append(f"gat_pass_a_scores masked slots {rtag}")
    if main:
        # live slots' emb rows and indices (a masked slot scores 0 and
        # needs nothing); the scores whole; projection and logits
        measure(sink, "gat_pass_a_scores" + suffix, err,
                lambda: gk.pass_a_scores(*a_args),
                lambda: gk.pass_a_scores_plain(*a_args),
                live * nbytes(emb, src, dst)
                + nbytes(nq, nk, w_ke, b_ke, mask, scores, m_edge),
                2.0 * live * G * n_edges * (D * HD + HD), dt,
                previous=lambda: gk.pass_a_scores(*a_args, _route=0),
                previous_is=previous_is, peak=tc_peak(dt), card=card)
        profile_kernels("gat_pass_a_scores" + suffix,
                        lambda: gk.pass_a_scores(*a_args))

    # the op's glue, as gat_projected_forward runs it
    self_scores = gk.head_sum(nq.float() * (nk + skb).float(), heads)
    gmax = torch.maximum(m_edge_p, self_scores.amax(1))
    e_self = torch.exp(self_scores - gmax[:, None, :])
    d_args = (scores_p, gmax, src, mask, N)
    denom, deg = gk.pass_a_denoms(*d_args)
    denom_p, deg_p = gk.pass_a_denoms_plain(*d_args)
    err = compare(f"gat_pass_a_denoms denom {tag}", denom, denom_p,
                  TOL["gat"])
    compare(f"gat_pass_a_denoms deg {tag}", deg, deg_p, 0.0)
    if main and dt == torch.bfloat16:
        # data-dependent: only the live edges' slots are read
        measure(reports, "gat_pass_a_denoms", err,
                lambda: gk.pass_a_denoms(*d_args),
                lambda: gk.pass_a_denoms_plain(*d_args),
                live * nbytes(scores_p, src)
                + nbytes(gmax, mask, denom, deg),
                2.0 * live * G * n_edges * heads, torch.float32)

    scale = (deg_p[..., None] + 1.0) \
        / torch.clamp_min(denom_p + e_self, gk.DENOM_EPS)
    seed = (nm.float() + smb.float()) * gk.heads_to_hd(e_self * scale, HD)
    c_args = (nm, emb, w_me, b_me, scores_p, gmax, scale, src, dst, mask)
    out_p = gk.pass_c_plain(*c_args, seed.clone(), heads)
    for route in routes:
        out = gk.pass_c(*c_args, seed.clone(), heads, _route=route)
        err = compare(f"gat_pass_c out {tag} route {route}", out, out_p,
                      TOL["gat_c"][dt])
    if main:
        # live edges only; the accumulator is read and written
        scratch = seed.clone()
        measure(sink, "gat_pass_c" + suffix, err,
                lambda: gk.pass_c(*c_args, scratch, heads),
                lambda: gk.pass_c_plain(*c_args, scratch, heads),
                live * nbytes(emb, scores_p, src, dst)
                + nbytes(nm, w_me, b_me, gmax, scale, mask)
                + 2 * nbytes(out),
                2.0 * live * G * n_edges * (D * HD + 2 * HD), dt,
                previous=lambda: gk.pass_c(*c_args, scratch, heads,
                                           _route=0),
                previous_is=previous_is, peak=tc_peak(dt), card=card)
        profile_kernels("gat_pass_c" + suffix,
                        lambda: gk.pass_c(*c_args, scratch, heads))

    # the whole op on the kernel path against the plain chain above
    op = gk.gat_projected_forward(nq, nk, nm, emb, w_ke, b_ke, w_me, b_me,
                                  skb, smb, src, dst, mask, heads)
    compare(f"gat_projected_forward out {tag}", op[0], out_p,
            TOL["gat_c"][dt])
    if not bool(torch.isfinite(op[0][~has_edge]).all()):
        FAILURES.append(f"non-finite output of empty graph {tag}")


# (D, HD, heads) of the forward phase: the backward phase's widths, then
# three past D = 256, where route 1 streams W's rows in chunks of 64 (a
# tail of 8 rows; 64 columns of 8 heads; a column slice of 136, 9 pairs)
FWD_WIDTHS = ((200, 200, HEADS), (24, 40, 4), (96, 128, 8), (256, 256, 8),
              (264, 200, 4), (520, 64, 8), (1040, 136, 1))


def phase_gat(gen, dev, reports, card):
    """Both routes in both dtypes wherever the widths take route 1 (bf16
    products on tensor cores, split-TF32 ones in f32), timed at the main
    shapes in both dtypes, the tensor-core route on the main path. Widths:
    FWD_WIDTHS."""
    for D, HD, heads in FWD_WIDTHS:
        for n_edges in (E, E - 3):
            src, dst, mask = graph_inputs(gen, dev, n_edges)
            for dt in (torch.float32, torch.bfloat16):
                main = D == 200 and n_edges == E
                gat_fwd_case(reports, gen, dev, D, HD, heads, src, dst, mask,
                             dt, f"D={D} HD={HD} E={n_edges} {dt}", main,
                             card)


# (D, HD, heads) at which the streaming kernel of passes A and C is timed
# beside the resident one that route 1 keeps at D <= 256: the preset's
# widths and the widest tile that holds W whole
STREAM_NARROW = ((200, 200, HEADS), (256, 256, 8))


def phase_gat_streamed(gen, dev, card):
    """Why route 1 of passes A and C holds W whole at D <= 256: there, on
    the streaming kernel (its plan and the bf16 W that the wrappers hand it
    past 256, by `gk._fwd_streams` patched), each pass against its plain
    version, then timed in turns with the resident kernel on the same
    inputs (resident, streamed, streamed, resident; medians of 20 calls,
    the streamed call's rounding of W to bf16 included)."""
    streamed = lambda: mock.patch.object(  # noqa: E731
        gk, "_fwd_streams", lambda D: True)
    for D, HD, heads in STREAM_NARROW:
        src, dst, mask = graph_inputs(gen, dev, E)
        r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa
        nq = (r(G, N, HD) / (HD // heads) ** 0.5).to(torch.bfloat16)
        nk, nm = ((r(G, N, HD) * 0.5).to(torch.bfloat16) for _ in range(2))
        emb = torch.relu(r(G, E, D)).to(torch.bfloat16)
        w, b_ = r(D, HD) * 0.05, r(HD) * 0.1
        a_args = (nq, nk, emb, w, b_, src, dst, mask, heads)
        scores_p, gmax = gk.pass_a_scores_plain(*a_args)
        tag = f"D={D} HD={HD} streamed"
        _build.reset_launch_counts()
        with streamed():
            scores, m_edge = gk.pass_a_scores(*a_args)
        compare(f"gat_pass_a_scores scores {tag}", scores, scores_p,
                TOL["gat"])
        has_edge = mask.any(1)
        compare(f"gat_pass_a_scores max {tag}", m_edge[has_edge],
                gmax[has_edge], TOL["gat"])
        scale = torch.rand((G, N, heads), generator=gen, device=dev)
        c_args = (nm, emb, w, b_, scores_p, gmax, scale, src, dst, mask)
        out0 = torch.zeros((G, N, HD), device=dev)
        with streamed():
            out = gk.pass_c(*c_args, out0.clone(), heads)
        compare(f"gat_pass_c out {tag}", out,
                gk.pass_c_plain(*c_args, out0.clone(), heads),
                TOL["gat_c"][torch.bfloat16])
        routes = {k: _build.ROUTES[k, 1]
                  for k in ("gat_pass_a_scores", "gat_pass_c")}
        if routes != {"gat_pass_a_scores": 1, "gat_pass_c": 1}:
            FAILURES.append(f"streamed passes {tag}: routes {routes}")
        for name, fn in (
                ("gat_pass_a_scores", lambda: gk.pass_a_scores(*a_args)),
                ("gat_pass_c", lambda: gk.pass_c(*c_args, out0, heads))):
            def on_stream(fn=fn):
                with streamed():
                    fn()
            ms = [device_ms(fn), device_ms(on_stream), device_ms(on_stream),
                  device_ms(fn)]
            log(f"  time {name} D={D} HD={HD} bf16: resident {ms[0]:.4f} "
                f"and {ms[3]:.4f} ms  streamed {ms[1]:.4f} and {ms[2]:.4f} "
                f"ms (streamed / resident "
                f"{(ms[1] + ms[2]) / (ms[0] + ms[3]):.3f})  [{card}]")


def encoder_ints(gen, dev, n_edges, n_rel):
    src, dst, mask = graph_inputs(gen, dev, n_edges)
    etype = torch.randint(0, n_rel, (G, n_edges), generator=gen, device=dev,
                          dtype=torch.int32)
    ntype = torch.randint(0, N_NTYPE, (G, N), generator=gen, device=dev,
                          dtype=torch.int32)
    return etype, src, dst, ntype, mask


def unaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary (the moments kernel then reads one slot a thread)."""
    buf = torch.empty(t.numel() + 16 // t.element_size(), device=t.device,
                      dtype=t.dtype)
    out = buf[4 // t.element_size():][:t.numel()].view(t.shape)
    out.copy_(t)
    return out


def phase_edge_moments(gen, more_gen, dev, reports):
    """The moments kernel against its plain version exactly: the OBQA /
    CSQA relations (39 with the self loop) at E and ragged E from `gen`;
    from `more_gen` the MedQA preset's (35), one relation and 7 node types,
    and arrays that start off a 16-byte boundary. Graph 1 has no masked
    slot in every case. At the main shapes also its time, the launch floor
    beside it, and the CUDA kernels of one call."""
    cases = [(gen, 39, N_NTYPE, E, False), (gen, 39, N_NTYPE, E - 3, False),
             (more_gen, 35, N_NTYPE, E, False),
             (more_gen, 1, 7, E - 3, False),
             (more_gen, 39, N_NTYPE, E - 3, True)]
    for g_, n_rel, n_ntype, n_edges, odd in cases:
        etype, src, dst, ntype, mask = encoder_ints(g_, dev, n_edges, n_rel)
        if n_ntype != N_NTYPE:
            ntype = torch.randint(0, n_ntype, ntype.shape, generator=g_,
                                  device=dev, dtype=torch.int32)
        ints = (etype, src, dst, ntype, mask)
        if odd:
            ints = tuple(unaligned(t) for t in ints)
        args = (*ints, n_rel, n_ntype)
        tag = f"n_rel={n_rel} n_ntype={n_ntype} E={n_edges}" \
            + (" unaligned" if odd else "")
        got = ek.edge_feature_moments(*args)
        want = ek.edge_feature_moments_plain(*args)
        errs = [compare(f"edge_moments {name} {tag}", g, w, 0.0)
                for name, g, w in zip(("hist", "M", "n"), got, want)]
        if n_rel == 39 and n_edges == E:
            # three increments of hist and nine of M per masked slot
            live = mask.float().mean().item()
            measure(reports, "edge_moments", max(errs),
                    lambda: ek.edge_feature_moments(*args),
                    lambda: ek.edge_feature_moments_plain(*args),
                    nbytes(*ints, *got), 13.0 * live * G * n_edges,
                    torch.float32)
            floor = device_ms(lambda: torch.cuda._sleep(0))
            log(f"  launch floor: an empty kernel (torch.cuda._sleep(0)) "
                f"{floor:.4f} ms by the same device_ms")
            for attempt in (1, 2):
                # the profiler drops an event now and then: a window that
                # holds fewer of the one kernel's launches is taken again
                rows = profile_kernels("edge_moments",
                                       lambda: ek.edge_feature_moments(*args))
                if attempt == 2 or rows is None or len(rows) != 1 \
                        or rows[0][1] >= 20:
                    break
                log("  fewer launches in the window than calls: traced "
                    "again")
            if rows is None:
                FAILURES.append("edge_moments: the profiler listed no "
                                "kernel of one call, so its one launch "
                                "is not shown")
            elif len(rows) != 1 or "edge_moments_kernel" not in rows[0][2] \
                    or rows[0][1] != 20:
                FAILURES.append("edge_moments: one call runs other kernels "
                                f"than its one launch: {rows}")
            else:
                log("  kernels of one edge_moments call: edge_moments_kernel"
                    " alone, one launch (no memset, no conversion)  ok")


def edge_hidden_bwd_case(reports, args, dt, tag, main, card=None):
    """The backward on each route against its plain version; times as in
    `edge_hidden_case`."""
    names = ("dW0", "db0", "da", "db")
    want = ek.edge_hidden_backward_plain(*args)
    for route in hidden_routes(dt, args[4].shape[1], *args[9:11]):
        got = ek.edge_hidden_backward(*args, _route=route)
        errs = [compare(f"edge_hidden_bwd {name} {tag} route {route}", g, w,
                        TOL["bwd"][dt])
                for name, g, w in zip(names, got, want)]
    # per element: three row sums, the affine, the relu mask, four
    # products and six accumulations
    etype, src, dst, ntype, w0, b0, a, b, dh = args[:9]
    n_bytes = nbytes(etype, src, dst, ntype, w0, b0, a, b, dh, *got)
    kernel = lambda: ek.edge_hidden_backward(*args)  # noqa: E731
    route0 = lambda: ek.edge_hidden_backward(*args, _route=0)  # noqa: E731
    plain = lambda: ek.edge_hidden_backward_plain(*args)  # noqa: E731
    if main and dt == torch.bfloat16:
        measure(reports, "edge_hidden_bwd", max(errs), kernel, plain,
                n_bytes, 16.0 * dh.numel(), torch.float32, previous=route0)
        profile_kernels("edge_hidden_bwd", kernel)
    elif card is not None:
        hidden_times("edge_hidden_bwd", tag, kernel, route0, plain, n_bytes,
                     16.0 * dh.numel(), card)


def phase_edge_hidden_bwd(gen, dev, reports, card):
    n_rel = 39
    F, D = n_rel + 2 * N_NTYPE, 200
    w0 = torch.randn((F, D), generator=gen, device=dev) * 0.2
    b0, a, b = (torch.randn(D, generator=gen, device=dev) * 0.5
                for _ in range(3))
    for n_edges in (E, E - 3):
        etype, src, dst, ntype, _ = encoder_ints(gen, dev, n_edges, n_rel)
        for dt in (torch.float32, torch.bfloat16):
            dh = torch.randn((G, n_edges, D), generator=gen, device=dev) \
                .to(dt)
            args = (etype, src, dst, ntype, w0, b0, a, b, dh, n_rel, N_NTYPE)
            edge_hidden_bwd_case(reports, args, dt, f"E={n_edges} {dt}",
                                 n_edges == E,
                                 card if n_edges == E else None)


def phase_edge_hidden_widths(gen, dev, reports, card):
    """Both edge-encoder hidden kernels off the main width, on both routes
    in both dtypes: D=24 x F=16 (route 1's product pads D to 32), D=256 x
    F=64 (one backward slice of 16 warps), D=100 x F=47 (the default
    gnn_dim, rows of 200 bytes in bf16: 8-byte pieces; timed), D=37 (odd:
    a bf16 row on a 2-byte boundary) and D=512 and 1040 (backward slices of
    256 and 208 columns; the forward's bf16 1040 and f32 tables in two or
    three slices), at E and E - 3."""
    for D, n_rel in ((24, 8), (256, 56), (100, 39), (37, 39), (512, 39),
                     (1040, 39)):
        F = n_rel + 2 * N_NTYPE
        w0 = torch.randn((F, D), generator=gen, device=dev) * 0.2
        b0, a, b = (torch.randn(D, generator=gen, device=dev) * 0.5
                    for _ in range(3))
        for n_edges in (E, E - 3):
            etype, src, dst, ntype, _ = encoder_ints(gen, dev, n_edges, n_rel)
            for dt in (torch.float32, torch.bfloat16):
                tag = f"D={D} F={F} E={n_edges} {dt}"
                args = (etype, src, dst, ntype, w0, b0, a, b, n_rel, N_NTYPE)
                timed = card if D == 100 and n_edges == E else None
                edge_hidden_case(reports, args, dt, tag, False, timed)
                dh = torch.randn((G, n_edges, D), generator=gen,
                                 device=dev).to(dt)
                edge_hidden_bwd_case(reports, args[:8] + (dh,) + args[8:],
                                     dt, tag, False, timed)


def profile_kernels(what, fn, iters=20, attempts=2, keep=None, show=8):
    """Device time by kernel name over `iters` calls of fn, from
    torch.profiler's CUDA activity: rows of (device us, launches, name), or
    None (and says so) where it records none. A window of short kernels
    at times comes back with no device activity, so an empty one is taken
    again, `attempts` times in all. `keep`: which kernel names to list
    (all by default); `show`: how many rows to print."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    device_us = lambda e: getattr(e, "device_time_total", None) \
        or getattr(e, "cuda_time_total", 0)
    rows = []
    for _ in range(attempts):
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
        except Exception as exc:  # a diagnostic: the checks do not need it
            log(f"  torch.profiler, {what}: failed on this machine: {exc!r}")
            return None
        rows = sorted(((device_us(e), e.count, e.key) for e in events
                       if device_us(e) > 0
                       and (keep is None or keep(e.key))), reverse=True)
        if rows:
            break
    if not rows:
        log(f"  torch.profiler, {what}: key_averages() shows no device time "
            "on this machine; times come from CUDA events")
        return None
    if show:
        log(f"  torch.profiler, {what}: device time per call by kernel, "
            f"{iters} calls")
    for us, count, key in rows[:show]:
        log(f"    {us / iters:10.1f} us  {count / iters:4.1f} launches  "
            f"{key[:100]}")
    return rows


def gat_bwd_inputs(gen, dev, D, HD, heads, src, dst, mask, dt):
    """Inputs of the two backward passes at one width, with the forward's
    residuals and the backward's glue as gat_projected_backward runs them."""
    n_edges = src.shape[1]
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    nq = (r(G, N, HD) / (HD // heads) ** 0.5).to(dt)
    nk, nm, skb, smb = ((r(G, N, HD) * 0.5).to(dt) for _ in range(4))
    emb = torch.relu(r(G, n_edges, D)).to(dt)
    w_ke, w_me = r(D, HD) * 0.05, r(D, HD) * 0.05
    b_ke, b_me = r(HD) * 0.1, r(HD) * 0.1
    gout = r(G, N, HD).to(dt)
    _, scores, gmax, denom_raw, scale, e_self = gk.gat_projected_forward(
        nq, nk, nm, emb, w_ke, b_ke, w_me, b_me, skb, smb, src, dst, mask,
        heads)
    dnm0 = gk.heads_to_hd(e_self * scale, HD) * gout.float()
    d_alpha_self = gk.head_sum((nm + smb).float() * gout.float(), heads)
    carry = (r(G, n_edges, D) * 0.1).to(dt)
    return dict(nq=nq, nk=nk, nm=nm, skb=skb, emb=emb, w_ke=w_ke, w_me=w_me,
                b_ke=b_ke, b_me=b_me, gout=gout, scores=scores, gmax=gmax,
                denom_raw=denom_raw, scale=scale, e_self=e_self, dnm0=dnm0,
                d_alpha_self=d_alpha_self, dscale0=d_alpha_self * e_self,
                carry=carry)


def gat_bwd_case(reports, t, src, dst, mask, heads, dt, tag, main):
    """Both backward passes against their plain versions on the inputs t,
    on the rule's route (`_edge_route`) and, in bf16, on route 2 (the
    wgmma edge kernel) named, which the rule leaves to a pass of several
    launches; at the main shapes also their times, in turns with the
    CUDA-core kernels (route 0) on the same inputs, which must be slower,
    beside the plain versions' and the bound (operations at `tc_peak`);
    in bf16 the rule's route in turns with route 2 too, logged beside each
    other and not held (a few per cent apart at the preset); and the
    device time by kernel of the routes: filed in `reports` in bf16, the
    main path's dtype, and logged in f32."""
    HD, D = t["nm"].shape[-1], t["emb"].shape[-1]
    sink, suffix = (reports, "") if dt == torch.bfloat16 \
        else (collections.defaultdict(dict), " f32")
    rule = gk._edge_route(dt, None, D, True)
    # route 2 named where the rule takes another but route 2 runs the
    # launch (bf16 up to D = 256)
    alt = 2 if dt == torch.bfloat16 and rule != 2 \
        and D <= gk.EDGE_MAX_D else None
    checked = (None,) if alt is None else (None, alt)
    previous_is = f"the CUDA-core kernels on the same {dt} inputs"
    alt_is = f"the wgmma edge kernel (route {alt}) on the same {dt} inputs"
    n_edges = src.shape[1]
    live = mask.float().mean().item()
    dead = ~mask
    for carry in (None, t["carry"]):
        p1 = (t["gout"], t["nm"], t["emb"], t["w_me"], t["b_me"], t["scores"],
              t["gmax"], t["scale"], src, dst, mask, carry)
        want = gk.bwd_pass1_plain(*p1, t["dnm0"].clone(),
                                  t["dscale0"].clone(), heads)
        for route in checked[::-1]:
            ctag = f"{tag} {'no carry' if carry is None else 'carry'}" + (
                "" if route is None else f" route {route}")
            got = gk.bwd_pass1(*p1, t["dnm0"].clone(), t["dscale0"].clone(),
                               heads, _route=route)
            names = ("demb", "d_alpha", "dnm", "dscale", "dW_me", "db_me")
            errs = [compare(f"gat_bwd_pass1 {name} {ctag}", g, w,
                            TOL["bwd"][dt])
                    for name, g, w in zip(names, got, want)]
            # masked slots (one graph has nothing else): demb is the carry
            # or 0 and d_alpha 0, exactly
            passed = 0.0 if carry is None else carry[dead]
            if bool((got[0][dead] != passed).any()) \
                    or bool((got[1].transpose(1, 2)[dead] != 0).any()):
                FAILURES.append(f"gat_bwd_pass1 masked slots {ctag}")
    if main:
        # live edges' rows of emb, scores and indices; the carry and
        # demb whole (a masked slot passes its carry through); the
        # node accumulators read and written. Three products.
        scratch = (t["dnm0"].clone(), t["dscale0"].clone())
        measure(sink, "gat_bwd_pass1" + suffix, max(errs),
                lambda: gk.bwd_pass1(*p1, *scratch, heads),
                lambda: gk.bwd_pass1_plain(*p1, *scratch, heads),
                live * nbytes(t["emb"], t["scores"], src, dst)
                + nbytes(t["gout"], t["nm"], t["w_me"], t["b_me"], t["gmax"],
                         t["scale"], mask, carry, got[0], got[1], got[4],
                         got[5])
                + 2 * nbytes(got[2], got[3]),
                3 * 2.0 * live * G * n_edges * D * HD, dt,
                previous=lambda: gk.bwd_pass1(*p1, *scratch, heads,
                                              _route=0),
                previous_is=previous_is, peak=tc_peak(dt))
        profile_kernels("gat_bwd_pass1" + suffix,
                        lambda: gk.bwd_pass1(*p1, *scratch, heads))
        if alt:
            alt1 = lambda: gk.bwd_pass1(*p1, *scratch, heads,  # noqa: E731
                                        _route=alt)
            faster_than_previous(
                f"gat_bwd_pass1 route {rule} vs {alt}",
                lambda: gk.bwd_pass1(*p1, *scratch, heads), alt1, alt_is,
                held=False)
            profile_kernels(f"gat_bwd_pass1 route {alt}" + suffix, alt1,
                            show=3)

    demb1, dalpha, _, dscale = want[:4]
    scale, denom_raw = t["scale"], t["denom_raw"]
    gate = (denom_raw > gk.DENOM_EPS).float()
    d_denom = -(scale / torch.clamp_min(denom_raw, gk.DENOM_EPS)) \
        * dscale * gate
    ds_self = gk.heads_to_hd(
        (t["d_alpha_self"] * scale + d_denom) * t["e_self"], HD)
    dnq0 = ds_self * (t["nk"].float() + t["skb"].float())
    dnk0 = ds_self * t["nq"].float()
    p2 = (t["nq"], t["nk"], t["emb"], t["w_ke"], t["b_ke"], t["scores"],
          t["gmax"], dalpha, scale, d_denom, src, dst, mask)
    want = gk.bwd_pass2_plain(*p2, demb1.clone(), dnq0.clone(), dnk0.clone(),
                              heads)
    for route in checked[::-1]:
        rtag = tag + ("" if route is None else f" route {route}")
        got = gk.bwd_pass2(*p2, demb1.clone(), dnq0.clone(), dnk0.clone(),
                           heads, _route=route)
        names = ("demb", "dnq", "dnk", "dW_ke", "db_ke")
        errs = [compare(f"gat_bwd_pass2 {name} {rtag}", g, w, TOL["bwd"][dt])
                for name, g, w in zip(names, got, want)]
        # a masked slot's demb is pass 1's, exactly
        if bool((got[0][dead] != demb1[dead]).any()):
            FAILURES.append(f"gat_bwd_pass2 masked slots {rtag}")
    if main:
        scratch = (demb1.clone(), dnq0.clone(), dnk0.clone())
        measure(sink, "gat_bwd_pass2" + suffix, max(errs),
                lambda: gk.bwd_pass2(*p2, *scratch, heads),
                lambda: gk.bwd_pass2_plain(*p2, *scratch, heads),
                live * nbytes(t["emb"], t["scores"], dalpha, src, dst)
                + nbytes(t["nq"], t["nk"], t["w_ke"], t["b_ke"], t["gmax"],
                         scale, d_denom, mask, got[3], got[4])
                + 2 * nbytes(got[0], got[1], got[2]),
                3 * 2.0 * live * G * n_edges * D * HD, dt,
                previous=lambda: gk.bwd_pass2(*p2, *scratch, heads,
                                              _route=0),
                previous_is=previous_is, peak=tc_peak(dt))
        profile_kernels("gat_bwd_pass2" + suffix,
                        lambda: gk.bwd_pass2(*p2, *scratch, heads))
        if alt:
            alt2 = lambda: gk.bwd_pass2(*p2, *scratch, heads,  # noqa: E731
                                        _route=alt)
            faster_than_previous(
                f"gat_bwd_pass2 route {rule} vs {alt}",
                lambda: gk.bwd_pass2(*p2, *scratch, heads), alt2, alt_is,
                held=False)
            profile_kernels(f"gat_bwd_pass2 route {alt}" + suffix, alt2,
                            show=3)


def phase_gat_bwd(gen, odd_gen, dev, reports):
    """Both dtypes on their tensor-core routes, bf16 on the route the rule
    gives a pass of one launch (`_edge_route`: route 1, the mma.sync edge
    kernel) and on route 2 named (the wgmma edge kernel of
    csrc/gat_edge.cu), split-TF32 products in float32, against their plain
    versions at every width; timed at the main shapes in turns with the
    CUDA-core kernels, which must be slower, and in bf16 route 1 in turns
    with route 2, logged (`gat_bwd_case`).
    And the count of wgmma (HGMMA), TMA (UTMALDG) and local-memory (LDL,
    STL) instructions in csrc/gat_edge.cu's SASS: route 2 runs on the
    first two and spills nothing, or the phase fails."""
    D = HD = 200
    for n_edges in (E, E - 3):
        src, dst, mask = graph_inputs(gen, dev, n_edges)
        for dt in (torch.float32, torch.bfloat16):
            t = gat_bwd_inputs(gen, dev, D, HD, HEADS, src, dst, mask, dt)
            gat_bwd_case(reports, t, src, dst, mask, HEADS, dt,
                         f"E={n_edges} {dt}", main=n_edges == E)
    # widths off the main shape. 24 x 40, 4 heads: both depths need padding
    # to 16 (to 32 and 48) and heads of 10 split the 8-column groups; 96 x
    # 128 and 256 x 256, 8 heads: the other widths the tensor-core kernels
    # are compiled for, the last with fewer warps a block; 264 x 200 and
    # 520 x 64, 8 heads: W's rows streamed (a chunk of 8 rows at the end;
    # the 208- and the 128-column tile, the latter for 64 columns). In f32,
    # which streams at every D: the 64-, 128-, 208- and 256-column tiles,
    # chunks of 32 rows (one of 24 rows at D = 24)
    src, dst, mask = graph_inputs(odd_gen, dev, E - 3)
    for D, HD, heads in ((24, 40, 4), (96, 128, 8), (256, 256, 8),
                         (264, 200, 4), (520, 64, 8)):
        for dt in (torch.float32, torch.bfloat16):
            t = gat_bwd_inputs(odd_gen, dev, D, HD, heads, src, dst, mask, dt)
            gat_bwd_case(reports, t, src, dst, mask, heads, dt,
                         f"D={D} HD={HD} E={E - 3} {dt}", main=False)
    counts = sass_counts("gat_edge", ops=("HGMMA", "UTMALDG", "LDL", "STL"))
    log("  csrc/gat_edge.cu's SASS: " + ", ".join(
        f"{op} {n}" for op, n in counts.items()))
    if not counts["HGMMA"] or not counts["UTMALDG"]:
        FAILURES.append("gat_bwd_pass1/2: route 2's SASS has no wgmma or no "
                        f"TMA load: {counts}")
    if counts["LDL"] or counts["STL"]:
        FAILURES.append("gat_bwd_pass1/2: route 2's SASS reads or writes "
                        f"local memory (spilled registers): {counts}")


def sass_counts(name, ops=("HGMMA", "UTMALDG", "UTMASTG")):
    """How often each of these instructions stands in the SASS of
    csrc/<name>.cu's built library (cuobjdump -sass, beside nvcc)."""
    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build._target(name))],
                          capture_output=True, text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}


# the demb product's widths beyond gnn_dim 512 and 1040 (4 heads): the
# kernels' (D, HD) of a pass of 16 heads at gnn_dim 100 and 200, which
# runs in head groups and so ends on one demb launch
DEMB_TAILS = ((104, 128), (200, 256))


def phase_gat_bwd_demb(gen, dev, reports, card):
    """Rows 8 and 9's demb product alone (`bwd_demb`, ROADMAP C17), the one
    launch a backward pass of several column launches ends on: at the
    kernels' widths of gnn_dim 512 and 1040 and at DEMB_TAILS (the tails
    of route 1's column tiles: `gk.demb_plan`), in both dtypes, on both
    routes, with no add, an add and in place (pass 2's), at E and E - 3,
    against its plain version (compare at TOL["bwd"]; bf16 also within one
    bf16 step in every element), a zero cotangent row (a masked slot)
    giving add (or 0) exactly, one launch a call on the route asked for.
    Then at gnn_dim 512 and 1040 in both dtypes its time in turns with
    route 0 (which must be slower), its plain version's, cuBLAS's addmm of
    the same function (library_ms) and the bound, each logged with its tile
    plan; bf16 at 1040 filed in `reports`; the device time by kernel. And
    the count of wgmma (HGMMA) and TMA (UTMALDG, UTMASTG) instructions in
    the library's SASS: route 1 runs on them, or the phase fails."""
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    wide = [gk.kernel_widths(width, width, HEADS)
            for width in (WIDE_D, WIDER_D)]
    for D, HD in wide + list(DEMB_TAILS):
        for n_edges in (E - 3, E):
            mask = graph_inputs(gen, dev, n_edges)[2]
            dead = ~mask
            for dt in (torch.float32, torch.bfloat16):
                cot = (r(G, n_edges, HD) * mask[..., None]).to(dt)
                w = r(D, HD) * 0.05
                add = (r(G, n_edges, D) * 0.1).to(dt)
                errs = []
                for route in (0, 1):
                    tag = f"D={D} HD={HD} E={n_edges} {dt} route {route}"
                    for what, a, in_place in (("no add", None, False),
                                              ("add", add, False),
                                              ("in place", add, True)):
                        want = gk.bwd_demb_plain(cot, w, a)
                        out = a.clone() if in_place else None
                        _build.reset_launch_counts()
                        got = gk.bwd_demb(cot, w, a if out is None else out,
                                          out, _route=route)
                        counts = (_build.LAUNCHES["gat_bwd_demb"],
                                  _build.ROUTES["gat_bwd_demb", route])
                        if counts != (1, 1) or (in_place and got is not out):
                            FAILURES.append(f"gat_bwd_demb launches {tag} "
                                            f"{what}: {counts}")
                        name = f"gat_bwd_demb {what} {tag}"
                        errs.append(compare(name, got, want, TOL["bwd"][dt]))
                        if dt == torch.bfloat16:
                            bf16_steps(name, got, want)
                        passed = 0.0 if a is None else a[dead]
                        if bool((got[dead] != passed).any()):
                            FAILURES.append(f"gat_bwd_demb masked slots "
                                            f"{tag} {what}")
                if (D, HD) not in wide or n_edges != E:
                    continue
                at_1040 = (D, HD) == wide[1]
                sink = reports if dt == torch.bfloat16 and at_1040 \
                    else collections.defaultdict(dict)
                name = "gat_bwd_demb" + ("" if dt == torch.bfloat16
                                         else " f32")
                plan = gk.demb_plan(D, HD, dt)
                log(f"  gat_bwd_demb D={D} HD={HD} {dt}: tiles of "
                    f"{plan.bm} x {plan.bn}, {plan.n_tiles} over D, "
                    f"{plan.k_tiles} slices of {plan.bk} through a ring of "
                    f"{plan.stages}, {plan.smem} bytes of shared memory")
                out = torch.empty_like(add)
                wr = w.to(dt)
                live = mask.float().mean().item()
                measure(sink, name, max(errs),
                        lambda: gk.bwd_demb(cot, w, add, out),
                        lambda: gk.bwd_demb_plain(cot, w, add),
                        nbytes(cot, add, out, wr),
                        2.0 * live * G * n_edges * HD * D, dt,
                        previous=lambda: gk.bwd_demb(cot, w, add, out,
                                                     _route=0),
                        previous_is=f"the CUDA-core demb kernel on the same "
                                    f"{dt} inputs",
                        peak=tc_peak(dt), card=card)
                lib_ms = device_ms(lambda: torch.addmm(
                    add.view(-1, D), cot.view(-1, HD), wr.t()))
                sink[name]["library_ms"] = lib_ms
                log(f"  time {name} D={D} HD={HD}: library (torch.addmm, "
                    f"{dt}) {lib_ms:.4f} ms  [{card}]")
                profile_kernels(f"{name} D={D} HD={HD}",
                                lambda: gk.bwd_demb(cot, w, add, out),
                                iters=5)
    counts = sass_counts("gat_demb")
    log("  csrc/gat_demb.cu's SASS: " + ", ".join(
        f"{op} {n}" for op, n in counts.items()))
    if not counts["HGMMA"] or not counts["UTMALDG"]:
        FAILURES.append("gat_bwd_demb: route 1's SASS has no wgmma or no "
                        f"TMA load: {counts}")


# rows 8 and 9's dW launch: the preset's widths, the demb tails' and the
# kernels' widths of gnn_dim 512 and 1040 (4 heads), (D, HD)
DW_WIDTHS = ((200, 200), (104, 104), (104, 128), (200, 256), (512, 512),
             (1040, 1056))


def dw_bias(got, ref) -> tuple[float, float]:
    """dW's signed bias against its f64 value `ref`, as shares of sum
    |ref|: toward zero (sum sign(ref) (got - ref), the drift of a
    truncating sum) and plain (sum (got - ref))."""
    d = got.double() - ref
    top = ref.abs().sum().item()
    return ((d * ref.sign()).sum().item() / top, d.sum().item() / top)


def phase_gat_bwd_dw(gen, dev, reports, card):
    """Rows 8 and 9's weight gradient (`bwd_dw`), the one launch a route-1
    backward pass makes it in: route 1 (csrc/gat_dw.cu, wgmma fed by TMA)
    against its plain version at DW_WIDTHS, E and E - 3, in both dtypes
    (compare at TOL["bwd"]), one launch a call on the route asked for;
    zero cotangent rows (masked slots) add exactly nothing: the result is
    bit for bit the same with emb's rows there replaced. Then at the
    preset, gnn_dim 512 and 1040 in both dtypes: route 1's time in turns
    with route 0 (the mma.sync kernel the passes ran before, over all HD
    columns: previous_ms), which must be slower, torch.mm of emb^T cot
    over all HD (library_ms),
    the plain version and the bound (operations at `tc_peak` over the live
    slots, or the operands' bytes), with the plan; the preset in bf16 filed
    in `reports`; dW's signed f64 bias at 1040 on both routes, route 1's no
    larger than route 0's (C16); the device time by kernel. And the count
    of wgmma (HGMMA), TMA (UTMALDG) and local-memory (LDL, STL)
    instructions in the library's SASS: route 1 runs on the first two and
    spills nothing, or the phase fails."""
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    timed = {(200, 200), gk.kernel_widths(WIDE_D, WIDE_D, HEADS),
             gk.kernel_widths(WIDER_D, WIDER_D, HEADS)}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for D, HD in DW_WIDTHS:
        for n_edges in (E - 3, E):
            mask = graph_inputs(gen, dev, n_edges)[2]
            dead = ~mask
            for dt in (torch.float32, torch.bfloat16):
                emb = torch.relu(r(G, n_edges, D)).to(dt)
                cot = (r(G, n_edges, HD) * mask[..., None]).to(dt)
                want = gk.bwd_dw_plain(emb, cot)
                other = emb.clone()
                other[dead] = (r(int(dead.sum()), D) * 50).to(dt)
                errs = {}
                for route in (0, 1):
                    tag = f"D={D} HD={HD} E={n_edges} {dt} route {route}"
                    _build.reset_launch_counts()
                    got = gk.bwd_dw(emb, cot, _route=route)
                    counts = (_build.LAUNCHES["gat_bwd_dw"],
                              _build.ROUTES["gat_bwd_dw", route])
                    if counts != (1, 1):
                        FAILURES.append(f"gat_bwd_dw launches {tag}: "
                                        f"{counts}")
                    errs[route] = compare(f"gat_bwd_dw {tag}", got, want,
                                          TOL["bwd"][dt])
                    if not torch.equal(gk.bwd_dw(other, cot, _route=route),
                                       got):
                        FAILURES.append(f"gat_bwd_dw masked slots {tag}")
                if (D, HD) not in timed or n_edges != E:
                    continue
                plan = gk.dw_plan(D, HD, G * n_edges, dt, n_sm)
                log(f"  gat_bwd_dw D={D} HD={HD} {dt}: tiles of {plan.bm} x "
                    f"{plan.bn}, {plan.n_tiles} of them, {plan.n_ranges} "
                    f"ranges of {plan.chunk} slots in slices of "
                    f"{plan.bk}, a ring of "
                    f"{plan.stages}, {plan.smem} bytes of shared memory, "
                    f"{plan.blocks} blocks, partials "
                    f"{plan.partial_bytes / 2 ** 20:.1f} MiB")
                if (D, HD) == (WIDER_D, gk.kernel_widths(
                        WIDER_D, WIDER_D, HEADS)[1]):
                    e2, c2 = emb.reshape(-1, D), cot.reshape(-1, HD)
                    ref = e2.double().t() @ c2.double()
                    toward = {}
                    for route in (1, 0):
                        toward[route], plain = dw_bias(
                            gk.bwd_dw(emb, cot, _route=route), ref)
                        log(f"  gat_bwd_dw D={D} HD={HD} {dt} route {route}:"
                            f" signed f64 bias of sum |dW|, toward zero "
                            f"{toward[route]:+.3e}, plain {plain:+.3e}")
                    if abs(toward[1]) > abs(toward[0]):
                        FAILURES.append(
                            f"gat_bwd_dw D={D} HD={HD} {dt}: route 1's bias "
                            f"toward zero {toward[1]:+.3e} exceeds route 0's "
                            f"{toward[0]:+.3e} (C16)")
                    del e2, c2, ref
                live = mask.float().mean().item()
                name = f"gat_bwd_dw D={D} HD={HD} {dt}"
                ms = faster_than_previous(
                    name, lambda: gk.bwd_dw(emb, cot),
                    lambda: gk.bwd_dw(emb, cot, _route=0),
                    "the mma.sync kernel over all HD columns on the same "
                    "inputs")
                plain_ms = device_ms(lambda: gk.bwd_dw_plain(emb, cot))
                e2, c2 = emb.view(-1, D), cot.view(-1, HD)
                lib_ms = device_ms(lambda: torch.mm(e2.t(), c2))
                bound_ms, by = bound(nbytes(emb, cot) + 4 * D * HD,
                                     2.0 * live * G * n_edges * D * HD, dt,
                                     tc_peak(dt))
                log(f"  time {name}: kernel {ms:.4f} ms  library (torch.mm) "
                    f"{lib_ms:.4f} ms ({'at or below' if ms <= lib_ms else 'ABOVE'}"
                    f" it)  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                    f"({by})  [{card}]")
                if (D, HD) == (200, 200) and dt == torch.bfloat16:
                    reports["gat_bwd_dw"].update(
                        max_abs_err=errs[1], ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)
                profile_kernels(f"gat_bwd_dw D={D} HD={HD} {dt}",
                                lambda: gk.bwd_dw(emb, cot), iters=5)
                del e2, c2
            del emb, cot, other
    counts = sass_counts("gat_dw", ops=("HGMMA", "UTMALDG", "LDL", "STL"))
    log("  csrc/gat_dw.cu's SASS: " + ", ".join(
        f"{op} {n}" for op, n in counts.items()))
    if not counts["HGMMA"] or not counts["UTMALDG"]:
        FAILURES.append("gat_bwd_dw: route 1's SASS has no wgmma or no "
                        f"TMA load: {counts}")
    if counts["LDL"] or counts["STL"]:
        FAILURES.append("gat_bwd_dw: route 1's SASS reads or writes local "
                        f"memory (spilled registers): {counts}")


def unproj_inputs(gen, dev, n_edges, dt):
    """Node projections, precomputed edge biases and an output cotangent of
    the unprojected op, rounded to dt."""
    HD = 200
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    nq = (r(G, N, HD) / (HD // HEADS) ** 0.5).to(dt)
    nk, nm, skb, smb = ((r(G, N, HD) * 0.5).to(dt) for _ in range(4))
    ekb, emb = ((r(G, n_edges, HD) * 0.5).to(dt) for _ in range(2))
    return (nq, nk, nm, ekb, emb, skb, smb), r(G, N, HD).to(dt)


def phase_gat_unproj(gen, dev, reports):
    HD = 200
    for n_edges in (E, E - 3):
        src, dst, mask = graph_inputs(gen, dev, n_edges)
        has_edge = mask.any(1)
        for dt in (torch.float32, torch.bfloat16):
            (nq, nk, nm, ekb, emb, skb, smb), gout = unproj_inputs(
                gen, dev, n_edges, dt)
            tag = f"E={n_edges} {dt}"
            tol = TOL["unproj"][dt]
            timing = timing_at(dt, n_edges == E)
            a = (nq, nk, ekb, src, dst, mask, HEADS)
            scores_p, m_edge_p = scores_case(reports, a, dt, tag, timing)

            # the op's glue, as gat_unprojected_forward runs it
            self_scores = gk.head_sum(nq.float() * (nk + skb).float(), HEADS)
            gmax = torch.maximum(m_edge_p, self_scores.amax(1))
            e_self = torch.exp(self_scores - gmax[:, None, :])
            d = (scores_p, gmax, src, mask, N)
            e_edge_p, denom_p, deg_p = denoms_case(reports, d, dt, tag,
                                                   timing)

            scale = (deg_p[..., None] + 1.0) \
                / torch.clamp_min(denom_p + e_self, gk.DENOM_EPS)
            seed = (nm + smb).float() * gk.heads_to_hd(e_self * scale, HD)
            c = (nm, emb, e_edge_p, scale, src, dst, mask)
            out_p = aggr_case(reports, c, seed, HEADS, dt, tag, timing)

            # the backward's glue, as gat_unprojected_backward runs it
            g = gout.float()
            dnm0 = gk.heads_to_hd(e_self * scale, HD) * g
            d_alpha_self = gk.head_sum((nm + smb).float() * g, HEADS)
            dscale0 = d_alpha_self * e_self
            p1 = (gout, nm, emb, e_edge_p, scale, src, dst, mask)
            want = bwd1_case(reports, p1, dnm0, dscale0, HEADS, dt, tag,
                             timing)

            _, dalpha, _, dscale = want
            gate = (denom_p + e_self > gk.DENOM_EPS).float()
            d_denom = -(scale / torch.clamp_min(denom_p + e_self,
                                                gk.DENOM_EPS)) * dscale * gate
            ds_self = gk.heads_to_hd(
                (d_alpha_self * scale + d_denom) * e_self, HD)
            dnq0 = ds_self * (nk.float() + skb.float())
            dnk0 = ds_self * nq.float()
            p2 = (nq, nk, ekb, e_edge_p, dalpha, scale, d_denom, src, dst,
                  mask)
            bwd2_case(reports, p2, dnq0, dnk0, HEADS, dt, tag, timing)

            # the whole forward on the kernel path against the plain chain
            op = uk.gat_unprojected_forward(nq, nk, nm, ekb, emb, skb, smb,
                                            src, dst, mask, HEADS)
            compare(f"gat_unprojected_forward out {tag}", op[0], out_p, tol)
            if not bool(torch.isfinite(op[0][~has_edge]).all()):
                FAILURES.append(f"non-finite output of empty graph {tag}")


ROUTE0_IS = "route 0, a warp an edge, on the same inputs"


def timing_at(dt, at_main_shapes):
    """What a routed unprojected kernel's case times: at the main shapes
    its report in bf16 ("report", route 1 beside route 0 on the same
    inputs) and route 1 in turns with route 0 in f32 ("turns"), where the
    route rule sends f32 to route 1; elsewhere nothing."""
    if not at_main_shapes:
        return None
    return "report" if dt == torch.bfloat16 else "turns"


def unproj_routes(route_of, dt, N_, E_, HD, heads):
    """The routes of a routed unprojected kernel (route_of: its rule) at
    this dtype and width: both where route 1 takes it, whether the rule
    picks it or a caller names it, else route 0."""
    try:
        route_of(dt, N_, E_, HD, heads, 1)
    except ValueError:
        return (0,)
    return (0, 1)


def time_routes(reports, name, timing, errs, route_of, shape, kernel, plain,
                n_bytes, flops):
    """A routed kernel's time at the main shapes: "report" files route 1's
    time, bound and plain time under `name`, route 1 timed in turns with
    route 0 (the run fails unless it is faster), and lists the kernels of
    one call by torch.profiler; "turns" (f32) times route 1 in turns with
    route 0 where the rule sends the dtype to route 1. kernel(route) runs
    the kernel on the rule's route (None) or a named one; where the rule
    sends f32 to route 0, both routes' f32 times are printed."""
    if timing is None:
        return
    dt = shape[0]
    if timing == "report":
        measure(reports, name, errs[route_of(*shape)], lambda: kernel(None),
                plain, n_bytes, flops, torch.float32,
                previous=lambda: kernel(0), previous_is=ROUTE0_IS)
        profile_kernels(name, lambda: kernel(None))
    elif route_of(*shape) == 1:
        faster_than_previous(f"{name} {dt}", lambda: kernel(None),
                             lambda: kernel(0), ROUTE0_IS)
    else:                                # the rule takes route 0 here
        on_1, on_0 = device_ms(lambda: kernel(1)), device_ms(lambda: kernel(0))
        log(f"  time {name:<18} {dt} route 1 {on_1:.4f} ms, route 0 "
            f"{on_0:.4f} ms: the rule takes route 0")


def denoms_route(dt, N_, E_, HD, heads, route=None):
    """`uk._denoms_route` in the form of the other route rules: the kernel
    reads f32 scores, so neither the op's dtype nor HD enters."""
    return uk._denoms_route(N_, E_, heads, route)


def scores_case(reports, a, dt, tag, timing):
    """edge_scores on each route its shapes take against its plain version:
    the scores, masked slots' exactly 0, and the max of each graph with a
    live slot, -1e30 for one without; at the main shapes also its time
    (`time_routes`). Returns the plain version's outputs."""
    nq, nk, ekb, src, dst, mask, heads = a
    G_, N_, HD = nq.shape
    n_edges = src.shape[1]
    want = uk.edge_scores_plain(*a)
    has_edge = mask.any(1)
    errs = {}
    for route in unproj_routes(uk._scores_route, dt, N_, n_edges, HD, heads):
        scores, m_edge = uk.edge_scores(*a, _route=route)
        t = f"{tag} route {route}"
        errs[route] = compare(f"gat_unproj_scores scores {t}", scores,
                              want[0], TOL["unproj"][dt])
        compare(f"gat_unproj_scores max {t}", m_edge[has_edge],
                want[1][has_edge], TOL["unproj"][dt])
        if not bool((m_edge[~has_edge] == gk.NEG).all()):
            FAILURES.append(f"gat_unproj_scores max of empty graph {t}")
        if bool((scores.transpose(1, 2)[~mask] != 0).any()):
            FAILURES.append(f"gat_unproj_scores masked slots {t}")
    # live slots' rows of ekb and indices; the scores whole (a masked slot
    # is written as 0); add, multiply, sum
    live = mask.float().mean().item()
    time_routes(reports, "gat_unproj_scores", timing, errs, uk._scores_route,
                (dt, N_, n_edges, HD, heads),
                lambda r: uk.edge_scores(*a, _route=r),
                lambda: uk.edge_scores_plain(*a),
                live * nbytes(ekb, src, dst) + nbytes(nq, nk, mask, *want),
                3.0 * live * G_ * n_edges * HD)
    return want


def denoms_case(reports, d, dt, tag, timing):
    """edge_denoms on each route its shapes take against its plain version
    (dt: the op's dtype, which set the scores), the degrees exactly and
    masked slots' e_edge exactly 0; at the main shapes also its time
    (`time_routes`), the wrapper's (route 0's includes its two zero
    fills). Returns the plain version's outputs."""
    scores, gmax, src, mask, n_nodes = d
    G_, heads, n_edges = scores.shape
    want = uk.edge_denoms_plain(*d)
    tol = TOL["unproj"][dt]
    errs = {}
    for route in unproj_routes(denoms_route, dt, n_nodes, n_edges, None,
                               heads):
        e_edge, denom, deg = uk.edge_denoms(*d, _route=route)
        t = f"{tag} route {route}"
        errs[route] = max(
            compare(f"gat_unproj_denoms e_edge {t}", e_edge, want[0], tol),
            compare(f"gat_unproj_denoms denom {t}", denom, want[1], tol))
        compare(f"gat_unproj_denoms deg {t}", deg, want[2], 0.0)
        if bool((e_edge.transpose(1, 2)[~mask] != 0).any()):
            FAILURES.append(f"gat_unproj_denoms e_edge of masked slots {t}")
    # live slots' scores and sources; e_edge written whole; the sums and
    # degrees written once
    live = mask.float().mean().item()
    time_routes(reports, "gat_unproj_denoms", timing, errs, denoms_route,
                (dt, n_nodes, n_edges, None, heads),
                lambda r: uk.edge_denoms(*d, _route=r),
                lambda: uk.edge_denoms_plain(*d),
                live * nbytes(scores, src) + nbytes(gmax, mask, *want),
                2.0 * live * G_ * n_edges * heads)
    return want


def aggr_case(reports, c, seed, heads, dt, tag, timing):
    """aggregate on each route its shapes take against its plain version;
    at the main shapes also its time (`time_routes`). Returns the plain
    version's output."""
    nm, emb, e_edge, scale, src, dst, mask = c
    G_, N_, HD = nm.shape
    n_edges = src.shape[1]
    want = uk.aggregate_plain(*c, seed.clone(), heads)
    errs = {}
    for route in unproj_routes(uk._aggr_route, dt, N_, n_edges, HD, heads):
        got = uk.aggregate(*c, seed.clone(), heads, _route=route)
        errs[route] = compare(f"gat_unproj_aggr out {tag} route {route}",
                              got, want, TOL["unproj"][dt])
    # live slots only; the accumulator is read and written
    live = mask.float().mean().item()
    scratch = seed.clone()
    time_routes(reports, "gat_unproj_aggr", timing, errs, uk._aggr_route,
                (dt, N_, n_edges, HD, heads),
                lambda r: uk.aggregate(*c, scratch, heads, _route=r),
                lambda: uk.aggregate_plain(*c, scratch, heads),
                live * nbytes(emb, e_edge, src, dst)
                + nbytes(nm, scale, mask) + 2 * nbytes(want),
                4.0 * live * G_ * n_edges * HD)
    return want


def bwd1_case(reports, p1, dnm0, dscale0, heads, dt, tag, timing):
    """bwd1 on each route its shapes take against its plain version,
    masked slots' demb and d_alpha exactly 0; at the main shapes also its
    time (`time_routes`). Returns the plain version's outputs."""
    gout, nm, emb, e_edge, scale, src, dst, mask = p1
    G_, N_, HD = nm.shape
    n_edges = src.shape[1]
    want = uk.bwd1_plain(*p1, dnm0.clone(), dscale0.clone(), heads)
    errs = {}
    for route in unproj_routes(uk._bwd1_route, dt, N_, n_edges, HD, heads):
        got = uk.bwd1(*p1, dnm0.clone(), dscale0.clone(), heads, _route=route)
        names = ("demb", "d_alpha", "dnm", "dscale")
        errs[route] = max(
            compare(f"gat_unproj_bwd1 {name} {tag} route {route}", g_, w,
                    TOL["unproj"][dt])
            for name, g_, w in zip(names, got, want))
        if bool((got[0][~mask] != 0).any()) \
                or bool((got[1].transpose(1, 2)[~mask] != 0).any()):
            FAILURES.append(f"gat_unproj_bwd1 masked slots {tag} route "
                            f"{route}")
    # live slots' rows of emb, e_edge and indices; demb and d_alpha whole;
    # the node accumulators read and written
    live = mask.float().mean().item()
    scratch = (dnm0.clone(), dscale0.clone())
    time_routes(reports, "gat_unproj_bwd1", timing, errs, uk._bwd1_route,
                (dt, N_, n_edges, HD, heads),
                lambda r: uk.bwd1(*p1, *scratch, heads, _route=r),
                lambda: uk.bwd1_plain(*p1, *scratch, heads),
                live * nbytes(emb, e_edge, src, dst)
                + nbytes(gout, nm, scale, mask, want[0], want[1])
                + 2 * nbytes(want[2], want[3]),
                6.0 * live * G_ * n_edges * HD)
    return want


def bwd2_case(reports, p2, dnq0, dnk0, heads, dt, tag, timing):
    """bwd2 on each route its shapes take against its plain version, masked
    slots' dekb exactly 0; at the main shapes also its time
    (`time_routes`)."""
    nq, nk, ekb, e_edge, dalpha, scale, d_denom, src, dst, mask = p2
    G_, N_, HD = nq.shape
    want = uk.bwd2_plain(*p2, dnq0.clone(), dnk0.clone(), heads)
    n_edges = src.shape[1]
    errs = {}
    for route in unproj_routes(uk._bwd2_route, dt, N_, n_edges, HD, heads):
        got = uk.bwd2(*p2, dnq0.clone(), dnk0.clone(), heads, _route=route)
        errs[route] = max(
            compare(f"gat_unproj_bwd2 {name} {tag} route {route}", g_, w,
                    TOL["unproj"][dt])
            for name, g_, w in zip(("dekb", "dnq", "dnk"), got, want))
        if bool((got[0][~mask] != 0).any()):
            FAILURES.append(f"gat_unproj_bwd2 masked slots {tag} route "
                            f"{route}")
    # live slots' rows of ekb, e_edge, d_alpha and indices; dekb whole (a
    # masked slot is written as 0); the node accumulators read and written
    live = mask.float().mean().item()
    scratch = (dnq0.clone(), dnk0.clone())
    time_routes(reports, "gat_unproj_bwd2", timing, errs, uk._bwd2_route,
                (dt, N_, n_edges, HD, heads),
                lambda r: uk.bwd2(*p2, *scratch, heads, _route=r),
                lambda: uk.bwd2_plain(*p2, *scratch, heads),
                live * nbytes(ekb, e_edge, dalpha, src, dst)
                + nbytes(nq, nk, scale, d_denom, mask, want[0])
                + 2 * nbytes(want[1], want[2]),
                7.0 * live * G_ * n_edges * HD)


def phase_unproj_rows12(gen, dev, reports):
    """Rows 1 and 2 alone at the main shapes, bf16 then f32: each route
    against its plain version, route 1 timed in turns with route 0 (for
    work on these two kernels, with `--csrc`)."""
    src, dst, mask = graph_inputs(gen, dev, E)
    for dt in (torch.bfloat16, torch.float32):
        (nq, nk, _, ekb, _, skb, _), _ = unproj_inputs(gen, dev, E, dt)
        tag, timing = f"E={E} {dt}", timing_at(dt, True)
        s_p, m_p = scores_case(reports, (nq, nk, ekb, src, dst, mask, HEADS),
                               dt, tag, timing)
        self_scores = gk.head_sum(nq.float() * (nk + skb).float(), HEADS)
        gmax = torch.maximum(m_p, self_scores.amax(1))
        denoms_case(reports, (s_p, gmax, src, mask, N), dt, tag, timing)


def phase_unproj_widths(gen, dev):
    """The five unprojected kernels off the main width, each with an
    all-masked graph, the backward's with random per-slot and per-node
    terms: HD=96 and HD=256 with 8 heads (heads straddle bwd2's route-1
    slices and the lanes' 8-column groups) at ragged E on both routes, and
    N=4000 nodes, whose block bwd2's route 1 cannot fit, on route 0 (the
    other four also on their route 1, which takes it)."""
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    for G_, N_, HD, heads in ((G, N, 96, 8), (G, N, 256, 8), (4, 4000, 200, 4)):
        n_edges = E - 3
        mask = torch.rand((G_, n_edges), generator=gen, device=dev) > 0.25
        mask[1] = False
        idx = lambda: torch.randint(0, N_, (G_, n_edges), generator=gen,
                                    device=dev, dtype=torch.int32)
        src, dst = idx(), idx()
        e_edge = torch.where(mask[:, None, :],
                             torch.rand((G_, heads, n_edges), generator=gen,
                                        device=dev), 0.0)
        dalpha = torch.where(mask[:, None, :], r(G_, heads, n_edges), 0.0)
        scale, d_denom = r(G_, N_, heads).abs() + 0.5, r(G_, N_, heads) * 0.1
        for dt in (torch.float32, torch.bfloat16):
            tag = f"G={G_} N={N_} HD={HD} heads={heads} E={n_edges} {dt}"
            nq = (r(G_, N_, HD) / (HD // heads) ** 0.5).to(dt)
            nk, ekb = (r(G_, N_, HD) * 0.5).to(dt), \
                (r(G_, n_edges, HD) * 0.5).to(dt)
            s_p, m_p = scores_case(None, (nq, nk, ekb, src, dst, mask, heads),
                                   dt, tag, None)
            # a stand-in for the self-loop scores' max, which gmax also takes
            gmax = torch.maximum(m_p, r(G_, heads))
            denoms_case(None, (s_p, gmax, src, mask, N_), dt, tag, None)
            p2 = (nq, nk, ekb, e_edge, dalpha, scale, d_denom, src, dst, mask)
            dnq0, dnk0 = r(G_, N_, HD) * 0.1, r(G_, N_, HD) * 0.1
            routes = unproj_routes(uk._bwd2_route, dt, N_, n_edges, HD, heads)
            if N_ == 4000 and routes != (0,):
                FAILURES.append("bwd2: route 1 takes N=4000")
            bwd2_case(None, p2, dnq0, dnk0, heads, dt, tag, None)
            nm, emb = (r(G_, N_, HD) * 0.5).to(dt), \
                (r(G_, n_edges, HD) * 0.5).to(dt)
            c = (nm, emb, e_edge, scale, src, dst, mask)
            aggr_case(None, c, r(G_, N_, HD), heads, dt, tag, None)
            p1 = (r(G_, N_, HD).to(dt), nm, emb, e_edge, scale, src, dst,
                  mask)
            bwd1_case(None, p1, r(G_, N_, HD) * 0.1,
                      r(G_, N_, heads) * 0.1, heads, dt, tag, None)


# ---------------------------------------------------------------------------
# gradients of the autograd Functions on the kernels, f32
# ---------------------------------------------------------------------------

def phase_op_gradients(gen, dev):
    D = HD = 200
    dph = HD // HEADS
    src, dst, mask = graph_inputs(gen, dev, E)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    names = ("nq", "nk", "nm", "edge_emb", "w_ke", "b_ke", "w_me", "b_me",
             "skb", "smb")
    vals = [r(G, N, HD) / dph ** 0.5, r(G, N, HD) * 0.5, r(G, N, HD) * 0.5,
            torch.relu(r(G, E, D)), r(D, HD) * 0.05, r(HD) * 0.1,
            r(D, HD) * 0.05, r(HD) * 0.1, r(G, N, HD) * 0.5,
            r(G, N, HD) * 0.5]
    gout, carry = r(G, N, HD), r(G, E, D) * 0.1

    def grads(fn):
        ten = [v.clone().requires_grad_() for v in vals]
        out, emb = fn(*ten)
        ((out * gout).sum() + (emb * carry).sum()).backward()
        return out.detach(), [t.grad for t in ten]

    def oracle(nq, nk, nm, emb, w_ke, b_ke, w_me, b_me, skb, smb):
        heads = lambda t: t.reshape(*t.shape[:-1], HEADS, dph)
        return relational_gat_attention_nodes(
            heads(nq), heads(nk), heads(nm), heads(emb @ w_ke + b_ke),
            heads(emb @ w_me + b_me), heads(skb), heads(smb), src, dst,
            mask, backend="scatter"), emb

    before = _build.LAUNCHES["gat_bwd_pass1"]
    out, got = grads(lambda *t: gk.gat_projected_chained(
        *t, src, dst, mask, HEADS))
    if _build.LAUNCHES["gat_bwd_pass1"] != before + 1:
        FAILURES.append("the op's backward did not launch gat_bwd_pass1")
    out_w, want = grads(oracle)
    compare("gat_projected out vs scatter oracle", out, out_w, GRAD_TOL)
    for name, g, w in zip(names, got, want):
        compare(f"gat_projected d{name} vs autograd(oracle)", g, w, GRAD_TOL)

    # the edge encoder in train mode: moments kernel -> analytic BatchNorm
    # statistics -> edge_hidden and its backward kernel, against the one-hot
    # rows through linear_0 -> BatchNorm -> relu -> linear_1 under autograd
    n_rel = 39
    F = n_rel + 2 * N_NTYPE
    etype, esrc, edst, ntype, emask = encoder_ints(gen, dev, E, n_rel)
    with torch.device(dev):
        enc = EdgeEncoder(D, F, num_updates=5).train()
    init_weights(enc, gen, 0.2)
    with torch.no_grad():
        enc.bn.scale.uniform_(0.5, 1.5, generator=gen)
        enc.bn.bias.copy_(r(D) * 0.1)
        enc.linear_0.bias.copy_(r(D) * 0.1)
    oh = torch.nn.functional.one_hot
    gather = lambda idx: torch.gather(ntype.long(), 1, idx.long())
    edge_feat = torch.cat([oh(etype.long(), n_rel), oh(gather(esrc), N_NTYPE),
                           oh(gather(edst), N_NTYPE)], -1).float()
    self_type = oh(ntype.long(), N_NTYPE)
    self_rel = torch.zeros((G, N, n_rel), device=dev)
    self_rel[..., n_rel - 1] = 1.0
    self_feat = torch.cat([self_rel, self_type, self_type], -1) \
        .reshape(G * N, F)
    cot_e, cot_s = r(G * E, D), r(G * N, D)
    params = {"W0": enc.linear_0.kernel, "b0": enc.linear_0.bias,
              "bn scale": enc.bn.scale, "bn bias": enc.bn.bias,
              "W1": enc.linear_1.kernel, "b1": enc.linear_1.bias}

    def enc_grads(fused):
        enc.zero_grad()
        if fused:
            (h_e, h_s), (w1, b1) = enc(
                self_feat, edge_ints=(etype, esrc, edst, ntype, emask),
                n_rel=n_rel, n_ntype=N_NTYPE)
            o_e, o_s = h_e.reshape(-1, D) @ w1 + b1, h_s @ w1 + b1
        else:
            o_e, o_s = enc([(edge_feat.reshape(-1, F),
                             emask.reshape(-1).float()), (self_feat, None)])
        ((o_e * cot_e).sum() + (o_s * cot_s).sum()).backward()
        return o_e.detach(), {k: p.grad.clone() for k, p in params.items()}

    before = (_build.LAUNCHES["edge_moments"],
              _build.LAUNCHES["edge_hidden_bwd"])
    out, got = enc_grads(True)
    if (_build.LAUNCHES["edge_moments"], _build.LAUNCHES["edge_hidden_bwd"]) \
            != (before[0] + 1, before[1] + 1):
        FAILURES.append("train-mode edge encoder did not launch its kernels")
    out_w, want = enc_grads(False)
    compare("edge encoder (train) out vs one-hot rows", out, out_w, GRAD_TOL)
    for k in params:
        # b0 sits ahead of the BatchNorm: its gradient is zero, and both
        # sides hold rounding noise of dW0's size
        compare(f"edge encoder (train) d{k} vs autograd", got[k], want[k],
                GRAD_TOL, scale=want["W0"].abs().max() if k == "b0" else None)


def scatter_oracle(nq, nk, nm, ekb, emb, skb, smb, src, dst, mask):
    """The scatter backend on (G, ., HD) arrays, as the op-level entry point
    takes them after the head split."""
    heads = lambda t: t.reshape(*t.shape[:-1], HEADS, t.shape[-1] // HEADS)
    return relational_gat_attention_nodes(
        *(heads(t) for t in (nq, nk, nm, ekb, emb, skb, smb)), src, dst,
        mask, backend="scatter")


def forward_backward(fn, leaves, gout):
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad(out, leaves,
                                             gout.to(out.dtype))


def value_and_grads(fn, vals, gout):
    return forward_backward(
        fn, [v.detach().clone().requires_grad_() for v in vals], gout)


UNPROJ_KERNELS = ("gat_unproj_scores", "gat_unproj_denoms", "gat_unproj_aggr",
                  "gat_unproj_bwd1", "gat_unproj_bwd2")
UNPROJ_INPUTS = ("nq", "nk", "nm", "ekb", "emb", "skb", "smb")
UNPROJ_ROUTED = {"gat_unproj_scores": uk._scores_route,
                 "gat_unproj_denoms": denoms_route,
                 "gat_unproj_aggr": uk._aggr_route,
                 "gat_unproj_bwd1": uk._bwd1_route,
                 "gat_unproj_bwd2": uk._bwd2_route}


def phase_unproj_gradients(gen, dev):
    src, dst, mask = graph_inputs(gen, dev, E)
    vals, gout = unproj_inputs(gen, dev, E, torch.float32)
    out, got = value_and_grads(
        lambda *t: uk.gat_unprojected(*t, src, dst, mask, HEADS), vals, gout)
    out_w, want = value_and_grads(
        lambda *t: scatter_oracle(*t, src, dst, mask), vals, gout)
    compare("gat_unprojected out vs scatter oracle", out, out_w, GRAD_TOL)
    for name, g, w in zip(UNPROJ_INPUTS, got, want):
        compare(f"gat_unprojected d{name} vs autograd(oracle)", g, w,
                GRAD_TOL)


# ---------------------------------------------------------------------------
# the op-level entry point
# ---------------------------------------------------------------------------

def phase_op(gen, dev, reports, card):
    D = HD = 200
    dph = HD // HEADS
    src, dst, mask = graph_inputs(gen, dev, E)
    heads = lambda t: t.reshape(*t.shape[:-1], HEADS, dph)

    def op(backend):
        return lambda *t: relational_gat_attention_nodes(
            *(heads(x) for x in t), src, dst, mask, backend=backend)

    for dt in (torch.bfloat16, torch.float32):
        name = "bf16" if dt == torch.bfloat16 else "f32"
        vals, gout = unproj_inputs(gen, dev, E, dt)
        # the main path: no backend named, CUDA tensors, forward + backward
        _build.reset_launch_counts()
        out, got = value_and_grads(op(None), vals, gout)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        ok = counts == {k: 1 for k in UNPROJ_KERNELS}
        log(f"  launches, one forward + backward, {name}, no backend named: "
            f"{counts}  {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"launch counts of the op, {name}")
        # every launch of the five routed kernels on the route its rule
        # names at these shapes, and that route 1 for bf16
        for k, route_of in UNPROJ_ROUTED.items():
            want = route_of(dt, N, E, HD, HEADS)
            ok = _build.ROUTES[k, want] == counts.get(k, 0) \
                and (want == 1 or dt != torch.bfloat16)
            log(f"  routes, {name}: {k} {_build.ROUTES[k, want]} of "
                f"{counts.get(k, 0)} on route {want}  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"{k} off route {want} in the op, {name}")
        if dt == torch.bfloat16:
            for k in UNPROJ_KERNELS:
                reports[k]["launches"] = counts.get(k, 0)
        if out.shape != (G, N, HD) or out.dtype != torch.float32 \
                or not bool(torch.isfinite(out).all()):
            FAILURES.append(f"output of the op, {name}")
        # the scatter backend in f32 on the same (rounded) inputs
        _build.reset_launch_counts()
        out_w, want = value_and_grads(op("scatter"),
                                      [v.float() for v in vals], gout)
        if _build.LAUNCHES:
            FAILURES.append("the scatter backend launched kernels")
        log(f"  launches, scatter backend: {dict(_build.LAUNCHES)}")
        compare(f"op out cuda vs scatter(f32), {name}", out, out_w,
                OP_TOL[dt]["out"])
        for k, g, w in zip(UNPROJ_INPUTS, got, want):
            if g.dtype != dt:
                FAILURES.append(f"dtype of d{k}, {name}")
            compare(f"op d{k} cuda vs scatter(f32), {name}", g, w,
                    OP_TOL[dt]["grad"])

        # times: forward and forward + backward on both backends, and the
        # projected op at the same shapes, which projects a (G, E, D) edge
        # embedding inside its kernels instead of reading ekb and emb
        r = lambda *s: torch.randn(s, generator=gen, device=dev)
        nq, nk, nm, _, _, skb, smb = vals
        edge_emb = torch.relu(r(G, E, D)).to(dt)
        w_ke, w_me, b_ke, b_me = r(D, HD) * .05, r(D, HD) * .05, r(HD) * .1, \
            r(HD) * .1
        proj_vals = [nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb]
        runs = {"cuda": (op("cuda"), vals), "scatter": (op("scatter"), vals),
                "projected op": (lambda *t: gk.gat_projected(
                    *t, src, dst, mask, HEADS), proj_vals)}
        for what, (fn, v) in runs.items():
            with torch.no_grad():
                fwd = device_ms(lambda: fn(*v), iters=10, warmup=2)
            leaves = [x.detach().clone().requires_grad_() for x in v]
            both = device_ms(lambda: forward_backward(fn, leaves, gout),
                             iters=10, warmup=2)
            log(f"  time {name} {what:<13} forward {fwd:.4f} ms  forward + "
                f"backward {both:.4f} ms  [{card}]")
            del leaves


# ---------------------------------------------------------------------------
# the serving slice
# ---------------------------------------------------------------------------

def build_model(cfg, dev, gen, enc_cfg=None):
    """The OBQA LMQAGNN (roberta-large unless `enc_cfg` names another
    encoder) with random weights from `gen`."""
    enc_cfg = enc_cfg or TextEncoderConfig.roberta_large()
    with torch.device(dev):
        model = LMQAGNN(
            make_encoder(enc_cfg), sent_dim=enc_cfg.hidden_size, k=cfg.k,
            n_ntype=N_NTYPE, n_etype=cfg.num_relation, n_concept=N_CONCEPT,
            concept_dim=cfg.gnn_dim, concept_in_dim=CONCEPT_IN,
            n_attention_head=cfg.att_head_num, fc_dim=cfg.fc_dim,
            n_fc_layer=cfg.fc_layer_num, p_emb=cfg.dropouti,
            p_gnn=cfg.dropoutg, p_fc=cfg.dropoutf, gnn_dtype=torch.bfloat16)
    init_weights(model, gen, cfg.init_range)
    with torch.no_grad():      # eval-mode BatchNorm that is not the identity
        for mod in model.modules():
            if isinstance(mod, MaskedBatchNorm):
                f = mod.features
                mod.mean.copy_(torch.randn(f, generator=gen, device=dev) * .1)
                mod.var.uniform_(0.5, 2.0, generator=gen)
                mod.scale.uniform_(0.5, 1.5, generator=gen)
                mod.bias.copy_(torch.randn(f, generator=gen, device=dev) * .1)
    return model, enc_cfg


def make_batch(gen, dev, vocab, n_etype, empty_graph=None):
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen,
                                             device=dev, dtype=torch.int32)
    lengths = ri(L // 3, L + 1, (B, C, 1))
    attn = (torch.arange(L, device=dev) < lengths).to(torch.int32)
    ids = torch.where(attn > 0, ri(3, vocab, (B, C, L)), 1)   # 1 = <pad>
    ids[..., 0] = 0                                           # <s>
    num_nodes = ri(N // 2, N + 1, (G,))
    real = torch.arange(N, device=dev)[None, :] < num_nodes[:, None]
    concept_ids = torch.where(real, ri(2, N_CONCEPT + 1, (G, N)), 1)
    concept_ids[:, 0] = 0
    node_types = torch.where(real, ri(0, 3, (G, N)), 2)
    node_types[:, 0] = 3
    n_edges = ri(E // 2, E + 1, (G, 1))
    if empty_graph is not None:
        n_edges[empty_graph] = 0
    hi = num_nodes[:, None]
    node = lambda: torch.minimum(
        (torch.rand((G, E), generator=gen, device=dev) * hi).to(torch.int32),
        hi - 1)
    graph = BatchedGraphs(
        concept_ids=concept_ids, node_types=node_types,
        node_scores=torch.randn((G, N), generator=gen, device=dev),
        num_nodes=num_nodes, edge_src=node(), edge_dst=node(),
        edge_type=ri(0, n_etype, (G, E)),
        edge_mask=torch.arange(E, device=dev)[None, :] < n_edges)
    return {"input_ids": ids, "attention_mask": attn}, graph


def set_gnn_dtype(model, dtype) -> None:
    for mod in model.decoder.gnn.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = dtype


def phase_slice(dev, reports, card, cfg, model, enc_cfg, gen):
    batches = [make_batch(gen, dev, enc_cfg.vocab_size, cfg.num_relation,
                          empty_graph=G - 1 if i == 0 else None)
               for i in range(3)]
    step = make_eval_step(model)
    gnn = model.decoder.gnn
    assert gnn.backend is None and gnn.dtype == torch.bfloat16

    # the main path: counts from 0, every forward through the kernels
    order = [0, 0, 1, 2, 0, 1, 2]           # the first forward warms up
    spans, handles = device_spans({"encoder": model.encoder,
                                   "decoder": model.decoder, "GNN": gnn})
    _build.reset_launch_counts()
    logits, times = {}, []
    for i, b in enumerate(order):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(*batches[b])
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t)
        logits.setdefault(b, out.clone())
    counts = dict(_build.LAUNCHES)
    for h in handles:
        h.remove()
    per_forward = {"edge_hidden": 1, "gat_pass_a_scores": cfg.k,
                   "gat_pass_a_denoms": cfg.k, "gat_pass_c": cfg.k}
    for name, n in per_forward.items():
        got = counts.get(name, 0)
        ok = got == n * len(order)
        log(f"  launches {name:<20} {got:>3} over {len(order)} forwards "
            f"(expected {n} per forward)  {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"launch count {name}")
        reports[name]["launches"] = got
    extra = set(counts) - set(per_forward)
    if extra:
        FAILURES.append(f"unexpected kernels launched: {sorted(extra)}")
    check_routes(BF16_ROUTES, f"{len(order)} served forwards, bf16 GNN")

    for b, out in logits.items():
        if out.shape != (B, C) or not bool(torch.isfinite(out).all()):
            FAILURES.append(f"logits of batch {b}: shape {tuple(out.shape)}")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    med = statistics.median(times)
    log(f"  serving: {med * 1e3:.3f} ms per request of {B} questions x {C} "
        f"choices (median of {len(times)}; min {min(times) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f}); {med * 1e3 / B:.3f} ms per question; "
        f"{G * E * cfg.k / med:.4e} edges/s (G*E*k over the median forward)"
        f"  [{card}]")
    span_ms = {name: statistics.median(s.elapsed_time(e) for s, e in evs[1:])
               for name, evs in spans.items()}
    log("  device time per forward (median; CUDA events around the modules): "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in span_ms.items())
        + " (the GNN is part of the decoder)")

    # the same weights on the scatter path, in bf16 and then in f32: the
    # logits, and the GNN's (G, N, D) output, where the kernels act directly
    gnn_out = {}
    hook = gnn.register_forward_hook(
        lambda mod, args, out: gnn_out.__setitem__("x", out))

    def serve(b, backend):
        gnn.backend = backend
        return step(*batches[b]), gnn_out["x"]

    for dt in (torch.bfloat16, torch.float32):
        set_gnn_dtype(model, dt)
        name = "bf16" if dt == torch.bfloat16 else "f32"
        for b in logits:
            want, want_gnn = serve(b, "scatter")
            got, got_gnn = serve(b, "cuda")
            compare(f"logits cuda vs scatter, {name}, batch {b}", got, want,
                    LOGIT_TOL[dt])
            compare(f"GNN output cuda vs scatter, {name}, batch {b}",
                    got_gnn, want_gnn, GNN_TOL[dt])
    hook.remove()
    set_gnn_dtype(model, torch.bfloat16)
    gnn.backend = None
    log(f"  logits of batch 0, question 0: {logits[0][0].tolist()}")
    encoder_in_bf16(model, enc_cfg, step, batches[0], card)


def set_encoder_dtype(model, enc_cfg, dtype) -> None:
    """The encoder's compute dtype, as `--encoder_dtype` sets it."""
    ecfg = dataclasses.replace(enc_cfg, dtype=dtype)
    for mod in model.encoder.modules():
        if hasattr(mod, "cfg"):
            mod.cfg = ecfg


def encoder_in_bf16(model, enc_cfg, step, batch, card) -> None:
    """A measurement, no default changed: the served forward with the
    encoder computing in bf16 against f32 (TF32 off) on the same batch,
    the logits' max|d| over max|logit| and the times."""
    logits, host, span = {}, {}, {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        set_encoder_dtype(model, enc_cfg, dt)
        spans, handles = device_spans({"encoder": model.encoder})
        times = []
        for _ in range(4):                    # the first warms up
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        for h in handles:
            h.remove()
        logits[name] = out.float()
        host[name] = statistics.median(times[1:]) * 1e3
        span[name] = statistics.median(s.elapsed_time(e)
                                       for s, e in spans["encoder"][1:])
    set_encoder_dtype(model, enc_cfg, torch.float32)
    err = (logits["bf16"] - logits["f32"]).abs().max().item()
    ref = logits["f32"].abs().max().item()
    same = int((logits["bf16"].argmax(1) == logits["f32"].argmax(1)).sum())
    log(f"  encoder in bf16 vs f32 (a measurement; the default stays f32): "
        f"logits max|d| {err:.3e} of max|logit| {ref:.3e}, {err / ref:.3e}; "
        f"argmax agrees on {same} of {B}; request {host['f32']:.3f} -> "
        f"{host['bf16']:.3f} ms, encoder device span {span['f32']:.3f} -> "
        f"{span['bf16']:.3f} ms (medians of 3)  [{card}]")
    if not bool(torch.isfinite(logits["bf16"]).all()):
        FAILURES.append("bf16 encoder logits")


# ---------------------------------------------------------------------------
# the detail step
# ---------------------------------------------------------------------------

def phase_detail(dev, card, cfg, model, enc_cfg, gen):
    lm, graph = make_batch(gen, dev, enc_cfg.vocab_size, cfg.num_relation,
                           empty_graph=G - 1)
    gnn = model.decoder.gnn
    assert gnn.backend is None and gnn.dtype == torch.bfloat16
    detail_step, eval_step = make_detail_step(model), make_eval_step(model)
    n_head, H = cfg.att_head_num, HEADS
    src = graph.edge_src.long()[None, ..., None].expand(cfg.k, G, E, H)
    for dt in (torch.bfloat16, torch.float32):
        name = "bf16" if dt == torch.bfloat16 else "f32"
        set_gnn_dtype(model, dt)
        _build.reset_launch_counts()
        times = []
        for _ in range(3 if dt == torch.bfloat16 else 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, pool, (edge, self_) = detail_step(lm, graph)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        counts = dict(_build.LAUNCHES)
        log(f"  kernels launched by the detail step, {name}: {counts} (none "
            "by design: the attention weights exist only on the scatter arm)")
        if counts:
            FAILURES.append(f"the detail step launched kernels: {counts}")
        shapes = {"logits": (logits, (B, C)), "pool": (pool, (n_head * G, N)),
                  "edge": (edge, (cfg.k, G, E, H)),
                  "self": (self_, (cfg.k, G, N, H))}
        for what, (t, shape) in shapes.items():
            if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
                FAILURES.append(f"detail {what} {name}: {tuple(t.shape)}")
        gnn.backend = "scatter"
        compare(f"detail logits vs served scatter path, {name}", logits,
                eval_step(lm, graph), LOGIT_TOL[dt])
        gnn.backend = None
        compare(f"detail logits vs served kernel path, {name}", logits,
                eval_step(lm, graph), LOGIT_TOL[dt])
        compare(f"pooler attention rows sum to 1, {name}",
                pool.float().sum(1), torch.ones(n_head * G, device=dev),
                ALPHA_SUM_TOL[torch.float32])
        total = self_.float().scatter_add(2, src, edge.float())
        compare(f"self alpha + live edge alphas per source = 1, {name}",
                total, torch.ones_like(total), ALPHA_SUM_TOL[dt])
        if bool((edge[:, ~graph.edge_mask] != 0).any()):
            FAILURES.append(f"detail: alphas of masked slots, {name}")
        if dt == torch.bfloat16:
            med = statistics.median(times[1:])
            log(f"  detail step: {med * 1e3:.3f} ms per request of {B} "
                f"questions x {C} choices (median of {len(times) - 1}, after "
                f"one warm-up of {times[0] * 1e3:.3f} ms)  [{card}]")
    set_gnn_dtype(model, torch.bfloat16)


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

def set_dropout(model, cfg, enc_cfg, on: bool) -> None:
    """The preset's dropout rates, or 0 everywhere."""
    p = (lambda x: x) if on else (lambda x: 0.0)
    ecfg = dataclasses.replace(
        enc_cfg, hidden_dropout=p(enc_cfg.hidden_dropout),
        attention_dropout=p(enc_cfg.attention_dropout))
    for mod in model.encoder.modules():
        if hasattr(mod, "cfg"):
            mod.cfg = ecfg
    dec = model.decoder
    dec.p_emb, dec.p_fc = p(cfg.dropouti), p(cfg.dropoutf)
    dec.gnn.dropout, dec.fc.dropout = p(cfg.dropoutg), p(cfg.dropoutf)
    dec.pooler.dropout = dec.pooler.attention.attn_dropout = p(0.1)


ROUTED = ("gat_pass_a_scores", "gat_pass_c", "gat_bwd_pass1", "gat_bwd_pass2",
          "gat_bwd_demb", "gat_bwd_dw", "edge_hidden", "edge_hidden_bwd")


# the route each routed entry point takes in a bf16 run at the preset:
# tensor cores (route 1), and for backward passes 1 and 2 the route the rule
# gives a pass of one launch at D = 200 (`_edge_route`: route 2, the wgmma
# edge kernel fed by TMA, csrc/gat_edge.cu, where it was the faster)
BF16_ROUTES = dict.fromkeys(ROUTED, 1) | dict.fromkeys(
    ("gat_bwd_pass1", "gat_bwd_pass2"),
    gk._edge_route(torch.bfloat16, None, 200, True))
# the source of backward passes 1 and 2's edge launch on each route
EDGE_SOURCE = {1: "gat_bwd.cu", 2: "gat_edge.cu"}


# the routes of a step with an f32 GNN: the forward passes A and C and
# backward passes 1 and 2 on tensor cores (split TF32), the edge encoder's
# route 1 (its backward's one-hot product on tf32)
F32_ROUTES = {"gat_pass_a_scores": 1, "gat_pass_c": 1, "gat_bwd_pass1": 1,
              "gat_bwd_pass2": 1, "gat_bwd_demb": 1, "gat_bwd_dw": 1,
              "edge_hidden": 1, "edge_hidden_bwd": 1}


def check_routes(route, what: str) -> None:
    """Every launch counted since the last reset of the entry points that
    have more than one route took its route: `route` for all of them (an
    int), or by entry point (a dict: BF16_ROUTES, F32_ROUTES)."""
    want = route if isinstance(route, dict) else dict.fromkeys(ROUTED, route)
    launched = [n for n in ROUTED if _build.LAUNCHES[n]]
    ok = all(_build.ROUTES[n, want[n]] == _build.LAUNCHES[n]
             for n in launched)
    log(f"  routes, {what}: " + ", ".join(
        f"{n} {_build.ROUTES[n, want[n]]} of {_build.LAUNCHES[n]} on route "
        f"{want[n]}" for n in launched) + f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"routes, {what}: {dict(_build.ROUTES)}")


def step_launches(k) -> dict:
    """Launches of each kernel in one forward + backward of the model on
    the kernel path (k GAT layers): each backward pass also one dW
    launch."""
    return {"edge_moments": 1, "edge_hidden": 1, "gat_pass_a_scores": k,
            "gat_pass_a_denoms": k, "gat_pass_c": k, "gat_bwd_pass1": k,
            "gat_bwd_pass2": k, "gat_bwd_dw": 2 * k, "edge_hidden_bwd": 1}


def check_launches(counts, n_steps, microbatches, k, what) -> None:
    per_pass = step_launches(k)
    bad = {name: counts.get(name, 0) for name, n in per_pass.items()
           if counts.get(name, 0) != n * n_steps * microbatches}
    extra = set(counts) - set(per_pass)
    ok = not bad and not extra
    log(f"  launches over {n_steps} step(s) x {microbatches} microbatch(es), "
        f"{what}: " + ", ".join(f"{n} {counts.get(n, 0)}" for n in per_pass)
        + f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"launch counts, {what}: {bad or sorted(extra)}")


class StepSpans:
    """CUDA events at the boundaries of a train step's parts: forward hooks
    on the encoder and the GNN, backward hooks on both (the encoder's
    backward ends the backward pass, where the optimizer starts)."""

    def __init__(self, model, optimizer):
        self.marks: list[dict] = []
        self.handles = []
        # the encoder's inputs are integers: its backward hook can only see
        # the cotangent of its output, which is what is wanted here
        warnings.filterwarnings("ignore", message="Full backward hook")
        enc, gnn = model.encoder, model.decoder.gnn
        for name, mod in (("enc", enc), ("gnn", gnn)):
            self.handles += [
                mod.register_forward_pre_hook(
                    lambda m, a, n=name: self.mark(n + "_fwd0")),
                mod.register_forward_hook(
                    lambda m, a, o, n=name: self.mark(n + "_fwd1")),
                mod.register_full_backward_pre_hook(
                    lambda m, g, n=name: self.mark(n + "_bwd0"))]
        self.handles.append(gnn.register_full_backward_hook(
            lambda m, gi, go: self.mark("gnn_bwd1")))
        self.optimizer, self.opt_step = optimizer, optimizer.step

        def step(*args):
            self.mark("opt0")
            return self.opt_step(*args)
        optimizer.step = step

    def mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks[-1][name] = ev

    def run(self, fn):
        self.marks.append({})
        self.mark("start")
        out = fn()
        self.mark("end")
        return out

    def close(self):
        for h in self.handles:
            h.remove()
        self.optimizer.step = self.opt_step

    def medians(self) -> dict:
        spans = {"step": ("start", "end"), "encoder fwd": ("enc_fwd0", "enc_fwd1"),
                 "GNN fwd": ("gnn_fwd0", "gnn_fwd1"),
                 "GNN bwd": ("gnn_bwd0", "gnn_bwd1"),
                 "encoder bwd": ("enc_bwd0", "opt0"),
                 "optimizer": ("opt0", "end")}
        out = {}
        for name, (a, b) in spans.items():
            ms = [m[a].elapsed_time(m[b]) for m in self.marks[1:]
                  if a in m and b in m]
            out[name] = statistics.median(ms) if ms else None
        return out


def profile_optimizer(opt, trainable: bool, card: str) -> None:
    """The optimizer step alone, on the gradients the last train step left:
    its host time and its span by CUDA events (median of 3, with nothing
    queued ahead of it, so a host-bound step shows), then one step under
    torch.profiler: the CUDA kernels launched inside it (its multi-tensor
    passes take some tens of tensors or 320 chunks of 65,536 elements a
    launch; a per-tensor loop launches about 13 a tensor) and their device
    time. A failure if it launched 2 or more kernels a tensor."""
    from torch.profiler import ProfilerActivity, profile
    what = "trained" if trainable else "frozen"
    n_tensors = sum(len(opt.groups[g]) for g in ("encoder", "decoder")
                    if g == "decoder" or trainable)
    host, spans = [], []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.record()
        opt.step(trainable)
        e.record()
        host.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        spans.append(s.elapsed_time(e))
    kernels = []
    for _ in range(3):            # a window at times records no device work
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            opt.step(trainable)
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    timing = (f"host {statistics.median(host):.3f} ms to launch, span "
              f"{statistics.median(spans):.3f} ms (CUDA events, medians of "
              "3)")
    if not kernels:
        log(f"  optimizer step alone, encoder {what}: {timing}; "
            "torch.profiler recorded no device work (kernels not counted)"
            f"  [{card}]")
        return
    busy = sum(ev.time_range.elapsed_us() for ev in kernels) / 1e3
    names = collections.Counter(re.sub(r"<.*", "", ev.name)[:60]
                                for ev in kernels)
    ok = len(kernels) < 2 * n_tensors
    log(f"  optimizer step alone, encoder {what}: {timing}; "
        f"{len(kernels)} CUDA kernels for {n_tensors} tensors, {busy:.3f} ms "
        f"of device time in them (torch.profiler)  [{card}]  "
        f"{'ok' if ok else 'FAIL: a per-tensor loop'}")
    log("    by name: " + "; ".join(f"{n} x{c}"
                                   for n, c in names.most_common(6)))
    if not ok:
        FAILURES.append(f"optimizer, encoder {what}: {len(kernels)} kernels "
                        f"for {n_tensors} tensors")


def optimizer_on_cpu(model, opt, frozen) -> None:
    """One optimizer step on the card against the same step on CPU copies
    of the same parameters, gradients and state, in f32: max|dp| over
    max|p| within 1e-6 over every trained tensor; beside it the moments'
    error and the global gradient norm of each against one summed in f64.
    The step leaves `.grad` as it was."""
    params = dict(model.named_parameters())
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_opt = build_train_optimizer(cpu_model, frozen=frozen, **OPT)
    for key, v in opt.state.items():
        cpu_opt.state[key] = v.detach().to("cpu", copy=True)
    for n, q in cpu_model.named_parameters():
        g = params[n].grad
        q.grad = None if g is None else g.detach().to("cpu", copy=True)
    norm64 = math.sqrt(sum(
        float(q.grad.double().square().sum()) for q in cpu_opt.params.values()
        if q.grad is not None))
    grad = {n: params[n].grad.clone() for n in opt.params
            if params[n].grad is not None}
    torch.cuda.synchronize()
    t = time.perf_counter()
    opt.step(True)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t
    t = time.perf_counter()
    cpu_opt.step(True)
    t_cpu = time.perf_counter() - t
    err = {"p": 0.0, "moments": 0.0}
    ref = {"p": 0.0, "moments": 0.0}
    for n, q in cpu_opt.params.items():
        err["p"] = max(err["p"], (params[n].detach().cpu() - q).abs().max()
                       .item())
        ref["p"] = max(ref["p"], q.abs().max().item())
    for key, q in cpu_opt.state.items():
        if ".mu." in key or ".nu." in key:
            err["moments"] = max(err["moments"], (opt.state[key].cpu() - q)
                                 .abs().max().item())
            ref["moments"] = max(ref["moments"], q.abs().max().item())
    rel = {k: err[k] / ref[k] if ref[k] else err[k] for k in err}
    same_grad = bool(grad) and all(torch.equal(params[n].grad, g)
                                   for n, g in grad.items())
    ok = rel["p"] <= 1e-6 and same_grad
    norms = (opt.last_grad_norm.item(), cpu_opt.last_grad_norm.item())
    log(f"  optimizer step, card vs CPU copies of the same state (f32, "
        f"{sum(q.numel() for q in cpu_opt.params.values())} parameters): "
        f"max|dp| {err['p']:.3e} of max|p| {ref['p']:.3e}, "
        f"{rel['p']:.3e} (tol 1.0e-06); the moments' {rel['moments']:.3e}; "
        f"global gradient norm {norms[0]:.7f} on the card, {norms[1]:.7f} "
        f"on the CPU, {norm64:.7f} summed in f64 (off by "
        f"{abs(norms[0] / norm64 - 1):.2e}, {abs(norms[1] / norm64 - 1):.2e})"
        f"; .grad left as it was: {same_grad}; host {t_card * 1e3:.1f} ms "
        f"on the card, {t_cpu * 1e3:.1f} ms on the CPU  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append("optimizer step card vs CPU")


def phase_train(dev, reports, card, cfg, model, enc_cfg, gen):
    batch = Batch(*make_batch(gen, dev, enc_cfg.vocab_size, cfg.num_relation),
                  torch.randint(0, C, (B,), generator=gen, device=dev))
    gnn = model.decoder.gnn
    frozen = entity_table_names(model)
    probe = ["decoder.gnn.edge_encoder.linear_0.kernel",
             "decoder.gnn.edge_encoder.bn.bias",
             "decoder.gnn.edge_encoder.bn.scale",
             "decoder.gnn.edge_encoder.linear_1.kernel",
             "decoder.gnn.gnn_layer_0.key_e.kernel",
             "decoder.gnn.gnn_layer_2.query.kernel",
             "decoder.gnn.gnn_layer_4.msg_e.bias",
             "decoder.gnn.emb_score.weight", "decoder.svec2nvec.weight",
             f"encoder.layer_{enc_cfg.num_layers - 1}.output.weight",
             "encoder.word_embeddings.weight"]
    params = dict(model.named_parameters())
    torch.cuda.reset_peak_memory_stats()

    # one step on each path from the same state: f32 GNN, dropout 0
    log("  kernel path vs scatter path, one step each from the same state "
        "(f32 GNN, dropout 0):")
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    set_dropout(model, cfg, enc_cfg, False)
    set_gnn_dtype(model, torch.float32)
    seen = {}
    for backend in ("cuda", "scatter"):
        model.load_state_dict(snapshot)
        gnn.backend = backend
        opt = build_train_optimizer(model, frozen=frozen, **OPT)
        step = make_train_step(model, opt)
        _build.reset_launch_counts()
        loss = step(batch, generator=torch.Generator(device=dev)
                    .manual_seed(SEED + 2))["loss"]
        torch.cuda.synchronize()
        if backend == "cuda":
            check_launches(dict(_build.LAUNCHES), 1, 1, cfg.k, "f32 step")
            check_routes(F32_ROUTES, "f32 step")
        elif _build.LAUNCHES:
            FAILURES.append("the scatter path launched kernels")
        seen[backend] = (loss, opt.last_grad_norm,
                         {n: params[n].grad.clone() for n in probe})
        del opt, step
    (loss, gnorm, grads), (loss_w, gnorm_w, grads_w) = \
        seen["cuda"], seen["scatter"]
    compare("train step loss", loss, loss_w, STEP_TOL["loss"])
    compare("train step global gradient norm", gnorm, gnorm_w,
            STEP_TOL["grad_norm"])
    for n in probe:
        compare(f"grad {n}", grads[n], grads_w[n], STEP_TOL["grad"])
    del seen, grads, grads_w
    model.load_state_dict(snapshot)
    del snapshot
    gnn.backend = None
    set_gnn_dtype(model, torch.bfloat16)
    set_dropout(model, cfg, enc_cfg, True)

    # steps on a fixed batch: bf16 GNN, the preset's dropout. The generator
    # is set back to one seed before every step, so every step draws the
    # same masks: the loss is then one function of the parameters, and its
    # fall shows the optimisation and not the masks' noise (with new masks
    # at every step the loss of this random model moves by +-0.05, more
    # than ten steps at these learning rates gain).
    opt = build_train_optimizer(model, frozen=frozen, **OPT)
    step = make_train_step(model, opt)
    generator = torch.Generator(device=dev)
    spans = StepSpans(model, opt)
    _build.reset_launch_counts()
    losses, times = [], []
    n_steps = TRAIN_STEPS + 1                  # the first one warms up
    for i in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        generator.manual_seed(SEED + 3)
        out = spans.run(lambda: step(batch, generator=generator))
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t)
        losses.append(out["loss"].item())
    spans.close()
    counts = dict(_build.LAUNCHES)
    check_launches(counts, n_steps, 1, cfg.k, "bf16 steps")
    check_routes(BF16_ROUTES, "bf16 steps")
    for name in ("edge_moments", "edge_hidden_bwd", "gat_bwd_pass1",
                 "gat_bwd_pass2", "gat_bwd_dw"):
        reports[name]["launches"] = counts.get(name, 0)
    log("  losses on the fixed batch, fixed dropout masks: "
        + ", ".join(f"{x:.5f}" for x in losses))
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        FAILURES.append("non-finite training loss")
    if not losses[-1] < losses[0]:
        FAILURES.append(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    med = statistics.median(times)
    log(f"  training: {med * 1e3:.3f} ms per step of {B} questions x {C} "
        f"choices (median of {len(times)}; min {min(times) * 1e3:.3f}, max "
        f"{max(times) * 1e3:.3f}); {G * E * cfg.k / med:.4e} edges/s  "
        f"[{card}]")
    log("  device time per step (median; CUDA events): " + ", ".join(
        f"{name} {'not measured' if ms is None else f'{ms:.3f} ms'}"
        for name, ms in spans.medians().items())
        + " (GNN bwd: from the GNN output's cotangent to its inputs'; "
        "encoder bwd: from the encoder output's cotangent to the end of the "
        "backward pass, the decoder's head before the GNN included)")

    # the encoder frozen: its parameters and moments stay as they are
    enc_params = {n: p.detach().clone() for n, p in params.items()
                  if n.startswith("encoder.")}
    enc_state = {k: v.clone() for k, v in opt.state.items()
                 if k.startswith("encoder.")}
    dec_before = params["decoder.svec2nvec.weight"].detach().clone()
    spans = StepSpans(model, opt)
    _build.reset_launch_counts()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = spans.run(lambda: step(batch, encoder_trainable=False,
                                      generator=generator))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    spans.close()
    check_launches(dict(_build.LAUNCHES), 3, 1, cfg.k, "frozen encoder")
    check_routes(BF16_ROUTES, "frozen encoder")
    same = all(torch.equal(params[n], v) for n, v in enc_params.items()) \
        and all(torch.equal(opt.state[k], v) for k, v in enc_state.items())
    moved = not torch.equal(params["decoder.svec2nvec.weight"], dec_before)
    log(f"  frozen encoder, 3 steps: {min(times[1:]) * 1e3:.3f} ms per step "
        f"(faster of the last 2; {', '.join(f'{x * 1e3:.3f}' for x in times)})"
        f", loss {loss['loss'].item():.5f}; encoder parameters "
        f"and moments unchanged: {same}; decoder moved: {moved}  [{card}]")
    log("  device time per frozen step (median of the last 2; CUDA events): "
        + ", ".join(f"{name} "
                    + ("not measured" if ms is None else f"{ms:.3f} ms")
                    for name, ms in spans.medians().items()))
    if not (same and moved and torch.isfinite(loss["loss"])):
        FAILURES.append("frozen-encoder step")
    del enc_params, enc_state

    # gradient accumulation over two microbatches
    step2 = make_train_step(model, opt, num_microbatches=2)
    _build.reset_launch_counts()
    loss = step2(batch, generator=generator)["loss"]
    torch.cuda.synchronize()
    check_launches(dict(_build.LAUNCHES), 1, 2, cfg.k, "two microbatches")
    check_routes(BF16_ROUTES, "two microbatches")
    log(f"  two microbatches: loss {loss.item():.5f}")
    if not torch.isfinite(loss):
        FAILURES.append("two-microbatch step")

    # the optimizer alone, on the gradients that step left
    for trainable in (True, False):
        profile_optimizer(opt, trainable, card)
    optimizer_on_cpu(model, opt, frozen)
    log(f"  peak device memory over the training phase "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

# ---------------------------------------------------------------------------
# the CLI: qagnn_tpu_torch.cli on a dataset written to disk
# ---------------------------------------------------------------------------

# questions per split (4 choices each), and the graphs' sizes: 100-199
# concepts, ConceptNet's 17 relations in the (17 n, n) adjacency layout with
# 700-1900 stored entries, so that after the context edges and the inverses
# every split's largest graph lands in the 4096-edge bucket, the train
# phase's E
CLI_QUESTIONS = {"train": 48, "dev": 16, "test": 16}
CLI_CONCEPTS = (100, 200)
CLI_ADJ_ENTRIES = (700, 1900)
CLI_RELATIONS = 17
CLI_WORDS = 400
# the entity table's rows (ConceptNet's); cut here, never a width, should
# the phase outgrow its time
CLI_ENTITY_ROWS = N_CONCEPT
CLI_EPOCHS, CLI_UNFREEZE = 2, 1


def write_cli_dataset(root: pathlib.Path, rng, questions=CLI_QUESTIONS,
                      entity_rows=CLI_ENTITY_ROWS) -> tuple[str, list[str]]:
    """Statements, graphs and an entity table in the reference's formats
    (reference utils/data_utils.py:79, utils/graph.py:114-129), from `rng`:
    `questions` per split, `entity_rows` rows of the table. Returns the
    table's path and the statements' words."""
    import pickle

    import scipy.sparse

    words = [f"w{i}" for i in range(CLI_WORDS)]
    (root / "statement").mkdir(parents=True)
    (root / "graph").mkdir()
    for split, n in questions.items():
        with open(root / "statement" / f"{split}.statement.jsonl", "w") as f:
            for i in range(n):
                stem = " ".join(rng.choice(words, int(rng.integers(8, 70))))
                choices = [{"label": "ABCD"[j], "text": " ".join(
                    rng.choice(words, int(rng.integers(1, 6))))}
                    for j in range(C)]
                f.write(json.dumps({
                    "id": f"{split}-{i}",
                    "answerKey": "ABCD"[int(rng.integers(C))],
                    "question": {"stem": stem + " ?",
                                 "choices": choices}}) + "\n")
        rows = []
        for g in range(n * C):
            nn_ = int(rng.integers(*CLI_CONCEPTS))
            concepts = np.unique(rng.integers(0, entity_rows - 1,
                                              2 * nn_))[:nn_]
            rng.shuffle(concepts)
            nn_ = len(concepts)
            n_q, n_a = int(rng.integers(1, 6)), int(rng.integers(1, 4))
            qm, am = np.zeros(nn_, bool), np.zeros(nn_, bool)
            qm[:n_q] = True
            am[n_q:n_q + n_a] = True
            # the split's first graph is its largest
            nnz = CLI_ADJ_ENTRIES[1] if g == 0 \
                else int(rng.integers(*CLI_ADJ_ENTRIES))
            flat = rng.choice(CLI_RELATIONS * nn_ * nn_, nnz, replace=False)
            adj = scipy.sparse.coo_matrix(
                (np.ones(nnz, bool), (flat // nn_, flat % nn_)),
                shape=(CLI_RELATIONS * nn_, nn_))
            cid2score = dict(zip(concepts.tolist(),
                                 rng.standard_normal(nn_).tolist()))
            cid2score[-1] = 0.0
            rows.append({"adj": adj, "concepts": concepts, "qmask": qm,
                         "amask": am, "cid2score": cid2score})
        with open(root / "graph" / f"{split}.graph.adj.pk", "wb") as f:
            pickle.dump(rows, f)
    emb_path = str(root / "ent_emb.npy")
    table = rng.random((entity_rows, CONCEPT_IN), dtype=np.float32)
    table -= 0.5
    np.save(emb_path, table)
    return emb_path, words


def hf_roberta_names(n_layers: int) -> dict[str, str]:
    """TextEncoder parameter name -> RobertaModel state-dict key: the inverse
    of models/text_encoder.py `convert_hf_encoder_params`, kept here so that
    the checkpoint this phase writes does not come from the code it tests."""
    names = {f"{t}.weight": f"embeddings.{t}.weight"
             for t in ("word_embeddings", "position_embeddings",
                       "token_type_embeddings")}
    pairs = [("embeddings_ln", "embeddings.LayerNorm"),
             ("pooler", "pooler.dense")]
    for i in range(n_layers):
        p, h = f"layer_{i}", f"encoder.layer.{i}"
        pairs += [(f"{p}.attention.{n}", f"{h}.attention.self.{n}")
                  for n in ("query", "key", "value")]
        pairs += [(f"{p}.attention.out", f"{h}.attention.output.dense"),
                  (f"{p}.attention_ln", f"{h}.attention.output.LayerNorm"),
                  (f"{p}.intermediate", f"{h}.intermediate.dense"),
                  (f"{p}.output", f"{h}.output.dense"),
                  (f"{p}.output_ln", f"{h}.output.LayerNorm")]
    for p, h in pairs:
        names[f"{p}.weight"], names[f"{p}.bias"] = f"{h}.weight", f"{h}.bias"
    return names


def write_hf_roberta(out: pathlib.Path, params: dict, enc_cfg, head=None,
                     model_type="roberta") -> None:
    """An HF save_pretrained-style directory of a RobertaModel: config.json
    and pytorch_model.bin under RobertaModel's key names. With `head` (an
    MLMHead's parameters, its decoder tied to the word embeddings), of a
    RobertaForMaskedLM as HF saves one: the encoder under `roberta.` with
    no pooler, `lm_head.dense.*`, `lm_head.layer_norm.*` and `lm_head.bias`,
    and no `lm_head.decoder.weight`. `model_type="bert"` writes a BertModel,
    whose keys are the same."""
    names = hf_roberta_names(enc_cfg.num_layers)
    if head is not None:
        names = {n: "roberta." + h for n, h in names.items()
                 if not n.startswith("pooler.")}
    if set(names) != set(params):
        FAILURES.append("the HF name map does not cover the encoder: "
                        f"{sorted(set(names) ^ set(params))[:5]}")
    sd = {names[n]: t for n, t in params.items()}
    if head is not None:
        sd |= {f"lm_head.{n}": head[n] for n in (
            "dense.weight", "dense.bias", "layer_norm.weight",
            "layer_norm.bias")}
        sd["lm_head.bias"] = head["decoder.bias"]
    out.mkdir(parents=True)
    torch.save(sd, out / "pytorch_model.bin")
    arch = {"roberta": "RobertaModel", "bert": "BertModel"}[model_type]
    with open(out / "config.json", "w") as f:
        json.dump({
            "model_type": model_type, "architectures": [
                "RobertaForMaskedLM" if head is not None else arch],
            "vocab_size": enc_cfg.vocab_size,
            "hidden_size": enc_cfg.hidden_size,
            "num_hidden_layers": enc_cfg.num_layers,
            "num_attention_heads": enc_cfg.num_heads,
            "intermediate_size": enc_cfg.intermediate_size,
            "max_position_embeddings": enc_cfg.max_position_embeddings,
            "type_vocab_size": enc_cfg.type_vocab_size,
            "layer_norm_eps": enc_cfg.layer_norm_eps,
            "hidden_dropout_prob": enc_cfg.hidden_dropout,
            "attention_probs_dropout_prob": enc_cfg.attention_dropout,
            "pad_token_id": enc_cfg.pad_token_id, "bos_token_id": 0,
            "eos_token_id": 2, "hidden_act": enc_cfg.hidden_act}, f)


EVAL_LAUNCHES = ("edge_hidden", "gat_pass_a_scores", "gat_pass_a_denoms",
                 "gat_pass_c")


class Tee:
    """A stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


class CliProbe:
    """Watches qagnn_tpu_torch.cli run: wraps the names the CLI calls
    (the loader, the encoder checkpoint reader, the step factories, the
    checkpoint functions) without changing what they return, and records
    per call its host time, its device span (CUDA events), the kernels it
    launched and the eval logits; checks that the loader's batches are
    pinned, that the loaded encoder is the written one bit for bit, and
    that a restored optimizer state is the saved one bit for bit."""

    def __init__(self, tokenizer, written: dict):
        self.tokenizer, self.written = tokenizer, written
        self.run = None
        self.calls: list[dict] = []
        self.times: dict[str, list[float]] = collections.defaultdict(list)
        self.dataset = None
        self.saved = None
        self.restored = (False, -1)     # (equal to the saved state, step)
        self.ckpt_bytes = 0
        self.unpinned = 0
        self.check_model = False

    def patches(self):
        from qagnn_tpu_torch import cli
        wrap = {"QAGNNDataLoader": self.loader,
                "build_model_and_data": self.build,
                "load_encoder_checkpoint": self.load_encoder,
                "make_train_step": self.step_wrapper("train"),
                "make_eval_step": self.step_wrapper("eval"),
                "make_detail_step": self.step_wrapper("detail"),
                "save_checkpoint": self.save, "load_checkpoint": self.load,
                "restore_into": self.restore}
        stack = contextlib.ExitStack()
        for name, make in wrap.items():
            stack.enter_context(mock.patch.object(
                cli, name, make(getattr(cli, name))))
        return stack

    def timed(self, what, fn, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        self.times[what].append(time.perf_counter() - t)
        return out

    def loader(self, orig):
        def make(*args, **kw):
            self.dataset = self.timed("dataset load", orig, *args, **kw)
            for split in (self.dataset.train_split, self.dataset.dev_split,
                          self.dataset.test_split):
                split.gather = self.gather_timer(split.gather)
            return self.dataset
        return make

    def gather_timer(self, gather):
        """Host time of each batch the CLI gathers, in its loop."""
        def timed_gather(idx):
            t = time.perf_counter()
            out = gather(idx)
            self.times[f"gather, {self.run}"].append(time.perf_counter() - t)
            return out
        return timed_gather

    def build(self, orig):
        def build(cfg, device, tokenizer=None, gnn_mesh=None):
            return self.timed("model and data build", orig, cfg, device,
                              tokenizer=self.tokenizer, gnn_mesh=gnn_mesh)
        return build

    def load_encoder(self, orig):
        def load(*args, **kw):
            cfg, params = self.timed("encoder checkpoint read", orig, *args,
                                     **kw)
            same = sorted(params) == sorted(self.written) and all(
                torch.equal(params[n], t) for n, t in self.written.items())
            if not same:
                FAILURES.append("the loaded encoder is not the written one")
            return cfg, params
        return load

    def step_wrapper(self, kind):
        def wrap(orig):
            def make(model, *args, **kw):
                if kind == "train" and self.check_model:
                    # after the pretrained merge: the model's encoder is the
                    # written checkpoint, bit for bit
                    enc = dict(model.encoder.named_parameters())
                    if not all(torch.equal(enc[n].cpu(), t)
                               for n, t in self.written.items()):
                        FAILURES.append("the model's encoder after the "
                                        "merge is not the written one")
                step = orig(model, *args, **kw)

                def run(*a, **k):
                    self.unpinned += sum(not t.is_pinned() for t in flatten(
                        a[0] if kind == "train" else a[:2]))
                    before = (collections.Counter(_build.LAUNCHES),
                              collections.Counter(_build.ROUTES))
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    out = step(*a, **k)
                    e.record()
                    torch.cuda.synchronize()
                    host = time.perf_counter() - t
                    call = dict(
                        kind=kind, run=self.run, host=host,
                        device=s.elapsed_time(e),
                        launches=collections.Counter(_build.LAUNCHES)
                        - before[0],
                        routes=collections.Counter(_build.ROUTES) - before[1])
                    if kind == "train":
                        call["trainable"] = a[1] if len(a) > 1 else \
                            k.get("encoder_trainable", True)
                        call["loss"] = out["loss"].item()
                    else:
                        call["logits"] = (out[0] if kind == "detail"
                                          else out).float().cpu()
                    self.calls.append(call)
                    return out
                return run
            return make
        return wrap

    def evals(self, run):
        return [c for c in self.calls if c["run"] == run
                and c["kind"] in ("eval", "detail")]

    def save(self, orig):
        def save(path, model, optimizer, generator=None, cfg=None):
            self.timed("checkpoint save", orig, path, model, optimizer,
                       generator, cfg)
            self.ckpt_bytes = sum(p.stat().st_size
                                  for p in pathlib.Path(path).rglob("*"))
            # the dev logits of the epoch saved (dev, then test, before a
            # save), and the optimizer state as saved
            self.saved = dict(
                dev_logits=self.evals(self.run)[-2]["logits"],
                step=int(optimizer.state["step"]),
                opt={k: v.detach().to("cpu", copy=True)
                     for k, v in optimizer.state.items()})
        return save

    def load(self, orig):
        def load(path):
            return self.timed("checkpoint load", orig, path)
        return load

    def restore(self, orig):
        def restore(state, model, optimizer=None, generator=None):
            orig(state, model, optimizer, generator)
            if optimizer is not None:
                same = sorted(optimizer.state) == sorted(self.saved["opt"]) \
                    and all(torch.equal(v.cpu(), self.saved["opt"][k])
                            for k, v in optimizer.state.items())
                self.restored = (same, int(optimizer.state["step"]))
        return restore


def flatten(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in flatten(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in flatten(v)]
    return [getattr(x, f.name) for f in dataclasses.fields(x)]


def gather_parts(split, idx) -> dict:
    """Host seconds of each part of `split.gather(idx)`, done as it does
    them: the statements' rows, the graphs' rows, batch_edge_lists (and
    within it, redone here alone, the per-graph int32 rows and their
    addresses, and the C++ packer's call with its outputs allocated), and
    the copy of the batch's tensors into pinned memory; beside them the
    whole gather, and two things the gather does not do: numpy's stable
    argsort of each graph's sources, and the copy of each graph's (2, E)
    block that the JAX package's packer interface would need."""
    from qagnn_tpu_torch.graph import batching
    st, gr, nc, E = (split.statements, split.graphs, split.n_choices,
                     split.edge_bucket)
    out = {}
    t = time.perf_counter()
    split.gather(idx)
    out["whole gather"] = time.perf_counter() - t
    t = time.perf_counter()
    lm = {k: torch.from_numpy(v[idx]) for k, v in st.inputs.items()}
    labels = torch.from_numpy(st.labels[idx].astype(np.int32))
    out["statement rows"] = time.perf_counter() - t
    t = time.perf_counter()
    flat = (idx[:, None] * nc + np.arange(nc)[None, :]).reshape(-1)
    eis = [gr.edge_indices[i] for i in flat]
    ets = [gr.edge_types[i] for i in flat]
    nodes = (gr.concept_ids[flat], gr.node_types[flat],
             gr.node_scores[flat], gr.num_nodes[flat])
    out["graph rows"] = time.perf_counter() - t
    t = time.perf_counter()
    graph = batching.batch_edge_lists(eis, ets, *nodes, edges_per_graph=E)
    out["batch_edge_lists"] = time.perf_counter() - t
    t = time.perf_counter()
    rows, ptrs = batching.edge_rows(eis, ets)
    out["  of which the rows and their addresses"] = time.perf_counter() - t
    lib = native_build.load_packer()
    lengths = np.array([ei.shape[1] for ei in eis], np.int64)
    t = time.perf_counter()
    packed = [np.empty((len(eis), E), dt)
              for dt in (np.int32, np.int32, np.int32, np.uint8)]
    lib.pack_edges_rows(*(p.ctypes.data for p in ptrs), lengths.ctypes.data,
                        len(eis), E, *(a.ctypes.data for a in packed))
    out["  of which the C++ pack"] = time.perf_counter() - t
    del rows
    t = time.perf_counter()
    [np.argsort(ei[0, :E], kind="stable") for ei in eis]
    out["numpy stable argsort (not on the path)"] = time.perf_counter() - t
    t = time.perf_counter()
    [np.ascontiguousarray(ei, np.int32) for ei in eis]
    out["per-graph (2, E) copies, as the JAX packer's interface needs (not "
        "on the path)"] = time.perf_counter() - t
    tensors = flatten([lm, graph, labels])
    t = time.perf_counter()
    pinned = [x.pin_memory() for x in tensors]
    out[f"pin {len(pinned)} tensors"] = time.perf_counter() - t
    return out


def check_cli_launches(probe, run, k) -> None:
    """Each call of a step launched its kernels the expected number of
    times (rows 6-12 per train step; rows 6, 7 and 11 per eval batch; none
    per detail batch), every routed entry point on its bf16 route
    (BF16_ROUTES)."""
    per_step = step_launches(k)
    want = {"train": per_step,
            "eval": {n: per_step[n] for n in EVAL_LAUNCHES}, "detail": {}}
    for kind, expected in want.items():
        calls = [c for c in probe.calls if c["run"] == run
                 and c["kind"] == kind]
        if not calls:
            continue
        bad = [dict(c["launches"]) for c in calls
               if dict(c["launches"]) != expected]
        off = [dict(c["routes"]) for c in calls
               if any(r != BF16_ROUTES.get(n, 1) for n, r in c["routes"])]
        ok = not bad and not off
        log(f"  launches per {kind} call, {run}: {len(calls)} calls, each "
            + (", ".join(f"{n} {v}" for n, v in expected.items()) or "none")
            + f", routed entry points on their bf16 routes  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"cli launches, {run} {kind}: {bad[:1]} {off[:1]}")


def phase_cli(dev, card):
    from qagnn_tpu_torch import cli

    rng = np.random.default_rng(SEED + 21)
    with tempfile.TemporaryDirectory(prefix="qagnn_cli_") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        emb_path, words = write_cli_dataset(tmp / "data", rng)
        sizes = ", ".join(f"{s} {n}" for s, n in CLI_QUESTIONS.items())
        log(f"  wrote the dataset ({sizes} questions x {C} choices; "
            f"entity table {CLI_ENTITY_ROWS} x "
            f"{CONCEPT_IN} f32) in {time.perf_counter() - t0:.1f} s")
        enc_cfg = TextEncoderConfig.roberta_large()
        with torch.device(dev):
            enc = TextEncoder(enc_cfg)
        init_weights(enc, torch.Generator(device=dev).manual_seed(SEED + 22))
        written = {n: p.detach().cpu() for n, p in enc.named_parameters()}
        del enc
        t0 = time.perf_counter()
        write_hf_roberta(tmp / "roberta-large", written, enc_cfg)
        log(f"  wrote the HF-format roberta-large directory in "
            f"{time.perf_counter() - t0:.1f} s")

        tokenizer = WordTokenizer(["<s>", "<pad>", "</s>", "<unk>"] + words)
        cfg = preset("obqa", encoder_load=str(tmp / "roberta-large"),
                     batch_size=B, mini_batch_size=B, eval_batch_size=B,
                     n_epochs=CLI_EPOCHS, unfreeze_epoch=CLI_UNFREEZE,
                     gnn_dtype="bfloat16", encoder_dtype="float32",
                     save_model=True, save_dir=str(tmp / "out"), seed=SEED,
                     log_interval=1,
                     max_seq_len=L, max_node_num=N)
        for split in CLI_QUESTIONS:
            data = tmp / "data"
            setattr(cfg, f"{split}_statements",
                    str(data / "statement" / f"{split}.statement.jsonl"))
            setattr(cfg, f"{split}_adj",
                    str(data / "graph" / f"{split}.graph.adj.pk"))
        cfg.ent_emb_paths = (emb_path,)

        probe = CliProbe(tokenizer, written)
        printed = {run: Tee(sys.stdout)
                   for run in ("train", "eval_detail", "resume")}
        with probe.patches():
            # the CLI's main path: counts from 0, read just after
            probe.run, probe.check_model = "train", True
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed["train"]):
                result = cli.train(cfg, dev)
            secs = {"train": time.perf_counter() - t0}
            counts, routes = dict(_build.LAUNCHES), dict(_build.ROUTES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            probe.check_model = False
            gc.collect()
            torch.cuda.empty_cache()

            probe.run = "eval_detail"
            cfg_eval = dataclasses.replace(
                cfg, mode="eval_detail", detail_batches=1,
                load_model_path=str(tmp / "out" / "checkpoint"),
                save_dir=str(tmp / "eval"))
            (tmp / "eval").mkdir()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed["eval_detail"]):
                detail = cli.eval_detail(cfg_eval, dev)
            secs["eval_detail"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()

            # one more epoch from the checkpoint (its epoch counter starts
            # at 0 again, so the encoder is frozen, as in the JAX CLI)
            probe.run = "resume"
            cfg_resume = dataclasses.replace(
                cfg, n_epochs=1, save_model=False,
                load_model_path=str(tmp / "out" / "checkpoint"),
                save_dir=str(tmp / "resume"))
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed["resume"]):
                resumed = cli.train(cfg_resume, dev)
            secs["resume"] = time.perf_counter() - t0
            probe.run = "report"
            gc.collect()
            torch.cuda.empty_cache()
        log("  wall time of the CLI's calls: " + ", ".join(
            f"{run} {x:.1f} s" for run, x in secs.items()))
        report_cli(probe, printed, cfg, result, detail, resumed, counts,
                   routes, peak, card)
        t0 = time.perf_counter()
    log(f"  removed the temporary directory in "
        f"{time.perf_counter() - t0:.1f} s")


def report_cli(probe, printed, cfg, result, detail, resumed, counts, routes,
               peak, card):
    k = cfg.k
    steps = [c for c in probe.calls if c["kind"] == "train"]
    train_steps = [c for c in steps if c["run"] == "train"]
    n_steps = CLI_EPOCHS * (CLI_QUESTIONS["train"] // B)
    n_evals = len([c for c in probe.calls if c["run"] == "train"
                   and c["kind"] == "eval"])
    # the whole train run: every kernel of the path, on its bf16 route
    per_step = step_launches(k)
    want = {n: v * n_steps + (v * n_evals if n in EVAL_LAUNCHES else 0)
            for n, v in per_step.items()}
    ok = counts == want and len(train_steps) == n_steps and all(
        routes.get((n, BF16_ROUTES[n]), 0) == counts[n]
        for n in ROUTED if n in counts)
    log(f"  launches over cli.train ({n_steps} steps, {n_evals} eval "
        f"batches): " + ", ".join(f"{n} {counts.get(n, 0)}" for n in want)
        + f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"cli launches: {counts} {routes}")
    for run in ("train", "eval_detail", "resume"):
        check_cli_launches(probe, run, k)

    losses = result["train_losses"] + resumed["train_losses"]
    log("  losses: " + ", ".join(f"{x:.5f}" for x in result["train_losses"])
        + " | resumed: " + ", ".join(f"{x:.5f}" for x in
                                     resumed["train_losses"]))
    if not all(np.isfinite(losses)) or len(resumed["train_losses"]) != \
            CLI_QUESTIONS["train"] // B:
        FAILURES.append("cli losses")
    log(f"  dev/test accuracy: train {result['best_dev_acc']:.4f} / "
        f"{result['final_test_acc']:.4f} (best epoch "
        f"{result['best_dev_epoch']}), eval_detail {detail['dev_acc']:.4f} "
        f"/ {detail['test_acc']:.4f}")

    same, step = probe.restored
    ok = same and step == probe.saved["step"] > 0
    log(f"  resume: optimizer state restored bit for bit: {same}; step "
        f"{step} (saved {probe.saved['step']})  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append("cli resume")
    ok = probe.unpinned == 0
    log(f"  the loader's batches pinned: {ok}  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"cli: {probe.unpinned} unpinned batch tensors")

    # eval_detail's dev logits against those of the epoch it restored
    got = probe.evals("eval_detail")[0]["logits"]
    want_l = probe.saved["dev_logits"]
    tol = LOGIT_TOL[torch.bfloat16]
    compare("eval_detail dev logits vs the trained model's", got, want_l,
            tol)
    top2 = want_l.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol * want_l.abs().max()
    agree = (got.argmax(1) == want_l.argmax(1))[clear]
    log(f"  eval_detail argmax agrees on {int(agree.sum())} of "
        f"{int(clear.sum())} questions whose top two logits differ by more "
        f"than the tolerance ({len(want_l)} in all)")
    if not bool(agree.all()):
        FAILURES.append("eval_detail predictions")

    # the CLI's own log line, one a step (log_interval 1): the wall time
    # since the previous line, so the first step of an epoch also holds the
    # previous epoch's evaluation and checkpoint save
    per_epoch = CLI_QUESTIONS["train"] // B
    for run in ("train", "resume"):
        lines = [x for x in "".join(printed[run].text).splitlines()
                 if "ms/batch" in x]
        for i, x in enumerate(lines):
            epoch = i // per_epoch
            state = "frozen" if epoch < CLI_UNFREEZE else "trained"
            log(f"  cli {run}, epoch {epoch} (encoder {state}): "
                f"{x.strip()}  [{card}]")

    def med(xs):
        return statistics.median(xs) if xs else float("nan")
    for trainable in (False, True):
        sel = [c for c in train_steps if c["trainable"] == trainable][1:]
        log(f"  cli train step, encoder "
            f"{'trained' if trainable else 'frozen'} (median of "
            f"{len(sel)}, first of each kind left out): host "
            f"{med([c['host'] * 1e3 for c in sel]):.3f} ms, device span "
            f"{med([c['device'] for c in sel]):.3f} ms  [{card}]")

    for run in ("train", "resume"):
        xs = probe.times[f"gather, {run}"]
        log(f"  gathers in the CLI's loop, {run}: " + ", ".join(
            f"{x * 1e3:.1f}" for x in xs) + " ms (each epoch's train "
            f"batches, then its dev and test batches)  [{card}]")
    ds = probe.dataset
    idx = np.arange(B)
    gathers, copies = [], []
    for _ in range(6):
        t = time.perf_counter()
        batch = ds.train_split.gather(idx)
        gathers.append(time.perf_counter() - t)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        moved = [t.to(DEVICE, non_blocking=True)
                 for t in flatten([batch.lm_inputs, batch.graph,
                                   batch.labels])]
        e.record()
        torch.cuda.synchronize()
        copies.append(s.elapsed_time(e))
        del moved
    h2d_bytes = sum(t.numel() * t.element_size() for t in flatten(
        [batch.lm_inputs, batch.graph, batch.labels]))
    log(f"  host gather of a batch ({G} graphs, "
        f"E={ds.train_split.edge_bucket}): {med(gathers[1:]) * 1e3:.3f} ms "
        f"(median of 5); H2D copy of its {h2d_bytes / 1e6:.3f} MB, pinned: "
        f"{med(copies[1:]):.4f} ms (CUDA events, median of 5)  [{card}]")
    parts = collections.defaultdict(list)
    for i in range(6):
        for part, x in gather_parts(ds.train_split, idx).items():
            if i:
                parts[part].append(x)
    log(f"  parts of the host gather of that batch (median of 5): " + "; ".join(
        f"{part.strip()} {med(xs) * 1e3:.3f} ms"
        for part, xs in parts.items()) + f"  [{card}]")

    def secs(what):
        return ", ".join(f"{x:.3f}" for x in probe.times[what]) + " s"
    log(f"  dataset load {secs('dataset load')}; model and data build "
        f"{secs('model and data build')}; encoder checkpoint read "
        f"{secs('encoder checkpoint read')}  [{card}]")
    log(f"  checkpoint {probe.ckpt_bytes / 2**30:.3f} GiB: save "
        f"{secs('checkpoint save')}, load {secs('checkpoint load')}  "
        f"[{card}]")
    for run in ("train", "eval_detail"):
        for kind in ("eval", "detail"):
            sel = [c for c in probe.calls if c["run"] == run
                   and c["kind"] == kind]
            if sel:
                log(f"  {run} {kind} batches: " + ", ".join(
                    f"{c['host'] * 1e3:.3f}" for c in sel) + " ms each "
                    f"(host, synchronised)  [{card}]")
    log(f"  peak device memory over cli.train {peak:.2f} GiB")


# ---------------------------------------------------------------------------
# the on-card training check: cli.train overfits 4 questions
# ---------------------------------------------------------------------------

OVERFIT_EPOCHS = 150


def softmax_shift_record(kept) -> list[tuple[float, int, int]]:
    """ROADMAP C7's measurement: for each of the GAT layers' forwards in
    `kept` (gat_projected_forward's inputs and results), the largest gap
    between a graph's max score and a source's own max (its self loop's
    and its live edges' scores), per head, and how many (source, head)
    denominators lie under DENOM_EPS, which the kernels then leave
    unnormalised, out of how many."""
    rows = []
    for (nq, nk, skb, src, mask), (_, scores, gmax, denom_raw, _, _) in kept:
        G_, H_, E_ = scores.shape
        edge = torch.where(mask[..., None], scores.transpose(1, 2),
                           -math.inf)
        m_src = gk.head_sum(nq.float() * (nk + skb).float(), H_)
        m_src = m_src.scatter_reduce(
            1, src.long()[..., None].expand(G_, E_, H_), edge, "amax")
        rows.append(((gmax[:, None, :] - m_src).max().item(),
                     int((denom_raw < gk.DENOM_EPS).sum()),
                     denom_raw.numel()))
    return rows


def phase_overfit(dev, card) -> None:
    """cli.train at the production GNN widths (k=5, gnn_dim 200, 200-node
    graphs, 38 relations, bf16 GNN; RAdam, the encoder trained from epoch
    0, dropout 0) on the 4-question synthetic set whose dev split is its
    train split, with a 4-layer, 256-wide BERT read through
    --encoder_load: the best dev accuracy must reach 1.0, the last loss
    fall under half the first, and eval_detail from the saved checkpoint
    score dev 1.0. The counterpart of the JAX package's on-chip check,
    tests_tpu/test_production_train.py."""
    from qagnn_tpu_torch import cli
    from qagnn_tpu_torch.data.synthetic import (
        write_synthetic_dataset,
        write_tiny_bert_checkpoint,
    )
    from qagnn_tpu_torch.utils.config import TrainConfig

    with tempfile.TemporaryDirectory(prefix="qagnn_overfit_") as tmp:
        t0 = time.perf_counter()
        emb_path = write_synthetic_dataset(f"{tmp}/data", n_questions=4,
                                           dev_equals_train=True)
        enc_dir = write_tiny_bert_checkpoint(
            f"{tmp}/bert", hidden_size=256, num_layers=4, num_heads=4)
        log(f"  wrote the synthetic set and the BERT checkpoint in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = TrainConfig(
            dataset="csqa", encoder="bert-base-uncased", encoder_load=enc_dir,
            encoder_dtype="bfloat16", inhouse=False,
            save_dir=f"{tmp}/out", save_model=True, detail_batches=0,
            batch_size=4, mini_batch_size=4, eval_batch_size=4,
            n_epochs=OVERFIT_EPOCHS, max_epochs_before_stop=1000,
            max_seq_len=24, max_node_num=200, num_relation=38, k=5,
            gnn_dim=200, fc_dim=200, att_head_num=2, gnn_dtype="bfloat16",
            dropouti=0.0, dropoutg=0.0, dropoutf=0.0, unfreeze_epoch=0,
            log_interval=50, decoder_lr=3e-3, encoder_lr=1e-4).resolved()
        for split in ("train", "dev", "test"):
            setattr(cfg, f"{split}_statements",
                    f"{tmp}/data/statement/{split}.statement.jsonl")
            setattr(cfg, f"{split}_adj",
                    f"{tmp}/data/graph/{split}.graph.adj.pk")
        cfg.ent_emb_paths = (emb_path,)

        printed = io.StringIO()
        _build.reset_launch_counts()
        # the last k forwards of the GAT layers (the final test evaluation,
        # on the trained weights) kept for the softmax shift's record
        kept = collections.deque(maxlen=cfg.k)
        forward = gk.gat_projected_forward

        def keep(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb, src,
                 dst, mask, heads):
            res = forward(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb,
                          smb, src, dst, mask, heads)
            kept.append(((nq.detach(), nk.detach(), skb.detach(), src,
                          mask), tuple(x.detach() for x in res)))
            return res
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), \
                mock.patch.object(gk, "gat_projected_forward", keep):
            result = cli.train(cfg, dev)
        secs = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        cfg_eval = dataclasses.replace(
            cfg, mode="eval_detail", save_dir=f"{tmp}/eval",
            load_model_path=f"{tmp}/out/checkpoint")
        pathlib.Path(cfg_eval.save_dir).mkdir()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            detail = cli.eval_detail(cfg_eval, dev)
        secs_eval = time.perf_counter() - t0

    losses = result["train_losses"]
    accs = [float(m) for m in re.findall(
        r"\| epoch\s+\d+ \| dev_acc\s+([0-9.]+)", printed.getvalue())]
    first = next((i for i, a in enumerate(accs) if a == 1.0), None)
    log(f"  cli.train: {len(accs)} epochs of one step each in {secs:.1f} s "
        f"({secs / max(len(accs), 1) * 1e3:.1f} ms an epoch with its dev and "
        f"test evaluation and checkpoint)  [{card}]")
    log(f"  dev accuracy by epoch: first 1.0 at epoch {first}; "
        + " ".join(f"{a:.2f}" for a in accs[::10]) + " (every 10th)")
    log("  losses: " + " ".join(f"{x:.3g}" for x in losses[::10])
        + f" (every 10th), last {losses[-1]:.3g}")
    log(f"  launches over cli.train: " + ", ".join(
        f"{n} {counts.get(n, 0)}" for n in step_launches(cfg.k)))
    for i, (gap, under, total) in enumerate(softmax_shift_record(kept)):
        log(f"  softmax shift after training, layer {i}: largest graph max "
            f"- source max {gap:.4g}; {under} of {total} (source, head) "
            f"denominators under DENOM_EPS = {gk.DENOM_EPS:g}")
    checks = {
        "best_dev_acc == 1.0": result["best_dev_acc"] == 1.0,
        "last loss < half the first": losses[-1] < 0.5 * losses[0],
        "eval_detail dev_acc == 1.0": detail["dev_acc"] == 1.0,
        "every kernel of the train step launched": all(
            counts.get(n, 0) > 0 for n in step_launches(cfg.k)),
    }
    log(f"  best_dev_acc {result['best_dev_acc']:.4f} (epoch "
        f"{result['best_dev_epoch']}); loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; eval_detail from the checkpoint: dev_acc "
        f"{detail['dev_acc']:.4f}, test_acc {detail['test_acc']:.4f} in "
        f"{secs_eval:.1f} s  " + ", ".join(
            f"{what} {'ok' if ok else 'FAIL'}" for what, ok in checks.items()))
    for what, ok in checks.items():
        if not ok:
            FAILURES.append(f"overfit: {what}")


# ---------------------------------------------------------------------------
# the encoder families: ALBERT, GPT, XLNet and the LSTM under the OBQA
# decoder, served, trained and driven through the CLI
# ---------------------------------------------------------------------------

# (family, name the CLI takes): each at its published width
ENCODER_FAMILIES = (("albert", "albert-xxlarge-v2"), ("gpt", "openai-gpt"),
                    ("xlnet", "xlnet-large-cased"), ("lstm", "lstm"))
# forwards served (the first warms up), trained steps and frozen steps on
# a fixed batch (the first of each warms up): albert-xxlarge's step takes
# seconds, so it runs the fewest
ENCODER_DEPTH = {"albert": (3, 3, 2), "gpt": (5, 4, 2), "xlnet": (4, 4, 2),
                 "lstm": (5, 4, 2)}
# encoder on the card vs the same module on the CPU, f32 with TF32 off:
# max|d| <= 1e-4 * max|want| on the rows the CPU computes (the CPU pass of
# albert-xxlarge is about 0.5 TFLOP a row)
ENCODER_CPU_TOL = 1e-4
ENCODER_CPU_ROWS = (0, G - 1)
# the CLI runs of this phase: one batch a split, and an entity table of
# 100,000 of ConceptNet's 799,273 rows at its width of 1024 (the rows are
# cut to keep 8 model builds and checkpoints within the phase's time; the
# cli phase drives the whole table through the CLI)
ENC_CLI_QUESTIONS = {"train": B, "dev": B, "test": B}
ENC_CLI_ENTITY_ROWS = 100_000
GPT_BPE_VOCAB = 40478       # openai-gpt's table before the 3 special tokens


def encoder_preset(family, vocab_path):
    """The encoder config of `family` as the CLI resolves its name."""
    from qagnn_tpu_torch import cli
    name = dict(ENCODER_FAMILIES)[family]
    cfg = preset("obqa", encoder=name, lstm_vocab=vocab_path)
    enc_cfg = cli.encoder_config_for(cfg)
    if family == "gpt":       # the stock table, grown again when it loads
        enc_cfg = dataclasses.replace(enc_cfg, vocab_size=GPT_BPE_VOCAB)
    return enc_cfg


def hf_names(family, n_layers) -> dict[str, tuple[str, bool]]:
    """Encoder parameter name -> (HF state-dict key, stored transposed):
    the inverse of the port's `convert_hf_*_params`, kept here so that the
    checkpoints this phase writes do not come from the code it tests. GPT's
    Conv1D keeps its weights as (in, out)."""
    names = {}
    if family == "albert":
        for t in ("word_embeddings", "position_embeddings",
                  "token_type_embeddings"):
            names[f"{t}.weight"] = (f"embeddings.{t}.weight", False)
        g = "encoder.albert_layer_groups.0.albert_layers.0"
        pairs = [("embeddings_ln", "embeddings.LayerNorm"),
                 ("embedding_projection",
                  "encoder.embedding_hidden_mapping_in"),
                 ("layer_shared.attention.out", f"{g}.attention.dense"),
                 ("layer_shared.attention_ln", f"{g}.attention.LayerNorm"),
                 ("layer_shared.intermediate", f"{g}.ffn"),
                 ("layer_shared.output", f"{g}.ffn_output"),
                 ("layer_shared.output_ln", f"{g}.full_layer_layer_norm")]
        pairs += [(f"layer_shared.attention.{n}", f"{g}.attention.{n}")
                  for n in ("query", "key", "value")]
        for p, h in pairs:
            for a in ("weight", "bias"):
                names[f"{p}.{a}"] = (f"{h}.{a}", False)
    elif family == "gpt":
        for t in ("tokens_embed", "positions_embed"):
            names[f"{t}.weight"] = (f"{t}.weight", False)
        for i in range(n_layers):
            for p, h, conv in (("c_attn", "attn.c_attn", True),
                               ("c_proj", "attn.c_proj", True),
                               ("ln_1", "ln_1", False),
                               ("mlp_fc", "mlp.c_fc", True),
                               ("mlp_proj", "mlp.c_proj", True),
                               ("ln_2", "ln_2", False)):
                names[f"block_{i}.{p}.weight"] = (f"h.{i}.{h}.weight", conv)
                names[f"block_{i}.{p}.bias"] = (f"h.{i}.{h}.bias", False)
    else:
        names["word_embedding.weight"] = ("word_embedding.weight", False)
        for i in range(n_layers):
            for n in ("q", "k", "v", "o", "r", "r_r_bias", "r_s_bias",
                      "r_w_bias", "seg_embed"):
                names[f"layer_{i}.rel_attn.{n}"] = (
                    f"layer.{i}.rel_attn.{n}", False)
            for p, h in (("rel_attn.layer_norm", "rel_attn.layer_norm"),
                         ("ff_layer_1", "ff.layer_1"),
                         ("ff_layer_2", "ff.layer_2"),
                         ("ff_layer_norm", "ff.layer_norm")):
                for a in ("weight", "bias"):
                    names[f"layer_{i}.{p}.{a}"] = (f"layer.{i}.{h}.{a}",
                                                   False)
    return names


def hf_config(family, c) -> dict:
    """config.json of the published checkpoint the family stands for
    (albert-xxlarge-v2, openai-gpt, xlnet-large-cased), at `c`'s shapes."""
    if family == "albert":
        return {"model_type": "albert", "architectures": ["AlbertModel"],
                "vocab_size": c.vocab_size, "embedding_size": c.embedding_size,
                "hidden_size": c.hidden_size,
                "num_hidden_layers": c.num_layers, "num_hidden_groups": 1,
                "num_attention_heads": c.num_heads,
                "intermediate_size": c.intermediate_size,
                "inner_group_num": 1, "hidden_act": "gelu_new",
                "hidden_dropout_prob": 0.0,
                "attention_probs_dropout_prob": 0.0,
                "max_position_embeddings": c.max_position_embeddings,
                "type_vocab_size": c.type_vocab_size,
                "initializer_range": 0.02, "layer_norm_eps": 1e-12,
                "pad_token_id": 0, "bos_token_id": 2, "eos_token_id": 3}
    if family == "gpt":
        return {"model_type": "openai-gpt",
                "architectures": ["OpenAIGPTModel"],
                "vocab_size": c.vocab_size, "n_positions": c.n_positions,
                "n_embd": c.hidden_size, "n_layer": c.num_layers,
                "n_head": c.num_heads, "afn": "gelu",
                "resid_pdrop": c.resid_dropout, "embd_pdrop": c.embd_dropout,
                "attn_pdrop": c.attn_dropout, "layer_norm_epsilon": 1e-5,
                "initializer_range": 0.02}
    return {"model_type": "xlnet", "architectures": ["XLNetLMHeadModel"],
            "vocab_size": c.vocab_size, "d_model": c.hidden_size,
            "n_layer": c.num_layers, "n_head": c.num_heads,
            "d_head": c.d_head, "d_inner": c.d_inner,
            "ff_activation": "gelu", "untie_r": True, "attn_type": "bi",
            "initializer_range": 0.02, "layer_norm_eps": 1e-12,
            "dropout": c.dropout, "mem_len": None, "reuse_len": None,
            "bi_data": False, "clamp_len": -1, "same_length": False,
            "pad_token_id": 5, "bos_token_id": 1, "eos_token_id": 2}


def write_hf_encoder(out: pathlib.Path, family, params, enc_cfg) -> None:
    """An HF save_pretrained-style directory: config.json and
    pytorch_model.bin under the HF model's key names, with the weights HF
    keeps that the encoder does not read (ALBERT's pooler, XLNet's
    mask_emb)."""
    names = hf_names(family, enc_cfg.num_layers)
    if set(names) != set(params):
        FAILURES.append(f"{family}: the HF name map does not cover the "
                        f"encoder: {sorted(set(names) ^ set(params))[:5]}")
    sd = {names[n][0]: (t.T.contiguous() if names[n][1] else t)
          for n, t in params.items()}
    if family == "albert":
        d = enc_cfg.hidden_size
        sd["pooler.weight"], sd["pooler.bias"] = torch.zeros(d, d), \
            torch.zeros(d)
    if family == "xlnet":
        sd["mask_emb"] = torch.zeros(1, 1, enc_cfg.hidden_size)
    out.mkdir(parents=True)
    torch.save(sd, out / "pytorch_model.bin")
    with open(out / "config.json", "w") as f:
        json.dump(hf_config(family, enc_cfg), f)


def family_lm_inputs(family, dev, lm):
    """`family`'s statement-layout inputs from make_batch's roberta-style
    ones (right-padded ids, lengths from L/3 to L): ALBERT's pairs padded
    with id 0; GPT's ids with the classification token's position and the
    lm labels; XLNet's left-padded pairs with the CLS at the end, segment
    ids 0, 1, 2 and 4 at the padding; the LSTM's ids and lengths."""
    ids, attn = lm["input_ids"], lm["attention_mask"]
    lengths = attn.sum(-1, dtype=torch.int32)
    if family == "lstm":
        return {"input_ids": torch.where(attn > 0, ids, 0),
                "lengths": lengths}
    if family == "gpt":
        return {"input_ids": torch.where(attn > 0, ids, 0),
                "cls_token_ids": lengths - 1,
                "lm_labels": torch.where(attn > 0, ids, -1)}
    pos = torch.arange(L, device=dev)
    if family == "xlnet":
        real = pos >= (L - lengths)[..., None]
        types = torch.where(pos < L - lengths[..., None] // 2, 0, 1)
        types[..., -1] = 2
        return {"input_ids": torch.where(real, ids.flip(-1), 0),
                "attention_mask": real.to(torch.int32),
                "token_type_ids": torch.where(real, types, 4)
                .to(torch.int32),
                "special_tokens_mask": (~real).to(torch.int32)}
    return {"input_ids": torch.where(attn > 0, ids, 0),
            "attention_mask": attn,
            "token_type_ids": torch.zeros_like(ids)}


def encoder_card_vs_cpu(family, model, lm) -> None:
    """The encoder on the card (f32, TF32 off) against the same module on
    CPU copies of the same weights, on ENCODER_CPU_ROWS of one batch."""
    flat = {k: v.reshape((G,) + tuple(v.shape[2:])) for k, v in lm.items()}
    rows = list(ENCODER_CPU_ROWS)
    enc = model.encoder.eval()
    with torch.inference_mode():
        got = enc(**flat)
    cpu = copy.deepcopy(enc).to("cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = cpu(**{k: v[rows].cpu() for k, v in flat.items()})
    secs = time.perf_counter() - t0
    del cpu
    compare(f"{family} encoder, card vs CPU (f32, rows {rows}; CPU "
            f"{secs:.1f} s)", got[rows].cpu(), want, ENCODER_CPU_TOL)


def serve_family(family, dev, card, cfg, model, batches, n_forwards) -> None:
    """Requests through make_eval_step: kernel launches per forward (rows
    6, 7 and 11, bf16 route), logits against the scatter path, the request
    time and the encoder's and decoder's device spans."""
    step = make_eval_step(model)
    gnn = model.decoder.gnn
    spans, handles = device_spans({"encoder": model.encoder,
                                   "decoder": model.decoder})
    _build.reset_launch_counts()
    times, logits = [], None
    for i in range(n_forwards):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(*batches[i % len(batches)])
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t)
        if logits is None:
            logits = out.clone()
    counts = dict(_build.LAUNCHES)
    for h in handles:
        h.remove()
    per_forward = {"edge_hidden": 1, "gat_pass_a_scores": cfg.k,
                   "gat_pass_a_denoms": cfg.k, "gat_pass_c": cfg.k}
    ok = counts == {n: v * n_forwards for n, v in per_forward.items()}
    log(f"  {family} launches over {n_forwards} served forwards: "
        + ", ".join(f"{n} {counts.get(n, 0)}" for n in per_forward)
        + f" (per forward: 1, k, k, k)  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{family} serve launches: {counts}")
    check_routes(BF16_ROUTES, f"{family} served forwards, bf16 GNN")
    if logits.shape != (B, C) or not bool(torch.isfinite(logits).all()):
        FAILURES.append(f"{family} logits: {tuple(logits.shape)}")
    gnn.backend = "scatter"
    want = step(*batches[0])
    gnn.backend = None
    compare(f"{family} logits cuda vs scatter, bf16 GNN", logits, want,
            LOGIT_TOL[torch.bfloat16])
    span_ms = {name: statistics.median(s.elapsed_time(e) for s, e in evs[1:])
               for name, evs in spans.items()}
    med = statistics.median(times)
    log(f"  {family} serving: {med * 1e3:.3f} ms per request of {B} "
        f"questions x {C} choices (median of {len(times)}; min "
        f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}); device spans "
        f"(median): encoder {span_ms['encoder']:.3f} ms, decoder "
        f"{span_ms['decoder']:.3f} ms  [{card}]")


def train_family(family, dev, card, cfg, model, batch, n_trained,
                 n_frozen) -> None:
    """Steps through make_train_step on a fixed batch with the preset's
    dropout, the masks drawn from one seed at every step: trained (loss
    finite and falling), then frozen (the encoder left as it is); the
    kernels' launches per step (rows 6-12, bf16 route), the step time and
    the peak memory."""
    opt = build_train_optimizer(model, frozen=entity_table_names(model),
                                **OPT)
    step = make_train_step(model, opt)
    generator = torch.Generator(device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    enc_param = next(model.encoder.parameters())
    for trainable, n in ((True, n_trained), (False, n_frozen)):
        what = "trained" if trainable else "frozen"
        before = enc_param.detach().clone()
        _build.reset_launch_counts()
        losses, times = [], []
        for i in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            generator.manual_seed(SEED + 3)
            out = step(batch, encoder_trainable=trainable,
                       generator=generator)
            losses.append(out["loss"].item())
            if i:
                times.append(time.perf_counter() - t)
        check_launches(dict(_build.LAUNCHES), n, 1, cfg.k,
                       f"{family}, encoder {what}")
        check_routes(BF16_ROUTES, f"{family} steps, encoder {what}")
        moved = not torch.equal(enc_param, before)
        ok = all(math.isfinite(x) for x in losses) and moved == trainable \
            and (not trainable or losses[-1] < losses[0])
        log(f"  {family} steps, encoder {what}: losses "
            + ", ".join(f"{x:.5f}" for x in losses)
            + f"; {statistics.median(times) * 1e3:.3f} ms per step (median "
            f"of {len(times)}; min {min(times) * 1e3:.3f}); encoder moved: "
            f"{moved}  [{card}]  {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"{family} training, encoder {what}: {losses}")
    log(f"  {family} peak device memory over the steps "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
    del opt, step


def cli_family(family, dev, card, tmp, data, emb_path, enc_dir, vocab_path,
               tokenizer, expected) -> None:
    """cli.train (one frozen epoch, one trained, checkpointed) and
    eval_detail from its checkpoint on the dataset at `data`: launches per
    call (rows 6-12 a train step, 6, 7 and 11 an eval batch, none a detail
    batch), the encoder as loaded, finite losses, eval_detail's dev logits
    against the trained model's, and the per-step times."""
    from qagnn_tpu_torch import cli
    name = dict(ENCODER_FAMILIES)[family]
    out = tmp / f"out-{family}"
    cfg = preset("obqa", encoder=name, encoder_load=enc_dir,
                 lstm_vocab=vocab_path, batch_size=B, mini_batch_size=B,
                 eval_batch_size=B, n_epochs=CLI_EPOCHS,
                 unfreeze_epoch=CLI_UNFREEZE, gnn_dtype="bfloat16",
                 encoder_dtype="float32", save_model=True,
                 save_dir=str(out), seed=SEED, log_interval=1,
                 max_seq_len=L, max_node_num=N)
    for split in ENC_CLI_QUESTIONS:
        setattr(cfg, f"{split}_statements",
                str(data / "statement" / f"{split}.statement.jsonl"))
        setattr(cfg, f"{split}_adj", str(data / "graph" /
                                         f"{split}.graph.adj.pk"))
    cfg.ent_emb_paths = (emb_path,)
    probe = CliProbe(tokenizer, expected)
    printed = io.StringIO()
    with probe.patches():
        probe.run, probe.check_model = "train", True
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            result = cli.train(cfg, dev)
        secs = {"train": time.perf_counter() - t0}
        probe.check_model = False
        gc.collect()
        torch.cuda.empty_cache()
        probe.run = "eval_detail"
        cfg_eval = dataclasses.replace(
            cfg, mode="eval_detail", detail_batches=1,
            load_model_path=str(out / "checkpoint"),
            save_dir=str(tmp / f"eval-{family}"))
        pathlib.Path(cfg_eval.save_dir).mkdir()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            detail = cli.eval_detail(cfg_eval, dev)
        secs["eval_detail"] = time.perf_counter() - t0
        probe.run = "report"
    gc.collect()
    torch.cuda.empty_cache()
    for run in ("train", "eval_detail"):
        check_cli_launches(probe, run, cfg.k)
    losses = result["train_losses"]
    n_steps = CLI_EPOCHS * (ENC_CLI_QUESTIONS["train"] // B)
    if len(losses) != n_steps or not all(map(math.isfinite, losses)):
        FAILURES.append(f"{family} cli losses: {losses}")
    compare(f"{family} eval_detail dev logits vs the trained model's",
            probe.evals("eval_detail")[0]["logits"],
            probe.saved["dev_logits"], LOGIT_TOL[torch.bfloat16])
    steps = [c for c in probe.calls if c["kind"] == "train"]
    log(f"  {family} cli.train: losses "
        + ", ".join(f"{x:.5f}" for x in losses) + "; steps (host, device "
        "span): " + ", ".join(
            f"{'trained' if c['trainable'] else 'frozen'} "
            f"{c['host'] * 1e3:.1f} / {c['device']:.1f} ms" for c in steps)
        + f"; dev/test {result['best_dev_acc']:.4f} / "
        f"{result['final_test_acc']:.4f}; eval_detail {detail['dev_acc']:.4f}"
        f" / {detail['test_acc']:.4f}; checkpoint "
        f"{probe.ckpt_bytes / 2**30:.3f} GiB; wall "
        + ", ".join(f"{r} {x:.1f} s" for r, x in secs.items()) + f"  [{card}]")


def phase_encoders(dev, card) -> None:
    """For each of ALBERT (albert-xxlarge-v2), GPT (openai-gpt), XLNet
    (xlnet-large-cased) and the LSTM (300 wide, 2 bidirectional layers) at
    its published width, under the OBQA GNN preset (k=5, gnn_dim 200, bf16
    GNN, G=64, N=200, E=4096, L=100, the 799,273 x 1024 entity table):
    random weights from a seed written as an HF-format directory and read
    back through load_encoder_checkpoint (the LSTM's vocabulary written by
    make_word_vocab); the encoder on the card against the CPU; requests
    through make_eval_step; steps through make_train_step, trained then
    frozen; and the CLI, train and eval_detail."""
    from qagnn_tpu_torch.data.word_tokenizer import make_word_vocab
    from qagnn_tpu_torch.models.hf_loading import load_encoder_checkpoint
    from qagnn_tpu_torch.train.step import _merge_pretrained

    cfg = preset("obqa")
    with tempfile.TemporaryDirectory(prefix="qagnn_encoders_") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        data = tmp / "data"
        emb_path, words = write_cli_dataset(
            data, np.random.default_rng(SEED + 41), ENC_CLI_QUESTIONS,
            ENC_CLI_ENTITY_ROWS)
        vocab_path = str(tmp / "words.json")
        make_word_vocab([str(data / "statement" / f"{s}.statement.jsonl")
                         for s in ENC_CLI_QUESTIONS], vocab_path,
                        freq_cutoff=1)
        log(f"  wrote the CLI dataset ({B} questions x {C} choices a split, "
            f"entity table {ENC_CLI_ENTITY_ROWS} x {CONCEPT_IN}) and the "
            f"LSTM's vocabulary in {time.perf_counter() - t0:.1f} s")
        for i, (family, name) in enumerate(ENCODER_FAMILIES):
            gen = torch.Generator(device=dev).manual_seed(SEED + 42 + i)
            enc_cfg = encoder_preset(family, vocab_path)
            log(f"\n  [{family}: {name}, hidden {enc_cfg.hidden_size}, "
                f"{enc_cfg.num_layers} layers]")
            with torch.device(dev):
                enc = make_encoder(enc_cfg)
            init_weights(enc, gen)
            written = {n: p.detach().cpu() for n, p in enc.named_parameters()}
            del enc
            enc_dir, expected, secs = None, {}, {}
            if family != "lstm":
                enc_dir = str(tmp / name)
                t0 = time.perf_counter()
                write_hf_encoder(tmp / name, family, written, enc_cfg)
                secs["written"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                enc_cfg, expected = load_encoder_checkpoint(enc_dir)
                secs["read back"] = time.perf_counter() - t0
                check_loaded(family, written, expected, enc_cfg)
            log(f"  {family}: {sum(t.numel() for t in written.values()):,} "
                "encoder parameters" + "".join(
                    f", {what} in {x:.1f} s" for what, x in secs.items()))
            del written
            model, _ = build_model(cfg, dev, gen, enc_cfg)
            _merge_pretrained(model, {"encoder." + n: t
                                      for n, t in expected.items()})
            batches = [make_batch(gen, dev, enc_cfg.vocab_size,
                                  cfg.num_relation,
                                  empty_graph=G - 1 if j == 0 else None)
                       for j in range(2)]
            batches = [(family_lm_inputs(family, dev, lm), graph)
                       for lm, graph in batches]
            n_fwd, n_trained, n_frozen = ENCODER_DEPTH[family]
            encoder_card_vs_cpu(family, model, batches[0][0])
            serve_family(family, dev, card, cfg, model, batches, n_fwd)
            train_family(family, dev, card, cfg, model,
                         Batch(*batches[1], torch.randint(
                             0, C, (B,), generator=gen, device=dev)),
                         n_trained, n_frozen)
            del model, batches
            gc.collect()
            torch.cuda.empty_cache()
            tokenizer = None if family == "lstm" else WordTokenizer(
                ["<pad>", "<s>", "</s>", "<unk>"] + words)
            cli_family(family, dev, card, tmp, data, emb_path, enc_dir,
                       vocab_path, tokenizer, expected)


def check_loaded(family, written, loaded, enc_cfg) -> None:
    """The encoder load_encoder_checkpoint read is the one written, bit for
    bit; openai-gpt's table has grown by the three rows of the special
    tokens, normal(0, 0.02) from np.random.default_rng(0)."""
    want = dict(written)
    if family == "gpt":
        table = written["tokens_embed.weight"]
        extra = np.random.default_rng(0).normal(0.0, 0.02,
                                                (3, table.shape[1]))
        want["tokens_embed.weight"] = torch.cat(
            [table, torch.from_numpy(extra).to(table.dtype)])
    same = sorted(loaded) == sorted(want) and all(
        torch.equal(loaded[n], t) for n, t in want.items())
    vocab_ok = family != "gpt" or enc_cfg.vocab_size == GPT_BPE_VOCAB + 3
    log(f"  {family}: the encoder read back is the one written"
        + (", its table grown by 3 rows" if family == "gpt" else "")
        + f": {same and vocab_ok}  {'ok' if same and vocab_ok else 'FAIL'}")
    if not (same and vocab_ok):
        FAILURES.append(f"{family}: the loaded encoder")


# ---------------------------------------------------------------------------
# the grid of ranks (qagnn_tpu_torch/parallel): the sharded ops on E/P edge
# slices, and cli.train on a 2 x 2 grid, every rank on this one card
# ---------------------------------------------------------------------------

MESH_P = (2, 4)            # ranks of the op-level grids (1 x P)
# the sharded ops against the unsharded ones on the card, max|got - want| <=
# tol * max|want|: the slices' partial sums meet in the collectives in
# another order than one kernel sums them; in bf16 the values stored after
# the sums (node cotangents, d_edge_emb, h) may round the other way at one
# ulp (2^-8 relative)
MESH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
MESH_CLI_QUESTIONS = {"train": 32, "dev": 16, "test": 16}
MESH_CLI_GRID = (2, 2)
# the 2 x 2 run against the same command at 1 x 1 (the GNN computes in
# bf16, and the slices' partial sums are rounded at other points than the
# one-card run's), each limit about 10x the largest of three readings
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the per-step losses, relative,
# at the CPU test's rtol (readings at most 1.89e-5); the grid's dev logits
# against a one-card eval_detail of its checkpoint, relative to the
# largest (readings at most 3.27e-4)
MESH_CLI_TOL = 2e-4
MESH_EVAL_TOL = 3e-3
# the change of the trained parameters over the run, the grid's against
# the one-card run's, |d_grid - d_one| / |d_one| over each part of the
# model (`update_gaps`; the entity table is frozen): about 3x the reading
# (the GNN's 8.62e-3; the encoder 1.38e-4, the rest 1.25e-3). The bf16
# GNN's rounding sets that floor: a fault that moves a part's change by
# less, as BatchNorm's sum_over backward done as the identity can, is held
# by tests/test_torch_parallel.py in f32.
MESH_UPDATE_TOL = 3e-2
# the sharded path's entry points: the wrapper each kernel row launches
# through, and the module it is called from
MESH_OPS = {
    "projected": [(gk, n) for n in ("pass_a_scores", "pass_a_denoms",
                                    "pass_c", "bwd_pass1", "bwd_pass2")],
    "unprojected": [(uk, n) for n in ("edge_scores", "edge_denoms",
                                      "aggregate", "bwd1", "bwd2")],
    "encoder": [(ek, n) for n in ("edge_feature_moments",
                                  "edge_hidden_forward",
                                  "edge_hidden_backward")]}
KERNEL_OF = {"pass_a_scores": "gat_pass_a_scores",
             "pass_a_denoms": "gat_pass_a_denoms", "pass_c": "gat_pass_c",
             "bwd_pass1": "gat_bwd_pass1", "bwd_pass2": "gat_bwd_pass2",
             "edge_scores": "gat_unproj_scores",
             "edge_denoms": "gat_unproj_denoms",
             "aggregate": "gat_unproj_aggr", "bwd1": "gat_unproj_bwd1",
             "bwd2": "gat_unproj_bwd2",
             "edge_feature_moments": "edge_moments",
             "edge_hidden_forward": "edge_hidden",
             "edge_hidden_backward": "edge_hidden_bwd"}


class Spy:
    """Wraps the sharded path's entry points: records the edge slots each
    call saw (its first (G, E) int32 or bool argument) and its arguments,
    so that each can be timed alone afterwards."""

    def __init__(self, n_graphs):
        self.n_graphs, self.slots, self.calls = n_graphs, {}, {}
        self.stack = contextlib.ExitStack()

    def __enter__(self):
        for group in MESH_OPS.values():
            for mod, name in group:
                self.stack.enter_context(mock.patch.object(
                    mod, name, self.wrap(name, getattr(mod, name))))
        return self

    def __exit__(self, *exc):
        self.stack.close()

    def wrap(self, name, fn):
        def call(*a, **k):
            e = next(t.shape[1] for t in a if isinstance(t, torch.Tensor)
                     and t.dtype in (torch.int32, torch.bool)
                     and t.ndim == 2 and t.shape[0] == self.n_graphs)
            self.slots.setdefault(name, set()).add(e)
            self.calls[name] = (fn, a, k)
            return fn(*a, **k)
        return call

    def times(self, iters=10):
        """Device ms of each recorded call alone (in-place outputs are added
        to again: the values do not matter here)."""
        return {name: device_ms(lambda f=f, a=a, k=k: f(*a, **k), iters=iters,
                                warmup=2)
                for name, (f, a, k) in self.calls.items()}


def rel_err(got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if not bool(torch.isfinite(got).all()):
        err = float("inf")
    return err, err / max(want.abs().max().item(), 1e-30)


def mesh_inputs(dev, dt, seed):
    """The projected op's, the unprojected op's and the encoder's inputs at
    the main path's shapes, the same on every rank (one seed)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    D = HD = 200
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    src, dst, mask = graph_inputs(gen, dev, E)
    proj = [(r(G, N, HD) / (HD // HEADS) ** 0.5).to(dt),
            (r(G, N, HD) * 0.5).to(dt), (r(G, N, HD) * 0.5).to(dt),
            torch.relu(r(G, E, D)).to(dt), r(D, HD) * 0.05, r(HD) * 0.1,
            r(D, HD) * 0.05, r(HD) * 0.1, (r(G, N, HD) * 0.5).to(dt),
            (r(G, N, HD) * 0.5).to(dt)]
    unproj, unproj_gout = unproj_inputs(gen, dev, E, dt)
    n_rel = 39
    enc = encoder_ints(gen, dev, E, n_rel)
    return dict(src=src, dst=dst, mask=mask, proj=proj, gout=r(G, N, HD),
                unproj=list(unproj), unproj_gout=unproj_gout, enc=enc,
                n_rel=n_rel, cot_e=r(G, E, D), cot_s=r(G * N, D))


def mesh_cases(mesh, dt, inp, spy):
    """One rank's sharded forward and backward of the three parts on its
    E/P slots, then, on rank 0, the unsharded ones on all E slots
    (`spy` None: their entry points not recorded). Returns {name: (got,
    want)} on rank 0, {} elsewhere, and the launches of each part."""
    from qagnn_tpu_torch.parallel.edge_shard_kernels import (
        gat_projected_sharded)
    from qagnn_tpu_torch.parallel.edge_shard_map import edge_sharded_gat_nodes
    from qagnn_tpu_torch.parallel.mesh import all_gather

    P, m = mesh.n_model, mesh.model_index
    sl = slice(m * E // P, (m + 1) * E // P)
    cut = lambda t: t[:, sl].contiguous()
    whole = lambda t: torch.cat(all_gather(t.contiguous(), mesh.model_group),
                                dim=1)
    edge = (cut(inp["src"]), cut(inp["dst"]), cut(inp["mask"]))
    heads = lambda t: t.reshape(*t.shape[:-1], HEADS, t.shape[-1] // HEADS)
    got, want, launches = {}, {}, {}

    def grads(fn, vals, gout):
        leaves = [v.detach().clone().requires_grad_() for v in vals]
        out = fn(*leaves)
        torch.autograd.backward(out, gout.to(out.dtype))
        return out.detach(), [t.grad for t in leaves]

    # rows 6-9: the projected op
    vals = list(inp["proj"])
    _build.reset_launch_counts()
    with spy:
        out, g = grads(lambda *t: gat_projected_sharded(
            *t, *edge, HEADS, mesh), vals[:3] + [cut(vals[3])] + vals[4:],
            inp["gout"])
    torch.cuda.synchronize()
    launches["projected"] = dict(_build.LAUNCHES)
    got["projected out"] = out
    for name, t in zip(("nq", "nk", "nm", "edge_emb", "w_ke", "b_ke", "w_me",
                        "b_me", "skb", "smb"), g):
        got[f"projected d{name}"] = whole(t) if name == "edge_emb" else t

    # rows 1-5: the unprojected op (edge arrays ekb, emb cut)
    vals = [heads(t) for t in inp["unproj"]]
    _build.reset_launch_counts()
    with spy:
        out, g = grads(lambda *t: edge_sharded_gat_nodes(
            *t, *edge, mesh=mesh), vals[:3] + [cut(vals[3]), cut(vals[4])]
            + vals[5:], inp["unproj_gout"])
    torch.cuda.synchronize()
    launches["unprojected"] = dict(_build.LAUNCHES)
    got["unprojected out"] = out
    for name, t in zip(("nq", "nk", "nm", "ekb", "emb", "skb", "smb"), g):
        got[f"unprojected d{name}"] = whole(t) if name in ("ekb", "emb") \
            else t

    # rows 10-12: the edge encoder in train mode
    etype, esrc, edst, ntype, emask = inp["enc"]
    n_rel = inp["n_rel"]

    def encoder(m_):
        with torch.device(mesh.device):
            enc = EdgeEncoder(200, n_rel + 2 * N_NTYPE, num_updates=5,
                              dtype=dt, mesh=m_).train()
        g_ = torch.Generator(device=mesh.device).manual_seed(SEED + 31)
        init_weights(enc, g_, 0.2)
        return enc

    def run_encoder(enc, ints, cot_e):
        oh = torch.nn.functional.one_hot
        self_type = oh(ntype.long(), N_NTYPE)
        self_rel = torch.zeros((G, N, n_rel), device=mesh.device)
        self_rel[..., n_rel - 1] = 1.0
        self_feat = torch.cat([self_rel, self_type, self_type], -1) \
            .reshape(G * N, -1)
        (h_e, h_s), _ = enc(self_feat, edge_ints=ints, n_rel=n_rel,
                            n_ntype=N_NTYPE)
        ((h_e.float() * cot_e).sum()
         + (h_s.float() * inp["cot_s"]).sum()).backward()
        params = {"W0": enc.linear_0.kernel, "b0": enc.linear_0.bias,
                  "bn scale": enc.bn.scale, "bn bias": enc.bn.bias}
        return h_e.detach(), h_s.detach(), {
            k: p.grad for k, p in params.items()}, (enc.bn.mean, enc.bn.var)

    _build.reset_launch_counts()
    with spy:
        h_e, h_s, g, stats = run_encoder(
            encoder(mesh), (cut(etype), cut(esrc), cut(edst), ntype,
                            cut(emask)), cut(inp["cot_e"]))
    torch.cuda.synchronize()
    launches["encoder"] = dict(_build.LAUNCHES)
    got.update({"encoder h_edge": whole(h_e), "encoder h_self": h_s,
                "encoder bn mean": stats[0], "encoder bn var": stats[1]})
    got.update({f"encoder d{k}": t for k, t in g.items()})
    if mesh.rank != 0:
        return {}, launches

    # the unsharded ops on all E slots, rank 0 alone
    out, g = grads(lambda *t: gk.gat_projected(
        *t, inp["src"], inp["dst"], inp["mask"], HEADS), inp["proj"],
        inp["gout"])
    want["projected out"] = out
    for name, t in zip(("nq", "nk", "nm", "edge_emb", "w_ke", "b_ke", "w_me",
                        "b_me", "skb", "smb"), g):
        want[f"projected d{name}"] = t
    out, g = grads(lambda *t: relational_gat_attention_nodes(
        *t, inp["src"], inp["dst"], inp["mask"], backend="cuda"),
        [heads(t) for t in inp["unproj"]], inp["unproj_gout"])
    want["unprojected out"] = out
    for name, t in zip(("nq", "nk", "nm", "ekb", "emb", "skb", "smb"), g):
        want[f"unprojected d{name}"] = t
    h_e, h_s, g, stats = run_encoder(encoder(None), inp["enc"], inp["cot_e"])
    want.update({"encoder h_edge": h_e, "encoder h_self": h_s,
                 "encoder bn mean": stats[0], "encoder bn var": stats[1]})
    want.update({f"encoder d{k}": t for k, t in g.items()})
    return {k: (got[k], want[k]) for k in want}, launches


def collective_times(mesh, iters=10) -> dict:
    """Host ms (median, all ranks together) of each collective of the
    sharded ops at the main path's shapes, on CUDA tensors."""
    import torch.distributed as dist

    from qagnn_tpu_torch.parallel.mesh import all_reduce
    HD = D = 200
    shapes = {"c1_max (G, H)": ((G, HEADS), "max"),
              "c2_denoms (G, N, H+1)": ((G, N, HEADS + 1), "sum"),
              "c3_aggr (G, N, HD)": ((G, N, HD), "sum"),
              "c4_dscale (G, N, H)": ((G, N, HEADS), "sum"),
              "c5_grads 3GNHD+2D HD+2HD": (
                  (3 * G * N * HD + 2 * D * HD + 2 * HD,), "sum"),
              "moments (world)": ((47 + 47 * 47 + 1,), "sum"),
              "hidden_grads (F+3)D": (((47 + 3) * D,), "sum")}
    out = {}
    for name, (shape, op) in shapes.items():
        t = torch.ones(shape, device=mesh.device)
        times = []
        for _ in range(iters + 2):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce(t, mesh.model_group, op)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times[2:])
    return out


def gloo_probe(mesh) -> dict:
    """Each collective the port uses, on CUDA tensors over gloo: its result
    on this rank (device, values), or the error it raised."""
    from qagnn_tpu_torch.parallel.mesh import all_gather, all_reduce, \
        broadcast
    r, dev = mesh.rank, mesh.device
    full = lambda v, dt=torch.float32: torch.full((4,), float(v), device=dev,
                                                  dtype=dt)
    cases = {"all_reduce SUM": lambda: all_reduce(full(r + 1), mesh.world_group),
             "all_reduce MAX": lambda: all_reduce(full(r + 1),
                                                  mesh.world_group, "max"),
             "all_reduce SUM bf16": lambda: all_reduce(
                 full(r + 1, torch.bfloat16), mesh.world_group),
             "all_gather": lambda: torch.cat(all_gather(full(r),
                                                        mesh.world_group)),
             "broadcast": lambda: broadcast(full(r + 5), mesh.world_group)}
    out = {}
    for name, fn in cases.items():
        try:
            t = fn()
            torch.cuda.synchronize()
            out[name] = (str(t.device), t.float().cpu().tolist())
        except Exception as exc:  # reported, and the phase fails on it
            out[name] = f"refused: {exc!r}"[:200]
    return out


def mesh_ops_rank(P):
    """One rank of the 1 x P op-level grid on this card."""
    from qagnn_tpu_torch.parallel.mesh import make_mesh
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, P, "cuda")
    res = {"rank": mesh.rank, "probe": gloo_probe(mesh), "dtypes": {}}
    for dt in (torch.float32, torch.bfloat16):
        inp = mesh_inputs(mesh.device, dt, SEED + 30)
        spy = Spy(G)
        pairs, launches = mesh_cases(mesh, dt, inp, spy)
        errs = {k: rel_err(g, w) for k, (g, w) in pairs.items()}
        if pairs:
            # b0 sits ahead of the BatchNorm: its gradient is zero, and both
            # sides hold rounding noise of dW0's size
            err = errs["encoder db0"][0]
            errs["encoder db0"] = (err, err / pairs["encoder dW0"][1].abs()
                                   .max().item())
        # each rank times its entry points alone, in turns; rank 0 also the
        # unsharded ones on all E slots
        times, whole = {}, {}
        for r in range(P):
            dist.barrier()
            if r == mesh.rank:
                times = spy.times()
                if r == 0:
                    spy_all = Spy(G)
                    with spy_all:
                        mesh_cases_whole(inp, dt)
                    whole = spy_all.times()
            torch.cuda.synchronize()
        dist.barrier()
        res["dtypes"][str(dt)] = dict(
            errs=errs, launches=launches,
            slots={k: sorted(v) for k, v in spy.slots.items()},
            ms=times, whole_ms=whole,
            collectives=collective_times(mesh) if dt == torch.bfloat16
            else {})
    return res


def mesh_cases_whole(inp, dt):
    """The unsharded ops' forward and backward on all E slots, once, for
    their entry points' times."""
    heads = lambda t: t.reshape(*t.shape[:-1], HEADS, t.shape[-1] // HEADS)
    leaves = [v.detach().clone().requires_grad_() for v in inp["proj"]]
    gk.gat_projected(*leaves, inp["src"], inp["dst"], inp["mask"],
                     HEADS).backward(inp["gout"])
    leaves = [heads(v).detach().clone().requires_grad_()
              for v in inp["unproj"]]
    relational_gat_attention_nodes(
        *leaves, inp["src"], inp["dst"], inp["mask"], backend="cuda"
    ).backward(inp["unproj_gout"].float())
    etype, esrc, edst, ntype, emask = inp["enc"]
    w0 = torch.randn(inp["n_rel"] + 2 * N_NTYPE, 200, device=etype.device,
                     requires_grad=True)
    z = torch.zeros(200, device=etype.device, requires_grad=True)
    ek.edge_feature_moments(etype, esrc, edst, ntype, emask, inp["n_rel"],
                            N_NTYPE)
    ek.edge_hidden(etype, esrc, edst, ntype, w0, z, z + 1, z, inp["n_rel"],
                   N_NTYPE, dt).float().sum().backward()


def phase_mesh_ops(card) -> dict:
    """Rows 1-12 on E/2 and E/4 edge slices: 1 x P grids of ranks on this
    card over gloo (CUDA tensors; the collectives staged through the
    host), each rank's sharded forward and backward against the unsharded
    kernels' on rank 0, in f32 and bf16."""
    from qagnn_tpu_torch.parallel.launch import run_ranks

    out = {}
    for P in MESH_P:
        t0 = time.perf_counter()
        results = run_ranks(mesh_ops_rank, P, "gloo", "cuda", 600, P)
        log(f"  1 x {P}: {P} ranks on the card, spawned and run in "
            f"{time.perf_counter() - t0:.1f} s")
        probe = results[0]["probe"]
        want = {"all_reduce SUM": [P * (P + 1) / 2] * 4,
                "all_reduce MAX": [float(P)] * 4,
                "all_reduce SUM bf16": [P * (P + 1) / 2] * 4,
                "all_gather": [float(r) for r in range(P) for _ in range(4)],
                "broadcast": [5.0] * 4}
        for name, w in want.items():
            ok = all(isinstance(r["probe"][name], tuple)
                     and r["probe"][name][0].startswith("cuda")
                     and r["probe"][name][1] == w for r in results)
            log(f"  gloo {name} on CUDA tensors: {probe[name]} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"mesh: gloo {name} on CUDA tensors")
        for dt_name, res0 in results[0]["dtypes"].items():
            dt = getattr(torch, dt_name.split(".")[-1])
            for what, (err, rel) in res0["errs"].items():
                ok = rel <= MESH_TOL[dt]
                log(f"  1x{P} {dt_name[6:]:<8} {what:<28} max_abs_err "
                    f"{err:.3e} max_rel_err {rel:.3e} tol {MESH_TOL[dt]:.1e}"
                    f"  {'ok' if ok else 'FAIL'}")
                if not ok:
                    FAILURES.append(f"mesh 1x{P} {dt_name} {what}")
            for r in results:
                res = r["dtypes"][dt_name]
                for part, group in MESH_OPS.items():
                    names = [n for _, n in group]
                    seen = {n: res["slots"].get(n) for n in names}
                    counts = {KERNEL_OF[n]: res["launches"][part].get(
                        KERNEL_OF[n], 0) for n in names}
                    ok = all(v == [E // P] for v in seen.values()) and all(
                        c == 1 for c in counts.values())
                    if not ok or r["rank"] == 0:
                        log(f"  rank {r['rank']} {dt_name[6:]} {part}: "
                            f"slots {seen}, launches {counts}  "
                            f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        FAILURES.append(f"mesh 1x{P} rank {r['rank']} "
                                        f"{part}: not one launch a kernel "
                                        f"on E/P slots")
        for r in results:
            res = r["dtypes"]["torch.bfloat16"]
            log(f"  1x{P} rank {r['rank']} bf16, each entry point alone on "
                f"its {E // P} slots (whole-E time beside it, rank 0's): "
                + ", ".join(f"{KERNEL_OF[n]} {ms:.4f}"
                            + (f" (E {results[0]['dtypes']['torch.bfloat16']['whole_ms'].get(n, float('nan')):.4f})")
                            for n, ms in res["ms"].items())
                + f" ms  [{card}]")
            log(f"  1x{P} rank {r['rank']} collectives, host ms, gloo on one "
                "card (staged through the host; not a scaling result): "
                + ", ".join(f"{k} {v:.3f}"
                            for k, v in res["collectives"].items())
                + f"  [{card}]")
        out[P] = results
    return out


class ParamWatch:
    """The trainable parameters of a cli.train run (its optimizer's; the
    frozen entity table is not among them): as the optimizer first sees
    them, and at the end of the run."""

    def __init__(self):
        self.optimizer = self.first = self.last = None

    def patch(self):
        from qagnn_tpu_torch import cli
        build = cli.build_train_optimizer

        def watched(model, **kw):
            self.optimizer = build(model, **kw)
            self.first = self.values()
            return self.optimizer
        return mock.patch.object(cli, "build_train_optimizer", watched)

    def values(self) -> dict:
        return {n: p.detach().float().cpu().numpy().copy()
                for n, p in sorted(self.optimizer.params.items())}

    def finish(self) -> str:
        """Keep the last values, let the model go; their digest."""
        self.last, self.optimizer = self.values(), None
        h = hashlib.sha256()
        for n, a in self.last.items():
            h.update(n.encode())
            h.update(a.tobytes())
        return h.hexdigest()


def update_gaps(grid: dict, one: dict) -> tuple[dict, dict]:
    """|d_grid - d_one| / |d_one| over the tensors of each part of the
    model (the encoder, the GNN, the rest of the decoder), where d is a
    run's last values less its first (each run's {"first": ..., "last":
    ...}): a fault in a gradient rule shows in the part it feeds, which
    the others' larger changes would hide in one norm over all. Also each
    tensor's (|d_grid - d_one|, |d_one|)."""
    sums = collections.defaultdict(lambda: [0.0, 0.0])
    tensors = {}
    for n, last in one["last"].items():
        part = "decoder.gnn" if n.startswith("decoder.gnn.") \
            else n.split(".")[0]
        d_one = last.astype(np.float64) - one["first"][n]
        d_grid = grid["last"][n].astype(np.float64) - grid["first"][n]
        tensors[n] = (float(np.linalg.norm(d_grid - d_one)),
                      float(np.linalg.norm(d_one)))
        sums[part][0] += tensors[n][0] ** 2
        sums[part][1] += tensors[n][1] ** 2
    return {part: math.sqrt(a / max(b, 1e-300))
            for part, (a, b) in sorted(sums.items())}, tensors


def mesh_cli_rank(cfg):
    """One rank of cli.train on the grid: its launches, peak memory, time,
    the logits of its evaluations (whole batches, gathered), the digest of
    its trained parameters and, on rank 0, their values before and
    after."""
    import torch.distributed as dist

    from qagnn_tpu_torch import cli

    logits = []
    to_numpy = cli._logits
    watch = ParamWatch()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(cli, "_logits", lambda out: logits.append(
            to_numpy(out)) or logits[-1]), watch.patch(), \
            contextlib.redirect_stdout(io.StringIO()) as printed:
        result = cli.train(cfg, "cuda")
    out = dict(result=result, logits=logits, printed=printed.getvalue(),
               launches=dict(_build.LAUNCHES),
               secs=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               digest=watch.finish())
    if dist.get_rank() == 0:
        out.update(first=watch.first, last=watch.last)
    return out


def phase_mesh_cli(dev, card) -> None:
    """cli.train at 2 x 2 (4 ranks on this card, gloo) and at 1 x 1 on the
    same files: OBQA's GNN widths (k=5, gnn_dim 200, 200-node graphs in the
    4096-edge bucket, bf16 GNN, dropout on), the whole 799,273 x 1024 entity
    table (row-sharded over 2 on the grid), the overfit phase's 4-layer
    256-wide BERT, 16 x 4 a batch in 2 microbatches, 2 steps an epoch, 2
    epochs. The losses and the parameters' change over the run must agree,
    the data ranks of a model slice must end with the same parameters, and
    rank 0's checkpoint must load into a one-card eval_detail whose dev
    logits are the grid's own."""
    from qagnn_tpu_torch import cli
    from qagnn_tpu_torch.data.synthetic import write_tiny_bert_checkpoint
    from qagnn_tpu_torch.parallel.launch import run_ranks

    rng = np.random.default_rng(SEED + 32)
    with tempfile.TemporaryDirectory(prefix="qagnn_mesh_") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        emb_path, _ = write_cli_dataset(tmp / "data", rng,
                                        questions=MESH_CLI_QUESTIONS)
        enc_dir = write_tiny_bert_checkpoint(
            str(tmp / "bert"), hidden_size=256, num_layers=4, num_heads=4)
        log(f"  wrote the dataset ({MESH_CLI_QUESTIONS} questions x {C} "
            f"choices, entity table {N_CONCEPT} x {CONCEPT_IN} f32) and the "
            f"BERT in {time.perf_counter() - t0:.1f} s")

        def config(save_dir, n_data, n_model):
            cfg = preset("obqa", encoder="bert-base-uncased",
                         encoder_load=enc_dir, batch_size=B,
                         mini_batch_size=B // 2, eval_batch_size=B,
                         n_epochs=2, unfreeze_epoch=0, gnn_dtype="bfloat16",
                         encoder_dtype="float32", save_model=True,
                         save_dir=str(save_dir), seed=SEED, log_interval=1,
                         max_seq_len=64, max_node_num=N, mesh_data=n_data,
                         mesh_model=n_model)
            for split in MESH_CLI_QUESTIONS:
                setattr(cfg, f"{split}_statements", str(
                    tmp / "data" / "statement" / f"{split}.statement.jsonl"))
                setattr(cfg, f"{split}_adj", str(
                    tmp / "data" / "graph" / f"{split}.graph.adj.pk"))
            cfg.ent_emb_paths = (emb_path,)
            return cfg

        # one card: the same command at 1 x 1
        torch.cuda.reset_peak_memory_stats()
        one_watch = ParamWatch()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as one_printed, \
                one_watch.patch():
            one = cli.train(config(tmp / "one", 1, 1), dev)
        one_secs = time.perf_counter() - t0
        one_watch.finish()
        one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()

        # the grid: cli.train as every rank runs it (run_ranks joins the
        # ranks, as torchrun would)
        n_data, n_model = MESH_CLI_GRID
        cfg = config(tmp / "grid", n_data, n_model)
        t0 = time.perf_counter()
        ranks = run_ranks(mesh_cli_rank, n_data * n_model, "gloo", "cuda",
                          900, cfg)
        grid_secs = time.perf_counter() - t0

        # rank 0's checkpoint on one card
        logits = []
        to_numpy = cli._logits
        cfg_eval = dataclasses.replace(
            cfg, mode="eval_detail", detail_batches=0,
            load_model_path=str(tmp / "grid" / "checkpoint"),
            save_dir=str(tmp / "eval"))
        (tmp / "eval").mkdir()
        t0 = time.perf_counter()
        with mock.patch.object(cli, "_logits", lambda out: logits.append(
                to_numpy(out)) or logits[-1]), \
                contextlib.redirect_stdout(io.StringIO()):
            detail = cli.eval_detail(cfg_eval, dev)
        eval_secs = time.perf_counter() - t0
        ckpt_gib = sum(f.stat().st_size for f in
                       (tmp / "grid" / "checkpoint").iterdir()) / 2 ** 30

    got = ranks[0]["result"]
    log(f"  1 x 1: cli.train {one_secs:.1f} s, peak {one_peak:.2f} GiB  "
        f"[{card}]")
    log(f"  2 x 2: cli.train over run_ranks {grid_secs:.1f} s (spawn "
        "included); per rank: " + ", ".join(
            f"rank {i} {r['secs']:.1f} s peak {r['peak_gib']:.2f} GiB"
            for i, r in enumerate(ranks)) + f"  [{card}]")
    step_ms = lambda text: " ".join(re.findall(  # noqa: E731
        r"\| ms/batch\s+([0-9.]+) \|", text))
    log(f"  ms a step by the CLI's log line (the first of each epoch holds "
        f"its start or the last evaluation and checkpoint): 1 x 1 "
        f"{step_ms(one_printed.getvalue())}; 2 x 2 "
        f"{step_ms(ranks[0]['printed'])}  [{card}]")
    log(f"  losses 1 x 1: {' '.join(f'{x:.6f}' for x in one['train_losses'])}")
    log(f"  losses 2 x 2: {' '.join(f'{x:.6f}' for x in got['train_losses'])}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["train_losses"],
                                                   one["train_losses"]))
    one_run = dict(first=one_watch.first, last=one_watch.last)
    same_start = sorted(ranks[0]["first"]) == sorted(one_run["first"]) \
        and all(np.array_equal(ranks[0]["first"][n], a)
                for n, a in one_run["first"].items())
    gaps, tensors = update_gaps(ranks[0], one_run) if same_start \
        else ({}, {})
    gap = max(gaps.values(), default=float("inf"))
    log(f"  trained parameters: {len(one_run['first'])} tensors; the grid's "
        "change over the run against the one-card run's: " + ", ".join(
            f"{part} {g:.3e}" for part, g in gaps.items())
        + "; the largest |d_grid - d_one| (|d_one|): " + ", ".join(
            f"{n} {a:.3e} ({b:.3e})" for n, (a, b) in sorted(
                tensors.items(), key=lambda t: -t[1][0])[:4]))
    log("  digests of the trained parameters, by rank: " + ", ".join(
        r["digest"][:12] for r in ranks))
    checks = {
        f"losses agree (max rel {rel:.2e} <= {MESH_CLI_TOL:.1e})":
            len(got["train_losses"]) == len(one["train_losses"]) == 4
            and rel <= MESH_CLI_TOL,
        "the grid starts from the one-card run's parameters": same_start,
        f"the parameters change as on one card ({gap:.2e} <= "
        f"{MESH_UPDATE_TOL:.1e})": gap <= MESH_UPDATE_TOL,
        "the data ranks of each model slice end with the same parameters":
            all(ranks[r]["digest"] == ranks[r % n_model]["digest"]
                for r in range(len(ranks))),
        "every kernel of the train step launched on every rank": all(
            r["launches"].get(n, 0) > 0 for r in ranks
            for n in step_launches(cfg.k)),
    }
    epoch = got["best_dev_epoch"]
    n_eval = 2                       # one dev and one test batch an epoch
    grid_dev = torch.from_numpy(ranks[0]["logits"][epoch * n_eval])
    one_dev = torch.from_numpy(logits[0])
    err, rel_l = rel_err(one_dev, grid_dev)
    checks[f"one-card dev logits of the grid's checkpoint (max rel "
           f"{rel_l:.2e} <= {MESH_EVAL_TOL:.1e})"] = \
        tuple(one_dev.shape) == (B, C) and rel_l <= MESH_EVAL_TOL
    log(f"  launches per rank over cli.train: " + "; ".join(
        f"rank {i}: " + ", ".join(f"{n} {r['launches'].get(n, 0)}"
                                  for n in step_launches(cfg.k))
        for i, r in enumerate(ranks)))
    log(f"  checkpoint {ckpt_gib:.2f} GiB (the table gathered by rank 0); "
        f"eval_detail from it on one card {eval_secs:.1f} s: dev_acc "
        f"{detail['dev_acc']:.4f} (grid's best {got['best_dev_acc']:.4f})")
    for what, ok in checks.items():
        log(f"  {what}: {'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"mesh cli: {what}")


# ---- the preprocessing vertical (qagnn_tpu_torch/preprocess) ---------------

# ConceptNet 5.6's English graph at its scale: N_CONCEPT concepts (the
# entity table's rows) and about 2.5 M merged triples. A triple's endpoints
# are drawn as floor(n * u**PREP_DEGREE_EXPONENT), u uniform, so low ids are
# heavy-tailed hubs; the first PREP_WORDS concepts are single words, the
# rest two-word compounds `w1_w2` of them.
PREP_CONCEPTS = N_CONCEPT
PREP_TRIPLES = 2_500_000
PREP_WORDS = 60_000
PREP_DEGREE_EXPONENT = 3.0
# merged relations of the English triples, relatedto first (hascontext is
# pruned by construct_graph)
PREP_RELATIONS = {
    "relatedto": 0.52, "isa": 0.09, "hascontext": 0.08, "atlocation": 0.05,
    "antonym": 0.04, "partof": 0.04, "usedfor": 0.03, "capableof": 0.02,
    "hasproperty": 0.02, "hassubevent": 0.02, "causes": 0.02, "desires": 0.02,
    "madeof": 0.01, "receivesaction": 0.01, "createdby": 0.01,
    "notdesires": 0.01, "notcapableof": 0.01}
PREP_FILLERS = ("the", "a", "of", "is", "which", "in", "to", "can", "be",
                "an", "when", "for", "what", "with", "on", "as", "by", "most")
# OBQA's train split alone, x 4 choices (each split present pays the
# grounding pool's 800k-concept matchers and 8 KG loads in Parts 1 and 3
# again: about 35 s a split on the card). Questions name common words, the
# hubs: their concepts are single words among the PREP_QUESTION_IDS most
# connected (and one compound), which gives 2-hop schema graphs of 43-1,319
# nodes (median 114), ~23k sentences for Part 2 to score
PREP_QUESTIONS = {"train": 32}
PREP_QUESTION_IDS = (0, 150)
PREP_NPROCS = 4
PREP_CHECKED = 2            # statements scored again on the CPU
# card vs CPU, f32 with TF32 off: |score| <= PREP_TOL * max|score| (24
# layers and a 50,265-way log-softmax summed over ~25 tokens in another
# order)
PREP_TOL = 1e-4
# the DDB graph the reference builds for MedQA-USMLE (9,958 nodes, 44,561
# edges), its names 1-3 words; MedQA questions of ~100 words
DDB_ENTITIES = 10_000
DDB_RELATIONS = 44_561
MEDQA_QUESTIONS = {"train": 32}
SAPBERT_CHECKED = 256       # names embedded again on the CPU
SAPBERT_TOL = 1e-4          # x max|emb|, card vs CPU, f32 with TF32 off


def prep_words(rng, n: int) -> list[str]:
    """`n` distinct three-syllable letter words (consonant + a/i/o/u, so
    the rule lemmatizer leaves them as they are)."""
    syll = np.array([c + v for c in "bcdfghjklmnprstvz" for v in "aiou"])
    draw = syll[rng.integers(0, len(syll), (2 * n, 3))]
    words = np.unique(np.char.add(np.char.add(draw[:, 0], draw[:, 1]),
                                  draw[:, 2]))
    return rng.permutation(words)[:n].tolist()


def write_conceptnet_en(cpnet: pathlib.Path, rng) -> tuple[list, list]:
    """The English triples (`rel \\t head \\t tail \\t weight`, as
    extract_english writes them) and the vocabulary of PREP_CONCEPTS
    concepts, the first PREP_WORDS single words. Returns (words,
    concepts)."""
    words = prep_words(rng, PREP_WORDS)
    k, n = len(words), PREP_CONCEPTS
    pairs = np.unique(rng.integers(0, k * k, int((n - k) * 1.05)))
    pairs = rng.permutation(pairs[pairs // k != pairs % k])[:n - k]
    w = np.array(words)
    concepts = words + np.char.add(np.char.add(w[pairs // k], "_"),
                                   w[pairs % k]).tolist()
    ends = (n * rng.random((2, PREP_TRIPLES)) ** PREP_DEGREE_EXPONENT
            ).astype(np.int64)
    rel_names = list(PREP_RELATIONS)
    p = np.array(list(PREP_RELATIONS.values()))
    rels = rng.choice(len(rel_names), PREP_TRIPLES, p=p / p.sum())
    cpnet.mkdir(parents=True)
    with open(cpnet / "conceptnet.en.csv", "w") as f:
        f.write("".join(f"{rel_names[r]}\t{concepts[h]}\t{concepts[t]}\t1.0\n"
                        for r, h, t in zip(rels.tolist(), ends[0].tolist(),
                                           ends[1].tolist())))
    with open(cpnet / "concept.txt", "w") as f:
        f.write("\n".join(concepts) + "\n")
    return words, concepts


def write_obqa(obqa: pathlib.Path, rng, concepts) -> None:
    """OBQA-format raw splits (question.stem, 4 choices, answerKey): stems
    name 3 single-word concepts and one compound among filler words, each
    choice one concept."""
    def surface(i):
        return concepts[int(i)].replace("_", " ")

    def word():
        return surface(rng.integers(*PREP_QUESTION_IDS))

    obqa.mkdir(parents=True)
    for split, n in PREP_QUESTIONS.items():
        with open(obqa / f"{split}.jsonl", "w") as f:
            for q in range(n):
                named = [word(), word(), word(),
                         surface(rng.integers(PREP_WORDS, len(concepts)))]
                stem = " ".join(f"{rng.choice(PREP_FILLERS)} {c}"
                                for c in named)
                choices = [{"label": "ABCD"[j], "text": word()}
                           for j in range(C)]
                f.write(json.dumps({
                    "id": f"{split}-{q}", "answerKey": "ABCD"[
                        int(rng.integers(C))],
                    "question": {"stem": stem.capitalize(),
                                 "choices": choices}}) + "\n")


def write_ddb(ddb: pathlib.Path, rng, words) -> list[str]:
    """ddb_names.json ({name: [ptr, preferred]}, a third of the entities
    with an alias) and ddb_relas.json ({key: [subj, obj, code]}) over
    DDB_ENTITIES entities, the reference's fallback pointers among them,
    relation codes from the 15 merged DDB relations plus a few unknown
    codes and dangling pointers. Returns the preferred names."""
    from qagnn_tpu_torch.preprocess.biomed import (
        DDB_RELATION_CODE_MAP,
        FALLBACK_A_PTR,
        FALLBACK_Q_PTR,
    )
    ptrs = [str(p) for p in rng.choice(np.arange(1, 60_000), DDB_ENTITIES,
                                       replace=False)
            if str(p) not in (FALLBACK_Q_PTR, FALLBACK_A_PTR)]
    ptrs = (ptrs + [FALLBACK_Q_PTR, FALLBACK_A_PTR])[-DDB_ENTITIES:]
    words, names, taken = np.asarray(words), {}, set()
    for ptr in ptrs:
        for preferred in ("1", "0") if rng.random() < 1 / 3 else ("1",):
            name = ""
            while not name or name in taken:
                name = " ".join(rng.choice(words, int(rng.integers(1, 4))))
            taken.add(name)
            names[name.capitalize() if preferred == "1" else name] = \
                [ptr, preferred]
    codes = list(DDB_RELATION_CODE_MAP) + ["999"]
    ends = (DDB_ENTITIES * rng.random((2, DDB_RELATIONS)) ** 2).astype(int)
    relas = {f"r{i}": [ptrs[s], ptrs[o], codes[int(rng.integers(
        len(codes)))]] for i, (s, o) in enumerate(zip(*ends.tolist()))}
    relas["dangling"] = [ptrs[0], "999999", "2"]
    ddb.mkdir(parents=True)
    (ddb / "ddb_names.json").write_text(json.dumps(names))
    (ddb / "ddb_relas.json").write_text(json.dumps(relas))
    return [n for n, (_, pref) in names.items() if pref == "1"]


def write_medqa(medqa: pathlib.Path, rng, entity_names) -> None:
    """MedQA-USMLE 4-option raw splits: ~100-word questions naming 6
    entities among filler words, options entity names."""
    raw = medqa / "raw" / "questions" / "US" / "4_options"
    raw.mkdir(parents=True)
    entity_names = np.asarray(entity_names)
    for split, n in MEDQA_QUESTIONS.items():
        with open(raw / f"phrases_no_exclude_{split}.jsonl", "w") as f:
            for _ in range(n):
                parts = [" ".join(rng.choice(PREP_FILLERS, 14))
                         + " " + str(rng.choice(entity_names))
                         for _ in range(6)]
                options = {k: str(rng.choice(entity_names)) for k in "ABCD"}
                f.write(json.dumps({
                    "question": ". ".join(parts) + "?", "options": options,
                    "answer_idx": "ABCD"[int(rng.integers(4))]}) + "\n")


def hf_init_(module, gen) -> None:
    """HF's BERT / RoBERTa initialisation: normal(0, 0.02) matrices and
    tables, zero biases, unit LayerNorm scales."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Embedding)):
                m.weight.normal_(0.0, 0.02, generator=gen)
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()


class ScorerProbe:
    """Stands in for the MLMScorer that run_dataset builds: counts the
    sentences scored, keeps the first PREP_CHECKED calls, and puts CUDA
    events around each chunk's device work (`sentence_scores`, before its
    .cpu())."""

    def __init__(self, scorer):
        self.scorer, self.calls, self.sentences, self.events = \
            scorer, [], 0, []
        chunk = scorer.sentence_scores

        def timed(enc):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = chunk(enc)
            ev[1].record()
            self.events.append(ev)
            return out
        scorer.sentence_scores = timed

    def __call__(self, question, names):
        scores = self.scorer(question, names)
        self.sentences += len(names)
        if len(self.calls) < PREP_CHECKED:
            self.calls.append((question, list(names), list(scores)))
        return scores

    def device_ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def order_agrees(got: list, want: dict, tol: float) -> bool:
    """Every two keys whose `want` values differ by more than `tol` come in
    `got` in the order of their values, descending."""
    pos = {k: i for i, k in enumerate(got)}
    keys = list(want)
    vals = np.array([want[k] for k in keys])
    at = np.array([pos[k] for k in keys])
    return not ((vals[:, None] - vals[None, :] > tol)
                & (at[:, None] > at[None, :])).any()


def prep_extract_check(tmp: pathlib.Path) -> float:
    """extract_english on a raw assertions file with merges, `*`-swaps, a
    non-English tail and a dropped relation. Returns its seconds."""
    from qagnn_tpu_torch.preprocess.conceptnet import extract_english
    raw = [("/r/AtLocation", "/c/en/lantern", "/c/en/antique_shop"),
           ("/r/UsedFor", "/c/en/lantern/n", "/c/en/light"),
           ("/r/HasA", "/c/en/house", "/c/en/roof"),
           ("/r/MotivatedByGoal", "/c/en/run", "/c/en/health"),
           ("/r/NotARelation", "/c/en/cat", "/c/en/dog"),
           ("/r/IsA", "/c/en/voiture", "/c/fr/vehicule")]
    with open(tmp / "assertions.csv", "w") as f:
        for rel, h, t in raw:
            f.write("\t".join(["/a/x", rel, h, t,
                               json.dumps({"weight": 1.0})]) + "\n")
    t0 = time.perf_counter()
    extract_english(str(tmp / "assertions.csv"), str(tmp / "en.csv"),
                    str(tmp / "vocab.txt"))
    secs = time.perf_counter() - t0
    rows = [r.split("\t") for r in (tmp / "en.csv").read_text().splitlines()]
    ok = rows == [["atlocation", "lantern", "antique_shop", "1.0"],
                  ["usedfor", "lantern", "light", "1.0"],
                  ["partof", "roof", "house", "1.0"],
                  ["causes", "health", "run", "1.0"]]
    log(f"  extract_english: merged, swapped and dropped rows "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"preprocess: extract_english wrote {rows}")
    return secs


def prep_card_vs_cpu(probe, rows, kg, lm_dir, tok) -> None:
    """The first PREP_CHECKED statements' scores on the card against the
    same model's on the CPU: the node sets exactly, the values within
    PREP_TOL x max|score|, the order of cid2score and of the row's extra
    nodes wherever two CPU scores differ by more than that."""
    from qagnn_tpu_torch.preprocess import graph_extraction as graphs
    cpu = graphs.make_torch_mlm_scorer(lm_dir, device="cpu", tokenizer=tok)
    for j, (question, names, card_scores) in enumerate(probe.calls):
        t0 = time.perf_counter()
        want = cpu(question, names)
        secs = time.perf_counter() - t0
        row = rows[j]
        ids = [-1] + [kg.concept2id[n] for n in names[1:]]
        cpu_c2s = dict(sorted(zip(ids, want), key=lambda x: -x[1]))
        tol = PREP_TOL * max(abs(v) for v in want)
        n_q = int(row["qmask"].sum() + row["amask"].sum())
        extra = row["concepts"][n_q:].tolist()
        checks = {
            "node set": set(row["cid2score"]) == set(cpu_c2s)
            == set(row["concepts"].tolist()) | {-1},
            "scores the row holds are the probe's":
                [row["cid2score"][i] for i in ids] == card_scores,
            "cid2score order": order_agrees(list(row["cid2score"]), cpu_c2s,
                                            tol),
            "extra nodes' order": order_agrees(
                extra, {k: v for k, v in cpu_c2s.items() if k in
                        set(extra)}, tol)}
        compare(f"statement {j}: {len(names)} scores, card vs CPU",
                torch.tensor(card_scores), torch.tensor(want), PREP_TOL)
        log(f"    ({len(names)} sentences on the CPU in {secs:.1f} s; "
            + "; ".join(f"{k} {'ok' if v else 'FAIL'}"
                        for k, v in checks.items()) + ")")
        FAILURES.extend(f"preprocess statement {j}: {k}"
                        for k, v in checks.items() if not v)


def phase_preprocess(dev, card) -> None:
    """The port's preprocessing vertical (qagnn_tpu_torch/preprocess) on
    inputs written from a seed: extract_english on a small raw file;
    run_common's construct_graph at ConceptNet's scale; run_dataset("obqa")
    with 4 worker processes and make_torch_mlm_scorer's random roberta-large
    MLM on the card (its first statements held against the CPU); run_medqa
    over a DDB-sized graph with the SapBERT table of a random BERT-base on
    the card (its first names held against the CPU). Prints host seconds
    per stage, Part 2's sentences/s, device ms a chunk and the card's idle
    share over it, SapBERT's names/s and the peak memory."""
    from qagnn_tpu_torch.data.graphs import load_graph_pk
    from qagnn_tpu_torch.models.mlm_head import MaskedLM
    from qagnn_tpu_torch.preprocess import biomed, driver
    from qagnn_tpu_torch.preprocess.grounding import create_matcher
    from qagnn_tpu_torch.preprocess.kg import KG

    rng = np.random.default_rng(SEED + 30)
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    # the pools' workers import this script again (as `__mp_main__`): the
    # forkserver they fork from imports its modules once beforehand
    multiprocessing.get_context("forkserver").set_forkserver_preload(
        [pathlib.Path(__file__).stem])
    torch.cuda.reset_peak_memory_stats()
    stages = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        (root / "extract").mkdir()
        stages["extract"] = prep_extract_check(root / "extract")

        t0 = time.perf_counter()
        words, concepts = write_conceptnet_en(root / "cpnet", rng)
        write_obqa(root / "obqa", rng, concepts)
        log(f"  wrote {PREP_TRIPLES:,} English triples over "
            f"{len(concepts):,} concepts and {sum(PREP_QUESTIONS.values())} "
            f"OBQA questions x {C} in {time.perf_counter() - t0:.1f} s")
        stages |= driver.run_common(str(root), PREP_NPROCS)
        t0 = time.perf_counter()
        kg = KG.load(str(root / "cpnet" / "conceptnet.en.kg.npz"))
        t1 = time.perf_counter()
        kg.build_indices()
        stages["build_indices"] = time.perf_counter() - t1
        degree = np.diff(kg._nbr_offsets)
        log(f"  KG: {kg.n_nodes:,} nodes, {len(kg.edge_src):,} directed "
            f"edges (inverses included); load {t1 - t0:.1f} s; neighbors "
            f"a node: median {np.median(degree):.0f}, max {degree.max():,}")
        t0 = time.perf_counter()
        create_matcher(str(root / "cpnet" / "concept.txt"))
        stages["matcher"] = time.perf_counter() - t0

        lm_cfg = TextEncoderConfig.roberta_large()
        with torch.device(dev):
            lm = MaskedLM(lm_cfg)
        hf_init_(lm, gen)
        lm_dir = str(root / "roberta-large-mlm")
        t0 = time.perf_counter()
        write_hf_roberta(pathlib.Path(lm_dir), {
            k: v.cpu() for k, v in lm.encoder.state_dict().items()
            if not k.startswith("pooler.")}, lm_cfg,
            head={k: v.cpu() for k, v in lm.head.state_dict().items()})
        del lm
        log(f"  wrote a random roberta-large MLM ({lm_cfg.num_layers} "
            f"layers, hidden {lm_cfg.hidden_size}, vocab "
            f"{lm_cfg.vocab_size:,}, decoder tied) in "
            f"{time.perf_counter() - t0:.1f} s")
        tok = WordTokenizer(
            (["<s>", "<pad>", "</s>", "<unk>", ".", "?"] + list(PREP_FILLERS)
             + words)[:lm_cfg.vocab_size])

        probes = []
        real = driver.make_torch_mlm_scorer
        with mock.patch.object(driver, "make_torch_mlm_scorer",
                               lambda *a, **k: probes.append(ScorerProbe(
                                   real(*a, **k))) or probes[-1]):
            t0 = time.perf_counter()
            split_secs = driver.run_dataset("obqa", str(root), PREP_NPROCS,
                                            lm_scorer_path=lm_dir,
                                            tokenizer=tok)
            dataset_secs = time.perf_counter() - t0
        probe = probes[0]
        for stage in ("ground", "part1", "part2", "part3"):
            stages[stage] = sum(s[stage] for s in split_secs.values())
        chunk_ms = probe.device_ms()
        busy = sum(chunk_ms) / 1e3
        on_card = probe.scorer.device.type == "cuda" and next(
            probe.scorer.model.parameters()).is_cuda
        log(f"  run_dataset(obqa, {PREP_NPROCS} processes) "
            f"{dataset_secs:.1f} s; the scorer "
            f"{'on the card' if on_card else 'NOT on the card'}; Part 2: "
            f"{probe.sentences:,} sentences in {stages['part2']:.1f} s = "
            f"{probe.sentences / stages['part2']:.0f} sentences/s, "
            f"{len(chunk_ms)} chunks, device ms a chunk median "
            f"{statistics.median(chunk_ms):.2f} (min {min(chunk_ms):.2f}, "
            f"max {max(chunk_ms):.2f}), device busy {busy:.2f} s: idle "
            f"share {1 - busy / stages['part2']:.3f}")
        if not on_card:
            FAILURES.append("preprocess: the MLM scorer is not on the card")

        rows_of, n_nodes = {}, []
        for split in PREP_QUESTIONS:
            pk = str(root / "obqa" / "graph" / f"{split}.graph.adj.pk")
            with open(pk, "rb") as f:
                rows_of[split] = pickle.load(f)
            bad = [i for i, r in enumerate(rows_of[split])
                   if set(r["cid2score"]) != set(r["concepts"].tolist())
                   | {-1}]
            data = load_graph_pk(pk, max_node_num=200, use_cache=False)
            n_nodes += [len(r["concepts"]) for r in rows_of[split]]
            ok = not bad and len(data) == len(rows_of[split]) == \
                C * PREP_QUESTIONS[split]
            log(f"  {split}: {len(rows_of[split])} rows, cid2score keys = "
                f"schema nodes + -1 {'ok' if not bad else f'FAIL {bad[:5]}'}"
                f"; load_graph_pk(200) {len(data)} graphs, "
                f"{data.n_relations} relations {'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"preprocess: obqa {split} rows")
        log(f"  schema nodes a statement: median "
            f"{np.median(n_nodes):.0f}, min {min(n_nodes)}, max "
            f"{max(n_nodes)}")
        prep_card_vs_cpu(probe, rows_of["train"], kg, lm_dir, tok)
        del probe, probes, kg
        gc.collect()

        t0 = time.perf_counter()
        names = write_ddb(root / "ddb", rng, words)
        write_medqa(root / "medqa_usmle", rng, names)
        sap_cfg = TextEncoderConfig.bert_base()
        with torch.device(dev):
            sap = TextEncoder(sap_cfg)
        hf_init_(sap, gen)
        sap_dir = root / "sapbert"
        write_hf_roberta(sap_dir, {k: v.cpu() for k, v in
                                   sap.state_dict().items()}, sap_cfg,
                         model_type="bert")
        del sap
        sap_tok = WordTokenizer(
            (["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + [w.lower() for w in
                                                     words])[
                :sap_cfg.vocab_size], cls_token="[CLS]", sep_token="[SEP]",
            unk_token="[UNK]", pad_token="[PAD]")
        log(f"  wrote a DDB of {DDB_ENTITIES:,} entities / "
            f"{DDB_RELATIONS:,} relations, MedQA "
            f"{sum(MEDQA_QUESTIONS.values())} questions x 4 and a random "
            f"BERT-base ({sap_cfg.num_layers} layers, hidden "
            f"{sap_cfg.hidden_size}) in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        med_secs = biomed.run_medqa(str(root), PREP_NPROCS,
                                    sapbert_path=str(sap_dir),
                                    tokenizer=sap_tok)
        stages["medqa"] = time.perf_counter() - t0 - med_secs["sapbert"]
        table = np.load(root / "ddb" / "ent_emb.npy")
        vocab = (root / "ddb" / "vocab.txt").read_text().splitlines()
        log(f"  run_medqa {time.perf_counter() - t0:.1f} s: KG "
            f"{med_secs['kg']:.1f} s, splits "
            + ", ".join(f"{s} {med_secs[s]:.1f} s" for s in MEDQA_QUESTIONS)
            + f"; SapBERT table {table.shape} in {med_secs['sapbert']:.1f} s"
            f" (checkpoint load included) = "
            f"{len(vocab) / med_secs['sapbert']:.0f} names/s")
        for split in MEDQA_QUESTIONS:
            data = load_graph_pk(str(root / "medqa_usmle" / "graph" /
                                     f"{split}.graph.adj.pk"),
                                 max_node_num=200, use_cache=False)
            if len(data) != 4 * MEDQA_QUESTIONS[split] or \
                    data.n_relations != 34:
                FAILURES.append(f"preprocess: medqa {split} graphs")
        if table.shape != (len(vocab), sap_cfg.hidden_size) or \
                not np.isfinite(table).all():
            FAILURES.append(f"preprocess: SapBERT table {table.shape}")
        (root / "check.txt").write_text(
            "\n".join(vocab[:SAPBERT_CHECKED]) + "\n")
        t0 = time.perf_counter()
        want = biomed.sapbert_entity_embeddings(
            str(root / "check.txt"), str(root / "check.npy"), str(sap_dir),
            device="cpu", tokenizer=sap_tok)
        compare(f"SapBERT: first {SAPBERT_CHECKED} names, card vs CPU",
                torch.from_numpy(table[:SAPBERT_CHECKED]),
                torch.from_numpy(want), SAPBERT_TOL)
        log(f"    (the CPU's {SAPBERT_CHECKED} names in "
            f"{time.perf_counter() - t0:.1f} s)")

    log("  host seconds by stage: " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    log(f"  peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB on "
        f"the card; the preprocess phase took "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")


# ---------------------------------------------------------------------------
# the tools (qagnn_tpu_torch/tools): the parity bands, profile_step read by
# trace_summary, the dress rehearsal and the CLI's profiler path
# ---------------------------------------------------------------------------

TOOLS_CLI_QUESTIONS = 8     # two train steps of 4 questions, one epoch
TOOLS_CLI_TRACED = 2        # steps in the CLI's profiler window


def tools_parity(dev, card) -> None:
    """parity_check.check and check_projected in bf16 at their full shapes:
    PARITY OK, and the candidate's launches: rows 1-5 once each, rows 6-12
    a k=2 forward and backward."""
    from qagnn_tpu_torch.tools import parity_check

    wants = {"check": dict.fromkeys(UNPROJ_KERNELS, 1),
             "check_projected": step_launches(
                 parity_check.PROJECTED_SHAPES[False][4])}
    for name, want in wants.items():
        printed = io.StringIO()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            ok = getattr(parity_check, name)(small=False, device=dev)
        secs = time.perf_counter() - t0
        counts, routes = dict(_build.LAUNCHES), dict(_build.ROUTES)
        log(f"  parity_check.{name}(small=False), bf16 on the card against "
            f"f32 on the CPU, {secs:.1f} s  [{card}]:")
        for line in printed.getvalue().splitlines():
            log("    " + line)
        log(f"    launches {counts}; routes {routes}")
        if not ok:
            FAILURES.append(f"tools: parity_check.{name} PARITY FAIL")
        if counts != want:
            FAILURES.append(f"tools: parity_check.{name} launches {counts}")
        off = {k: n for k, n in routes.items() if k[1] != 1}
        if off:
            FAILURES.append(f"tools: parity_check.{name} off route 1: {off}")


def trace_rows(what: str, make_trace):
    """trace_summary's rows of the trace `make_trace()` writes (it returns
    the trace's path or directory), taken again once when it holds no
    device event; None, a failure, when the second is empty too."""
    from qagnn_tpu_torch.tools import trace_summary

    for attempt in (1, 2):
        path = make_trace()
        try:
            return path, trace_summary.summarise(path)
        except trace_summary.NoDeviceEvents as exc:
            log(f"  trace_summary, {what}, attempt {attempt}: {exc}")
    FAILURES.append(f"tools: {what}: no device events in two traces")
    return path, None


def check_trace(what: str, rows, calls, card, retake=False) -> bool:
    """Log the trace's device ops and fail unless its counts of the
    kernels of rows 6-12 are those that `calls` ((entry point, route) ->
    calls) launch. With `retake`, a trace that holds fewer launches of some
    kernels than were made and more of none is not a failure but False,
    for the caller to trace again: the profiler drops an event now and then
    (on an H100 a trace once held two of three edge_moments_kernel
    launches), while a name the map gets wrong reads the same in every
    trace."""
    from qagnn_tpu_torch.tools import trace_summary as ts

    want = ts.expected_kernels(calls)
    got = ts.kernel_counts(rows)
    total = sum(r.ms for r in rows)
    ours = [r for r in rows if ts.kernel_base(r.name) in want]
    ours_ms = sum(r.ms for r in ours)
    log(f"  {what}: device op time {total:.3f} ms, rows 6-12's kernels "
        f"{ours_ms:.3f} ms ({100 * ours_ms / max(total, 1e-9):.1f}%), "
        f"torch's ops {total - ours_ms:.3f} ms  [{card}]")
    log(f"    {'ms':>9} {'%':>5} {'n':>5} {'us a launch':>11}  op")
    for r in rows[:14] + [r for r in ours if r not in rows[:14]]:
        log(f"    {r.ms:9.3f} {100 * r.ms / max(total, 1e-9):5.1f} "
            f"{r.count:5d} {1e3 * r.ms / r.count:11.1f}  {r.name[:100]}")
    bad = {k: (got.get(k, 0), n) for k, n in want.items()
           if got.get(k, 0) != n}
    log(f"    rows 6-12 by __global__ name, trace / launched: " + ", ".join(
        f"{k} {got.get(k, 0)}/{n}" for k, n in sorted(want.items()))
        + (f"  MISMATCH {bad}" if bad else "  ok"))
    if bad and retake and all(g < n for g, n in bad.values()):
        log("    fewer launches in the trace than were made: traced again")
        return False
    if bad:
        FAILURES.append(f"tools: {what}: kernel counts {bad}")
    return True


def step_calls(D, k, dt, n_rel, n_steps) -> dict:
    """(entry point, route) -> calls of rows 6-12 in `n_steps` train steps of
    QAGNNMessagePassing at gnn_dim D, k layers, 4 heads, n_rel relations
    with the self loop, on the routes the wrappers' rules give these
    widths."""
    Dk, HDk = gk.kernel_widths(D, D, HEADS)
    routes = {"gat_pass_a_scores": gk._fwd_route(dt, Dk, HDk, HEADS, None),
              "gat_pass_c": gk._fwd_route(dt, Dk, HDk, HEADS, None),
              "gat_bwd_pass1": gk._edge_route(
                  dt, None, Dk, len(gk.launches(HDk, HEADS)) == 1),
              "gat_bwd_pass2": gk._edge_route(
                  dt, None, Dk, len(gk.launches(HDk, HEADS)) == 1),
              "gat_bwd_dw": gk._bwd_route(dt, None),
              "edge_hidden": ek._hidden_route(dt, D, n_rel, N_NTYPE),
              "edge_hidden_bwd": ek._hidden_route(dt, D, n_rel, N_NTYPE)}
    return {(name, routes.get(name)): n * n_steps
            for name, n in step_launches(k).items()}


def tools_profile_step(card) -> None:
    """`python -m qagnn_tpu_torch.tools.profile_step` at its full shapes
    with the kernels, run as its users run it, in a process of its own (in
    this long process the profiler at times dropped one of the traced
    steps' edge_moments_kernel records, ROADMAP C15), its trace read by
    trace_summary: rows 6-12's __global__ kernels as often as the traced
    steps launch them on the routes the wrappers' rules give."""
    from qagnn_tpu_torch.tools import profile_step

    shapes = profile_step.Shapes()
    calls = step_calls(shapes.D, shapes.k, torch.bfloat16,
                       profile_step.N_ETYPE + 1, profile_step.TRACED_STEPS)
    with tempfile.TemporaryDirectory(prefix="qagnn_prof_") as tmp:
        runs = []

        def make_trace():
            out = f"{tmp}/{len(runs)}"
            runs.append(run_tool(["qagnn_tpu_torch.tools.profile_step",
                                  "--trace-dir", out],
                                 "python -m qagnn_tpu_torch.tools."
                                 "profile_step"))
            if runs[-1] is not None:
                log(f"  profile_step printed: {runs[-1].split()}")
            return out

        for attempt in (1, 2):
            path, rows = trace_rows("profile_step", make_trace)
            if rows is None or runs[-1] is None:
                return
            log(f"  trace {pathlib.Path(path).stat().st_size / 2 ** 20:.1f} "
                f"MiB of {profile_step.TRACED_STEPS} traced steps")
            if check_trace("profile_step's trace", rows, calls, card,
                           retake=attempt == 1):
                break


def start_tool(argv) -> tuple:
    """Start `python -m ...` from the repository root."""
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", *argv], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=pathlib.Path(__file__).resolve().parent)


def finish_tool(started, what, timeout=600) -> str | None:
    """Wait for a command `start_tool` started: its stdout, or None (a
    failure) when it exits with another code than 0 or outlasts
    `timeout` seconds (then it is killed)."""
    t0, proc = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    log(f"  {what}: exit {proc.returncode} in {time.perf_counter() - t0:.1f}"
        " s")
    if proc.returncode != 0:
        log(out[-3000:] + err[-3000:])
        FAILURES.append(f"tools: {what} exited {proc.returncode}")
        return None
    return out


def run_tool(argv, what, timeout=600) -> str | None:
    return finish_tool(start_tool(argv), what, timeout)


REHEARSAL = (["qagnn_tpu_torch.tools.dress_rehearsal", "--synthetic",
              "--train"], "dress_rehearsal --synthetic --train")


def tools_rehearsal(out) -> None:
    """The report of `dress_rehearsal --synthetic --train` run on the card
    as a command: status OK, the step-0 encoder on the card within 2e-3 of
    the CPU's, and rows 6-12 launched."""
    if out is None:
        return
    for line in out.splitlines()[:-1]:
        if line.startswith("|"):
            log("    " + line)
    report = json.loads(out.strip().splitlines()[-1])
    launches = report.get("launches", {})
    log(f"    report: status {report.get('status')}, device "
        f"{report.get('device')}, sent_vec_max_rel "
        f"{report.get('sent_vec_max_rel')}, step0_loss "
        f"{report.get('step0_loss')}, train_losses "
        f"{report.get('train_losses')}, launches {launches}")
    checks = {"status OK": report.get("status") == "OK",
              "on the card": report.get("device") == "cuda",
              "sent_vecs within 2e-3": report.get("sent_vec_max_rel", 1.0)
              < 2e-3,
              "rows 6-12 launched": all(
                  launches.get(n, 0) > 0 for n in step_launches(1))}
    for what, ok in checks.items():
        if not ok:
            FAILURES.append(f"tools: dress_rehearsal {what}")


def tools_cli_trace(card) -> None:
    """`python -m qagnn_tpu_torch.cli` training on a synthetic set of two
    steps an epoch with --profile_dir over both: trace_summary lists rows
    6-12's kernels as often as two train steps launch them (on the routes
    the wrappers' rules give the run's widths)."""
    from qagnn_tpu_torch.data.synthetic import (
        write_synthetic_dataset,
        write_tiny_bert_checkpoint,
    )
    from qagnn_tpu_torch.tools.dress_rehearsal import SYNTHETIC_RELATIONS
    from qagnn_tpu_torch.utils.config import TrainConfig

    base = TrainConfig()
    D, k = base.gnn_dim, base.k
    Dk, HDk = gk.kernel_widths(D, D, HEADS)
    calls = step_calls(D, k, torch.bfloat16, SYNTHETIC_RELATIONS + 1,
                       TOOLS_CLI_TRACED)
    with tempfile.TemporaryDirectory(prefix="qagnn_cli_prof_") as tmp:
        emb_path = write_synthetic_dataset(f"{tmp}/data",
                                           n_questions=TOOLS_CLI_QUESTIONS)
        enc_dir = write_tiny_bert_checkpoint(f"{tmp}/bert")
        splits = [f"--{split}_{kind}={tmp}/data/{sub}/{split}.{ext}"
                  for split in ("train", "dev", "test")
                  for kind, sub, ext in (
                      ("statements", "statement", "statement.jsonl"),
                      ("adj", "graph", "graph.adj.pk"))]
        runs = []

        def make_trace():
            prof = f"{tmp}/prof{len(runs)}"
            runs.append(run_tool(
                ["qagnn_tpu_torch.cli", "--mode", "train", "--dataset",
                 "csqa", "--encoder", "bert-base-uncased", "--encoder_load",
                 enc_dir, "--inhouse", "false", "--batch_size", "4",
                 "--mini_batch_size", "4", "--eval_batch_size", "4",
                 "--n_epochs", "1", "--max_seq_len", "24", "--max_node_num",
                 "8", "--num_relation", str(SYNTHETIC_RELATIONS),
                 "--ent_emb_paths", emb_path, "--save_dir", f"{tmp}/out",
                 "--profile_dir", prof, "--profile_start_step", "0",
                 "--profile_num_steps", str(TOOLS_CLI_TRACED), *splits],
                "python -m qagnn_tpu_torch.cli with --profile_dir"))
            return prof

        for attempt in (1, 2):
            path, rows = trace_rows("the CLI's --profile_dir trace",
                                    make_trace)
            if rows is None or runs[-1] is None:
                return
            for line in runs[-1].splitlines():
                if "profiler trace" in line or "| epoch" in line:
                    log("    " + line)
            if check_trace(f"the CLI's trace of {TOOLS_CLI_TRACED} train "
                           f"steps at gnn_dim {D} (kernels at {Dk} x {HDk})",
                           rows, calls, card, retake=attempt == 1):
                break


def phase_tools(dev, card) -> None:
    """The port's tools on the card: the parity bands, profile_step's trace
    through trace_summary, the dress rehearsal and the CLI's profiler
    path, and the phase's seconds."""
    t0 = time.perf_counter()
    tools_parity(dev, card)
    tools_profile_step(card)
    # the rehearsal's command runs beside the CLI's: each process counts
    # and traces its own launches, and the CLI trace's device times are
    # taken beside the rehearsal's work
    rehearsal = start_tool(REHEARSAL[0])
    try:
        tools_cli_trace(card)
    finally:
        out = finish_tool(rehearsal, REHEARSAL[1])
    tools_rehearsal(out)
    log(f"  the tools phase took {time.perf_counter() - t0:.1f} s ({card})")


# ---------------------------------------------------------------------------
# the widths phase: relation ids past n_rel, the unprojected op at widths
# one launch does not take, and the GNN at gnn_dim 512 and 1040
# ---------------------------------------------------------------------------

WIDE_D, WIDE_K = 512, 5        # gnn_dim 512: 4 heads of 128, k = 5
# gnn_dim 1040: 4 heads of 260 features, padded to 264, each run as two
# column slices (128 + 136) in rows 6-9
WIDER_D = 1040
# (HD, heads) of the unprojected op; the last two have a head wider than a
# launch (304 after padding: two slices; 520: three)
WIDE_UNPROJ = ((100, 4), (320, 10), (300, 1), (1040, 2))
OUT_OF_RANGE = 0.1             # live slots given relation ids n_rel, n_rel+1
# the GNN at gnn_dim 512 and 1040 on the kernel path against the scatter
# path, same
# weights and inputs, train mode, dropout 0, each in its dtype: the output
# as GNN_TOL holds it; every parameter gradient against one reference that
# holds still, the scatter path in f64 (`reference_grads`). In f32 each
# draw of the kernel path within STEP_TOL's named-gradient tolerance of the
# model's largest (sums of other orders, the edge rows' closed-form
# moments, k layers and two BatchNorms), and the mean of its
# WIDE_GRAD_DRAWS draws within twice the mean of as many draws of the f32
# scatter path (`grad_spread`). In bf16
# both paths' gradients drift from the reference by several percent of the
# largest (the edge encoder's W0 collects every layer's edge cotangent: 4-14%
# on the CPU with the kernels' plain versions, at gnn_dim 200 and 512, the
# kernel path's drift 0.5-1.3 times the scatter path's), so the kernel
# path's bf16 drift is held to twice the scatter path's in the same run
WIDE_GRAD_TOL = STEP_TOL["grad"]
WIDE_BF16_DRIFT = 2.0
# draws of each f32 path in `grad_spread`. Each path's gap from the f64
# reference spreads by a factor of 7 from run to run on an H100 at gnn_dim
# 1040 (scatter 1.6e-4 to 1.1e-3, kernel 2.8e-4 to 1.2e-3, means 6.8e-4 and
# 8.2e-4): resampling 51 draws of each, the mean of nine against twice the
# mean of nine fails a correct tree about once in 800 runs (the median of
# three against twice the median of three: once in 15) and still fails a
# kernel path 2.5 times the scatter path's in 94 runs of 100
WIDE_GRAD_DRAWS = 9
WIDE_CLI_QUESTIONS = 8         # two train steps of 4 questions


# the single-launch functions of rows 1 and 3-9 (the denominators run one
# launch a head group, unsplit), the one demb product of a pass of rows 8
# and 9 of several launches and the one dW product of every pass of rows 8
# and 9: (module, name, its plain version, the
# arguments the plain version takes, the arguments a launch adds to in
# place, tolerance by dtype)
LAUNCH_ROWS = (
    (gk, "_pass_a_scores", gk.pass_a_scores_plain, 9, (), lambda dt: TOL["gat"]),
    (gk, "_pass_c", gk.pass_c_plain, 12, (10,), lambda dt: TOL["gat_c"][dt]),
    (gk, "_bwd_pass1", gk.bwd_pass1_plain, 15, (12, 13),
     lambda dt: TOL["bwd"][dt]),
    (gk, "_bwd_pass2", gk.bwd_pass2_plain, 17, (13, 14, 15),
     lambda dt: TOL["bwd"][dt]),
    (gk, "bwd_demb", gk.bwd_demb_plain, 3, (2,), lambda dt: TOL["bwd"][dt]),
    (gk, "bwd_dw", gk.bwd_dw_plain, 2, (), lambda dt: TOL["bwd"][dt]),
    (uk, "_edge_scores", uk.edge_scores_plain, 7, (),
     lambda dt: TOL["unproj"][dt]),
    (uk, "_aggregate", uk.aggregate_plain, 9, (7,),
     lambda dt: TOL["unproj"][dt]),
    (uk, "_bwd1", uk.bwd1_plain, 11, (8, 9), lambda dt: TOL["unproj"][dt]),
    (uk, "_bwd2", uk.bwd2_plain, 13, (10, 11), lambda dt: TOL["unproj"][dt]))


def launch_gap(got, want) -> float:
    """max|got - want| / max|want| over the finite entries of want; a max
    left at NEG (a graph with no live slot, or a split head's slices before
    the last) must be NEG in both, and a non-finite got is inf."""
    got, want = got.float(), want.float()
    unset = want <= gk.NEG / 2
    if bool((got[unset] != want[unset]).any()) \
            or not bool(torch.isfinite(got).all()):
        return float("inf")
    got, want = got[~unset], want[~unset]
    if not want.numel():
        return 0.0
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


class LaunchCheck:
    """Holds every launch of rows 1 and 3-9 (and rows 8 and 9's demb and
    dW products) made inside it against its plain version on the same inputs (what a launch adds to in place copied for
    the plain version first; a split head's partial mode included): the
    largest gap (`launch_gap`) over each entry point's launches and outputs,
    a failure above the row's tolerance. These launches count as the path's
    own; the plain versions launch nothing."""

    def __init__(self, what, dt):
        self.what, self.dt = what, dt
        self.gaps, self.calls = {}, collections.Counter()
        self.stack = contextlib.ExitStack()

    def __enter__(self):
        for mod, name, plain, n_args, in_place, tol in LAUNCH_ROWS:
            self.stack.enter_context(mock.patch.object(
                mod, name, self.wrap(name, getattr(mod, name), plain, n_args,
                                     in_place, tol(self.dt))))
        return self

    def __exit__(self, *exc):
        self.stack.close()

    def wrap(self, name, fn, plain, n_args, in_place, tol):
        def call(*a, **part):
            copy_ = lambda x: x.clone() if torch.is_tensor(x) else x  # noqa
            pa = [copy_(x) if i in in_place else x
                  for i, x in enumerate(a[:n_args])]
            pk = {k: copy_(v) for k, v in part.items()}
            want = plain(*pa, **pk)
            got = fn(*a, **part)
            pair = list(zip(got, want)) if isinstance(got, tuple) \
                else [(got, want)]
            # a launch of a pass of several leaves its dW to `bwd_dw`
            # (None on both sides)
            gap = max(float("inf") if (g is None) != (w is None)
                      else 0.0 if g is None else launch_gap(g, w)
                      for g, w in pair)
            self.calls[name] += 1
            old = self.gaps.get(name, (0.0, tol))[0]
            self.gaps[name] = (max(old, gap), tol)
            return got
        return call

    def report(self):
        for name, (gap, tol) in sorted(self.gaps.items()):
            ok = gap <= tol
            log(f"  each launch vs its plain version, {name} {self.what}: "
                f"{self.calls[name]} launches, largest max|d| / max|want| "
                f"{gap:.3e}  tol {tol:.1e}  {'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"widths: {name} launch vs plain, "
                                f"{self.what}")


def csrc_kernel(key) -> bool:
    """Whether a profiler key names a kernel of qagnn_tpu_torch/csrc (an
    anonymous namespace's `__global__`), not one of torch's."""
    return re.match(r"(void )?\(anonymous namespace\)::", key) is not None


def unproj_row_times(vals, gout, src, dst, mask, heads, tag, card):
    """Rows 1-5 alone on the op's inputs, as gat_unprojected_forward and
    _backward run them: each wrapper's device time a call (all its
    launches, and whatever it does around them), beside its launches'
    device time alone (torch.profiler, the csrc kernels of the call: what
    the call would take with nothing copied around them) and their ratio;
    its plain version's on the whole width, and the bound of the call's
    work, counted as the kernel phase counts it."""
    nq, nk, nm, ekb, emb, skb, smb = vals
    HD = nq.shape[-1]
    live = mask.float().mean().item()
    s, m_edge = uk.edge_scores(nq, nk, ekb, src, dst, mask, heads)
    self_scores = gk.head_sum(nq.float() * (nk + skb).float(), heads)
    gmax = torch.maximum(m_edge, self_scores.amax(1))
    e_self = torch.exp(self_scores - gmax[:, None, :])
    e_edge, denom, deg = uk.edge_denoms(s, gmax, src, mask, N)
    denom_raw = denom + e_self
    scale = (deg[..., None] + 1.0) / torch.clamp_min(denom_raw, gk.DENOM_EPS)
    out = torch.zeros((G, N, HD), device=nq.device)
    g = gout.float()
    dnm0, ds0 = torch.zeros_like(out), torch.zeros_like(scale)
    demb, dalpha, _, dscale = uk.bwd1(gout, nm, emb, e_edge, scale, src, dst,
                                      mask, dnm0.clone(), ds0.clone(), heads)
    d_denom = (-(scale / torch.clamp_min(denom_raw, gk.DENOM_EPS)) * dscale
               * (denom_raw > gk.DENOM_EPS).float()).contiguous()
    a1 = (nq, nk, ekb, src, dst, mask, heads)
    a2 = (s, gmax, src, mask, N)
    a3 = (nm, emb, e_edge, scale, src, dst, mask, out, heads)
    a4 = (gout, nm, emb, e_edge, scale, src, dst, mask, dnm0, ds0, heads)
    a5 = (nq, nk, ekb, e_edge, dalpha, scale, d_denom, src, dst, mask,
          dnm0, dnm0.clone(), heads)
    n = G * E * HD
    for name, fn, plain, args, n_bytes, flops in (
            ("gat_unproj_scores", uk.edge_scores, uk.edge_scores_plain, a1,
             live * nbytes(ekb, src, dst) + nbytes(nq, nk, mask, s, m_edge),
             3.0 * live * n),
            ("gat_unproj_denoms", uk.edge_denoms, uk.edge_denoms_plain, a2,
             live * nbytes(s, src) + nbytes(gmax, mask, e_edge, denom, deg),
             2.0 * live * G * E * heads),
            ("gat_unproj_aggr", uk.aggregate, uk.aggregate_plain, a3,
             live * nbytes(emb, e_edge, src, dst) + nbytes(nm, scale, mask)
             + 2 * nbytes(out), 4.0 * live * n),
            ("gat_unproj_bwd1", uk.bwd1, uk.bwd1_plain, a4,
             live * nbytes(emb, e_edge, src, dst)
             + nbytes(gout, nm, scale, mask, demb, dalpha)
             + 2 * nbytes(dnm0, ds0), 6.0 * live * n),
            ("gat_unproj_bwd2", uk.bwd2, uk.bwd2_plain, a5,
             live * nbytes(ekb, e_edge, dalpha, src, dst)
             + nbytes(nq, nk, scale, d_denom, mask, demb)
             + 4 * nbytes(dnm0), 7.0 * live * n)):
        # the accumulators are added to again: the values do not matter
        _build.reset_launch_counts()
        fn(*args)
        launches = _build.LAUNCHES[name]
        ms = device_ms(lambda: fn(*args), iters=5, warmup=1)
        rows = profile_kernels(f"{name} {tag}", lambda: fn(*args), iters=5,
                               keep=csrc_kernel, show=0)
        alone = "not measured" if rows is None else \
            f"{sum(us for us, _, _ in rows) / 5e3:.4f} ms"
        ratio = "" if rows is None else \
            f" (call / launches {ms / (sum(r[0] for r in rows) / 5e3):.2f})"
        plain_ms = device_ms(lambda: plain(*args), iters=5, warmup=1)
        bound_ms, by = bound(n_bytes, flops, torch.float32)
        log(f"  time {name} {tag}: {launches} launches, kernels {ms:.4f} ms "
            f"a call, its launches alone {alone}{ratio}  plain "
            f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({by})  [{card}]")


def widths_split_forward(gen, dev):
    """Passes A and C at D = 200 with one head of 304 features (two column
    slices of 152), on both routes in bf16 (the tensor-core kernels' partial
    mode) and route 0 in f32, against the unsliced plain versions and each
    launch against its plain version (`LaunchCheck`)."""
    src, dst, mask = graph_inputs(gen, dev, E)
    for dt in (torch.bfloat16, torch.float32):
        tag = f"D=200 HD=304 heads=1 {dt}"
        with LaunchCheck(tag, dt) as check:
            gat_fwd_case(None, gen, dev, 200, 304, 1, src, dst, mask, dt, tag,
                         False)
        check.report()


def widths_relation_ids(gen, dev):
    """Rows 10-12 at the OBQA preset's F = 47 (39 relations with the self
    loop, 4 node types) and D = 200, a tenth of the live slots given ids
    n_rel and n_rel + 1: the moments exactly, the hidden pass and its
    backward on both routes in both dtypes at the tolerances of their own
    phases, against their plain versions, which give such a slot no
    relation feature; then rows 11 and 12 so at the default gnn_dim 100,
    from a generator of their own."""
    n_rel = 39
    F = n_rel + 2 * N_NTYPE
    for D, gen_ in ((200, gen), (100, torch.Generator(device=dev)
                                 .manual_seed(SEED + 50))):
        w0 = torch.randn((F, D), generator=gen_, device=dev) * 0.2
        b0, a, b = (torch.randn(D, generator=gen_, device=dev) * 0.5
                    for _ in range(3))
        for n_edges in (E, E - 3):
            etype, src, dst, ntype, mask = encoder_ints(gen_, dev, n_edges,
                                                        n_rel)
            wild = mask & (torch.rand(mask.shape, generator=gen_, device=dev)
                           < OUT_OF_RANGE)
            etype = torch.where(wild, n_rel + (torch.rand(
                mask.shape, generator=gen_, device=dev) < 0.5).int(), etype)
            log(f"  D={D} E={n_edges}: {int(wild.sum())} of "
                f"{int(mask.sum())} live slots with ids {n_rel} or "
                f"{n_rel + 1}")
            ints = (etype, src, dst, ntype, mask, n_rel, N_NTYPE)
            if D == 200:
                got = ek.edge_feature_moments(*ints)
                want = ek.edge_feature_moments_plain(*ints)
                for name, g, w in zip(("hist", "M", "n"), got, want):
                    compare(f"edge_moments {name} ids past n_rel "
                            f"E={n_edges}", g, w, 0.0)
            args = (etype, src, dst, ntype, w0, b0, a, b, n_rel, N_NTYPE)
            for dt in (torch.float32, torch.bfloat16):
                tag = f"ids past n_rel D={D} E={n_edges} {dt}"
                edge_hidden_case(None, args, dt, tag, False)
                dh = torch.randn((G, n_edges, D), generator=gen_,
                                 device=dev).to(dt)
                edge_hidden_bwd_case(None, args[:8] + (dh,) + args[8:], dt,
                                     tag, False)


def op_launches(HD, heads) -> dict:
    """Launches of rows 1-5 in one forward + backward of the unprojected op:
    one a head group or a column slice of a wide head (`gk.launches`), the
    denominators one a group of at most 8 heads."""
    n = len(gk.launches(uk._padded(HD, heads), heads))
    return {k: len(gk.head_groups(heads, heads))
            if k == "gat_unproj_denoms" else n for k in UNPROJ_KERNELS}


def wide_unproj_inputs(gen, dev, HD, heads, dt):
    """The unprojected op's seven inputs (the query scaled by 1/sqrt of a
    head's features) and an output cotangent at (HD, heads), in dt."""
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    nq = (r(G, N, HD) / (HD // heads) ** 0.5).to(dt)
    rest = [(r(G, n, HD) * 0.5).to(dt) for n in (N, N, E, E, N, N)]
    return [nq, *rest], r(G, N, HD).to(dt)


def widths_unprojected(gen, dev, card):
    """Rows 1-5 through `relational_gat_attention_nodes` (no backend
    named), forward and backward, at widths one launch does not take, in
    both dtypes, against the scatter backend in f32 as the op phase holds
    them; each row launched once a head group or a column slice of a wide
    head, every launch held against its plain version (`LaunchCheck`); at
    a wide head each row's time in bf16 (`unproj_row_times`)."""
    for HD, heads in WIDE_UNPROJ:
        dph = HD // heads
        src, dst, mask = graph_inputs(gen, dev, E)
        split = lambda t: t.reshape(*t.shape[:-1], heads, dph)  # noqa: E731
        launches = op_launches(HD, heads)

        def op(backend):
            return lambda *t: relational_gat_attention_nodes(
                *(split(x) for x in t), src, dst, mask, backend=backend)

        for dt in (torch.bfloat16, torch.float32):
            tag = f"HD={HD} heads={heads} {dt}"
            vals, gout = wide_unproj_inputs(gen, dev, HD, heads, dt)
            _build.reset_launch_counts()
            out, got = value_and_grads(op(None), vals, gout)
            torch.cuda.synchronize()
            counts, routes = dict(_build.LAUNCHES), dict(_build.ROUTES)
            ok = counts == launches
            log(f"  launches, {tag}: {counts} (want {launches}; routes "
                + ", ".join(f"{k} {r_}: {c}" for (k, r_), c in
                            sorted(routes.items()))
                + f")  {'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"widths: launches of the op, {tag}")
            if uk._padded(HD, heads) // heads > gk.MAX_COLS:
                with LaunchCheck(tag, dt) as check:
                    value_and_grads(op(None), vals, gout)
                check.report()
                if dt == torch.bfloat16:
                    unproj_row_times(vals, gout, src, dst, mask, heads, tag,
                                     card)
            out_w, want = value_and_grads(op("scatter"),
                                          [v.float() for v in vals], gout)
            compare(f"op out cuda vs scatter(f32), {tag}", out, out_w,
                    OP_TOL[dt]["out"])
            for k, g, w in zip(UNPROJ_INPUTS, got, want):
                compare(f"op d{k} cuda vs scatter(f32), {tag}", g, w,
                        OP_TOL[dt]["grad"])
            leaves = [v.detach().clone().requires_grad_() for v in vals]
            ms = device_ms(lambda: forward_backward(op(None), leaves, gout),
                           iters=5, warmup=1)
            log(f"  time {tag}: forward + backward {ms:.4f} ms  [{card}]")
            if dt == torch.bfloat16 and uk._padded(HD, heads) // heads \
                    > gk.MAX_COLS:
                # each row's launches alone (the wrappers' copies and pads
                # are torch's kernels)
                profile_kernels(f"op forward + backward {tag}",
                                lambda: forward_backward(op(None), leaves,
                                                         gout), iters=5,
                                keep=lambda key: re.match(
                                    r"(void )?\(anonymous namespace\)::",
                                    key))


def gnn_run(dev, backend, dt, cot, width, check=None):
    """One train-mode forward + backward of QAGNNMessagePassing at gnn_dim
    `width` (k = 5, 4 heads, 38 relations, dropout 0) on one path in one
    compute dtype (f64 on the scatter path: the reference), weights and
    inputs from fixed seeds (H in f32 whatever the dtype, so that the score
    basis is the same), inside `check` (a LaunchCheck) where given:
    (output in f32, parameter gradients in f32, launches)."""
    n_etype = 38
    with torch.device(dev):
        mp = QAGNNMessagePassing(WIDE_K, N_NTYPE, n_etype, width,
                                 dropout=0.0, head_count=HEADS,
                                 backend=backend, dtype=dt)
    init_weights(mp, torch.Generator(device=dev).manual_seed(SEED), 0.02)
    g_in = torch.Generator(device=dev).manual_seed(SEED + 1)
    src, dst, mask = graph_inputs(g_in, dev, E)
    H = torch.randn((G, N, width), generator=g_in, device=dev) \
        .requires_grad_()
    args = (torch.randint(0, N_NTYPE, (G, N), generator=g_in, device=dev),
            torch.rand((G, N), generator=g_in, device=dev), src, dst,
            torch.randint(0, n_etype + 1, (G, E), generator=g_in,
                          device=dev, dtype=torch.int32), mask)
    _build.reset_launch_counts()
    with check or contextlib.nullcontext():
        out = mp.train()(H, *args)
        (out.float() * cot).sum().backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.float() for n, p in mp.named_parameters()
             if p.grad is not None}
    if not bool(torch.isfinite(out).all()) or not all(
            bool(torch.isfinite(g).all()) for g in grads.values()):
        FAILURES.append(f"widths: non-finite values at gnn_dim {width}, "
                        f"{backend} {dt}")
    return out.detach().float(), grads, dict(_build.LAUNCHES)


def grad_gap(got, want) -> tuple[float, str]:
    """The largest max|got - want| of a parameter over the largest
    max|want| of the model, and that parameter's name."""
    if sorted(got) != sorted(want):
        FAILURES.append("widths: the two paths' gradients name other "
                        "parameters")
    top = max(float(w.abs().max()) for w in want.values())
    return max(((g - want[n]).abs().max().item() / top, n)
               for n, g in got.items())


def reference_grads(dev, cot, width):
    """The f64 reference of the widths phase's gradient checks (ROADMAP
    C14): the scatter path of `gnn_run` built in float64 (BatchNorm's batch
    moments too), the same weights, inputs and cotangent, under torch's
    deterministic algorithms (warn_only: the ops without one are named);
    its parameter gradients, and a checksum that shows it holds still from
    run to run."""
    was = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            _, ref, _ = gnn_run(dev, "scatter", torch.float64, cot, width)
        finally:
            torch.use_deterministic_algorithms(was)
    loose = sorted({str(w.message).split(" does not have")[0][:80]
                    for w in caught if "deterministic" in str(w.message)})
    checksum = sum(float(g.double().abs().sum()) for g in ref.values())
    log(f"  f64 reference at gnn_dim {width}: the scatter path in float64, "
        f"deterministic; sum of |grad| over every parameter {checksum!r}; "
        f"ops without a deterministic algorithm: {loose or 'none'}")
    return ref


def widths_gnn(gen, dev, card, width, reports=None):
    """Rows 6-12 in a train-mode forward + backward of QAGNNMessagePassing
    at gnn_dim `width` (k = 5, 4 heads; at 512 two head groups of 256
    columns a pass; at 1040 four heads of 264 padded features, each two
    column slices; past D = 256 backward passes 1 and 2 stream W's rows),
    on the kernel path against the scatter path, in both dtypes: the
    output, every parameter gradient against the f64 reference
    (`reference_grads`; bf16: the kernel path's drift beside the bf16
    scatter path's; f32: `grad_spread`), each entry point's launches and
    routes; past 512 every launch of rows 6-9 against its plain version
    (`LaunchCheck`)."""
    HDk = gk.kernel_widths(width, width, HEADS)[1]
    cot = torch.randn((G, N, width), generator=gen, device=dev)
    ref = reference_grads(dev, cot, width)
    for dt in (torch.bfloat16, torch.float32):
        name = "bf16" if dt == torch.bfloat16 else "f32"
        # rows 6-9 a launch a head group or column slice; rows 11 and 12 one
        # call over all of D's column slices; a backward pass of several
        # launches one demb product
        n_launches = len(gk.launches(HDk, HEADS))
        per = dict.fromkeys(("gat_pass_a_scores", "gat_pass_c",
                             "gat_bwd_pass1", "gat_bwd_pass2"), n_launches)
        launches = {n: c * per.get(n, 1)
                    for n, c in step_launches(WIDE_K).items()}
        if n_launches > 1:
            launches["gat_bwd_demb"] = 2 * WIDE_K
        check = LaunchCheck(f"gnn_dim {width} {name}", dt) \
            if width > WIDE_D else None
        out, grads, counts = gnn_run(dev, "cuda", dt, cot, width, check)
        routes = dict(_build.ROUTES)
        if width == WIDE_D and dt == torch.bfloat16 and reports is not None:
            # the demb kernel's path: the GNN past one launch a pass
            reports["gat_bwd_demb"]["launches"] = counts.get("gat_bwd_demb",
                                                             0)
        if check is not None:
            check.report()
        want, want_grads, none = gnn_run(dev, "scatter", dt, cot, width)
        ok = counts == launches and not none
        log(f"  launches, one train forward + backward at gnn_dim {width}, "
            f"{name}: {counts} (want {launches}; scatter {none})  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"widths: launches at gnn_dim {width}, {name}")
        off = [k for k in ROUTED if routes.get((k, 0))]
        log("  routes, " + ", ".join(f"{k} {r}: {c}" for (k, r), c in
                                     sorted(routes.items()))
            + f"  {'ok' if not off else 'FAIL'}")
        if off:
            FAILURES.append(f"widths: routes at gnn_dim {width}, {name}")
        compare(f"GNN out at gnn_dim {width}, kernel vs scatter, {name}",
                out, want, GNN_TOL[dt])
        if dt == torch.float32:
            grad_spread(dev, cot, width, grads, want_grads, ref)
            continue
        gap, worst = grad_gap(grads, ref)
        base, base_worst = grad_gap(want_grads, ref)
        tol = WIDE_BF16_DRIFT * base
        ok = gap <= tol
        log(f"  GNN parameter gradients at gnn_dim {width}, kernel path "
            f"{name}: largest max|d| / max|grad| {gap:.3e} ({worst}) vs the "
            f"f64 reference, tol {tol:.3e} = {WIDE_BF16_DRIFT:g} x the bf16 "
            f"scatter path's {base:.3e} ({base_worst})  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"widths: gradients at gnn_dim {width}, {name}")


def grad_spread(dev, cot, width, kernel, scatter, ref):
    """The f32 gradient check (ROADMAP C14): the checked run of each path
    and WIDE_GRAD_DRAWS - 1 more on the same inputs, each draw's gap from
    the f64 reference as `grad_gap` reads it, with the parameter that sets
    it. Every kernel-path draw must lie within WIDE_GRAD_TOL of the
    reference, and the mean of the kernel path's gaps within WIDE_BF16_DRIFT
    times the mean of the f32 scatter path's: both paths' gaps spread from
    run to run (their sums take the atomics' order), so each side is
    estimated from all of its draws, and no few lucky draws of either path
    decide. Each path's spread against itself is logged beside."""
    def runs(backend, n=WIDE_GRAD_DRAWS - 1):
        return [gnn_run(dev, backend, torch.float32, cot, width)[1]
                for _ in range(n)]

    def spread(xs):
        gaps = [grad_gap(a, b)[0]
                for i, a in enumerate(xs) for b in xs[i + 1:]]
        return f"{min(gaps):.3e} to {max(gaps):.3e}"

    kernel, scatter = [kernel] + runs("cuda"), [scatter] + runs("scatter")
    k_gaps = [grad_gap(x, ref) for x in kernel]
    s_gaps = [grad_gap(x, ref) for x in scatter]
    k_mean = statistics.fmean(g for g, _ in k_gaps)
    s_mean = statistics.fmean(g for g, _ in s_gaps)
    ok_abs = all(g <= WIDE_GRAD_TOL for g, _ in k_gaps)
    ok_rel = k_mean <= WIDE_BF16_DRIFT * s_mean
    fmt = lambda gaps: ", ".join(f"{g:.3e} ({n})" for g, n in gaps)  # noqa
    log(f"  GNN parameter gradients at gnn_dim {width}, f32, largest max|d| "
        f"/ max|grad| of each draw vs the f64 reference: kernel path "
        f"{fmt(k_gaps)}; scatter path {fmt(s_gaps)}; every kernel draw "
        f"under {WIDE_GRAD_TOL:.1e}  {'ok' if ok_abs else 'FAIL'}; kernel "
        f"mean {k_mean:.3e} under {WIDE_BF16_DRIFT:g} x the scatter "
        f"mean {s_mean:.3e} = {WIDE_BF16_DRIFT * s_mean:.3e}  "
        f"{'ok' if ok_rel else 'FAIL'}")
    log(f"  f32 gradient spread at gnn_dim {width} (pairs of draws): "
        f"kernel path against itself {spread(kernel)}; scatter path against "
        f"itself {spread(scatter)}")
    if not (ok_abs and ok_rel):
        FAILURES.append(f"widths: f32 gradients at gnn_dim {width} vs the "
                        "f64 reference")


def bwd_launches_by_kernel(rows, iters, n_launches, what, dt):
    """A backward pass on its default route from torch.profiler's rows of
    `iters` calls: the edge kernel once a column launch (past D = 256 it
    streams W's rows in that one launch; bf16 the wgmma kernel,
    `edge_wgmma_kernel`, and never the mma.sync one, `edge_pass_tc_kernel`;
    f32 the other way round), the demb kernel once a call of more than
    one column launch (never in a call of one), the dW kernel
    (`dw_wgmma_kernel`) once a call and the mma.sync dW kernel
    (`dw_tc_kernel`) never, and each one's us a launch. More launches than
    these fail, and so
    does a kernel the profiler recorded no launch of while it recorded
    others; between the two are events the profiler did not record, and
    are logged."""
    from qagnn_tpu_torch.tools.trace_summary import kernel_base
    if rows is None:
        log(f"  {what}: launches by kernel not read (no profiler rows)")
        return
    n, us = collections.Counter(), collections.Counter()
    for t, count, key in rows:
        n[kernel_base(key)] += count
        us[kernel_base(key)] += t
    wgmma = dt == torch.bfloat16
    for k, per_call in (("edge_wgmma_kernel", n_launches if wgmma else 0),
                        ("edge_pass_tc_kernel", 0 if wgmma else n_launches),
                        ("dw_wgmma_kernel", 1), ("dw_tc_kernel", 0),
                        ("demb_tc_kernel", int(n_launches > 1))):
        calls = n[k] / iters
        ok = 0 < calls <= per_call if per_call else calls == 0
        log(f"  {what}: {k} {calls:g} launches a call for {n_launches} "
            f"column launches, {us[k] / max(n[k], 1):.1f} us a launch  "
            f"{'ok' if ok else 'FAIL'}"
            + ("" if calls == per_call or not ok
               else " (the profiler recorded fewer)"))
        if not ok:
            FAILURES.append(f"widths: {k} launches, {what}")


def widths_passes(gen, dev, card, D, HD):
    """Rows 6-9 alone at D x HD (the kernels' widths), 4 heads: passes A and
    C and backward passes 1 and 2 on every route in both dtypes (bf16 rows
    8 and 9 on route 2, the wgmma edge kernel, too) against their plain
    versions, masked slots exactly, at E and E - 3, every launch of the
    four against its plain version (`LaunchCheck`: the streaming kernels,
    a split head's partial mode included); then each call's device time
    with its bound (operations at `tc_peak`; rows 6 and 7 in both dtypes
    (`widths_fwd_times`), rows 8 and 9 in turns with the route they
    replaced on the same inputs, which must be slower: f32 the CUDA-core
    kernels, bf16 the mma.sync edge kernel), and the device time of each
    kernel launch it makes (torch.profiler: one edge kernel a column
    launch of rows 8 and 9, in bf16 also the mma.sync one's),
    rows 11 and 12 at this D too. The backward passes' plain version is
    the unsliced one at every width: a pass of several launches rounds
    demb once, in its one demb product (ROADMAP C17), so in bf16 every
    element of demb lies within one bf16 step of it (`bf16_steps`)."""
    n_launches = len(gk.launches(HD, HEADS))
    for n_edges in (E - 3, E):
        src, dst, mask = graph_inputs(gen, dev, n_edges)
        live = mask.float().mean().item()
        for dt in (torch.float32, torch.bfloat16):
            ftag = f"D={D} HD={HD} E={n_edges} {dt}"
            with LaunchCheck(f"{ftag}, forward", dt) as check:
                gat_fwd_case(None, gen, dev, D, HD, HEADS, src, dst, mask,
                             dt, ftag, False)
            check.report()
            t = gat_bwd_inputs(gen, dev, D, HD, HEADS, src, dst, mask, dt)
            dead = ~mask
            p1 = (t["gout"], t["nm"], t["emb"], t["w_me"], t["b_me"],
                  t["scores"], t["gmax"], t["scale"], src, dst, mask,
                  t["carry"])
            want1 = gk.bwd_pass1_plain(*p1, t["dnm0"].clone(),
                                       t["dscale0"].clone(), HEADS)
            scale, denom_raw = t["scale"], t["denom_raw"]
            d_denom = (-(scale / torch.clamp_min(denom_raw, gk.DENOM_EPS))
                       * want1[3] * (denom_raw > gk.DENOM_EPS).float())
            p2 = (t["nq"], t["nk"], t["emb"], t["w_ke"], t["b_ke"],
                  t["scores"], t["gmax"], want1[1], scale,
                  d_denom.contiguous(), src, dst, mask)
            acc2 = (torch.randn((G, N, HD), generator=gen, device=dev),
                    torch.randn((G, N, HD), generator=gen, device=dev))
            want2 = gk.bwd_pass2_plain(*p2, want1[0].clone(),
                                       *(x.clone() for x in acc2), HEADS)
            # bf16: route 2 (the wgmma edge kernel, the default) and route
            # 1 (the mma.sync one) named
            for route in (0, 1, 2) if dt == torch.bfloat16 else (0, 1):
                tag = f"D={D} HD={HD} E={n_edges} {dt} route {route}"
                _build.reset_launch_counts()
                check = LaunchCheck(tag, dt) if route else None
                with check or contextlib.nullcontext():
                    got1 = gk.bwd_pass1(*p1, t["dnm0"].clone(),
                                        t["dscale0"].clone(), HEADS,
                                        _route=route)
                    got2 = gk.bwd_pass2(*p2, want1[0].clone(),
                                        *(x.clone() for x in acc2), HEADS,
                                        _route=route)
                if check is not None:
                    check.report()
                for name, g, w in zip(("demb", "d_alpha", "dnm", "dscale",
                                       "dW_me", "db_me"), got1, want1):
                    compare(f"gat_bwd_pass1 {name} {tag}", g, w,
                            TOL["bwd"][dt])
                if bool((got1[0][dead] != t["carry"][dead]).any()):
                    FAILURES.append(f"gat_bwd_pass1 masked slots {tag}")
                for name, g, w in zip(("demb", "dnq", "dnk", "dW_ke",
                                       "db_ke"), got2, want2):
                    compare(f"gat_bwd_pass2 {name} {tag}", g, w,
                            TOL["bwd"][dt])
                if bool((got2[0][dead] != want1[0][dead]).any()):
                    FAILURES.append(f"gat_bwd_pass2 masked slots {tag}")
                if dt == torch.bfloat16:
                    bf16_steps(f"gat_bwd_pass1 demb {tag}", got1[0], want1[0])
                    bf16_steps(f"gat_bwd_pass2 demb {tag}", got2[0], want2[0])
                # a pass of several launches: one demb product each; on
                # routes 1 and 2 every pass one dW product (their route 1)
                demb_calls = 2 if n_launches > 1 else 0
                of = {"gat_bwd_demb": min(route, 1),
                      "gat_bwd_dw": min(route, 1)}
                counts = {k: (_build.LAUNCHES[k],
                              _build.ROUTES[k, of.get(k, route)])
                          for k in ("gat_bwd_pass1", "gat_bwd_pass2",
                                    "gat_bwd_demb", "gat_bwd_dw")}
                want_counts = {"gat_bwd_pass1": (n_launches,) * 2,
                               "gat_bwd_pass2": (n_launches,) * 2,
                               "gat_bwd_demb": (demb_calls,) * 2,
                               "gat_bwd_dw": (2 * min(route, 1),) * 2}
                if counts != want_counts:
                    FAILURES.append(f"widths: launches of the passes, {tag}: "
                                    f"{counts}")
                log(f"  launches and routes, {tag}: {counts} ({n_launches} "
                    "head groups or column slices)")
            if n_edges != E:
                continue
            # times of a call (its head groups or column slices) beside the
            # bound of its work, counted as the main path's measures count it
            s1 = (t["dnm0"].clone(), t["dscale0"].clone())
            s2 = (want1[0].clone(), *(x.clone() for x in acc2))
            flops = 3 * 2.0 * live * G * E * D * HD
            # bf16 in turns with the mma.sync edge kernel (route 1), f32
            # with the CUDA-core kernels (route 0)
            before = 1 if dt == torch.bfloat16 else 0
            for name, fn, route0, plain, n_bytes in (
                    ("gat_bwd_pass1", lambda: gk.bwd_pass1(*p1, *s1, HEADS),
                     lambda: gk.bwd_pass1(*p1, *s1, HEADS, _route=before),
                     lambda: gk.bwd_pass1_plain(*p1, *s1, HEADS),
                     live * nbytes(t["emb"], t["scores"], src, dst)
                     + nbytes(t["gout"], t["nm"], t["w_me"], t["b_me"],
                              t["gmax"], scale, mask, t["carry"], want1[0],
                              want1[1], want1[4], want1[5])
                     + 2 * nbytes(want1[2], want1[3])),
                    ("gat_bwd_pass2", lambda: gk.bwd_pass2(*p2, *s2, HEADS),
                     lambda: gk.bwd_pass2(*p2, *s2, HEADS, _route=before),
                     lambda: gk.bwd_pass2_plain(*p2, *s2, HEADS),
                     live * nbytes(t["emb"], t["scores"], want1[1], src, dst)
                     + nbytes(t["nq"], t["nk"], t["w_ke"], t["b_ke"],
                              t["gmax"], scale, d_denom, mask, want2[3],
                              want2[4])
                     + 2 * nbytes(want2[0], want2[1], want2[2]))):
                ms = faster_than_previous(
                    f"{name} D={D} HD={HD} {dt}", fn, route0,
                    ("the mma.sync edge kernel (route 1)" if before else
                     "the CUDA-core kernels") + f" on the same {dt} inputs",
                    iters=5, warmup=1)
                plain_ms = device_ms(plain, iters=5, warmup=1)
                bound_ms, by = bound(n_bytes, flops, dt, tc_peak(dt))
                log(f"  time {name} D={D} HD={HD} {dt}: kernels {ms:.4f} ms "
                    f"a call ({n_launches} launches)  plain {plain_ms:.4f} ms"
                    f" ({'above' if plain_ms > ms else 'NOT above'} the "
                    f"kernels)  bound {bound_ms:.4f} ms ({by})  [{card}]")
                rows = profile_kernels(f"{name} D={D} HD={HD} {dt}", fn,
                                       iters=5)
                bwd_launches_by_kernel(rows, 5, n_launches,
                                       f"{name} D={D} HD={HD} {dt}", dt)
                if before:
                    profile_kernels(f"{name} D={D} HD={HD} {dt} route 1",
                                    route0, iters=5, show=2)
    # the forward passes at this D in both dtypes, and rows 11-12 (route 1
    # in turns with route 0)
    for dt in (torch.float32, torch.bfloat16):
        widths_fwd_times(gen, dev, card, D, HD, src, dst, mask, dt)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    n_rel = 39
    etype, esrc, edst, ntype, _ = encoder_ints(gen, dev, E, n_rel)
    F = n_rel + 2 * N_NTYPE
    w0, b0, ea, eb = r(F, D) * 0.2, r(D) * 0.5, r(D) * 0.5, r(D) * 0.5
    h_args = (etype, esrc, edst, ntype, w0, b0, ea, eb, n_rel, N_NTYPE)
    ints = nbytes(etype, esrc, edst, ntype, w0, b0, ea, eb)
    dh0 = r(G, E, D)
    for dt in (torch.bfloat16, torch.float32):
        dh = dh0.to(dt)
        tag = f"D={D} HD={HD} {dt}"
        for name, fn, route0, plain, n_bytes, flops in (
                ("edge_hidden", lambda: ek.edge_hidden_forward(*h_args, dt),
                 lambda: ek.edge_hidden_forward(*h_args, dt, _route=0),
                 lambda: ek.edge_hidden_plain(*h_args, dt),
                 ints + nbytes(dh), 6.0 * G * E * D),
                ("edge_hidden_bwd",
                 lambda: ek.edge_hidden_backward(*h_args[:8], dh, n_rel,
                                                 N_NTYPE),
                 lambda: ek.edge_hidden_backward(*h_args[:8], dh, n_rel,
                                                 N_NTYPE, _route=0),
                 lambda: ek.edge_hidden_backward_plain(*h_args[:8], dh,
                                                       n_rel, N_NTYPE),
                 ints + nbytes(dh) + (F + 3) * D * 4, 16.0 * dh.numel())):
            hidden_times(name, tag, fn, route0, plain, n_bytes, flops, card,
                         iters=5)
            profile_kernels(f"{name} {tag}", fn, iters=5)


def widths_fwd_times(gen, dev, card, D, HD, src, dst, mask, dt):
    """A call of passes A and C (their head groups or column slices) at
    D x HD in dt, 4 heads: its device time, in turns with the CUDA-core
    kernels (route 0) on the same inputs (route 1 must be the faster),
    beside the plain version's time with TF32 off and the bound (operations
    at `tc_peak`), and each launch's device time (torch.profiler)."""
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    live = mask.float().mean().item()
    nq = (r(G, N, HD) / (HD // HEADS) ** 0.5).to(dt)
    nk, nm = (r(G, N, HD) * 0.5).to(dt), (r(G, N, HD) * 0.5).to(dt)
    emb = torch.relu(r(G, E, D)).to(dt)
    w, b_ = r(D, HD) * 0.05, r(HD) * 0.1
    a_args = (nq, nk, emb, w, b_, src, dst, mask, HEADS)
    scores, gmax = gk.pass_a_scores(*a_args)
    scale = torch.rand((G, N, HEADS), generator=gen, device=dev)
    c_args = (nm, emb, w, b_, scores, gmax, scale, src, dst, mask)
    out = torch.zeros((G, N, HD), device=dev)
    n_launches = len(gk.launches(HD, HEADS))
    for name, fn, previous, plain, n_bytes, flops in (
            ("gat_pass_a_scores", lambda: gk.pass_a_scores(*a_args),
             lambda: gk.pass_a_scores(*a_args, _route=0),
             lambda: gk.pass_a_scores_plain(*a_args),
             live * nbytes(emb, src, dst)
             + nbytes(nq, nk, w, b_, mask, scores, gmax),
             2.0 * live * G * E * (D * HD + HD)),
            ("gat_pass_c", lambda: gk.pass_c(*c_args, out, HEADS),
             lambda: gk.pass_c(*c_args, out, HEADS, _route=0),
             lambda: gk.pass_c_plain(*c_args, out, HEADS),
             live * nbytes(emb, scores, src, dst)
             + nbytes(nm, w, b_, gmax, scale, mask) + 2 * nbytes(out),
             2.0 * live * G * E * (D * HD + 2 * HD))):
        ms = faster_than_previous(
            f"{name} D={D} HD={HD} {dt}", fn, previous,
            f"the CUDA-core kernels on the same {dt} inputs", iters=5,
            warmup=1)
        plain_ms = device_ms(plain, iters=5, warmup=1)
        bound_ms, by = bound(n_bytes, flops, dt, tc_peak(dt))
        log(f"  time {name} D={D} HD={HD} {dt}: kernels {ms:.4f} ms a call "
            f"({n_launches} launches)  plain {plain_ms:.4f} ms  bound "
            f"{bound_ms:.4f} ms ({by})  [{card}]")
        profile_kernels(f"{name} D={D} HD={HD} {dt}", fn, iters=5)


def widths_cli(card, widths):
    """`python -m qagnn_tpu_torch.cli` training two steps of a synthetic
    set at each --gnn_dim of `widths` on the card, the processes side by
    side, each on its own copy of the set: exit 0. Meanwhile `cli.main` in
    this process on the same set at the default gnn_dim (no --gnn_dim) and
    at --gnn_dtype float32 --gnn_dim 200 (the preset's width): rows 11 and
    12 launched on route 1 alone (`_build.ROUTES`)."""
    from qagnn_tpu_torch import cli
    from qagnn_tpu_torch.data.synthetic import (
        write_synthetic_dataset,
        write_tiny_bert_checkpoint,
    )
    with tempfile.TemporaryDirectory(prefix="qagnn_wide_cli_") as tmp:
        enc_dir = write_tiny_bert_checkpoint(f"{tmp}/bert")

        def argv(root, *extra):
            emb_path = write_synthetic_dataset(
                f"{root}/data", n_questions=WIDE_CLI_QUESTIONS)
            splits = [f"--{split}_{kind}={root}/data/{sub}/{split}.{ext}"
                      for split in ("train", "dev", "test")
                      for kind, sub, ext in (
                          ("statements", "statement", "statement.jsonl"),
                          ("adj", "graph", "graph.adj.pk"))]
            return ["--mode", "train", "--dataset", "csqa", "--encoder",
                    "bert-base-uncased", "--encoder_load", enc_dir,
                    "--inhouse", "false", "--batch_size", "4",
                    "--mini_batch_size", "4", "--eval_batch_size", "4",
                    "--n_epochs", "1", "--max_seq_len", "24",
                    "--max_node_num", "8", "--num_relation", "7", *extra,
                    "--ent_emb_paths", emb_path, "--save_dir",
                    f"{root}/out", *splits]

        started = [(width, start_tool(["qagnn_tpu_torch.cli", *argv(
            f"{tmp}/{width}", "--gnn_dim", str(width))]))
            for width in widths]
        for name, extra in (("the default gnn_dim", ()),
                            ("--gnn_dtype float32 --gnn_dim 200",
                             ("--gnn_dtype", "float32", "--gnn_dim", "200"))):
            printed = io.StringIO()
            _build.reset_launch_counts()
            with contextlib.redirect_stdout(printed):
                cli.main(argv(f"{tmp}/{len(extra)}", *extra))
            for line in printed.getvalue().splitlines():
                if line.startswith("|"):
                    log("    " + line)
            counts = {k: (_build.LAUNCHES[k], _build.ROUTES[k, 1])
                      for k in ("edge_hidden", "edge_hidden_bwd")}
            ok = all(n > 0 and n == r1 for n, r1 in counts.values())
            log(f"  cli.main at {name}: rows 11 and 12 launches, on route 1:"
                f" {counts}  {'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"widths: rows 11-12 off route 1, CLI at "
                                f"{name}: {counts}")
        for width, proc in started:
            out = finish_tool(
                proc, f"python -m qagnn_tpu_torch.cli --gnn_dim {width}")
            if out is not None:
                for line in out.splitlines():
                    if line.startswith("|"):
                        log("    " + line)


# the fused GNN whose edge-sized operands stay in place (`widths_inplace`):
# the CLI's default gnn_dim 100 (the kernels' 104, which the edge encoder
# emits and the k layers carry) and the OBQA preset's 200, which needs no
# pad; the profiler's op names of a move of an array that computes nothing
INPLACE_D = (100, 200)
EDGE_MOVES = ("aten::constant_pad_nd", "aten::slice_backward", "aten::copy_",
              "aten::clone", "aten::_to_copy", "aten::cat", "aten::stack",
              "aten::new_zeros", "aten::zeros_like")


def edge_moves(fn, n_edges) -> list | None:
    """The ops of one call of fn that move an edge-sized array, (G, E, c)
    with c >= 8, without computing anything (EDGE_MOVES; an op inside
    another such op counts once, as the outer one), from torch.profiler's
    record of the call's ops and their input shapes: (name, shapes, device
    us) each; None where the profiler fails on this machine."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
    except Exception as exc:
        log(f"  torch.profiler: failed on this machine: {exc!r}")
        return None
    if not any(e.name.startswith("aten::") for e in events):
        log("  torch.profiler: no op recorded; the count would be empty")
        return None

    def edge_sized(shapes):
        return any(isinstance(s, (list, tuple)) and len(s) == 3
                   and tuple(s[:2]) == (G, n_edges) and s[2] >= 8
                   for s in shapes or ())
    device_us = lambda e: getattr(e, "device_time_total", None) \
        or getattr(e, "cuda_time_total", 0)  # noqa: E731
    return [(e.name, e.input_shapes, device_us(e)) for e in events
            if e.name in EDGE_MOVES and edge_sized(e.input_shapes)
            and (e.cpu_parent is None
                 or e.cpu_parent.name not in EDGE_MOVES)]


def device_busy_ms(fn, iters=5, attempts=2) -> float | None:
    """The device's busy time in one call of fn: the summed durations of
    the device's own activities (kernels, copies, fills) over `iters`
    calls in torch.profiler's record, each counted once (a CPU op's
    device_time_total counts its kernels again at every level of nesting),
    over iters; None where the profiler records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            spans = [e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
        except Exception as exc:  # a measurement: the checks do not need it
            log(f"  torch.profiler: failed on this machine: {exc!r}")
            return None
        if spans:
            return sum(spans) / iters / 1e3
    return None


def step_times(fn, iters=5, spin=400_000_000):
    """(wall, queued, busy) ms of one call of fn, medians of `iters`: the
    host clock around a synchronised call (what a caller waits, the host's
    launches included); CUDA events around a call queued behind a spin
    kernel long enough that the host's launches run ahead of the device
    (what the call takes where the device is the bottleneck, as behind the
    encoder in a train step); and `device_busy_ms`."""
    fn()
    torch.cuda.synchronize()
    walls, queued = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        queued.append(start.elapsed_time(end))
    return (statistics.median(walls), statistics.median(queued),
            device_busy_ms(fn))


def widths_inplace(gen, dev, card, widths=INPLACE_D):
    """QAGNNMessagePassing on the fused path (k = 5, 4 heads, 38 relations,
    dropout 0; G=64, N=200, E=4096) at each of `widths` in both dtypes:
    the served forward (eval mode, no autograd) and a train step's forward
    + backward, each as wall, queued and device-busy time (`step_times`:
    alone at these shapes the host's launches take longer than the
    device's work, so the wall time hides the device's); and
    torch.profiler's count of the ops of a train step that move an
    edge-sized array without computing (`edge_moves`), which must be none:
    the edge encoder emits the embedding at the kernels' width and every
    layer reads it in place."""
    n_etype = 38
    for width in widths:
        Dk = gk.kernel_widths(width, width, HEADS)[0]
        for dt in (torch.bfloat16, torch.float32):
            with torch.device(dev):
                mp = QAGNNMessagePassing(WIDE_K, N_NTYPE, n_etype, width,
                                         dropout=0.0, head_count=HEADS,
                                         dtype=dt)
            init_weights(mp, torch.Generator(device=dev).manual_seed(SEED),
                         0.02)
            src, dst, mask = graph_inputs(gen, dev, E)
            H = torch.randn((G, N, width), generator=gen, device=dev)
            args = (H, torch.randint(0, N_NTYPE, (G, N), generator=gen,
                                     device=dev),
                    torch.rand((G, N), generator=gen, device=dev), src, dst,
                    torch.randint(0, n_etype + 1, (G, E), generator=gen,
                                  device=dev, dtype=torch.int32), mask)
            cot = torch.randn((G, N, width), generator=gen, device=dev)

            def serve():
                with torch.no_grad():
                    return mp.eval()(*args)

            def step():
                out = mp.train()(*args)
                (out.float() * cot).sum().backward()

            _build.reset_launch_counts()
            step()
            fused = _build.LAUNCHES["gat_bwd_pass1"] == WIDE_K \
                and _build.LAUNCHES["edge_hidden"] == 1
            tag = f"gnn_dim {width} (kernels' {Dk}) {dt}"
            times = [step_times(fn) for fn in (serve, step)]
            moves = edge_moves(step, E)
            log(f"  time fused GNN, {tag}: "
                + ", ".join(f"{what} {w:.4f} ms wall, {q:.4f} ms queued, "
                            + ("busy not measured" if b is None
                               else f"{b:.4f} ms busy")
                            for what, (w, q, b) in zip(
                                ("served forward", "train forward + "
                                 "backward"), times))
                + f"  [{card}]")
            if moves is None or moves or not fused:
                FAILURES.append(f"widths: fused GNN at {tag}: "
                                + ("the profiler saw no ops" if moves is None
                                   else f"edge-sized moves {moves}"
                                   if moves else "not on the kernels"))
            log(f"  edge-sized pads and copies in a train step, {tag}: "
                f"{'not measured' if moves is None else len(moves)}"
                + "".join(f"\n    {n} {sh} {us:.1f} us"
                          for n, sh, us in moves or ())
                + f"  {'ok' if moves == [] and fused else 'FAIL'}")


def inplace_unproj_times(gen, dev, card):
    """Rows 1-5's call times beside their launches' (`unproj_row_times`)
    and the op's forward + backward, bf16, at the two widths with a head
    wider than a launch, and at HD 1024 (2 heads of 512: two slices of 256
    a head, every slice's rows starting on a 32-byte sector, where two of
    HD 1040's three a head start 16 bytes off one)."""
    for HD, heads in WIDE_UNPROJ[2:] + ((1024, 2),):
        src, dst, mask = graph_inputs(gen, dev, E)
        vals, gout = wide_unproj_inputs(gen, dev, HD, heads, torch.bfloat16)
        tag = f"HD={HD} heads={heads} {torch.bfloat16}"
        unproj_row_times(vals, gout, src, dst, mask, heads, tag, card)
        split = lambda t: t.reshape(*t.shape[:-1], heads,  # noqa: E731
                                    HD // heads)
        leaves = [v.detach().clone().requires_grad_() for v in vals]
        ms = device_ms(lambda: forward_backward(
            lambda *t: relational_gat_attention_nodes(
                *(split(x) for x in t), src, dst, mask), leaves, gout),
            iters=5, warmup=1)
        log(f"  time the op, {tag}: forward + backward {ms:.4f} ms  "
            f"[{card}]")


def phase_widths(gen, dev, card, reports) -> None:
    """C9-C12 on the card: relation ids past n_rel through rows 10-12, the
    unprojected op at widths one launch does not take (a head wider than a
    launch among them), the GNN and its passes at gnn_dim 512 and 1040, and
    the CLI at both."""
    t0 = time.perf_counter()
    widths_relation_ids(gen, dev)
    widths_unprojected(gen, dev, card)
    widths_split_forward(gen, dev)
    for width in (WIDE_D, WIDER_D):
        widths_gnn(gen, dev, card, width, reports)
        widths_passes(gen, dev, card,
                      *gk.kernel_widths(width, width, HEADS))
    widths_cli(card, (WIDE_D, WIDER_D))
    widths_inplace(gen, dev, card, INPLACE_D[:1])
    log(f"  the widths phase took {time.perf_counter() - t0:.1f} s ({card})")


PHASES = ("kernels", "grads", "op", "serve", "detail", "train", "cli",
          "overfit", "encoders", "mesh", "preprocess", "tools", "widths")
# parts of the kernel phase that can be asked for alone
KERNEL_PARTS = ("fwd", "bwd", "enc", "moments", "unproj", "scores")
# parts of the widths phase that can be asked for alone
WIDTHS_PARTS = ("inplace", "passes")


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--csrc", default=None,
                    help="build the kernels from this directory instead of "
                         "qagnn_tpu_torch/csrc (to time a variant of the "
                         "sources beside the committed ones)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(PHASES) | set(KERNEL_PARTS) | set(WIDTHS_PARTS):
        ap.error(f"unknown phase in {sorted(only)}; the phases are {PHASES} "
                 f"and, of the kernel phase alone, {KERNEL_PARTS}, of the "
                 f"widths phase, {WIDTHS_PARTS}")
    if args.csrc is not None:
        _build.CSRC = pathlib.Path(args.csrc).resolve()
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; it runs only on the card",
              file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    log("\n[build]")
    secs = _build.build_all(verbose=True)
    log(f"  built {_build.sources()} in {secs:.1f} s")
    t0 = time.perf_counter()
    lib = native_build.build_library()
    log(f"  built the edge packer {lib.relative_to(lib.parents[2])} with g++ "
        f"in {time.perf_counter() - t0:.1f} s")

    def entry(source, replaces):
        return dict(route="cuda", source=f"qagnn_tpu_torch/csrc/{source}",
                    replaces=replaces)
    gat, enc = "qagnn_tpu/ops/pallas_gat.py", \
        "qagnn_tpu/ops/pallas_edge_encoder.py"
    reports = {
        "edge_hidden": entry("edge_hidden.cu", f"{enc}:164"),
        "gat_pass_a_scores": entry("gat_fwd.cu", f"{gat}:650"),
        "gat_pass_a_denoms": entry("gat_fwd.cu", f"{gat}:650"),
        "gat_pass_c": entry("gat_fwd.cu", f"{gat}:716"),
        "edge_moments": entry("edge_moments.cu", f"{enc}:93"),
        "edge_hidden_bwd": entry("edge_hidden.cu", f"{enc}:179"),
        # the main path's edge launch of both passes: the source of the
        # route the rule gives the preset's bf16 pass (BF16_ROUTES)
        "gat_bwd_pass1": entry(EDGE_SOURCE[BF16_ROUTES["gat_bwd_pass1"]],
                               f"{gat}:765"),
        "gat_bwd_pass2": entry(EDGE_SOURCE[BF16_ROUTES["gat_bwd_pass2"]],
                               f"{gat}:849"),
        # the demb product of both passes, one launch a pass of several
        "gat_bwd_demb": entry("gat_demb.cu", f"{gat}:828"),
        # the dW product of both passes, one launch a pass
        "gat_bwd_dw": entry("gat_dw.cu", f"{gat}:835"),
        "gat_unproj_scores": entry("gat_unproj.cu", f"{gat}:331"),
        "gat_unproj_denoms": entry("gat_unproj.cu", f"{gat}:346"),
        "gat_unproj_aggr": entry("gat_unproj.cu", f"{gat}:373"),
        "gat_unproj_bwd1": entry("gat_unproj.cu", f"{gat}:481"),
        "gat_unproj_bwd2": entry("gat_unproj.cu", f"{gat}:517"),
    }
    # one generator per new phase, so that a phase added later leaves the
    # earlier phases' inputs as they were
    new_gen = lambda i: torch.Generator(device=dev).manual_seed(SEED + i)
    gen = new_gen(0)
    if only & {"kernels", "enc"}:
        log("\n[kernel 11: edge_hidden]")
        phase_edge_hidden(gen, dev, reports, card)
    if only & {"kernels", "fwd"}:
        log("\n[kernels 6 and 7: GAT pass A (two launches) and pass C]")
        phase_gat(new_gen(17), dev, reports, card)
        log("\n[kernels 6 and 7: the streaming kernel at D <= 256]")
        phase_gat_streamed(new_gen(24), dev, card)
    if only & {"kernels", "enc", "moments"}:
        log("\n[kernel 10: edge_moments]")
        phase_edge_moments(gen, new_gen(19), dev, reports)
    if only & {"kernels", "enc"}:
        log("\n[kernel 12: edge_hidden_bwd]")
        phase_edge_hidden_bwd(gen, dev, reports, card)
        log("\n[kernels 11 and 12 at other widths]")
        phase_edge_hidden_widths(new_gen(18), dev, reports, card)
    if only & {"kernels", "bwd"}:
        log("\n[kernels 8 and 9: GAT backward pass 1 and pass 2]")
        phase_gat_bwd(gen, new_gen(16), dev, reports)
        log("\n[kernels 8 and 9: the demb product of a pass of several "
            "launches]")
        phase_gat_bwd_demb(new_gen(27), dev, reports, card)
        log("\n[kernels 8 and 9: the dW product of every pass, one "
            "launch]")
        phase_gat_bwd_dw(new_gen(28), dev, reports, card)
    if only & {"kernels", "unproj"}:
        log("\n[kernels 1 to 5: the unprojected GAT op, forward and backward]")
        phase_gat_unproj(new_gen(12), dev, reports)
        log("\n[kernels 1 to 5 at other widths, and at N=4000 nodes]")
        phase_unproj_widths(new_gen(20), dev)
    if "scores" in only:
        log("\n[kernels 1 and 2 alone: the unprojected op's scores and "
            "denominators]")
        phase_unproj_rows12(new_gen(12), dev, reports)
    if "grads" in only:
        log("\n[op gradients: the Functions on the kernels vs autograd "
            "through the scatter path, f32]")
        phase_op_gradients(gen, dev)
        phase_unproj_gradients(new_gen(13), dev)
    if "op" in only:
        log("\n[slice 3: relational_gat_attention_nodes on CUDA tensors, "
            "forward and backward]")
        phase_op(new_gen(14), dev, reports, card)
    if only & {"serve", "detail", "train"}:
        cfg = preset("obqa")
        gen = new_gen(1)
        t0 = time.perf_counter()
        model, enc_cfg = build_model(cfg, dev, gen)
        torch.cuda.synchronize()
        log(f"\n[model] OBQA preset: roberta-large ({enc_cfg.num_layers} "
            f"layers, hidden {enc_cfg.hidden_size}), k={cfg.k}, "
            f"gnn_dim={cfg.gnn_dim}, {cfg.num_relation} relations, entity "
            f"table {N_CONCEPT}x{CONCEPT_IN}; built in "
            f"{time.perf_counter() - t0:.1f} s")
    if "serve" in only:
        log("\n[slice 1: OBQA LMQAGNN serving forward]")
        phase_slice(dev, reports, card, cfg, model, enc_cfg, gen)
    if "detail" in only:
        log("\n[slice 3: OBQA LMQAGNN detail step]")
        phase_detail(dev, card, cfg, model, enc_cfg, new_gen(15))
    if "train" in only:
        log("\n[slice 2: OBQA LMQAGNN training steps]")
        phase_train(dev, reports, card, cfg, model, enc_cfg, gen)
    if "cli" in only:
        # the earlier phases' model goes first: the train phase peaks at
        # 28.8 GiB, and the CLI builds its own
        model = None
        gc.collect()
        torch.cuda.empty_cache()
        log("\n[the CLI: qagnn_tpu_torch.cli train, eval_detail and "
            "resume on a dataset on disk]")
        phase_cli(dev, card)
    if "overfit" in only:
        log("\n[the training check: cli.train overfits 4 questions at the "
            "production GNN widths]")
        phase_overfit(dev, card)
    if "encoders" in only:
        log("\n[the encoder families: albert-xxlarge-v2, openai-gpt, "
            "xlnet-large-cased and the LSTM served, trained and driven "
            "through the CLI under the OBQA decoder]")
        t0 = time.perf_counter()
        phase_encoders(dev, card)
        log(f"  the encoders phase took {time.perf_counter() - t0:.1f} s")
    if "mesh" in only:
        gc.collect()
        torch.cuda.empty_cache()
        log("\n[the grid of ranks: rows 1-12 on E/2 and E/4 edge slices, "
            "and cli.train on 2 x 2 ranks, all on this card over gloo]")
        t0 = time.perf_counter()
        phase_mesh_ops(card)
        phase_mesh_cli(dev, card)
        log(f"  the mesh phase took {time.perf_counter() - t0:.1f} s")
    if "preprocess" in only:
        gc.collect()
        torch.cuda.empty_cache()
        log("\n[the preprocessing vertical: ConceptNet at its scale to OBQA "
            "graphs with the roberta-large MLM scorer on the card, and "
            "MedQA with the SapBERT table]")
        phase_preprocess(dev, card)
    if "tools" in only:
        # the tools draw their inputs from their own seeds, none from this
        # script's generators
        gc.collect()
        torch.cuda.empty_cache()
        log("\n[the tools: parity_check's bf16 bands, profile_step read by "
            "trace_summary, the dress rehearsal and the CLI's profiler "
            "path, on the card]")
        phase_tools(dev, card)
    if "widths" in only:
        gc.collect()
        torch.cuda.empty_cache()
        log("\n[the widths: relation ids past n_rel through rows 10-12, rows "
            "1-5 at HD 100, 320, 300 (one head) and 1040 (two heads), rows "
            "6-12 at gnn_dim 512 and 1040 and the CLI "
            "there]")
        phase_widths(new_gen(21), dev, card, reports)
    if "passes" in only:
        log("\n[the widths, rows 6-9 alone at gnn_dim 512 and 1040]")
        for width in (WIDE_D, WIDER_D):
            widths_passes(new_gen(21), dev, card,
                          *gk.kernel_widths(width, width, HEADS))
    if "inplace" in only:
        log("\n[the widths, in place: the fused GNN at gnn_dim 100 and 200, "
            "rows 1-5 at HD 300 and 1040]")
        widths_inplace(new_gen(25), dev, card)
        inplace_unproj_times(new_gen(26), dev, card)

    left = stop_children()
    log(f"\n[processes] still running at the end: {len(left)}, each "
        "stopped" + "".join(f"\n  {line}" for line in left))
    log(f"  the whole script took {time.perf_counter() - t_start:.1f} s "
        f"({card})")
    if FAILURES:
        log("\nFAILED: " + "; ".join(FAILURES))
        return 1
    if only != set(PHASES):
        log(f"\npartial run ({sorted(only)}) passed; no result line")
        return 0
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: ({"name": name} | r)[k] for k in keys}
               for name, r in reports.items()]
    log("")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    take_orphans()
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
