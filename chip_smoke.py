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
     (D=24, HD=40, which need padding; 96 x 128; 256 x 256), on both of
     their routes in bf16, with their masked slots held exactly, their
     tensor-core kernels (bf16) timed in turns with the CUDA-core ones on the
     same inputs, and torch.profiler's device time by kernel name; the
     edge encoder's hidden pass and its backward on both of their routes in
     bf16 (also at D=24 x F=16 and D=256 x F=64, and at D=100 where only
     the CUDA-core route runs), route 1 timed in turns with route 0; the
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
 14. prints one JSON line of per-kernel numbers, the card's name and power
     limit, and as its last line {"ok": true, "device": {...}}.

`--only kernels,grads,op,serve,detail,train,cli,overfit,encoders,mesh,
preprocess` runs
a subset of the phases (for work on one of them; `fwd`, `bwd`, `enc`,
`moments` and `unproj` are the kernel phase's parts for the GAT forward
passes A and C,
for the two GAT backward passes, for the edge encoder's three kernels (rows
10-12), for its feature moments (row 10) and for the unprojected op's five
kernels (rows 1-5) alone; `scores` runs rows 1 and 2 alone at the main
shapes, which no other phase repeats);
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
import dataclasses
import gc
import hashlib
import io
import json
import math
import multiprocessing
import pathlib
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np
import torch

from qagnn_tpu_torch.cli import make_encoder
from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.models.gnn import EdgeEncoder
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


def bound(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure(reports, name, err, kernel, plain, n_bytes, flops, dtype,
            previous=None,
            previous_is="the CUDA-core kernels on the same bf16 inputs"):
    """Time a kernel and its plain version at the main path's inputs and
    file them, with the bound, under `name`. No PyTorch call computes any
    of these functions whole, so library_ms is None. `previous`: the
    kernel's earlier version on the same inputs (`previous_is` says which),
    timed in turns with it (kernel, previous, previous, kernel) and printed
    as previous_ms."""
    if previous is None:
        ms = device_ms(kernel)
    else:
        ms = faster_than_previous(name, kernel, previous, previous_is)
    plain_ms = device_ms(plain)
    bound_ms, by = bound(n_bytes, flops, dtype)
    log(f"  time {name:<18} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"bound {bound_ms:.4f} ms ({by})")
    reports[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=by, library_ms=None)


def faster_than_previous(name, kernel, previous, previous_is):
    """Time a kernel in turns with its earlier version on the same inputs
    (kernel, previous, previous, kernel); a failure unless both of the
    kernel's times lie below both of the earlier version's. Returns the
    kernel's mean time."""
    ms = device_ms(kernel)
    prev = (device_ms(previous), device_ms(previous))
    again = device_ms(kernel)
    faster = max(ms, again) < min(prev)
    log(f"  time {name:<18} kernel {ms:.4f} and {again:.4f} ms  "
        f"previous_ms {sum(prev) / 2:.4f} ({prev[0]:.4f} and {prev[1]:.4f}:"
        f" {previous_is})  {'faster' if faster else 'NOT FASTER'}")
    if not faster:
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
    both in bf16 where route 1 takes the width, else route 0."""
    return (0, 1) if ek._hidden_route(dt, D, n_rel, n_ntype) else (0,)


def edge_hidden_case(reports, args, dt, tag, main):
    """edge_hidden on each route against its plain version; at the main
    shapes also its time, route 1's beside route 0's on the same inputs."""
    want = ek.edge_hidden_plain(*args, dt)
    for route in hidden_routes(dt, args[4].shape[1], *args[8:10]):
        got = ek.edge_hidden_forward(*args, dt, _route=route)
        err = compare(f"edge_hidden {tag} route {route}", got, want,
                      TOL["edge_hidden"][dt])
    if main:
        # three row sums, bias, affine, relu per output element
        etype, src, dst, ntype, w0, b0, a, b = args[:8]
        measure(reports, "edge_hidden", err,
                lambda: ek.edge_hidden_forward(*args, dt),
                lambda: ek.edge_hidden_plain(*args, dt),
                nbytes(etype, src, dst, ntype, w0, b0, a, b, got),
                6.0 * got.numel(), torch.float32,
                previous=lambda: ek.edge_hidden_forward(*args, dt, _route=0))
        profile_kernels("edge_hidden",
                        lambda: ek.edge_hidden_forward(*args, dt))


def phase_edge_hidden(gen, dev, reports):
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
                             n_edges == E and dt == torch.bfloat16)


def gat_fwd_case(reports, gen, dev, D, HD, heads, src, dst, mask, dt, tag,
                 main):
    """Passes A and C on every route their widths take in this dtype
    against their plain versions, masked slots' scores and the empty
    graph's max exactly, and the whole forward; at the main shapes also
    their times, the tensor-core route's beside the CUDA-core kernels' on
    the same inputs."""
    n_edges = src.shape[1]
    live = mask.float().mean().item()
    has_edge = mask.any(1)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    nq = (r(G, N, HD) / (HD // heads) ** 0.5).to(dt)
    nk, nm, skb, smb = ((r(G, N, HD) * 0.5).to(dt) for _ in range(4))
    emb = torch.relu(r(G, n_edges, D)).to(dt)
    w_ke, w_me = r(D, HD) * 0.05, r(D, HD) * 0.05
    b_ke, b_me = r(HD) * 0.1, r(HD) * 0.1
    routes = (0, 1) if gk._fwd_route(dt, D, HD, heads, None) else (0,)

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
        measure(reports, "gat_pass_a_scores", err,
                lambda: gk.pass_a_scores(*a_args),
                lambda: gk.pass_a_scores_plain(*a_args),
                live * nbytes(emb, src, dst)
                + nbytes(nq, nk, w_ke, b_ke, mask, scores, m_edge),
                2.0 * live * G * n_edges * (D * HD + HD), dt,
                previous=lambda: gk.pass_a_scores(*a_args, _route=0))
        profile_kernels("gat_pass_a_scores",
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
    if main:
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
        measure(reports, "gat_pass_c", err,
                lambda: gk.pass_c(*c_args, scratch, heads),
                lambda: gk.pass_c_plain(*c_args, scratch, heads),
                live * nbytes(emb, scores_p, src, dst)
                + nbytes(nm, w_me, b_me, gmax, scale, mask)
                + 2 * nbytes(out),
                2.0 * live * G * n_edges * (D * HD + 2 * HD), dt,
                previous=lambda: gk.pass_c(*c_args, scratch, heads,
                                           _route=0))
        profile_kernels("gat_pass_c",
                        lambda: gk.pass_c(*c_args, scratch, heads))

    # the whole op on the kernel path against the plain chain above
    op = gk.gat_projected_forward(nq, nk, nm, emb, w_ke, b_ke, w_me, b_me,
                                  skb, smb, src, dst, mask, heads)
    compare(f"gat_projected_forward out {tag}", op[0], out_p,
            TOL["gat_c"][dt])
    if not bool(torch.isfinite(op[0][~has_edge]).all()):
        FAILURES.append(f"non-finite output of empty graph {tag}")


def phase_gat(gen, dev, reports):
    """float32 runs the CUDA-core kernels; bfloat16 both routes, the
    tensor-core one on the main path. Widths as the backward phase's."""
    for D, HD, heads in ((200, 200, HEADS), (24, 40, 4), (96, 128, 8),
                         (256, 256, 8)):
        for n_edges in (E, E - 3):
            src, dst, mask = graph_inputs(gen, dev, n_edges)
            for dt in (torch.float32, torch.bfloat16):
                main = D == 200 and n_edges == E and dt == torch.bfloat16
                gat_fwd_case(reports, gen, dev, D, HD, heads, src, dst, mask,
                             dt, f"D={D} HD={HD} E={n_edges} {dt}", main)


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
            rows = profile_kernels("edge_moments",
                                   lambda: ek.edge_feature_moments(*args))
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


def edge_hidden_bwd_case(reports, args, dt, tag, main):
    """The backward on each route against its plain version; at the main
    shapes also its time, route 1's beside route 0's on the same inputs."""
    names = ("dW0", "db0", "da", "db")
    want = ek.edge_hidden_backward_plain(*args)
    for route in hidden_routes(dt, args[4].shape[1], *args[9:11]):
        got = ek.edge_hidden_backward(*args, _route=route)
        errs = [compare(f"edge_hidden_bwd {name} {tag} route {route}", g, w,
                        TOL["bwd"][dt])
                for name, g, w in zip(names, got, want)]
    if main:
        # per element: three row sums, the affine, the relu mask, four
        # products and six accumulations
        etype, src, dst, ntype, w0, b0, a, b, dh = args[:9]
        measure(reports, "edge_hidden_bwd", max(errs),
                lambda: ek.edge_hidden_backward(*args),
                lambda: ek.edge_hidden_backward_plain(*args),
                nbytes(etype, src, dst, ntype, w0, b0, a, b, dh, *got),
                16.0 * dh.numel(), torch.float32,
                previous=lambda: ek.edge_hidden_backward(*args, _route=0))
        profile_kernels("edge_hidden_bwd",
                        lambda: ek.edge_hidden_backward(*args))


def phase_edge_hidden_bwd(gen, dev, reports):
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
                                 n_edges == E and dt == torch.bfloat16)


def phase_edge_hidden_widths(gen, dev, reports):
    """Both edge-encoder hidden kernels off the main width: D=24 x F=16
    (route 1's product pads D to 32), D=256 x F=64 (the widest route 1
    takes) and D=100 x F=47 (the default gnn_dim: route 0 alone)."""
    for D, n_rel in ((24, 8), (256, 56), (100, 39)):
        F = n_rel + 2 * N_NTYPE
        w0 = torch.randn((F, D), generator=gen, device=dev) * 0.2
        b0, a, b = (torch.randn(D, generator=gen, device=dev) * 0.5
                    for _ in range(3))
        for n_edges in (E, E - 3):
            etype, src, dst, ntype, _ = encoder_ints(gen, dev, n_edges, n_rel)
            for dt in (torch.float32, torch.bfloat16):
                tag = f"D={D} F={F} E={n_edges} {dt}"
                args = (etype, src, dst, ntype, w0, b0, a, b, n_rel, N_NTYPE)
                edge_hidden_case(reports, args, dt, tag, False)
                dh = torch.randn((G, n_edges, D), generator=gen,
                                 device=dev).to(dt)
                edge_hidden_bwd_case(reports, args[:8] + (dh,) + args[8:],
                                     dt, tag, False)


def profile_kernels(what, fn, iters=20, attempts=2):
    """Device time by kernel name over `iters` calls of fn, from
    torch.profiler's CUDA activity: rows of (device us, launches, name), or
    None (and says so) where it records none. A window of short kernels
    at times comes back with no device activity, so an empty one is taken
    again, `attempts` times in all."""
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
                       if device_us(e) > 0), reverse=True)
        if rows:
            break
    if not rows:
        log(f"  torch.profiler, {what}: key_averages() shows no device time "
            "on this machine; times come from CUDA events")
        return None
    log(f"  torch.profiler, {what}: device time per call by kernel, "
        f"{iters} calls")
    for us, count, key in rows[:8]:
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
    """Both backward passes against their plain versions on the inputs t;
    at the main shapes also their times, beside the CUDA-core kernels'."""
    HD, D = t["nm"].shape[-1], t["emb"].shape[-1]
    n_edges = src.shape[1]
    live = mask.float().mean().item()
    dead = ~mask
    for carry in (None, t["carry"]):
        ctag = f"{tag} {'no carry' if carry is None else 'carry'}"
        p1 = (t["gout"], t["nm"], t["emb"], t["w_me"], t["b_me"], t["scores"],
              t["gmax"], t["scale"], src, dst, mask, carry)
        got = gk.bwd_pass1(*p1, t["dnm0"].clone(), t["dscale0"].clone(),
                           heads)
        want = gk.bwd_pass1_plain(*p1, t["dnm0"].clone(),
                                  t["dscale0"].clone(), heads)
        names = ("demb", "d_alpha", "dnm", "dscale", "dW_me", "db_me")
        errs = [compare(f"gat_bwd_pass1 {name} {ctag}", g, w, TOL["bwd"][dt])
                for name, g, w in zip(names, got, want)]
        # masked slots (one graph has nothing else): demb is the carry or 0
        # and d_alpha 0, exactly
        passed = 0.0 if carry is None else carry[dead]
        if bool((got[0][dead] != passed).any()) \
                or bool((got[1].transpose(1, 2)[dead] != 0).any()):
            FAILURES.append(f"gat_bwd_pass1 masked slots {ctag}")
    if main:
        # live edges' rows of emb, scores and indices; the carry and
        # demb whole (a masked slot passes its carry through); the
        # node accumulators read and written. Three products.
        scratch = (t["dnm0"].clone(), t["dscale0"].clone())
        measure(reports, "gat_bwd_pass1", max(errs),
                lambda: gk.bwd_pass1(*p1, *scratch, heads),
                lambda: gk.bwd_pass1_plain(*p1, *scratch, heads),
                live * nbytes(t["emb"], t["scores"], src, dst)
                + nbytes(t["gout"], t["nm"], t["w_me"], t["b_me"], t["gmax"],
                         t["scale"], mask, carry, got[0], got[1], got[4],
                         got[5])
                + 2 * nbytes(got[2], got[3]),
                3 * 2.0 * live * G * n_edges * D * HD, dt,
                previous=lambda: gk.bwd_pass1(*p1, *scratch, heads, _route=0))
        profile_kernels("gat_bwd_pass1",
                        lambda: gk.bwd_pass1(*p1, *scratch, heads))

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
    got = gk.bwd_pass2(*p2, demb1.clone(), dnq0.clone(), dnk0.clone(), heads)
    want = gk.bwd_pass2_plain(*p2, demb1.clone(), dnq0.clone(), dnk0.clone(),
                              heads)
    names = ("demb", "dnq", "dnk", "dW_ke", "db_ke")
    errs = [compare(f"gat_bwd_pass2 {name} {tag}", g, w, TOL["bwd"][dt])
            for name, g, w in zip(names, got, want)]
    # a masked slot's demb is pass 1's, exactly
    if bool((got[0][dead] != demb1[dead]).any()):
        FAILURES.append(f"gat_bwd_pass2 masked slots {tag}")
    if main:
        scratch = (demb1.clone(), dnq0.clone(), dnk0.clone())
        measure(reports, "gat_bwd_pass2", max(errs),
                lambda: gk.bwd_pass2(*p2, *scratch, heads),
                lambda: gk.bwd_pass2_plain(*p2, *scratch, heads),
                live * nbytes(t["emb"], t["scores"], dalpha, src, dst)
                + nbytes(t["nq"], t["nk"], t["w_ke"], t["b_ke"], t["gmax"],
                         scale, d_denom, mask, got[3], got[4])
                + 2 * nbytes(got[0], got[1], got[2]),
                3 * 2.0 * live * G * n_edges * D * HD, dt,
                previous=lambda: gk.bwd_pass2(*p2, *scratch, heads, _route=0))
        profile_kernels("gat_bwd_pass2",
                        lambda: gk.bwd_pass2(*p2, *scratch, heads))


def phase_gat_bwd(gen, odd_gen, dev, reports):
    """float32 runs the CUDA-core kernels, bfloat16 the tensor-core ones."""
    D = HD = 200
    for n_edges in (E, E - 3):
        src, dst, mask = graph_inputs(gen, dev, n_edges)
        for dt in (torch.float32, torch.bfloat16):
            t = gat_bwd_inputs(gen, dev, D, HD, HEADS, src, dst, mask, dt)
            gat_bwd_case(reports, t, src, dst, mask, HEADS, dt,
                         f"E={n_edges} {dt}",
                         main=n_edges == E and dt == torch.bfloat16)
    # widths off the main shape. 24 x 40, 4 heads: both depths need padding
    # to 16 (to 32 and 48) and heads of 10 split the 8-column groups; 96 x
    # 128 and 256 x 256, 8 heads: the other widths the tensor-core kernels
    # are compiled for, the last with fewer warps a block
    src, dst, mask = graph_inputs(odd_gen, dev, E - 3)
    for D, HD, heads in ((24, 40, 4), (96, 128, 8), (256, 256, 8)):
        for dt in (torch.float32, torch.bfloat16):
            t = gat_bwd_inputs(odd_gen, dev, D, HD, heads, src, dst, mask, dt)
            gat_bwd_case(reports, t, src, dst, mask, heads, dt,
                         f"D={D} HD={HD} E={E - 3} {dt}", main=False)


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
    check_routes(1, f"{len(order)} served forwards, bf16 GNN")

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
          "edge_hidden", "edge_hidden_bwd")


def check_routes(route: int, what: str) -> None:
    """Every launch counted since the last reset of the entry points that
    have two routes took `route` (1, tensor cores, for bf16; 0 for f32)."""
    launched = [n for n in ROUTED if _build.LAUNCHES[n]]
    ok = all(_build.ROUTES[n, route] == _build.LAUNCHES[n] for n in launched)
    log(f"  routes, {what}: " + ", ".join(
        f"{n} {_build.ROUTES[n, route]} of {_build.LAUNCHES[n]}"
        for n in launched) + f" on route {route}  {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"routes, {what}: {dict(_build.ROUTES)}")


def step_launches(k) -> dict:
    """Launches of each kernel in one forward + backward of the model on
    the kernel path (k GAT layers)."""
    return {"edge_moments": 1, "edge_hidden": 1, "gat_pass_a_scores": k,
            "gat_pass_a_denoms": k, "gat_pass_c": k, "gat_bwd_pass1": k,
            "gat_bwd_pass2": k, "edge_hidden_bwd": 1}


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
            check_routes(0, "f32 step")
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
    check_routes(1, "bf16 steps")
    for name in ("edge_moments", "edge_hidden_bwd", "gat_bwd_pass1",
                 "gat_bwd_pass2"):
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
    check_routes(1, "frozen encoder")
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
    check_routes(1, "two microbatches")
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
    per detail batch), every routed entry point on route 1 (bf16)."""
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
               if any(r != 1 for _, r in c["routes"])]
        ok = not bad and not off
        log(f"  launches per {kind} call, {run}: {len(calls)} calls, each "
            + (", ".join(f"{n} {v}" for n, v in expected.items()) or "none")
            + f", routed entry points on route 1  {'ok' if ok else 'FAIL'}")
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
    # the whole train run: every kernel of the path, on route 1
    per_step = step_launches(k)
    want = {n: v * n_steps + (v * n_evals if n in EVAL_LAUNCHES else 0)
            for n, v in per_step.items()}
    ok = counts == want and len(train_steps) == n_steps and all(
        routes.get((n, 1), 0) == counts[n] for n in ROUTED if n in counts)
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
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
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
    check_routes(1, f"{family} served forwards, bf16 GNN")
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
        check_routes(1, f"{family} steps, encoder {what}")
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


PHASES = ("kernels", "grads", "op", "serve", "detail", "train", "cli",
          "overfit", "encoders", "mesh", "preprocess")
# parts of the kernel phase that can be asked for alone
KERNEL_PARTS = ("fwd", "bwd", "enc", "moments", "unproj", "scores")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--csrc", default=None,
                    help="build the kernels from this directory instead of "
                         "qagnn_tpu_torch/csrc (to time a variant of the "
                         "sources beside the committed ones)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(PHASES) | set(KERNEL_PARTS):
        ap.error(f"unknown phase in {sorted(only)}; the phases are {PHASES} "
                 f"and, of the kernel phase alone, {KERNEL_PARTS}")
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
        "gat_bwd_pass1": entry("gat_bwd.cu", f"{gat}:765"),
        "gat_bwd_pass2": entry("gat_bwd.cu", f"{gat}:849"),
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
        phase_edge_hidden(gen, dev, reports)
    if only & {"kernels", "fwd"}:
        log("\n[kernels 6 and 7: GAT pass A (two launches) and pass C]")
        phase_gat(new_gen(17), dev, reports)
    if only & {"kernels", "enc", "moments"}:
        log("\n[kernel 10: edge_moments]")
        phase_edge_moments(gen, new_gen(19), dev, reports)
    if only & {"kernels", "enc"}:
        log("\n[kernel 12: edge_hidden_bwd]")
        phase_edge_hidden_bwd(gen, dev, reports)
        log("\n[kernels 11 and 12 at other widths]")
        phase_edge_hidden_widths(new_gen(18), dev, reports)
    if only & {"kernels", "bwd"}:
        log("\n[kernels 8 and 9: GAT backward pass 1 and pass 2]")
        phase_gat_bwd(gen, new_gen(16), dev, reports)
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
    sys.exit(main())
