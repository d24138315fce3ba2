"""Drive the PyTorch/CUDA port (qagnn_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card. It

  1. prints the card's name and power limit and turns TF32 off;
  2. builds the hand-written kernels of qagnn_tpu_torch/csrc with nvcc;
  3. holds each kernel against its plain PyTorch version on the card, at the
     serving slice's shapes (G=64 graphs, N=200 nodes, E=4096 edge slots,
     D=HD=200, 4 heads) with about 25% of edge slots masked, one graph with
     every edge masked, and a ragged-E case, in float32 and bfloat16, and
     times both with CUDA events;
  4. serves the OBQA roberta-large LMQAGNN (random weights from a seed,
     perturbed BatchNorm running statistics) through `make_eval_step` on the
     kernel path, checks that every kernel ran the expected number of times,
     and compares the logits with the same model on the scatter path;
  5. prints one JSON line of per-kernel numbers, the card's name and power
     limit, and as its last line {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when there is no CUDA device or any
check fails. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.models.norm import MaskedBatchNorm
from qagnn_tpu_torch.models.qagnn import LMQAGNN
from qagnn_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from qagnn_tpu_torch.ops import _build
from qagnn_tpu_torch.ops import edge_encoder_kernels as ek
from qagnn_tpu_torch.ops import gat_kernels as gk
from qagnn_tpu_torch.train.step import make_eval_step
from qagnn_tpu_torch.utils.config import preset
from qagnn_tpu_torch.utils.initialization import init_weights

SEED = 0
# the serving slice: the batch bench.py times end to end (B=16 x C=4)
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
       "gat": 1e-4}
# kernel path vs scatter path, logits and GNN output, same relative form: in
# f32 the paths differ by summation order; in bf16 they round at different
# places (the kernel path composes linear_1 into key_e / msg_e in f32), which
# reached 2.2e-4 on the logits and 8.1e-3 on the GNN output on an H100.
LOGIT_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-3}
GNN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

FAILURES: list[str] = []


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def compare(what: str, got, want, tol: float) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        FAILURES.append(f"{what}: shape {tuple(got.shape)} vs "
                        f"{tuple(want.shape)}")
        return float("inf")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    ref = want.abs().max().item() if want.numel() else 0.0
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


def measure(reports, name, err, kernel, plain, n_bytes, flops, dtype):
    """Time a kernel and its plain version at the main path's inputs and
    file them, with the bound, under `name`. No PyTorch call computes any
    of these functions whole, so library_ms is None."""
    ms, plain_ms = device_ms(kernel), device_ms(plain)
    bound_ms, by = bound(n_bytes, flops, dtype)
    log(f"  time {name:<18} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"bound {bound_ms:.4f} ms ({by})")
    reports[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=by, library_ms=None)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def graph_inputs(gen, dev, n_edges):
    mask = torch.rand((G, n_edges), generator=gen, device=dev) > 0.25
    mask[1] = False                        # a graph with every edge masked
    idx = lambda hi: torch.randint(0, hi, (G, n_edges), generator=gen,
                                   device=dev, dtype=torch.int32)
    return idx(N), idx(N), mask


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
            got = ek.edge_hidden(*args, dt)
            want = ek.edge_hidden_plain(*args, dt)
            err = compare(f"edge_hidden E={n_edges} {dt}", got, want,
                          TOL["edge_hidden"][dt])
            if n_edges == E and dt == torch.bfloat16:
                # three row sums, bias, affine, relu per output element
                measure(reports, "edge_hidden", err,
                        lambda: ek.edge_hidden(*args, dt),
                        lambda: ek.edge_hidden_plain(*args, dt),
                        nbytes(etype, src, dst, ntype, w0, b0, a, b, got),
                        6.0 * got.numel(), torch.float32)


def phase_gat(gen, dev, reports):
    D = HD = 200
    dph = HD // HEADS
    for n_edges in (E, E - 3):
        src, dst, mask = graph_inputs(gen, dev, n_edges)
        live = mask.float().mean().item()
        for dt in (torch.float32, torch.bfloat16):
            r = lambda *s: torch.randn(s, generator=gen, device=dev)
            nq = (r(G, N, HD) / dph ** 0.5).to(dt)
            nk, nm, skb, smb = ((r(G, N, HD) * 0.5).to(dt) for _ in range(4))
            emb = torch.relu(r(G, n_edges, D)).to(dt)
            w_ke, w_me = r(D, HD) * 0.05, r(D, HD) * 0.05
            b_ke, b_me = r(HD) * 0.1, r(HD) * 0.1
            tag = f"E={n_edges} {dt}"
            main = n_edges == E and dt == torch.bfloat16

            a_args = (nq, nk, emb, w_ke, b_ke, src, dst, mask, HEADS)
            scores, m_edge = gk.pass_a_scores(*a_args)
            scores_p, m_edge_p = gk.pass_a_scores_plain(*a_args)
            err = compare(f"gat_pass_a_scores scores {tag}", scores,
                          scores_p, TOL["gat"])
            has_edge = mask.any(1)
            compare(f"gat_pass_a_scores max {tag}", m_edge[has_edge],
                    m_edge_p[has_edge], TOL["gat"])
            if not bool((m_edge[~has_edge] == gk.NEG).all()):
                FAILURES.append(f"gat_pass_a_scores max of empty graph {tag}")
            if main:
                measure(reports, "gat_pass_a_scores", err,
                        lambda: gk.pass_a_scores(*a_args),
                        lambda: gk.pass_a_scores_plain(*a_args),
                        nbytes(nq, nk, emb, w_ke, b_ke, src, dst, mask,
                               scores, m_edge),
                        2.0 * G * n_edges * (D * HD + HD), dt)

            # the op's glue, as gat_projected_forward runs it
            self_scores = gk.head_sum(nq.float() * (nk + skb).float(), HEADS)
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
                        2.0 * live * G * n_edges * HEADS, torch.float32)

            scale = (deg_p[..., None] + 1.0) \
                / torch.clamp_min(denom_p + e_self, gk.DENOM_EPS)
            seed = (nm.float() + smb.float()) \
                * gk.heads_to_hd(e_self * scale, HD)
            c_args = (nm, emb, w_me, b_me, scores_p, gmax, scale, src, dst,
                      mask)
            out = gk.pass_c(*c_args, seed.clone(), HEADS)
            out_p = gk.pass_c_plain(*c_args, seed.clone(), HEADS)
            err = compare(f"gat_pass_c out {tag}", out, out_p, TOL["gat"])
            if main:
                # live edges only; the accumulator is read and written
                scratch = seed.clone()
                measure(reports, "gat_pass_c", err,
                        lambda: gk.pass_c(*c_args, scratch, HEADS),
                        lambda: gk.pass_c_plain(*c_args, scratch, HEADS),
                        live * nbytes(emb, scores_p, src, dst)
                        + nbytes(nm, w_me, b_me, gmax, scale, mask)
                        + 2 * nbytes(out),
                        2.0 * live * G * n_edges * (D * HD + 2 * HD), dt)

            # the whole op on the kernel path against the plain chain above
            op = gk.gat_projected_forward(nq, nk, nm, emb, w_ke, b_ke, w_me,
                                          b_me, skb, smb, src, dst, mask,
                                          HEADS)
            compare(f"gat_projected_forward out {tag}", op[0], out_p,
                    TOL["gat"])
            if not bool(torch.isfinite(op[0][~has_edge]).all()):
                FAILURES.append(f"non-finite output of empty graph {tag}")


# ---------------------------------------------------------------------------
# the serving slice
# ---------------------------------------------------------------------------

def build_model(cfg, dev, gen):
    enc_cfg = TextEncoderConfig.roberta_large()
    with torch.device(dev):
        model = LMQAGNN(
            TextEncoder(enc_cfg), sent_dim=enc_cfg.hidden_size, k=cfg.k,
            n_ntype=N_NTYPE, n_etype=cfg.num_relation, n_concept=N_CONCEPT,
            concept_dim=cfg.gnn_dim, concept_in_dim=CONCEPT_IN,
            n_attention_head=cfg.att_head_num, fc_dim=cfg.fc_dim,
            n_fc_layer=cfg.fc_layer_num, gnn_dtype=torch.bfloat16)
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


def phase_slice(dev, reports, card):
    cfg = preset("obqa")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    t0 = time.perf_counter()
    model, enc_cfg = build_model(cfg, dev, gen)
    torch.cuda.synchronize()
    log(f"  OBQA preset: roberta-large ({enc_cfg.num_layers} layers, hidden "
        f"{enc_cfg.hidden_size}), k={cfg.k}, gnn_dim={cfg.gnn_dim}, "
        f"{cfg.num_relation} relations, entity table {N_CONCEPT}x"
        f"{CONCEPT_IN}; built in {time.perf_counter() - t0:.1f} s")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; it runs only on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
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

    reports = {
        "edge_hidden": dict(
            route="cuda", source="qagnn_tpu_torch/csrc/edge_hidden.cu",
            replaces="qagnn_tpu/ops/pallas_edge_encoder.py:164"),
        "gat_pass_a_scores": dict(
            route="cuda", source="qagnn_tpu_torch/csrc/gat_fwd.cu",
            replaces="qagnn_tpu/ops/pallas_gat.py:650"),
        "gat_pass_a_denoms": dict(
            route="cuda", source="qagnn_tpu_torch/csrc/gat_fwd.cu",
            replaces="qagnn_tpu/ops/pallas_gat.py:650"),
        "gat_pass_c": dict(
            route="cuda", source="qagnn_tpu_torch/csrc/gat_fwd.cu",
            replaces="qagnn_tpu/ops/pallas_gat.py:716"),
    }
    gen = torch.Generator(device=dev).manual_seed(SEED)
    log("\n[kernel 11: edge_hidden]")
    phase_edge_hidden(gen, dev, reports)
    log("\n[kernels 6 and 7: GAT pass A (two launches) and pass C]")
    phase_gat(gen, dev, reports)
    log("\n[slice: OBQA LMQAGNN serving forward]")
    phase_slice(dev, reports, card)

    if FAILURES:
        log("\nFAILED: " + "; ".join(FAILURES))
        return 1
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
