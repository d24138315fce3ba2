"""Time variants of the projected GAT op's kernels side by side on one card.

    python3 gat_variants.py D HD tag=DIR [tag=DIR ...] [--dtype bfloat16]
        [--passes fwd|demb|dw] [--widths]

Each DIR is a copy of qagnn_tpu_torch/csrc (the sources themselves for
"qagnn_tpu_torch/csrc"), edited by hand. The script builds every copy's
library at once (`gat_bwd`, `gat_fwd` with `--passes fwd`, `gat_demb`
with `--passes demb`, `gat_dw` and `gat_bwd` with `--passes dw`), one
nvcc a copy, then, one process a copy, runs backward passes 1 and 2,
forward passes A and C, (`--passes demb`) the backward passes' demb
product alone (`bwd_demb`, with an add; `--widths`: at every column tile
width `demb_tc_kernel` is built at that fits, `gk.demb_plan`'s choice
marked), or (`--passes dw`) their dW product alone (`bwd_dw` over all HD
columns of E = 4096 slots a graph, beside torch.mm of the same product and
route 0, the mma.sync kernel; `--widths`: every tile `dw_wgmma_kernel` is
built at, each at the plan's count of slot ranges and at half and twice
it, `gk.dw_plan`'s choice marked), on route 1 (the wrappers of
qagnn_tpu_torch/ops/gat_kernels.py, head groups and column launches
included) at G=64, N=200, E=4096, D x HD with 4 heads, on chip_smoke.py's
inputs: each call's largest gap from its plain version (max|d| / max|want|
over its outputs), its device time (median of 10 calls by CUDA events),
the time of route 0 on the same inputs for the forward passes, and
torch.profiler's time by kernel. Build logs go to
chiprun_out/gat_variants_build_<tag>.log. It runs only on a CUDA card and
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent


def _use(csrc: str):
    from qagnn_tpu_torch.ops import _build
    _build.CSRC = pathlib.Path(csrc).resolve()
    return _build


def build(csrc: str, passes: str) -> None:
    _use(csrc).build_all({"fwd": ["gat_fwd"], "demb": ["gat_demb"],
                          "dw": ["gat_dw", "gat_bwd"]}
                         .get(passes, ["gat_bwd"]), verbose=True)


def gap(got, want):
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max()) for g, w in pairs)


def run_fwd(csrc: str, D: int, HD: int, tag: str, dtype: str) -> None:
    import torch
    _use(csrc)
    import chip_smoke as cs
    from qagnn_tpu_torch.ops import gat_kernels as gk
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dt, heads = torch.device("cuda"), getattr(torch, dtype), cs.HEADS
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    src, dst, mask = cs.graph_inputs(gen, dev, cs.E)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    nq = (r(cs.G, cs.N, HD) / (HD // heads) ** 0.5).to(dt)
    nk, nm = ((r(cs.G, cs.N, HD) * 0.5).to(dt) for _ in range(2))
    emb = torch.relu(r(cs.G, cs.E, D)).to(dt)
    w, b = r(D, HD) * 0.05, r(HD) * 0.1
    a_args = (nq, nk, emb, w, b, src, dst, mask, heads)
    scores, gmax = gk.pass_a_scores_plain(*a_args)
    scale = torch.rand((cs.G, cs.N, heads), generator=gen, device=dev)
    c_args = (nm, emb, w, b, scores, gmax, scale, src, dst, mask)
    out = torch.zeros((cs.G, cs.N, HD), device=dev)
    scratch = out.clone()        # pass C adds into it when timed
    for name, fn, plain in (
            ("pass_a", lambda **k: gk.pass_a_scores(*a_args, **k),
             lambda: gk.pass_a_scores_plain(*a_args)),
            ("pass_c", lambda **k: gk.pass_c(*c_args, scratch, heads, **k),
             lambda: gk.pass_c_plain(*c_args, out.clone(), heads))):
        err = gap(gk.pass_c(*c_args, out.clone(), heads)
                  if name == "pass_c" else fn(), plain())
        ms = cs.device_ms(fn, iters=10)
        ms0 = cs.device_ms(lambda: fn(_route=0), iters=10)
        print(f"{tag} D={D} HD={HD} {dtype} {name} {ms:.4f} ms (route 0 "
              f"{ms0:.4f})  gap {err:.2e}  [{cs.card_line()}]", flush=True)
        cs.profile_kernels(f"{tag} {name}", fn, iters=5)


def run_demb(csrc: str, D: int, HD: int, tag: str, dtype: str,
             widths: bool = False) -> None:
    import torch
    _use(csrc)
    import chip_smoke as cs
    from qagnn_tpu_torch.ops import gat_kernels as gk
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    mask = cs.graph_inputs(gen, dev, cs.E)[2]
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    cot = (r(cs.G, cs.E, HD) * mask[..., None]).to(dt)
    w, add = r(D, HD) * 0.05, (r(cs.G, cs.E, D) * 0.1).to(dt)
    out = torch.empty_like(add)
    chosen = gk.demb_plan(D, HD, dt)
    plans = [gk.demb_plan(D, HD, dt, bn=bn) for bn in gk.DEMB_WIDTHS[dt]] \
        if widths else [chosen]
    for p in plans:
        if p.smem > gk.TC_SMEM_LIMIT:
            continue
        call = lambda: gk.bwd_demb(cot, w, add, out, _plan=p)  # noqa: E731
        err = gap(call(), gk.bwd_demb_plain(cot, w, add))
        ms = cs.device_ms(call, iters=10)
        print(f"{tag} D={D} HD={HD} {dtype} demb {ms:.4f} ms  gap {err:.2e}"
              f"  tiles {p.bm} x {p.bn} ({p.n_tiles} over D), ring "
              f"{p.stages}{'  (the plan)' if p == chosen else ''}  "
              f"[{cs.card_line()}]", flush=True)
    cs.profile_kernels(f"{tag} demb", lambda: gk.bwd_demb(cot, w, add, out),
                       iters=5)


def run_dw(csrc: str, D: int, HD: int, tag: str, dtype: str,
           widths: bool = False) -> None:
    import torch
    _use(csrc)
    import chip_smoke as cs
    from qagnn_tpu_torch.ops import gat_kernels as gk
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    mask = cs.graph_inputs(gen, dev, cs.E)[2]
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    emb = torch.relu(r(cs.G, cs.E, D)).to(dt)
    cot = (r(cs.G, cs.E, HD) * mask[..., None]).to(dt)
    want = gk.bwd_dw_plain(emb, cot)
    e2, c2 = emb.view(-1, D), cot.view(-1, HD)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    R = cs.G * cs.E
    mm_ms = cs.device_ms(lambda: torch.mm(e2.t(), c2), iters=10)
    r0_ms = cs.device_ms(lambda: gk.bwd_dw(emb, cot, _route=0), iters=10)
    print(f"{tag} D={D} HD={HD} {dtype} dw torch.mm {mm_ms:.4f} ms, route 0 "
          f"{r0_ms:.4f} ms  [{cs.card_line()}]", flush=True)
    chosen = gk.dw_plan(D, HD, R, dt, n_sm)
    plans = [chosen]
    if widths:
        for bm, bn in gk.DW_TILES[dt]:
            base = gk.dw_plan(D, HD, R, dt, n_sm, bm=bm, bn=bn)
            plans += [gk.dw_plan(D, HD, R, dt, n_sm, bm=bm, bn=bn,
                                 n_ranges=max(1, int(base.n_ranges * f)))
                      for f in (0.5, 1, 2)]
    for p in dict.fromkeys(plans):
        call = lambda: gk.bwd_dw(emb, cot, _plan=p)  # noqa: E731
        err = gap(call(), want)
        ms = cs.device_ms(call, iters=10)
        print(f"{tag} D={D} HD={HD} {dtype} dw {ms:.4f} ms  gap {err:.2e}  "
              f"tiles {p.bm} x {p.bn} ({p.n_tiles}), {p.n_ranges} ranges of "
              f"{p.chunk} slots, ring {p.stages}"
              f"{'  (the plan)' if p == chosen else ''}  "
              f"[{cs.card_line()}]", flush=True)
    cs.profile_kernels(f"{tag} dw", lambda: gk.bwd_dw(emb, cot), iters=5)


def run(csrc: str, D: int, HD: int, tag: str, dtype: str) -> None:
    import torch
    _use(csrc)
    import chip_smoke as cs
    from qagnn_tpu_torch.ops import gat_kernels as gk
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dt, heads = torch.device("cuda"), getattr(torch, dtype), cs.HEADS
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    src, dst, mask = cs.graph_inputs(gen, dev, cs.E)
    t = cs.gat_bwd_inputs(gen, dev, D, HD, heads, src, dst, mask, dt)

    p1 = (t["gout"], t["nm"], t["emb"], t["w_me"], t["b_me"], t["scores"],
          t["gmax"], t["scale"], src, dst, mask, t["carry"])
    acc1 = (t["dnm0"], t["dscale0"])
    want1 = gk.bwd_pass1_plain(*p1, *(x.clone() for x in acc1), heads)
    d_denom = torch.randn(t["scale"].shape, generator=gen, device=dev) * 0.1
    p2 = (t["nq"], t["nk"], t["emb"], t["w_ke"], t["b_ke"], t["scores"],
          t["gmax"], want1[1], t["scale"], d_denom, src, dst, mask)
    acc2 = (want1[0], torch.randn(t["dnm0"].shape, generator=gen, device=dev),
            torch.randn(t["dnm0"].shape, generator=gen, device=dev))
    for name, fn, plain, p, acc in (
            ("pass1", gk.bwd_pass1, gk.bwd_pass1_plain, p1, acc1),
            ("pass2", gk.bwd_pass2, gk.bwd_pass2_plain, p2, acc2)):
        got = fn(*p, *(x.clone() for x in acc), heads)
        err = gap(got, plain(*p, *(x.clone() for x in acc), heads))
        kept = tuple(x.clone() for x in acc)
        ms = cs.device_ms(lambda: fn(*p, *kept, heads), iters=10)
        print(f"{tag} D={D} HD={HD} {dtype} {name} {ms:.4f} ms  gap "
              f"{err:.2e}  [{cs.card_line()}]", flush=True)
        cs.profile_kernels(f"{tag} {name}", lambda: fn(*p, *kept, heads),
                           iters=5)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("D", type=int)
    ap.add_argument("HD", type=int)
    ap.add_argument("variants", nargs="+", help="tag=DIR")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--passes", default="bwd",
                    choices=("bwd", "fwd", "demb", "dw"))
    ap.add_argument("--widths", action="store_true",
                    help="demb: time every column tile width that fits; dw: "
                         "every tile, at three counts of slot ranges")
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        build(args.variants[0], args.passes)
        return 0
    if args.run:
        tag, csrc = args.variants[0].split("=", 1)
        if args.passes == "demb":
            run_demb(csrc, args.D, args.HD, tag, args.dtype, args.widths)
        elif args.passes == "dw":
            run_dw(csrc, args.D, args.HD, tag, args.dtype, args.widths)
        else:
            {"fwd": run_fwd}.get(args.passes, run)(csrc, args.D, args.HD,
                                                   tag, args.dtype)
        return 0
    pairs = [v.split("=", 1) for v in args.variants]
    logs = ROOT / "chiprun_out"
    logs.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    procs = [(tag, subprocess.Popen(
        [sys.executable, __file__, "0", "0", csrc, "--build", "--passes",
         args.passes],
        stdout=open(logs / f"gat_variants_build_{tag}.log", "w"),
        stderr=subprocess.STDOUT)) for tag, csrc in pairs]
    failed = [tag for tag, p in procs if p.wait() != 0]
    print(f"built {len(procs)} copies in {time.perf_counter() - t0:.1f} s"
          + (f"; failed: {failed}" if failed else ""), flush=True)
    for tag, csrc in pairs:
        if tag not in failed:
            subprocess.run([sys.executable, __file__, str(args.D),
                            str(args.HD), f"{tag}={csrc}", "--run",
                            "--dtype", args.dtype, "--passes", args.passes]
                           + (["--widths"] if args.widths else []),
                           check=False)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
