"""The port's tools (qagnn_tpu_torch/tools/) on the CPU.

  * parity_check: the three-way bands pass at small shapes with the
    kernels' plain versions as the candidate and print their tables; the
    f32 references equal the JAX package's (the unprojected op's scatter
    value and seven gradients at the JAX tool's inputs, and the message
    passing's loss and parameter gradients from flax-initialised
    variables) within 1e-5 of the largest value; a candidate whose bf16
    gradient is scaled by 1.5 fails.
  * profile_step at G=2, N=16, E=64, D=32, k=2: it prints warm / traced /
    done and writes a Chrome trace, and its first step's loss equals the
    JAX QAGNNMessagePassing's train-mode loss on the same inputs and
    converted weights (dropout 0) within 1e-4 relative.
  * trace_summary on a hand-written trace in torch.profiler's schema (the
    port's __global__ names, a memcpy and a memset; CPU ops, runtime calls,
    annotations and flows ignored), and on profile_step's CPU trace, which
    has no device events and exits 1.
  * the kernel map: every __global__ name it gives is one in csrc/.
  * every tool refuses to run without a card unless the CPU is named.
"""

import contextlib
import gzip
import io
import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qagnn_tpu.models.gnn import QAGNNMessagePassing as JaxMP
from qagnn_tpu.ops.gat_attention import (
    relational_gat_attention_nodes as jax_attention,
)

from qagnn_tpu_torch.models.gnn import QAGNNMessagePassing
from qagnn_tpu_torch.ops import edge_encoder_kernels as ek
from qagnn_tpu_torch.tools import dress_rehearsal
from qagnn_tpu_torch.tools import parity_check as pc
from qagnn_tpu_torch.tools import profile_step as ps
from qagnn_tpu_torch.tools import trace_summary as ts
from qagnn_tpu_torch.utils.config import TrainConfig
from qagnn_tpu_torch.utils.convert import grads_to_flax, load_flax_variables

ROOT = Path(__file__).resolve().parents[1]
TOOLS = sorted((ROOT / "qagnn_tpu_torch" / "tools").glob("*.py"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


# -- parity_check -----------------------------------------------------------

@pytest.mark.parametrize("which", ["op", "projected"])
def test_parity_check_small_passes_on_cpu(which, capsys):
    if which == "op":
        assert pc.check(small=True, device="cpu")
    else:
        assert pc.check_projected(small=True, device="cpu")
    out = capsys.readouterr().out
    assert "PARITY OK" in out and "f32_gap" in out
    assert ("dekb" in out) if which == "op" else ("key_e.kernel" in out)


def test_parity_main_exits_0_on_cpu(capsys):
    assert pc.main(["--small", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PARITY OK" in out and "[projected] PARITY OK" in out


@pytest.mark.parametrize("small", [True, False], ids=["small", "bench"])
def test_op_reference_matches_jax(small):
    """The port's f32 reference (the scatter backend on the CPU) against
    the JAX package's scatter backend on the JAX tool's inputs."""
    inputs = pc.op_inputs(small)
    heads = pc.OP_SHAPES[small][-1]
    value, grads = pc.op_loss_and_grads(inputs, heads, "scatter",
                                        torch.float32, "cpu")
    *floats, src, dst, mask = inputs

    def loss(diff):
        r = [t.reshape(t.shape[0], t.shape[1], heads, -1) for t in diff]
        out = jax_attention(*r, jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(mask), backend="scatter")
        return jnp.sum(out.astype(jnp.float32) ** 2)

    want, want_grads = jax.jit(jax.value_and_grad(loss))(
        [jnp.asarray(a) for a in floats])
    _close(value, float(want), 1e-5, "value")
    for name, got, w in zip(pc.GRAD_NAMES, grads, want_grads):
        _close(got, w, 1e-5, name)


def _flax_projected(small):
    G, N, E, D, K, H = pc.PROJECTED_SHAPES[small]
    inputs = pc.projected_inputs(small)
    jargs = tuple(jnp.asarray(a) for a in inputs)
    jmp = JaxMP(k=K, n_ntype=pc.N_NTYPE, n_etype=pc.N_ETYPE, hidden_size=D,
                dropout=0.0, head_count=H, backend="scatter")
    variables = jmp.init(jax.random.PRNGKey(0), *jargs, train=False)
    return inputs, jargs, jmp, jax.tree.map(np.asarray, variables)


def _state_of(small, variables):
    model = pc.projected_model(small, "scatter", torch.float32)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    return model.state_dict()


def test_projected_reference_matches_jax():
    inputs, jargs, jmp, variables = _flax_projected(True)
    state = _state_of(True, variables)
    value, grads = pc.projected_loss_and_grads(state, inputs, True,
                                               "scatter", torch.float32,
                                               "cpu")

    def loss(params):
        out, _ = jmp.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *jargs, train=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) ** 2)

    want, want_grads = jax.jit(jax.value_and_grad(loss))(
        variables["params"])
    _close(value, float(want), 1e-5, "loss")
    model = pc.projected_model(True, "scatter", torch.float32)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[name])
    got_flat = jax.tree_util.tree_flatten_with_path(grads_to_flax(model))[0]
    want_flat = dict(jax.tree_util.tree_flatten_with_path(want_grads)[0])
    top = max(float(np.abs(w).max()) for w in want_flat.values())
    assert len(got_flat) == len(want_flat)
    for path, g in got_flat:
        err = float(np.abs(g - np.asarray(want_flat[path])).max())
        assert err <= 1e-5 * top, (jax.tree_util.keystr(path), err)
    # the check runs from `state`: its reference loss is the JAX one
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        pc.check_projected(small=True, device="cpu", state=state)
    ref = re.search(r"forward loss: ref=(\S+)", printed.getvalue())
    assert float(ref.group(1)) == pytest.approx(float(want), rel=1e-5)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 1.5 * g


def _broken(fn):
    """`fn` with the gradient of its first argument scaled by 1.5 where it
    computes in bfloat16: a fault of the bf16 path alone."""
    def wrapped(x, *rest):
        if x.dtype == torch.bfloat16:
            x = _ScaleGrad.apply(x)
        return fn(x, *rest)
    return wrapped


@pytest.mark.parametrize("which", ["op", "projected"])
def test_parity_check_fails_a_broken_candidate(which, monkeypatch, capsys):
    from qagnn_tpu_torch.models import gnn
    from qagnn_tpu_torch.ops import gat_attention

    if which == "op":
        monkeypatch.setattr(gat_attention, "gat_unprojected",
                            _broken(gat_attention.gat_unprojected))
        assert not pc.check(small=True, device="cpu")
    else:
        monkeypatch.setattr(gnn, "gat_projected_chained",
                            _broken(gnn.gat_projected_chained))
        assert not pc.check_projected(small=True, device="cpu")
    assert "PARITY FAIL" in capsys.readouterr().out


# -- profile_step -----------------------------------------------------------

SMALL = ps.Shapes(G=2, N=16, E=64, D=32, k=2)


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """profile() at SMALL on the CPU from flax-initialised variables, with
    dropout 0, in f32; and the JAX train-mode loss of the first step."""
    inputs = ps.step_inputs(SMALL)
    jargs = tuple(jnp.asarray(a) for a in inputs)
    jmp = JaxMP(k=SMALL.k, n_ntype=ps.N_NTYPE, n_etype=ps.N_ETYPE,
                hidden_size=SMALL.D, dropout=0.0, backend="scatter")
    variables = jax.tree.map(np.asarray, jmp.init(
        jax.random.PRNGKey(0), *jargs, train=False))
    out, _ = jmp.apply(variables, *jargs, train=True,
                       mutable=["batch_stats"])
    want = float(jnp.sum(out * out))

    model = QAGNNMessagePassing(SMALL.k, ps.N_NTYPE, ps.N_ETYPE, SMALL.D)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    trace_dir = tmp_path_factory.mktemp("prof")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = ps.profile(str(trace_dir), "cuda", "cpu", SMALL,
                            torch.float32, dropout=0.0,
                            state=model.state_dict())
    return result, printed.getvalue(), trace_dir, want


def test_profile_step_prints_and_writes_a_trace(profiled):
    result, printed, trace_dir, _ = profiled
    lines = printed.splitlines()
    assert [ln.split()[0] for ln in lines] == ["warm", "traced", "done"]
    assert float(lines[0].split()[1]) == result["warm"]
    assert np.isfinite(result["traced"])
    path = Path(result["trace"])
    assert path.parent == trace_dir and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # no kernel on the CPU
    assert result["launches"] == {} and result["routes"] == {}


def test_profile_step_first_loss_matches_jax(profiled):
    result, _, _, want = profiled
    assert abs(result["warm"] - want) <= 1e-4 * abs(want), \
        (result["warm"], want)


def test_trace_summary_refuses_a_cpu_trace(profiled, capsys):
    _, _, trace_dir, _ = profiled
    assert ts.main([str(trace_dir)]) == 1
    err = capsys.readouterr().err
    assert "no device events" in err and "profile_step.json" in err
    with pytest.raises(ts.NoDeviceEvents):
        ts.summarise(trace_dir)


# -- trace_summary ----------------------------------------------------------

FWD_TC = ("void (anonymous namespace)::fwd_pass_tc_kernel<0, 13>"
          "((anonymous namespace)::TcFwdArgs)")
REDUCE = "void reduce_partials_kernel(float const*, float*, int, int)"
MEMCPY = "Memcpy HtoD (Pageable -> Device)"


def _trace_events():
    def x(cat, name, dur, **kw):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
                "ts": 0, "dur": dur, **kw}
    return [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
        x("cpu_op", "aten::mm", 900.0),
        x("cuda_runtime", "cudaLaunchKernel", 5.0),
        x("python_function", "forward", 1000.0),
        x("gpu_user_annotation", "ProfilerStep#1", 2000.0),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 0,
         "tid": 7, "ts": 0},
        x("kernel", FWD_TC, 240.0),
        x("kernel", FWD_TC, 236.0),
        x("kernel", REDUCE, 3.0),
        x("kernel", REDUCE, 2.5),
        x("kernel", REDUCE, 1.5),
        x("gpu_memcpy", MEMCPY, 50.0),
        x("gpu_memset", "Memset (Device)", 1.0),
    ]


def test_trace_summary_of_a_hand_written_trace(tmp_path, capsys):
    older = tmp_path / "a" / "old.json"
    older.parent.mkdir()
    older.write_text(json.dumps({"traceEvents": []}))
    os.utime(older, (1, 1))
    newest = tmp_path / "b.json.gz"
    with gzip.open(newest, "wt") as f:
        json.dump({"traceEvents": _trace_events()}, f)
    assert ts.find_trace(tmp_path) == newest

    rows = ts.summarise(tmp_path)
    assert [r.name for r in rows] == [FWD_TC, MEMCPY, REDUCE,
                                      "Memset (Device)"]
    assert [r.count for r in rows] == [2, 1, 3, 1]
    assert rows[0].ms == pytest.approx(0.476)
    assert rows[2].ms == pytest.approx(0.007)
    assert ts.summarise(newest, top_n=2) == rows[:2]

    assert ts.main([str(tmp_path), "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"trace: {newest}"
    assert out[1] == "total device op time: 0.53 ms"
    assert len(out) == 3 + 2 and out[3].split()[:3] == ["0.48", "89.1", "2"]

    assert ts.kernel_counts(rows) == {"fwd_pass_tc_kernel": 2,
                                      "reduce_partials_kernel": 3,
                                      "Memcpy": 1, "Memset": 1}


def _bf16_routes(launches, D, several):
    """The routes a bf16 train step at width D takes: backward passes 1 and
    2 the rule's (`_edge_route`: route 2, the wgmma edge kernel, for a pass
    of `several` launches, route 1, the mma.sync one, for a pass of one
    with its demb product), route 1 for the other routed entry points."""
    from qagnn_tpu_torch.ops import gat_kernels as gk

    edge = gk._edge_route(torch.bfloat16, None, D, not several)
    route = {"gat_bwd_pass1": edge, "gat_bwd_pass2": edge}

    return {(k, route.get(k, 1)): n for k, n in launches.items()
            if k not in ("gat_pass_a_denoms", "edge_moments")}


def test_expected_kernels_of_a_train_step():
    """One train step at k=5 on the bf16 routes: what rows 6-12 launch,
    by __global__ name. Backward passes 1 and 2, a pass of one launch at
    D = 200, run their edge launch on route 1 (`edge_pass_tc_kernel`, the
    mma.sync kernel, which makes the demb product too), and each makes its
    dW in one `gat_bwd_dw` call (`dw_wgmma_kernel` and its partials'
    reduction)."""
    launches = {"gat_pass_a_scores": 5, "gat_pass_a_denoms": 5,
                "gat_pass_c": 5, "gat_bwd_pass1": 5, "gat_bwd_pass2": 5,
                "gat_bwd_dw": 10, "edge_moments": 1, "edge_hidden": 1,
                "edge_hidden_bwd": 1, "gat_unproj_scores": 1}
    from qagnn_tpu_torch.ops import gat_kernels as gk

    calls = ts.entry_calls(launches, _bf16_routes(launches, 200, False))
    assert ("gat_unproj_scores", 1) not in calls
    assert calls[("gat_pass_a_denoms", None)] == 5
    assert gk._edge_route(torch.bfloat16, None, 200, True) == 1
    assert ts.expected_kernels(calls) == {
        "fwd_pass_tc_kernel": 10, "pass_a_denoms_kernel": 5,
        "edge_pass_tc_kernel": 10, "dw_wgmma_kernel": 10,
        "reduce_partials_kernel": 21, "edge_moments_kernel": 1,
        "edge_hidden_tc_kernel": 1, "edge_rows_kernel": 1,
        "edge_hidden_bwd_tc_kernel": 1}


def test_expected_kernels_of_a_train_step_at_gnn_dim_512():
    """At gnn_dim 512 (4 heads: two head groups of 256 columns a pass,
    D = 512 past the 256 rows W holds in shared memory) a bf16 train step
    at k=5 calls each GAT entry point twice a layer, and route 2 of
    backward passes 1 and 2 streams W's rows in one edge launch a call
    (`edge_wgmma_kernel`, no demb product in a launch of a pass of several):
    one edge kernel a call, as at gnn_dim 200; each pass of two launches
    ends on one demb product (`gat_bwd_demb`) and, as every pass, one dW
    product over all of its columns (`gat_bwd_dw`), not one a call. The edge
    encoder's rows 11 and 12 take route 1 there too, all of D's column
    slices in one launch of each kernel a call."""
    from qagnn_tpu_torch.ops import gat_kernels as gk

    D, HD = gk.kernel_widths(512, 512, 4)
    per = len(gk.launches(HD, 4))
    assert (D, per) == (512, 2) and gk._bwd_streams(D)
    assert gk._edge_route(torch.bfloat16, None, D, False) == 2
    launches = {"gat_pass_a_scores": 5 * per, "gat_pass_a_denoms": 5 * per,
                "gat_pass_c": 5 * per, "gat_bwd_pass1": 5 * per,
                "gat_bwd_pass2": 5 * per, "gat_bwd_demb": 2 * 5,
                "gat_bwd_dw": 2 * 5, "edge_moments": 1, "edge_hidden": 1,
                "edge_hidden_bwd": 1}
    want = ts.expected_kernels(ts.entry_calls(
        launches, _bf16_routes(launches, D, True)))
    assert want["edge_wgmma_kernel"] == 2 * 5 * per == 20
    assert "edge_pass_tc_kernel" not in want
    assert want["dw_wgmma_kernel"] == want["edge_wgmma_kernel"] // per
    assert "dw_tc_kernel" not in want
    assert want["demb_tc_kernel"] == 10 and "demb_kernel" not in want
    assert want["fwd_pass_tc_kernel"] == 20
    assert want["reduce_partials_kernel"] == 20 + 10 + 1
    assert ek._hidden_route(torch.bfloat16, D, 39, 4) == 1
    assert want["edge_hidden_tc_kernel"] == want["edge_rows_kernel"] == 1
    assert want["edge_hidden_bwd_tc_kernel"] == 1
    assert "edge_hidden_kernel" not in want


def test_kernel_map_names_the_csrc_kernels():
    text = "\n".join(p.read_text() for p in
                     (ROOT / "qagnn_tpu_torch" / "csrc").glob("*.cu*"))
    names = {k for m in ts.PORT_KERNELS.values() for k in m}
    for name in names:
        assert re.search(r"__global__[^;{]{0,160}?\b" + name + r"\s*[<(]",
                         text), name
    entries = {e for e, _ in ts.PORT_KERNELS}
    assert entries == {"gat_pass_a_scores", "gat_pass_a_denoms",
                       "gat_pass_c", "gat_bwd_pass1", "gat_bwd_pass2",
                       "gat_bwd_demb", "gat_bwd_dw", "edge_moments",
                       "edge_hidden", "edge_hidden_bwd"}
    for name in ("fwd_pass_tc_kernel<0, 13>(x)", "void edge_rows_kernel(x)",
                 "void a::b::dw_tc_kernel<2, 16>(Args)",
                 "void a::dw_wgmma_kernel<__nv_bfloat16, 2, 192>(x)",
                 "void a::edge_wgmma_kernel<1, 4, false, 4>(x)",
                 "void edge_hidden_tc_kernel<float, 16, true>(x)",
                 "void a::edge_hidden_bwd_tc_kernel<__nv_bfloat16, 6, 8>(x)"):
        assert ts.kernel_base(name) in names


# -- the package's rules ----------------------------------------------------

def test_tools_refuse_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pc.check(small=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        pc.check_projected(small=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ps.main(["--trace-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        dress_rehearsal.rehearse(TrainConfig())
    assert not any(tmp_path.iterdir())


def test_the_package_scan_covers_the_tools():
    from test_torch_package import SOURCES, _imported_roots

    names = {"__init__", "parity_check", "profile_step", "trace_summary",
             "dress_rehearsal"}
    assert {p.stem for p in TOOLS} == names
    assert set(TOOLS) <= set(SOURCES)
    for path in TOOLS:
        assert not {"jax", "flax", "qagnn_tpu"} & set(_imported_roots(path))
