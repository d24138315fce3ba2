"""Package rules of qagnn_tpu_torch.

The port and chip_smoke.py import neither JAX, flax nor the JAX package.
This is a scan of the sources: the interpreter may have imported jax before
any test runs, so sys.modules would prove nothing. The CUDA sources include
only the CUDA toolkit's and the C library's headers and the package's own
(a plain C interface: nothing of PyTorch, pybind or JAX's FFI); the C++
host code of `native/` only the C++ standard library's. No module imports
`transformers` at its top or any of its model classes (the port runs every
model on its own modules; tokenizers and configs stay lazy imports). And an
entry point run with no device named refuses to fall back to the CPU when
there is no card.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "qagnn_tpu")
SOURCES = sorted((ROOT / "qagnn_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


CSRC = sorted((ROOT / "qagnn_tpu_torch" / "csrc").glob("*.cu*"))
ALLOWED_INCLUDES = {"cuda.h", "cuda_runtime.h", "cuda_bf16.h", "stdint.h"}


NATIVE = sorted((ROOT / "qagnn_tpu_torch" / "native").glob("*.cc"))
STANDARD_HEADERS = {"algorithm", "cstddef", "cstdint", "cstring", "numeric",
                    "vector"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "__import__", "import_module"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# the only names of `transformers` the port may import, inside a function:
# tokenizers, configs, and `utils` (the hub cache's file lookup)
TRANSFORMERS_ALLOWED = ("Tokenizer", "TokenizerFast", "Config", "utils")


def _transformers_imports(path: Path):
    """(imported at the module's top, name) of every import of
    transformers in the file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = {id(node) for node in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "transformers":
                    yield id(node) in top, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module.split(".")[0] == "transformers":
            for alias in node.names:
                yield id(node) in top, alias.name


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_transformers_models(path):
    found = list(_transformers_imports(path))
    assert not [n for top, n in found if top], \
        f"{path.relative_to(ROOT)} imports transformers at its top"
    bad = sorted(n for _, n in found if not n.endswith(TRANSFORMERS_ALLOWED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_transformers_scan_finds_model_classes():
    """The scan sees a model class imported inside a function, and the
    port's lazy tokenizer imports."""
    probe = ROOT / "qagnn_tpu" / "preprocess" / "graph_extraction.py"
    assert (False, "RobertaForMaskedLM") in set(_transformers_imports(probe))
    port = ROOT / "qagnn_tpu_torch" / "preprocess" / "graph_extraction.py"
    assert set(_transformers_imports(port)) == {(False, "AutoTokenizer")}


@pytest.mark.parametrize("path", CSRC,
                         ids=[str(p.relative_to(ROOT)) for p in CSRC])
def test_cuda_sources_include_only_toolkit_headers(path):
    text = path.read_text()
    own = {p.name for p in CSRC}
    includes = set(re.findall(r'#include\s*[<"]([^>"]+)[>"]', text))
    assert includes, path
    assert includes <= ALLOWED_INCLUDES | own, includes
    assert not re.search(r"\b(jax|flax|optax|qagnn_tpu(?!_torch|/))\b", re.sub(
        r"//.*", "", text))


@pytest.mark.parametrize("path", NATIVE,
                         ids=[str(p.relative_to(ROOT)) for p in NATIVE])
def test_native_sources_include_only_standard_headers(path):
    text = path.read_text()
    includes = set(re.findall(r'#include\s*[<"]([^>"]+)[>"]', text))
    assert includes and includes <= STANDARD_HEADERS, includes
    assert not re.search(r"\b(jax|flax|optax|qagnn_tpu(?!_torch|/))\b",
                         re.sub(r"//.*", "", text))


def test_scan_sees_the_package():
    assert ROOT.joinpath("chip_smoke.py").exists()
    names = {p.name for p in SOURCES}
    assert {"gat_kernels.py", "gat_unproj_kernels.py", "gat_attention.py",
            "edge_encoder_kernels.py", "gnn.py",
            "qagnn.py", "step.py", "convert.py", "optim.py", "losses.py",
            "cli.py", "loader.py", "graphs.py", "statements.py",
            "synthetic.py", "batching.py", "hf_loading.py", "checkpoint.py",
            "build.py", "chip_smoke.py"} <= names
    assert [p.name for p in NATIVE] == ["packer.cc"]
    assert {"gat_fwd.cu", "gat_bwd.cu", "gat_unproj.cu", "gat_common.cuh",
            "gat_tc_common.cuh", "gat_fwd_tc.cuh", "gat_bwd_tc.cuh",
            "mma_tile.cuh", "edge_hidden.cu", "edge_moments.cu"} \
        <= {p.name for p in CSRC}
    # the scan itself finds a forbidden import
    probe = ROOT / "qagnn_tpu" / "ops" / "gat_attention.py"
    assert "jax" in set(_imported_roots(probe))


def test_eval_step_refuses_cpu_fallback(monkeypatch):
    from qagnn_tpu_torch.train.step import make_eval_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(torch.nn.Linear(2, 2))


def test_detail_step_refuses_cpu_fallback(monkeypatch):
    from qagnn_tpu_torch.train.step import make_detail_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_detail_step(torch.nn.Linear(2, 2))


def test_cli_module_refuses_cpu_fallback(tmp_path):
    """`python -m qagnn_tpu_torch.cli` with no --device on a host without a
    card exits with an error instead of training on the CPU."""
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "qagnn_tpu_torch.cli", "--save_dir",
         str(tmp_path / "out")], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert not (tmp_path / "out").exists()


def test_the_scan_covers_the_preprocess_modules():
    scanned = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for name in ("__init__", "kg", "conceptnet", "convert", "lemma",
                 "grounding", "graph_extraction", "biomed", "driver"):
        assert f"qagnn_tpu_torch/preprocess/{name}.py" in scanned, name
    assert "qagnn_tpu_torch/models/mlm_head.py" in scanned


def test_the_scan_covers_the_grid_modules():
    """The scan reaches parallel/, whose ranks must import no JAX either."""
    scanned = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for name in ("__init__", "launch", "mesh", "graph_sharding",
                 "edge_shard_kernels", "edge_shard_map", "dryrun"):
        assert f"qagnn_tpu_torch/parallel/{name}.py" in scanned, name
