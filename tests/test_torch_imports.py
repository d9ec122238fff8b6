"""Import hygiene of the port: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the entry points
refuse to run on the CPU unless asked to by ``device="cpu"``."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_port_has_its_kernel_sources():
    from repro_torch.kernels import build

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert {p.stem for p in csrc.glob("*.cu")} == set(build.SOURCES) == {
        "spmm_eb", "spmm_rb", "sddmm", "fused_attention_fwd",
        "fused_attention_bwd", "segment_reduce", "grouped_matmul",
        "eb_partials", "attn_user", "grouped_matmul_dw"}
    # the epilogue is fused into the kernels; the headers they share
    assert {p.name for p in csrc.glob("*.cuh")} == {
        "attention.cuh", "epilogue.cuh", "spmm.cuh"}


def test_the_scan_covers_the_fuse_package_and_every_kernel_module():
    scanned = {str(p.relative_to(ROOT / "src" / "repro_torch"))
               for p in PORT_FILES if p.is_relative_to(ROOT / "src")}
    assert {"fuse/__init__.py", "fuse/ir.py", "fuse/rules.py",
            "fuse/legality.py", "fuse/planner.py", "fuse/execute.py",
            "kernels/segment_reduce.py", "configs/__init__.py",
            "configs/base.py", "configs/qwen3_moe_235b.py",
            "models/moe.py", "models/transformer.py",
            "models/registry.py", "serve/engine.py",
            "launch/serve.py", "launch/hillclimb.py", "launch/train.py",
            "train/optimizer.py", "train/train_step.py", "train/trainer.py",
            "checkpoint/manager.py", "data/synthetic.py",
            "distributed/collectives.py", "distributed/fault_tolerance.py",
            "core/tree.py"} <= scanned
    assert {f"tune/{m}.py" for m in (
        "__init__", "measure", "cache", "space", "driver", "search",
        "attention", "calibrate")} <= scanned
    from repro_torch.kernels import build

    assert {f"kernels/{s}.py" for s in ("spmm_eb", "spmm_rb", "sddmm",
                                        "segment_reduce", "grouped_matmul",
                                        "eb_partials", "attn_user",
                                        "grouped_matmul_dw")} <= scanned
    assert len(build.SOURCES) == 10


def test_importing_every_port_module_loads_no_jax():
    """Transitive imports too: a fresh interpreter imports every module
    of the port and finds neither JAX nor the JAX package loaded."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in PORT_FILES if p.is_relative_to(ROOT / "src")]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_spmm_without_device_raises_when_cuda_is_absent(no_cuda):
    import repro_torch.sparse as ts

    a = ts.random_csr(16, 16, density=0.2, seed=0, device="cpu")
    b = torch.ones(16, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.spmm(a, b)
    assert ts.spmm(a, b, device="cpu").shape == (16, 4)


def test_entry_points_without_device_raise_when_cuda_is_absent(no_cuda):
    import repro_torch.fuse as tf
    import repro_torch.sparse as ts
    from repro_torch.models import (
        GCN,
        gcn_two_layer,
        graph_attention,
        normalized_adjacency,
    )

    a = ts.random_csr(16, 16, density=0.2, seed=0, device="cpu")
    x = torch.ones(16, 4)
    seg = torch.zeros(16, dtype=torch.int32)
    chain, params = tf.gcn_chain(a, (torch.ones(4, 4), torch.ones(4, 2)))
    for call in (lambda: ts.random_csr(16, 16, seed=0),
                 lambda: ts.graph_pattern_csr("roadnet", 16),
                 lambda: ts.CSR.from_numpy(np.array([0, 0]), [], [], (1, 1)),
                 lambda: normalized_adjacency(a),
                 lambda: GCN(4, 8, 2),
                 lambda: ts.sddmm(a.indices, a.indices, x, x),
                 lambda: ts.make_spmm(a.indices, a.indices, 16, 16),
                 lambda: ts.sparse_attention(a, x, x, x),
                 lambda: graph_attention(a, x, x, x),
                 lambda: ts.segment_reduce(seg, x, 1),
                 lambda: gcn_two_layer(a, x, torch.ones(4, 4),
                                       torch.ones(4, 2)),
                 lambda: tf.run_plan(tf.plan(chain), x, params)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_operands_on_another_device_than_requested_raise():
    import repro_torch.sparse as ts

    a = ts.random_csr(16, 16, density=0.2, seed=0, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        ts.spmm(a, torch.ones(16, 4, device="meta"), device="cpu")
