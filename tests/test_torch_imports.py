"""Import hygiene of the port: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the entry points
refuse to run on the CPU unless asked to by ``device="cpu"``."""
import ast
import pathlib

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
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    assert {p.stem for p in csrc.glob("*.cu")} == {
        "spmm_eb", "spmm_rb", "epilogue"}


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
    import repro_torch.sparse as ts
    from repro_torch.models import GCN, normalized_adjacency

    a = ts.random_csr(16, 16, density=0.2, seed=0, device="cpu")
    for call in (lambda: ts.random_csr(16, 16, seed=0),
                 lambda: ts.graph_pattern_csr("roadnet", 16),
                 lambda: ts.CSR.from_numpy(np.array([0, 0]), [], [], (1, 1)),
                 lambda: normalized_adjacency(a),
                 lambda: GCN(4, 8, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_operands_on_another_device_than_requested_raise():
    import repro_torch.sparse as ts

    a = ts.random_csr(16, 16, density=0.2, seed=0, device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        ts.spmm(a, torch.ones(16, 4, device="meta"), device="cpu")
