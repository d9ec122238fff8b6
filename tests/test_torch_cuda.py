"""The port's CUDA kernels against their plain versions on the card, at
small sizes.  Every test here needs an NVIDIA GPU and skips, when it
runs, on a machine without one.  On the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerance: f32 rtol = atol = 1e-5 (atomics reorder the sums); bf16 one
bf16 step (2^-7).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

RTOL = ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _matrix(dev, n=300, seed=0):
    import repro_torch.sparse as ts

    return ts.power_law_csr(n, n, avg_degree=6.0, alpha=1.6, seed=seed,
                            device=dev)


def _dense(dev, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dev)


@pytest.mark.parametrize("strategy,skew", [
    ("segment", None), ("accumulate", None), ("segment", (8, 2)),
    ("parallel", (8, 0))])
@pytest.mark.parametrize("G", [8, 32])
@pytest.mark.parametrize("n_dense", [40, 256])
def test_eb_kernel_matches_plain(dev, strategy, skew, G, n_dense):
    from repro_torch.kernels import spmm_eb

    a = _matrix(dev)
    kw = {} if skew is None else dict(group_size=G, split_threshold=skew[0],
                                      merge_threshold=skew[1])
    g = a.grouped(128, **kw)
    b = _dense(dev, (a.shape[1], n_dense), 1)
    args = dict(n_rows=a.shape[0], nnz_tile=128, group_size=G,
                strategy=strategy, heavy_tiles=g.heavy_tiles)
    before = spmm_eb.KERNEL.launches
    got = spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b, col_tile=128, **args)
    assert spmm_eb.KERNEL.launches == before + 1
    want = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b, **args)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "tanh",
                                 "sigmoid"])
@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_epilogue_kernel_matches_plain(dev, act, out_dtype):
    from repro_torch.core import Epilogue
    from repro_torch.kernels import common

    acc = _dense(dev, (300, 40), 2)
    ep = Epilogue(act, bias=True, residual=True, out_dtype=out_dtype)
    ops = dict(bias=_dense(dev, (40,), 3), residual=_dense(dev, (300, 40), 4))
    got = common.apply_epilogue(acc.clone(), ep, **ops)
    want = common.apply_epilogue_plain(acc.clone(), ep, **ops)
    assert got.dtype == want.dtype
    tol = 2.0 ** -7 if out_dtype else RTOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("row_tile", [4, 8, 32])
@pytest.mark.parametrize("n_dense", [40, 256])
def test_rb_kernel_matches_plain(dev, row_tile, n_dense):
    from repro_torch.core import Epilogue
    from repro_torch.kernels import spmm_rb

    a = _matrix(dev, seed=5)
    e = a.ell(row_tile=row_tile)
    b = _dense(dev, (a.shape[1], n_dense), 6)
    kw = dict(n_rows=a.shape[0], epilogue=Epilogue("gelu", bias=True),
              bias=_dense(dev, (n_dense,), 7))
    got = spmm_rb.spmm_rb(e.cols, e.vals, b, row_tile=row_tile,
                          col_tile=128, **kw)
    want = spmm_rb.spmm_rb_plain(e.cols, e.vals, b, **kw)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_user_strategy_raises_on_cuda(dev):
    import repro_torch.sparse as ts
    from repro_torch.core import Schedule, register_strategy, spec_segment

    register_strategy("t_cuda_user", spec_segment, overwrite=True)
    a = _matrix(dev)
    with pytest.raises(NotImplementedError, match="no CUDA realization"):
        ts.spmm(a, _dense(dev, (a.shape[1], 8), 8),
                schedule=Schedule(nnz_tile=64, group_size=8,
                                  strategy="t_cuda_user"))


@pytest.mark.parametrize("schedule", ["auto", "RB+PR"])
def test_gcn_forward_on_cuda_matches_cpu(dev, schedule):
    from repro_torch.models import GCN, normalized_adjacency

    import repro_torch.sparse as ts

    raw = ts.graph_pattern_csr("social", 500, seed=0, device="cpu")
    adj_cpu = normalized_adjacency(raw, device="cpu")
    adj = normalized_adjacency(raw, device=dev)
    x = _dense("cpu", (500, 16), 9)
    params = {k: np.random.default_rng(i).standard_normal(s).astype(
        np.float32) * 0.1 for i, (k, s) in enumerate(
        (("w1", (16, 32)), ("b1", (32,)), ("w2", (32, 4))))}
    want = GCN.from_jax_params(params, schedule=schedule, device="cpu")(
        adj_cpu, x)
    got = GCN.from_jax_params(params, schedule=schedule, device=dev)(
        adj, x.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
