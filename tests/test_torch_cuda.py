"""The port's CUDA kernels (EB and RB SpMM, the epilogue, SDDMM, fused
attention forward and backward) against their plain versions on the
card, at small sizes, and the kernel paths' gradients against the
CPU's.  Every test here needs an NVIDIA GPU and skips, when it runs, on
a machine without one.  On the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerance: f32 rtol = atol = 1e-5 (atomics reorder the sums; SDDMM's
atol grows with d, the length of its dots); bf16 one bf16 step (2^-7).
Gradients: 1e-4, as they sum products of two such results.
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
    with torch.no_grad():
        want = GCN.from_jax_params(params, schedule=schedule, device="cpu")(
            adj_cpu, x)
        got = GCN.from_jax_params(params, schedule=schedule, device=dev)(
            adj, x.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# --- SDDMM, the SpMM backward, fused attention ----------------------------


@pytest.mark.parametrize("nnz", [1, 300, 1000])
@pytest.mark.parametrize("d", [1, 37, 64, 256])
@pytest.mark.parametrize("with_scale", [False, True])
def test_sddmm_kernel_matches_plain(dev, nnz, d, with_scale):
    from repro_torch.kernels import sddmm

    rng = np.random.default_rng(nnz + d)
    rows = torch.from_numpy(np.sort(rng.integers(0, 50, nnz)).astype(
        np.int32)).to(dev)
    cols = torch.from_numpy(rng.integers(0, 70, nnz).astype(np.int32)).to(dev)
    a, b = _dense(dev, (50, d), 10), _dense(dev, (70, d), 11)
    scale = _dense(dev, (nnz,), 12) if with_scale else None
    before = sddmm.KERNEL.launches
    got = sddmm.sddmm(rows, cols, a, b, scale, nnz_tile=128)
    assert sddmm.KERNEL.launches == before + 1
    torch.testing.assert_close(got, sddmm.sddmm_plain(rows, cols, a, b, scale),
                               rtol=RTOL, atol=RTOL * d)


@pytest.mark.parametrize("schedule", ["auto", "RB+PR", "EB+SR"])
def test_spmm_backward_on_cuda_matches_cpu(dev, schedule):
    import repro_torch.sparse as ts
    from repro_torch.core import Epilogue
    from repro_torch.kernels import sddmm, spmm_eb

    grads = {}
    for where in ("cpu", dev):
        a = _matrix(where, seed=3)
        a.vals.requires_grad_()
        b = _dense(where, (a.shape[1], 40), 13).requires_grad_()
        bias = _dense(where, (40,), 14).requires_grad_()
        res = _dense(where, (a.shape[0], 40), 15).requires_grad_()
        before = (sddmm.KERNEL.launches, spmm_eb.KERNEL.launches)
        out = ts.spmm(a, b, schedule, bias=bias, residual=res,
                      epilogue=Epilogue("relu"), device=where)
        out.backward(_dense(where, tuple(out.shape), 16))
        grads[str(where)] = [t.grad.cpu() for t in (a.vals, b, bias, res)]
        if where == dev:
            # dvals on the SDDMM kernel, dB on the EB kernel
            assert sddmm.KERNEL.launches == before[0] + 1
            assert spmm_eb.KERNEL.launches > before[1]
    for g_cuda, g_cpu in zip(grads[str(dev)], grads["cpu"]):
        torch.testing.assert_close(g_cuda, g_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shuffled", [False, True])
def test_make_spmm_kernel_on_cuda_matches_cpu(dev, shuffled):
    import repro_torch.sparse as ts
    from repro_torch.kernels import sddmm, spmm_eb

    coo = _matrix("cpu", seed=6).tocoo()
    order = (torch.from_numpy(np.random.default_rng(6).permutation(
        coo.nnz)) if shuffled else torch.arange(coo.nnz))
    results = {}
    for where in ("cpu", dev):
        rows, cols = coo.rows[order].to(where), coo.cols[order].to(where)
        fn = ts.make_spmm(rows, cols, *coo.shape, impl="kernel",
                          device=where)
        vals = coo.vals.detach()[order].to(where).requires_grad_()
        b = _dense(where, (coo.shape[1], 40), 21).requires_grad_()
        before = (sddmm.KERNEL.launches, spmm_eb.KERNEL.launches)
        out = fn(vals, b)
        out.backward(_dense(where, tuple(out.shape), 22))
        results[str(where)] = [t.cpu() for t in (out.detach(), vals.grad,
                                                 b.grad)]
        if where == dev:
            # forward and dB on the EB kernel, dvals on the SDDMM kernel
            assert sddmm.KERNEL.launches == before[0] + 1
            assert spmm_eb.KERNEL.launches == before[1] + 2
    for g_cuda, g_cpu in zip(results[str(dev)], results["cpu"]):
        torch.testing.assert_close(g_cuda, g_cpu, rtol=1e-4, atol=1e-4)


def _attention_case(dev, n_rows, n_kv, heads, d, dv, seed):
    """A pattern with empty rows, single-nonzero rows, a long row, and
    columns in no order within a row (so the dK/dV scatters hit columns
    unsorted)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 6, n_rows)
    lengths[::7] = 0
    lengths[1::7] = 1
    lengths[3] = 100  # a row longer than three warp chunks
    cols = np.concatenate([rng.choice(n_kv, int(n), replace=n > n_kv)
                           for n in lengths]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(heads, n, w, generator=g).to(dev)
                   for n, w in ((n_rows, d), (n_kv, d), (n_kv, dv),
                                (n_rows, dv)))
    bias = torch.randn(len(cols), generator=g).to(dev)
    return (torch.from_numpy(indptr).to(dev), torch.from_numpy(cols).to(dev),
            q, k, v, do, bias)


@pytest.mark.parametrize("heads,d,dv", [(1, 16, 16), (4, 64, 64),
                                        (2, 37, 130), (3, 256, 8)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_attention_kernels_match_plain(dev, heads, d, dv, with_bias):
    from repro_torch.kernels import fused_attention as fa

    indptr, cols, q, k, v, do, bias = _attention_case(dev, 90, 70, heads, d,
                                                      dv, heads + d)
    bias = bias if with_bias else None
    kw = dict(scale=d ** -0.5, bias=bias)
    before = (fa.FWD_KERNEL.launches, fa.BWD_KERNEL.launches)
    got = fa.fused_sparse_attention(indptr, cols, q, k, v, **kw)
    want = fa.fused_sparse_attention_plain(indptr, cols, q, k, v, **kw)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=RTOL, atol=RTOL)
    empty = (indptr[1:] == indptr[:-1]).nonzero()[:, 0]
    assert bool((got[1][:, empty] == fa.NEG_INF).all())
    assert bool((got[2][:, empty] == 0).all())
    got_b = fa.fused_sparse_attention_bwd(indptr, cols, q, k, v, do, got[1],
                                          got[2], **kw)
    want_b = fa.fused_sparse_attention_bwd_plain(indptr, cols, q, k, v, do,
                                                 want[1], want[2], **kw)
    for g_, w_ in zip(got_b, want_b):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)
    assert (fa.FWD_KERNEL.launches, fa.BWD_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)


def test_graph_attention_grads_on_cuda_match_cpu(dev):
    from repro_torch.models import graph_attention

    grads, outs = {}, {}
    for where in ("cpu", dev):
        a = _matrix(where, n=120, seed=4)
        q, k, v = (_dense(where, (120, 2, 32), s).requires_grad_()
                   for s in (17, 18, 19))
        out = graph_attention(a, q, k, v, device=where)
        out.backward(_dense(where, tuple(out.shape), 20))
        outs[str(where)] = out.detach().cpu()
        grads[str(where)] = [t.grad.cpu() for t in (q, k, v)]
    torch.testing.assert_close(outs[str(dev)], outs["cpu"], rtol=RTOL,
                               atol=RTOL)
    for g_cuda, g_cpu in zip(grads[str(dev)], grads["cpu"]):
        torch.testing.assert_close(g_cuda, g_cpu, rtol=1e-4, atol=1e-4)
