"""The port's CUDA kernels (EB and RB SpMM with their fused epilogue,
SDDMM, fused attention forward and backward, segment reduce, grouped
matmul) against
their plain versions on the card, at small sizes, the kernel paths'
gradients against the CPU's, the launches of the planned GCN and
readout, and those of the MoE layer and an LM decode step.  Every test
here needs an NVIDIA GPU and skips, when it runs, on a machine without
one.  On the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerance: EB and RB per output element, K_TERMS units of 2^-24 of the
magnitude of the terms entering it (plus one bf16 step for a bf16
output), and so segment-reduce sums over a hub of thousands of lanes;
other f32 kernels rtol = atol = 1e-5 (atomics reorder the sums;
SDDMM's atol grows with d, the length of its dots); bf16 one bf16 step
(2^-7).
Gradients: 1e-4, as they sum products of two such results.  Segment
max and min compare bit for bit (NaN positions equal, every other value
with the same bits): -0.0 orders below +0.0, so their order does not
matter.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

RTOL = ATOL = 1e-5
#: EB and RB against their plain versions, per output element: the two
#: sum the same f32 terms in other orders (and the epilogue's expf and
#: tanhf differ from torch's by an ulp or two), so the error is bounded by
#: K_TERMS units of 2^-24 of the magnitude of everything that enters that
#: output; a fixed atol cannot cover a row whose terms cancel.  The H100
#: runs of ``chip_smoke.py`` read k at most 4.66; 16 leaves a margin.
K_TERMS = 16


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


def _hub_matrix(dev, n=3000, hub_len=9000, long_len=700, seed=0):
    """CSR (n, n): short rows (0 to 12 nnz, some empty), row n // 30 a hub
    of ``hub_len`` nnz over several of the kernel's chunks, and row
    2n // 3 long enough (``long_len``) to cross a chunk boundary or two;
    values from a numpy seed."""
    from repro_torch.sparse import CSR

    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 13, size=n)
    lengths[n // 30], lengths[2 * n // 3] = hub_len, long_len
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate([rng.integers(0, n, size=k)
                              for k in lengths]).astype(np.int32)
    vals = rng.standard_normal(indptr[-1]).astype(np.float32)
    return CSR.from_numpy(indptr, indices, vals, (n, n), device=dev)


def _terms(plain, *args, bias=None, residual=None, **kw):
    """Sum over the terms entering each output of their magnitudes: the
    plain version on |values| and |B|, plus |bias| and |residual|."""
    t = plain(*[a.abs() if a.is_floating_point() else a for a in args],
              **kw)
    if bias is not None:
        t = t + bias.abs()
    if residual is not None:
        t = t + residual.abs()
    return t


def _assert_within_terms(got, want, terms, k=K_TERMS):
    """Per output: |got - want| <= k * 2^-24 * (its terms' magnitude
    + |want|), plus one bf16 step of |want| for a bf16 output."""
    assert got.dtype == want.dtype and got.shape == want.shape
    w = want.float()
    bound = k * 2.0 ** -24 * (terms + w.abs())
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * w.abs()
    err = (got.float() - w).abs()
    worst = float((err / bound.clamp_min(1e-30)).max())
    assert bool((err <= bound).all()), f"worst error {worst:.2f}x the bound"


@pytest.mark.parametrize("strategy,skew", [
    ("segment", None), ("accumulate", None), ("parallel", None),
    ("segment", (8, 2)), ("parallel", (8, 0)), ("accumulate", (8, 0))])
@pytest.mark.parametrize("G", [8, 32])
@pytest.mark.parametrize("n_dense", [40, 33, 256])
def test_eb_kernel_matches_plain(dev, strategy, skew, G, n_dense):
    from repro_torch.kernels import spmm_eb

    a = _matrix(dev)
    kw = {} if skew is None else dict(group_size=G, split_threshold=skew[0],
                                      merge_threshold=skew[1])
    g = a.grouped(128, **kw)
    assert (g.heavy_tiles > 0) == (skew is not None)
    b = _dense(dev, (a.shape[1], n_dense), 1)
    args = dict(n_rows=a.shape[0], nnz_tile=128, group_size=G,
                strategy=strategy, heavy_tiles=g.heavy_tiles)
    before = spmm_eb.KERNEL.launches
    got = spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b, col_tile=128, **args)
    assert spmm_eb.KERNEL.launches == before + 1
    want = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b, **args)
    _assert_within_terms(got, want, _terms(spmm_eb.spmm_eb_plain, g.rows,
                                           g.cols, g.vals, b, **args))


@pytest.mark.parametrize("strategy,G", [("segment", 32), ("segment", 8),
                                        ("parallel", 8), ("accumulate", 8)])
@pytest.mark.parametrize("n_dense", [40, 33, 256])
def test_eb_kernel_carry_walk_on_hub_rows(dev, strategy, G, n_dense):
    """A hub row over several chunks and a row over a chunk boundary: the
    carry rows the kernel writes equal ``eb_carry_plan``'s, the output
    matches the plain version, and a second launch gives the same bits."""
    from repro_torch.kernels import spmm_eb

    a = _hub_matrix(dev)
    g = a.grouped(128)
    b = _dense(dev, (a.shape[1], n_dense), 2)
    kw = dict(n_rows=a.shape[0], nnz_tile=128, group_size=G,
              strategy=strategy, heavy_tiles=0)
    old = spmm_eb.TARGET_WARPS
    spmm_eb.TARGET_WARPS = 16
    try:  # chunks of a few tiles: many crossings
        got, carry, chunk = spmm_eb._launch(
            g.rows, g.cols, g.vals, b, epilogue=spmm_eb._NOOP, bias=None,
            residual=None, **kw)
        again, _, _ = spmm_eb._launch(
            g.rows, g.cols, g.vals, b, epilogue=spmm_eb._NOOP, bias=None,
            residual=None, **kw)
    finally:
        spmm_eb.TARGET_WARPS = old
    plan = spmm_eb.eb_carry_plan(g.rows, chunk=chunk, group_size=G,
                                 strategy=strategy, nnz_tile=128)
    assert torch.equal(carry, plan)
    assert int((plan[0::2] == 100).sum()) >= 2  # the hub crosses chunks
    assert torch.equal(got, again)
    want = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b, **kw)
    terms = _terms(spmm_eb.spmm_eb_plain, g.rows, g.cols, g.vals, b, **kw)
    _assert_within_terms(got, want, terms)
    chunked = spmm_eb.spmm_eb_chunked_plain(
        g.rows.cpu(), g.cols.cpu(), g.vals.cpu(), b.cpu(), chunk=chunk, **kw)
    _assert_within_terms(got.cpu(), chunked, terms.cpu())


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "tanh",
                                 "sigmoid"])
@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_epilogue_kernel_matches_plain(dev, act, out_dtype):
    """The epilogue fused into the EB kernel (rows stored in the walk,
    rows finished from carries, empty rows) and into RB, with bias and
    residual, f32 and bf16 outputs."""
    from repro_torch.core import Epilogue
    from repro_torch.kernels import spmm_eb, spmm_rb

    a = _hub_matrix(dev, seed=3)
    n = a.shape[0]
    ep = Epilogue(act, bias=True, residual=True, out_dtype=out_dtype)
    ops = dict(bias=_dense(dev, (40,), 3), residual=_dense(dev, (n, 40), 4))
    b = _dense(dev, (n, 40), 5)
    g = a.grouped(128)
    kw = dict(n_rows=n, nnz_tile=128, group_size=32, epilogue=ep, **ops)
    got = spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b, **kw)
    want = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b, **kw)
    _assert_within_terms(got, want, _terms(
        spmm_eb.spmm_eb_plain, g.rows, g.cols, g.vals, b, n_rows=n,
        nnz_tile=128, group_size=32, **ops))
    e = a.ell(row_tile=8)
    assert e.width > 32  # the slots come in chunks of 32
    kw = dict(n_rows=n, epilogue=ep, **ops)
    got = spmm_rb.spmm_rb(e.cols, e.vals, b, **kw)
    want = spmm_rb.spmm_rb_plain(e.cols, e.vals, b, **kw)
    _assert_within_terms(got, want, _terms(spmm_rb.spmm_rb_plain, e.cols,
                                           e.vals, b, n_rows=n, **ops))


@pytest.mark.parametrize("row_tile", [4, 8, 32])
@pytest.mark.parametrize("n_dense", [40, 33, 256])
def test_rb_kernel_matches_plain(dev, row_tile, n_dense):
    from repro_torch.core import Epilogue
    from repro_torch.kernels import spmm_rb

    a = _matrix(dev, seed=5)
    e = a.ell(row_tile=row_tile)
    b = _dense(dev, (a.shape[1], n_dense), 6)
    ops = dict(bias=_dense(dev, (n_dense,), 7))
    kw = dict(n_rows=a.shape[0], epilogue=Epilogue("gelu", bias=True), **ops)
    got = spmm_rb.spmm_rb(e.cols, e.vals, b, row_tile=row_tile,
                          col_tile=128, **kw)
    want = spmm_rb.spmm_rb_plain(e.cols, e.vals, b, **kw)
    _assert_within_terms(got, want, _terms(
        spmm_rb.spmm_rb_plain, e.cols, e.vals, b, n_rows=a.shape[0], **ops))


def test_rb_kernel_takes_rows_wider_than_32_slots(dev):
    from repro_torch.kernels import spmm_rb

    a = _hub_matrix(dev, n=500, hub_len=77, long_len=40, seed=4)
    for width in (None, 100):
        e = a.ell(row_tile=8, width=width)
        assert e.width > 64
        b = _dense(dev, (500, 256), 8)
        got = spmm_rb.spmm_rb(e.cols, e.vals, b, n_rows=500)
        want = spmm_rb.spmm_rb_plain(e.cols, e.vals, b, n_rows=500)
        _assert_within_terms(got, want, _terms(spmm_rb.spmm_rb_plain, e.cols,
                                               e.vals, b, n_rows=500))


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
@pytest.mark.parametrize("d", [1, 37, 40, 64, 256])
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("shuffled", [False, True])
def test_sddmm_kernel_matches_plain(dev, nnz, d, with_scale, shuffled):
    """Sorted streams (runs of one row crossing warp and block edges) and
    the same streams shuffled, nnz not a multiple of 32."""
    from repro_torch.kernels import sddmm

    rng = np.random.default_rng(nnz + d)
    rows = np.sort(rng.integers(0, 50, nnz))
    if shuffled:
        rows = rng.permutation(rows)
    rows = torch.from_numpy(rows.astype(np.int32)).to(dev)
    cols = torch.from_numpy(rng.integers(0, 70, nnz).astype(np.int32)).to(dev)
    a, b = _dense(dev, (50, d), 10), _dense(dev, (70, d), 11)
    scale = _dense(dev, (nnz,), 12) if with_scale else None
    before = sddmm.KERNEL.launches
    got = sddmm.sddmm(rows, cols, a, b, scale, nnz_tile=128)
    assert sddmm.KERNEL.launches == before + 1
    torch.testing.assert_close(got, sddmm.sddmm_plain(rows, cols, a, b, scale),
                               rtol=RTOL, atol=RTOL * d)


@pytest.mark.parametrize("d,aligned", [(40, True), (40, False), (300, True),
                                       (1032, True), (301, True)])
@pytest.mark.parametrize("nnz_tile", [100, 256])
def test_sddmm_kernel_long_runs_and_geometries(dev, d, aligned, nnz_tile):
    """Runs of one row of 1 to 300 entries over tiles that are not a
    multiple of 32, on every geometry: 16-byte workers, 4-byte loads of a
    misaligned A, 4 vectors a lane, and the wide walk."""
    from repro_torch.kernels import sddmm

    rng = np.random.default_rng(d + nnz_tile)
    lengths = rng.integers(1, 300, 12)
    rows = np.repeat(rng.permutation(40)[:12], lengths).astype(np.int32)
    nnz = rows.shape[0]
    cols = rng.integers(0, 60, nnz).astype(np.int32)
    rows, cols = (torch.from_numpy(x).to(dev) for x in (rows, cols))
    a = _dense(dev, (40 * d + 1,), 13)
    a = (a[:40 * d] if aligned else a[1:]).view(40, d)
    b = _dense(dev, (60, d), 14)
    scale = _dense(dev, (nnz,), 15)
    g = sddmm.sddmm_geometry(d, a.data_ptr() % 16 == 0)
    assert (g.vec == 4) == (aligned and d % 4 == 0)
    before = sddmm.KERNEL.launches
    got = sddmm.sddmm(rows, cols, a, b, scale, nnz_tile=nnz_tile)
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


def test_fused_attention_bwd_splits_long_rows(dev):
    """Rows longer than ``BWD_CHUNK`` (one of about 5,000 nonzeros, one of
    a chunk and one, one of two chunks and seven) are walked in chunks in
    three launches; one of exactly a chunk is not split.  The gradients
    match the plain version and the chunk walk's plain version at the
    backward's 1e-4, and dQ (split rows' included) is the same bit for
    bit over two launches."""
    from repro_torch.kernels import fused_attention as fa

    rng = np.random.default_rng(11)
    n_rows, n_kv, heads, d = 64, 6000, 2, 64
    chunk = fa.BWD_CHUNK
    lengths = rng.integers(0, 6, n_rows)
    lengths[::9] = 0
    lengths[[5, 20, 30, 40]] = (5000, chunk, chunk + 1, 2 * chunk + 7)
    cols = np.concatenate([rng.choice(n_kv, int(n), replace=False)
                           for n in lengths]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    g = torch.Generator().manual_seed(12)
    q, k, v, do = (torch.randn(heads, n, d, generator=g).to(dev)
                   for n in (n_rows, n_kv, n_kv, n_rows))
    bias = torch.randn(len(cols), generator=g).to(dev)
    ip, cc = (torch.from_numpy(a).to(dev) for a in (indptr, cols))
    plan = fa.attn_row_plan(ip, chunk)
    assert plan.split_rows.tolist() == [5, 30, 40]
    kw = dict(scale=d ** -0.5, bias=bias)
    _, m, l = fa.fused_sparse_attention(ip, cc, q, k, v, **kw)
    before = fa.BWD_KERNEL.launches
    got = fa.fused_sparse_attention_bwd(ip, cc, q, k, v, do, m, l, **kw)
    assert fa.BWD_KERNEL.launches == before + 3
    again = fa.fused_sparse_attention_bwd(ip, cc, q, k, v, do, m, l, **kw)
    assert torch.equal(got[0].view(torch.int32), again[0].view(torch.int32))
    args = (ip, cc, q, k, v, do, m, l)
    for want in (fa.fused_sparse_attention_bwd_plain(*args, **kw),
                 fa.fused_sparse_attention_bwd_chunked_plain(
                     *args, chunk=chunk, **kw)):
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dv", [64, 40])
def test_fused_attention_fwd_splits_long_rows(dev, dv):
    """Rows longer than ``FWD_CHUNK`` (one of 5,000 nonzeros, one of a
    chunk and one, one of two chunks and seven) are walked in chunks and
    merged in a second launch; one of exactly a chunk is not split.  out,
    m and l match the plain version and the chunk walk's plain version,
    and out (split rows' included) is the same bit for bit over two
    launches.  dv 64 takes the 16-byte V walk, dv 40 the 4-byte one."""
    from repro_torch.kernels import fused_attention as fa

    rng = np.random.default_rng(13)
    n_rows, n_kv, heads, d = 64, 6000, 2, 64
    chunk = fa.FWD_CHUNK
    lengths = rng.integers(0, 6, n_rows)
    lengths[::9] = 0
    lengths[[5, 20, 30, 40]] = (5000, chunk, chunk + 1, 2 * chunk + 7)
    cols = np.concatenate([rng.choice(n_kv, int(n), replace=False)
                           for n in lengths]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    g = torch.Generator().manual_seed(14)
    q, k = (torch.randn(heads, n, d, generator=g).to(dev)
            for n in (n_rows, n_kv))
    v = torch.randn(heads, n_kv, dv, generator=g).to(dev)
    bias = torch.randn(len(cols), generator=g).to(dev)
    ip, cc = (torch.from_numpy(a).to(dev) for a in (indptr, cols))
    plan = fa.attn_row_plan(ip, chunk)
    assert plan.split_rows.tolist() == [5, 30, 40]
    kw = dict(scale=d ** -0.5, bias=bias)
    before = fa.FWD_KERNEL.launches
    got = fa.fused_sparse_attention(ip, cc, q, k, v, **kw)
    assert fa.FWD_KERNEL.launches == before + 2
    again = fa.fused_sparse_attention(ip, cc, q, k, v, **kw)
    for g_, a_ in zip(got, again):
        assert torch.equal(g_.view(torch.int32), a_.view(torch.int32))
    args = (ip, cc, q, k, v)
    for want in (fa.fused_sparse_attention_plain(*args, **kw),
                 fa.fused_sparse_attention_chunked_plain(*args, chunk=chunk,
                                                         **kw)):
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=RTOL, atol=RTOL)
    empty = (ip[1:] == ip[:-1]).nonzero()[:, 0]
    assert bool((got[1][:, empty] == fa.NEG_INF).all())
    assert bool((got[2][:, empty] == 0).all())
    assert bool((got[0][:, empty] == 0).all())


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


# --- segment reduce, the planner's GCN and readout -------------------------


def _segments(dev, t, n_seg, c, seed, *, aligned=0):
    """Sorted ids (segment n_seg // 2 left empty) or, with ``aligned``,
    segments of exactly that many lanes; standard-normal data."""
    rng = np.random.default_rng(seed)
    if aligned:
        seg = np.arange(t) // aligned
    else:
        seg = np.sort(rng.integers(0, n_seg, t))
        seg[seg == n_seg // 2] = n_seg // 2 - 1
    data = rng.standard_normal((t, c)).astype(np.float32)
    return (torch.from_numpy(seg.astype(np.int32)).to(dev),
            torch.from_numpy(data).to(dev))


def _assert_segred_same(got, want, op):
    assert got.shape == want.shape and got.dtype == want.dtype
    if op in ("max", "min"):
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32))
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("strategy", ["segment", "parallel", "accumulate"])
@pytest.mark.parametrize("G,c", [(8, 1), (32, 4), (16, 37), (32, 256)])
def test_segment_reduce_kernel_matches_plain(dev, strategy, op, G, c):
    """A ragged stream (T not a multiple of G or of the tile); ``parallel``
    on unsorted-group ids, where kernel and plain version both compute
    the group-to-first-lane realization."""
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segments(dev, 1000 + G // 2 + 3, 60, c, seed=G + c)
    kw = dict(num_segments=60, tile=4 * G, group_size=G, strategy=strategy,
              op=op)
    before = sr.KERNEL.launches
    got = sr.segment_reduce(seg, data, **kw)
    assert sr.KERNEL.launches == before + 1
    _assert_segred_same(got, sr.segment_reduce_plain(seg, data, **kw), op)
    empty = {"add": 0.0, "max": -float("inf"), "min": float("inf")}[op]
    assert bool((got[30] == empty).all())  # an untouched segment


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("strategy", ["segment", "accumulate"])
def test_segment_reduce_signed_zeros_nan_and_inf(dev, strategy, op):
    from repro_torch.kernels import segment_reduce as sr

    vals = torch.tensor([[-0.0, 0.0], [0.0, -0.0], [-0.0, -0.0],
                         [0.0, 0.0], [-0.0, float("inf")],
                         [0.0, -float("inf")], [float("nan"), 1.0],
                         [2.0, -0.0]])
    data = vals.repeat(40, 1).to(dev)
    seg = (torch.arange(data.shape[0]) // 3).to(torch.int32).to(dev)
    kw = dict(num_segments=int(seg[-1]) + 2, tile=64, group_size=8,
              strategy=strategy, op=op)
    got = sr.segment_reduce(seg, data, **kw)
    _assert_segred_same(got, sr.segment_reduce_plain(seg, data, **kw), op)
    zeros = got[:-1][got[:-1] == 0]
    assert zeros.numel() > 0 and bool(
        (torch.signbit(zeros) == (op == "min")).all())


def test_segment_reduce_edges(dev):
    """Fewer lanes than a group, an empty stream, and ids outside
    [0, num_segments) (not written)."""
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segments(dev, 5, 4, 3, seed=1)
    for op in ("add", "max"):
        _assert_segred_same(
            sr.segment_reduce(seg, data, num_segments=4, op=op),
            sr.segment_reduce_plain(seg, data, num_segments=4, op=op), op)
    out = sr.segment_reduce(seg[:0], data[:0], num_segments=3, op="min")
    assert bool((out == float("inf")).all()) and out.shape == (3, 3)
    bad = torch.tensor([-1, 0, 7, 1], dtype=torch.int32, device=dev)
    out = sr.segment_reduce(bad, torch.ones(4, 2, device=dev),
                            num_segments=2, group_size=1, tile=4,
                            strategy="accumulate")
    assert out.tolist() == [[1.0, 1.0], [1.0, 1.0]]


def _segred_hub_stream(dev, t, c, seed, *, shuffled=False):
    """Ids in order over 200 segments (the first five and the last five
    empty, others of 0 to 6 lanes, segment 97 a hub of the lanes left,
    over many of the kernel's chunks), or the same ids shuffled."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 7, size=200)
    lengths[:5] = lengths[-5:] = lengths[97] = 0
    lengths[97] = t - lengths.sum()
    seg = np.repeat(np.arange(200), lengths).astype(np.int32)
    if shuffled:
        seg = rng.permutation(seg)
    data = rng.standard_normal((t, c)).astype(np.float32)
    return (torch.from_numpy(seg).to(dev), torch.from_numpy(data).to(dev))


def _assert_segred_within_terms(sr, got, want, seg, data, op, **kw):
    """max and min bit for bit; add per output element within K_TERMS
    units of 2^-24 of the magnitude of the terms entering it (the sum of
    |data| its lanes send there, and itself): the hub's sums of thousands
    of terms cancel, so a tolerance relative to the output alone does not
    hold its order of summation."""
    if op != "add":
        _assert_segred_same(got, want, op)
        return
    terms = sr.segment_reduce_plain(seg, data.abs(), **{**kw, "op": "add"})
    _assert_within_terms(got, want, terms)


def _poisoned_segment_reduce(sr, seg, data, **kw):
    """The kernel's call just after a NaN-filled tensor of its output's
    size is freed, so the output's ``torch.empty`` likely reuses it and a
    segment the walk never writes shows as NaN."""
    n_out = data.shape[1] + int(kw.get("count_column", False))
    poison = torch.full((kw["num_segments"], n_out), float("nan"),
                        device=data.device)
    del poison
    return sr.segment_reduce(seg, data, **kw)


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("strategy", ["segment", "parallel", "accumulate"])
@pytest.mark.parametrize("G,c", [(32, 4), (8, 1), (1, 3), (32, 41),
                                 (16, 40), (32, 256)])
def test_segment_reduce_carry_walk_on_poisoned_memory(dev, strategy, op, G,
                                                      c):
    """Ids in order with a hub over many chunks (its chain of carries
    longer than a finishing worker walks alone) and empty segments below,
    between and above the ids: the walk and its finishing launch write
    every output element, over NaN-poisoned memory, and match the plain
    version; C = 4 and 1 lane-parallel, 41 (4-byte loads), 40 (16-byte)
    and 256 column-parallel."""
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segred_hub_stream(dev, 6007, c, seed=G + c)
    kw = dict(num_segments=200, group_size=G, strategy=strategy, op=op)
    before = (sr.KERNEL.launches, sr.FINISH.launches)
    got = _poisoned_segment_reduce(sr, seg, data, **kw)
    assert (sr.KERNEL.launches, sr.FINISH.launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = sr.segment_reduce_plain(seg, data, **kw)
    assert not bool(torch.isnan(got).any())
    _assert_segred_within_terms(sr, got, want, seg, data, **kw)
    empty = {"add": 0.0, "max": -float("inf"), "min": float("inf")}[op]
    assert bool((got[:5] == empty).all()) and bool((got[-5:] == empty).all())


@pytest.mark.parametrize("c", [1, 4, 41, 256])
def test_segment_reduce_add_same_bits_over_two_launches(dev, c):
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segred_hub_stream(dev, 6007, c, seed=3)
    kw = dict(num_segments=200, op="add")
    first = sr.segment_reduce(seg, data, **kw)
    assert torch.equal(first.view(torch.int32),
                       sr.segment_reduce(seg, data, **kw).view(torch.int32))


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("c", [4, 41, 256])
def test_segment_reduce_out_of_order_takes_the_atomic_path(dev, op, c):
    """Shuffled ids: one launch (no finishing launch), atomic write-backs
    into an identity-filled output, the plain version's result."""
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segred_hub_stream(dev, 6007, c, seed=c, shuffled=True)
    kw = dict(num_segments=200, group_size=1, strategy="accumulate", op=op)
    before = (sr.KERNEL.launches, sr.FINISH.launches)
    got = sr.segment_reduce(seg, data, **kw)
    assert (sr.KERNEL.launches, sr.FINISH.launches) == (before[0] + 1,
                                                        before[1])
    _assert_segred_within_terms(sr, got,
                                sr.segment_reduce_plain(seg, data, **kw),
                                seg, data, **kw)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("c", [2, 41])
def test_segment_reduce_atomic_path_signed_zeros_nan_and_inf(dev, op, c):
    """The atomic path's single atomicMax / atomicMin on the value's bits:
    -0.0 against +0.0 in both orders, NaN and +-inf, on shuffled ids, bit
    for bit as the plain version gives them."""
    from repro_torch.kernels import segment_reduce as sr

    vals = torch.tensor([-0.0, 0.0, -0.0, 0.0, float("inf"),
                         -float("inf"), float("nan"), 2.0, -3.0])
    rng = np.random.default_rng(c)
    data = vals[torch.from_numpy(rng.integers(0, 9, (900, c)))].to(dev)
    seg = torch.from_numpy(rng.integers(0, 300, 900).astype(np.int32))
    seg = seg.to(dev)
    for strategy in ("segment", "accumulate"):
        kw = dict(num_segments=301, group_size=4, strategy=strategy, op=op)
        got = sr.segment_reduce(seg, data, **kw)
        _assert_segred_same(got, sr.segment_reduce_plain(seg, data, **kw),
                            op)


@pytest.mark.parametrize("c", [3, 40, 41])
@pytest.mark.parametrize("shuffled", [False, True])
def test_segment_reduce_count_column_matches_plain(dev, c, shuffled):
    """The mean's virtual column of ones: the lane counts beside the
    sums, as the plain version's concatenated column gives them."""
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segred_hub_stream(dev, 3001, c, seed=c, shuffled=shuffled)
    kw = dict(num_segments=200, count_column=True)
    got = _poisoned_segment_reduce(sr, seg, data, **kw)
    assert got.shape == (200, c + 1)
    _assert_segred_within_terms(sr, got,
                                sr.segment_reduce_plain(seg, data, **kw),
                                seg, data, op="add", **kw)
    assert torch.equal(got[:, -1].long(),
                       torch.bincount(seg.long(), minlength=200))


def test_segment_reduce_op_on_cuda_matches_cpu(dev):
    import repro_torch.sparse as ts
    from repro_torch.core import Schedule, register_strategy, spec_segment

    seg, data = _segments("cpu", 700, 50, 6, seed=5)
    for op in ("sum", "max", "min", "mean"):
        want = ts.segment_reduce(seg, data, 50, op=op, device="cpu")
        got = ts.segment_reduce(seg.to(dev), data.to(dev), 50, op=op)
        _assert_segred_same(got.cpu(), want, op)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.segment_reduce(seg.to(dev), data.to(dev).requires_grad_(), 50)
    register_strategy("t_cuda_segred_user", spec_segment, overwrite=True)
    with pytest.raises(NotImplementedError, match="no CUDA realization"):
        ts.segment_reduce(seg.to(dev), data.to(dev), 50,
                          schedule=Schedule(strategy="t_cuda_segred_user"))


@pytest.mark.parametrize("schedule", ["eb", "rb"])
def test_planned_gcn_and_readout_launches(dev, schedule):
    """``run_plan`` on the two-layer GCN chain takes 2 planned launches:
    EB 2 and its finishing launch 2 (the epilogue is fused into EB), or
    RB 2; the readout chain adds one segment-reduce launch.  Outputs match
    the CPU's."""
    import repro_torch.fuse as tf
    import repro_torch.sparse as ts
    from repro_torch.core import Schedule
    from repro_torch.kernels import spmm_eb, spmm_rb
    from repro_torch.kernels import segment_reduce as sr

    sched = (Schedule("eb", nnz_tile=128, group_size=32)
             if schedule == "eb" else Schedule.named("RB+PR"))
    counters = (spmm_eb.KERNEL, spmm_eb.FINISH, spmm_rb.KERNEL, sr.KERNEL)
    want_counts = (2, 2, 0, 0) if schedule == "eb" else (0, 0, 2, 0)
    outs = {}
    for where in ("cpu", dev):
        a = _matrix(where, n=300, seed=2)
        w0, w1, b0 = (_dense(where, s, i) for i, s in
                      enumerate(((16, 32), (32, 8), (32,))))
        x = _dense(where, (300, 16), 7)
        seg = (torch.arange(300) // 26).to(torch.int32).to(where)
        for op in (None, "mean", "max"):
            chain, params = tf.gcn_chain(a, (w0, w1), (b0, None),
                                         schedule=sched)
            if op is not None:
                chain += (tf.segment_reduce_node(op),)
                params += [{"seg_ids": seg, "num_segments": 12}]
            p = tf.plan(chain)
            assert p.n_launches == (2 if op is None else 3)
            before = [k.launches for k in counters]
            with torch.no_grad():
                outs[(str(where), op)] = tf.run_plan(p, x, params,
                                                     device=where).cpu()
            delta = tuple(k.launches - b for k, b in zip(counters, before))
            if where != "cpu":
                assert delta == want_counts[:3] + (int(op is not None),)
                torch.testing.assert_close(
                    outs[(str(where), op)],
                    tf.run_chain_ref(chain, x, params).cpu(), rtol=1e-4,
                    atol=1e-4)
    for op in (None, "mean", "max"):
        torch.testing.assert_close(outs[(str(dev), op)], outs[("cpu", op)],
                                   rtol=1e-4, atol=1e-4)


def _gmm_operands(dev, tile, n_tiles, e, d, f, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n_tiles * tile, d, generator=g).to(dtype).to(dev)
    w = (torch.randn(e, d, f, generator=g) * d ** -0.5).to(dtype).to(dev)
    te = torch.randint(0, e, (n_tiles,), generator=g,
                       dtype=torch.int32).to(dev)
    b = torch.randn(e, f, generator=g).to(dev)
    return x, te, w, b


@pytest.mark.parametrize("f", [64, 40, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [1, 4, 10, 17, 128])
def test_grouped_matmul_kernel_matches_plain(dev, tile, dtype, f):
    """Both routes: bf16 with F = 64 and 40 on the tensor cores (``mma``;
    D = 300 takes 4-byte token copies and a ragged last ring stage, F =
    40 a ragged slab), bf16 with F = 20 and f32 on the CUDA cores
    (``fma``; both row-chunk sizes, 4 and 8, ragged above 8; F = 40 in
    bf16 and F = 20 in f32 would take scalar loads there); token tiles
    of 1 to 128 (the tensor-core route takes 32 rows a pass); no
    epilogue, bias + SiLU, and a bf16 output."""
    from repro_torch.core import Epilogue
    from repro_torch.kernels import grouped_matmul as gm

    x, te, w, b = _gmm_operands(dev, tile, 5, 6, 300, f, dtype, tile + f)
    route = "mma" if dtype == torch.bfloat16 and f % 8 == 0 else "fma"
    for ep, bias in ((Epilogue(), None),
                     (Epilogue("silu", bias=True), b),
                     (Epilogue(out_dtype="bfloat16"), None)):
        kw = dict(bias=bias, epilogue=ep, token_tile=tile)
        before = gm.KERNEL.launches
        taken = gm.ROUTE_LAUNCHES[route]
        got = gm.grouped_matmul(x, te, w, f_tile=f, d_tile=300, **kw)
        assert gm.KERNEL.launches == before + 1
        assert gm.ROUTE_LAUNCHES[route] == taken + 1
        want = gm.grouped_matmul_plain(x, te, w, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        rtol = RTOL + (2.0 ** -7 if ep.out_dtype else 0.0)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=ATOL)


@pytest.mark.parametrize("case", ["odd_d", "tokens_off_4_bytes"])
@pytest.mark.parametrize("tile", [4, 10, 17])
def test_grouped_matmul_cuda_core_route_takes_bf16_16_byte_loads(dev, tile,
                                                                  case):
    """bf16 tokens on bf16 weights whose rows the tensor-core copies cannot
    take (odd D, or tokens 2 bytes off a 4-byte boundary) but whose F % 8
    and aligned weights give the CUDA-core route its 16-byte weight loads;
    row chunks of 4 and 8, ragged above 8; no epilogue, bias + SiLU, and a
    bf16 output."""
    from repro_torch.core import Epilogue
    from repro_torch.kernels import grouped_matmul as gm

    d = 301 if case == "odd_d" else 300
    x, te, w, b = _gmm_operands(dev, tile, 5, 6, d, 64, torch.bfloat16,
                                tile + d)
    if case == "tokens_off_4_bytes":
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        x_off = flat[1:].view(x.shape)
        x_off.copy_(x)
        x = x_off
    assert gm.gmm_route(x.dtype, w.dtype, d, 64, x.data_ptr(),
                        w.data_ptr()) == "fma"
    for ep, bias in ((Epilogue(), None),
                     (Epilogue("silu", bias=True), b),
                     (Epilogue(out_dtype="bfloat16"), None)):
        kw = dict(bias=bias, epilogue=ep, token_tile=tile)
        before = (gm.KERNEL.launches, gm.ROUTE_LAUNCHES["fma"])
        got = gm.grouped_matmul(x, te, w, f_tile=64, d_tile=d, **kw)
        assert (gm.KERNEL.launches, gm.ROUTE_LAUNCHES["fma"]) == (
            before[0] + 1, before[1] + 1)
        want = gm.grouped_matmul_plain(x, te, w, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        rtol = RTOL + (2.0 ** -7 if ep.out_dtype else 0.0)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=ATOL)


def test_grouped_matmul_kernel_mixed_misaligned_and_bad_experts(dev):
    """f32 tokens on bf16 weights; weights 2 bytes off a 16-byte boundary
    (scalar loads); a tile whose expert id lies outside [0, E) is NaN;
    f16 operands are refused."""
    from repro_torch.kernels import grouped_matmul as gm

    x, te, w, _ = _gmm_operands(dev, 4, 6, 3, 128, 64, torch.bfloat16, 0)
    got = gm.grouped_matmul(x.float(), te, w, token_tile=4, f_tile=64,
                            d_tile=128)
    torch.testing.assert_close(
        got, gm.grouped_matmul_plain(x.float(), te, w, token_tile=4),
        rtol=RTOL, atol=ATOL)
    flat = torch.empty(w.numel() + 1, dtype=w.dtype, device=dev)
    w_off = flat[1:].view(w.shape)
    w_off.copy_(w)
    torch.testing.assert_close(
        gm.grouped_matmul(x, te, w_off, token_tile=4, f_tile=64, d_tile=128),
        gm.grouped_matmul_plain(x, te, w, token_tile=4), rtol=RTOL,
        atol=ATOL)
    bad = te.clone()
    bad[2] = 7
    out = gm.grouped_matmul(x, bad, w, token_tile=4, f_tile=64, d_tile=128)
    assert bool(out[8:12].isnan().all()) and not bool(
        out[:8].isnan().any())
    with pytest.raises(NotImplementedError, match="loads"):
        gm.grouped_matmul(x.half(), te, w, token_tile=4, f_tile=64,
                          d_tile=128)


#: The tensor-core route's per-element bound, in units of 2^-24 of the
#: magnitude of the terms entering an output (``_assert_within_terms``):
#: ``mma.sync`` adds each k16 step's products into its f32 sum with
#: truncation, up to 2 units of the sum's magnitude a step, so the bound
#: is 2 units per step of D plus K_TERMS for the plain version's own f32
#: order and the epilogue's expf and tanhf.  A wrong fragment, stage or
#: expert moves an output by whole products, far above it.
def _mma_k(d):
    return 2 * -(-d // 16) + K_TERMS


@pytest.mark.parametrize("d,f", [(300, 40), (4096, 1536)])
@pytest.mark.parametrize("tile", [1, 4, 10, 16, 17, 128])
def test_grouped_matmul_tensor_core_route_matches_plain(dev, tile, d, f):
    """The tensor-core route at the tiles of decode (4), prefill (10),
    one and two mma.sync n8 tiles, a ragged third and four passes of 32
    rows (128), at the MoE width (D 4096, F 1536) and at ragged D and F,
    for every activation with and without bias and both output types,
    per element against the plain version."""
    from repro_torch.core import Epilogue
    from repro_torch.kernels import grouped_matmul as gm

    x, te, w, b = _gmm_operands(dev, tile, 5, 6, d, f, torch.bfloat16,
                                tile + d)
    assert gm.gmm_route(x.dtype, w.dtype, d, f, x.data_ptr(),
                        w.data_ptr()) == "mma"
    terms = gm.grouped_matmul_plain(x.abs(), te, w.abs(), token_tile=tile)
    for ep, bias in ((Epilogue(), None),
                     (Epilogue("relu", bias=True), b),
                     (Epilogue("gelu"), None),
                     (Epilogue("silu", bias=True), b),
                     (Epilogue("tanh", bias=True), b),
                     (Epilogue("sigmoid"), None),
                     (Epilogue(out_dtype="bfloat16"), None),
                     (Epilogue("silu", bias=True, out_dtype="bfloat16"), b)):
        kw = dict(bias=bias, epilogue=ep, token_tile=tile)
        before = (gm.KERNEL.launches, gm.ROUTE_LAUNCHES["mma"])
        got = gm.grouped_matmul(x, te, w, f_tile=f, d_tile=d, **kw)
        assert (gm.KERNEL.launches, gm.ROUTE_LAUNCHES["mma"]) == (
            before[0] + 1, before[1] + 1)
        want = gm.grouped_matmul_plain(x, te, w, **kw)
        t = terms if bias is None else terms + bias[te.long()].abs(
        ).repeat_interleave(tile, 0)
        _assert_within_terms(got, want, t, _mma_k(d))


def test_grouped_matmul_tensor_core_route_is_deterministic(dev):
    """One block sums each output over all of D in a fixed order: two
    launches at the decode shape give the same bits."""
    from repro_torch.kernels import grouped_matmul as gm

    x, te, w, _ = _gmm_operands(dev, 4, 8, 8, 4096, 1536, torch.bfloat16, 3)
    kw = dict(token_tile=4, f_tile=1536, d_tile=4096)
    a, b = (gm.grouped_matmul(x, te, w, **kw) for _ in range(2))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_moe_and_decode_step_launches(dev):
    """``apply_moe`` on the kernel path is 3 grouped-matmul launches and
    matches the einsum path and the CPU; a decode step of the 2-layer
    smoke MoE model is 6, and its logits match the CPU's."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models import get_model
    from repro_torch.models.moe import apply_moe

    cfg = smoke_config(ARCHS["qwen3-moe-235b-a22b"])
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_dev(v) for v in tree]
        return tree.to(dev)

    p_dev = to_dev(params)
    x = _dense("cpu", (24, cfg.d_model), 3)
    moe_cpu, moe_dev = params["layers"][0]["moe"], p_dev["layers"][0]["moe"]
    with torch.no_grad():
        before = gm.KERNEL.launches
        got, _ = apply_moe(cfg, moe_dev, x.to(dev))
        assert gm.KERNEL.launches == before + 3
        einsum, _ = apply_moe(cfg.scaled(moe_kernel_dispatch=False),
                              moe_dev, x.to(dev))
        want, _ = apply_moe(cfg, moe_cpu, x, device="cpu")
        torch.testing.assert_close(got, einsum, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        toks = torch.randint(0, cfg.vocab_size, (2, 6))
        lc, cc = api.prefill(params, {"tokens": toks}, 10)
        ld, cd = api.prefill(p_dev, {"tokens": toks.to(dev)}, 10)
        before = gm.KERNEL.launches
        lc, _ = api.decode_step(params, cc, lc.argmax(-1))
        ld, _ = api.decode_step(p_dev, cd, ld.argmax(-1))
        assert gm.KERNEL.launches == before + 3 * cfg.n_layers
        torch.testing.assert_close(ld.cpu(), lc, rtol=1e-4, atol=1e-4)
