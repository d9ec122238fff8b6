"""The attention backward's chunk plan and its split walk (the plain
version of what ``csrc/fused_attention_bwd.cu`` computes: rows longer
than a chunk cut into chunks, delta and dQ summed from the chunks'
partials in chunk order) against the port's unsplit plain version and
the JAX package's fused backward in interpret mode, on the same numpy
inputs; and the grouped matmul's choice between its tensor-core and
CUDA-core routes.

Tolerance: rtol = atol = 1e-5, as in ``test_torch_attention.py``: every
value is an f32 sum of at most a few hundred terms of size about one,
taken in another order (chunk partials first; the reference tile by
tile).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_attention as jfa
from repro_torch.kernels import fused_attention as tfa
from repro_torch.kernels import grouped_matmul as tgmm

RTOL = ATOL = 1e-5
CHUNK = 8
NNZ_TILE = 32


def _pattern(seed=0):
    """CSR order over 24 columns: a hub row of 10 chunks and a bit,
    empty rows, and rows of exactly 1, CHUNK and CHUNK + 1 nonzeros
    (columns repeat only in the hub row, as a multigraph's would)."""
    rng = np.random.default_rng(seed)
    n_kv = 24
    lengths = rng.integers(0, 6, 20)
    lengths[[1, 7, 13]] = 0
    lengths[[2, 5]] = 1
    lengths[[3, 11]] = CHUNK
    lengths[[4, 17]] = CHUNK + 1
    lengths[9] = 10 * CHUNK + 3
    cols = np.concatenate([rng.choice(n_kv, int(n), replace=n > n_kv)
                           for n in lengths]).astype(np.int32)
    rows = np.repeat(np.arange(lengths.size), lengths).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return indptr, rows, cols, n_kv


def _operands(heads, n_rows, n_kv, d, dv, nnz, seed=1):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (heads, n_rows, d), (heads, n_kv, d), (heads, n_kv, dv),
        (heads, n_rows, dv)))
    bias = rng.standard_normal(nnz).astype(np.float32)
    return q, k, v, do, bias


def test_plan_cuts_every_row_longer_than_a_chunk():
    indptr, _, _, _ = _pattern()
    plan = tfa.attn_row_plan(torch.from_numpy(indptr), CHUNK)
    want_rows, want_first, want_row, want_start, want_split = [], [0], [], \
        [], []
    for r, (lo, hi) in enumerate(zip(indptr[:-1], indptr[1:])):
        if hi - lo <= CHUNK:
            continue
        for start in range(lo, hi, CHUNK):
            want_row.append(r)
            want_start.append(start)
            want_split.append(len(want_rows))
        want_rows.append(r)
        want_first.append(len(want_row))
    assert want_rows == [4, 9, 17]
    assert want_first == [0, 2, 13, 15]  # the hub row: 11 chunks
    for got, want in ((plan.split_rows, want_rows),
                      (plan.split_first, want_first),
                      (plan.chunk_row, want_row),
                      (plan.chunk_start, want_start),
                      (plan.chunk_split, want_split)):
        assert got.dtype == torch.int32 and got.tolist() == want
    assert (plan.chunk, plan.n_chunks, plan.n_split) == (CHUNK, 15, 3)


def test_plan_is_remembered_per_pattern_and_chunk():
    ip = torch.from_numpy(_pattern()[0])
    plan = tfa.attn_row_plan(ip, CHUNK)
    assert tfa.attn_row_plan(ip, CHUNK) is plan
    assert tfa.attn_row_plan(ip, 2 * CHUNK) is not plan
    assert tfa.attn_row_plan(ip, 1000).n_chunks == 0
    with pytest.raises(ValueError, match="chunk"):
        tfa.attn_row_plan(ip, 0)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("heads,d,dv", [(1, 8, 8), (3, 16, 5)])
def test_chunked_walk_matches_plain_and_reference(heads, d, dv, with_bias):
    indptr, rows, cols, n_kv = _pattern(seed=heads)
    n_rows = indptr.shape[0] - 1
    q, k, v, do, bias = _operands(heads, n_rows, n_kv, d, dv, rows.shape[0],
                                  seed=heads + d)
    bias = bias if with_bias else None
    scale = d ** -0.5
    t = torch.from_numpy
    kw = dict(scale=scale, bias=None if bias is None else t(bias))
    _, m, l = tfa.fused_sparse_attention(t(indptr), t(cols), t(q), t(k),
                                         t(v), **kw)
    args = (t(indptr), t(cols), t(q), t(k), t(v), t(do), m, l)
    got = tfa.fused_sparse_attention_bwd_chunked_plain(*args, chunk=CHUNK,
                                                       **kw)
    unsplit = tfa.fused_sparse_attention_bwd_plain(*args, **kw)
    # the reference's kernel in interpret mode, on the padded stream
    pad = -(-rows.shape[0] // NNZ_TILE) * NNZ_TILE - rows.shape[0]
    rp, cp = (jnp.asarray(np.pad(x, (0, pad))) for x in (rows, cols))
    want = jfa.fused_sparse_attention_bwd(
        rp, cp, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(do), jnp.asarray(m.numpy()), jnp.asarray(l.numpy()),
        n_rows=n_rows, nnz=rows.shape[0], nnz_tile=NNZ_TILE, scale=scale,
        bias=None if bias is None else jnp.asarray(np.pad(bias, (0, pad))),
        interpret=True)
    for g, u, w in zip(got, unsplit, want):
        assert g.dtype == torch.float32 and g.shape == u.shape
        torch.testing.assert_close(g, u, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    empty = np.diff(indptr) == 0
    assert bool((got[0][:, empty] == 0).all())


def test_chunked_walk_without_a_split_row_is_the_plain_walk():
    """A chunk longer than every row leaves one partial per row: the
    chunk walk sums the same terms as the plain version."""
    indptr, rows, cols, n_kv = _pattern(seed=5)
    q, k, v, do, bias = _operands(2, indptr.shape[0] - 1, n_kv, 8, 8,
                                  rows.shape[0], seed=6)
    t = torch.from_numpy
    _, m, l = tfa.fused_sparse_attention(t(indptr), t(cols), t(q), t(k),
                                         t(v), scale=0.4, bias=t(bias))
    args = (t(indptr), t(cols), t(q), t(k), t(v), t(do), m, l)
    got = tfa.fused_sparse_attention_bwd_chunked_plain(
        *args, scale=0.4, bias=t(bias), chunk=1000)
    want = tfa.fused_sparse_attention_bwd(*args, scale=0.4, bias=t(bias))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("x_dtype,w_dtype,d,f,x_addr,w_addr,route", [
    (BF16, BF16, 4096, 1536, 0, 0, "mma"),   # the serving operands
    (BF16, BF16, 1536, 4096, 256, 512, "mma"),
    (BF16, BF16, 300, 40, 4, 0, "mma"),      # 4-byte token copies
    (BF16, BF16, 300, 20, 0, 0, "fma"),      # F % 8
    (BF16, BF16, 301, 64, 0, 0, "fma"),      # odd D: rows 2-byte aligned
    (BF16, BF16, 128, 64, 0, 2, "fma"),      # weights off 16 bytes
    (BF16, BF16, 128, 64, 2, 0, "fma"),      # tokens off 4 bytes
    (F32, BF16, 128, 64, 0, 0, "fma"),       # TF32 would round f32
    (BF16, F32, 128, 64, 0, 0, "fma"),
    (F32, F32, 4096, 1536, 0, 0, "fma"),
])
def test_grouped_matmul_route_choice(x_dtype, w_dtype, d, f, x_addr, w_addr,
                                     route):
    assert tgmm.gmm_route(x_dtype, w_dtype, d, f, x_addr, w_addr) == route
    assert tgmm.ROUTES[route] in (0, 1)


def test_grouped_matmul_on_cpu_takes_no_route():
    """CPU tensors run the plain version: no route counts a launch."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, generator=g).to(BF16)
    w = torch.randn(2, 16, 8, generator=g).to(BF16)
    te = torch.tensor([1, 0], dtype=torch.int32)
    before = dict(tgmm.ROUTE_LAUNCHES)
    got = tgmm.grouped_matmul(x, te, w, token_tile=4, f_tile=8, d_tile=16)
    assert tgmm.ROUTE_LAUNCHES == before
    torch.testing.assert_close(
        got, tgmm.grouped_matmul_plain(x, te, w, token_tile=4))
