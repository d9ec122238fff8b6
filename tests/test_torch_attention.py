"""The port's fused sparse attention (the kernels' plain versions on the
CPU) against the JAX package's fused Pallas kernels in interpret mode,
and the public ``sparse_attention`` / ``graph_attention`` forward and
gradients against ``jax.grad``, on the same numpy inputs.

Tolerances: rtol = atol = 1e-5 for out, m, l and the gradients.  Every
value is a short f32 sum (rows of at most a few dozen nonzeros, d <= 16)
taken in another order: the reference rescales its running sums tile by
tile, the port once per 32 nonzeros (plain versions: once per row).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as js
import repro_torch.sparse as ts
from repro.core import Schedule as JS
from repro.kernels import fused_attention as jfa
from repro.models.attention import graph_attention as jax_graph_attention
from repro_torch.core import Schedule as TS
from repro_torch.kernels import fused_attention as tfa
from repro_torch.models import graph_attention

RTOL = ATOL = 1e-5
NNZ_TILE = 32


def _pattern(n_rows=30, n_kv=24, seed=0):
    """CSR-order pattern with empty rows, single-nonzero rows and one
    long row; columns within a row in no order."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 6, n_rows)
    lengths[::5] = 0
    lengths[2::5] = 1
    lengths[3] = 40
    cols = np.concatenate([rng.choice(n_kv, int(n), replace=n > n_kv)
                           for n in lengths]).astype(np.int32)
    rows = np.repeat(np.arange(n_rows), lengths).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return indptr, rows, cols


def _operands(heads, n_rows, n_kv, d, dv, nnz, seed=1):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (heads, n_rows, d), (heads, n_kv, d), (heads, n_kv, dv),
        (heads, n_rows, dv)))
    bias = rng.standard_normal(nnz).astype(np.float32)
    return q, k, v, do, bias


def _jax_kernels(rows, cols, q, k, v, do, n_rows, scale, bias):
    """(out, m, l) and (dq, dk, dv) of the reference's fused kernels on
    the trailing-padded stream, as its ``_sparse_attention_diff`` pads
    it."""
    nnz = rows.shape[0]
    pad = max(-(-max(nnz, 1) // NNZ_TILE) * NNZ_TILE, NNZ_TILE) - nnz
    rp, cp = (jnp.asarray(np.pad(x, (0, pad))) for x in (rows, cols))
    bp = None if bias is None else jnp.asarray(np.pad(bias, (0, pad)))
    dv = v.shape[-1]
    dv_pad = -(-dv // 8) * 8
    vp = np.pad(v, ((0, 0), (0, 0), (0, dv_pad - dv)))
    kw = dict(n_rows=n_rows, nnz=nnz, nnz_tile=NNZ_TILE, scale=scale,
              bias=bp, interpret=True)
    out, m, l = jfa.fused_sparse_attention(rp, cp, jnp.asarray(q),
                                           jnp.asarray(k), jnp.asarray(vp),
                                           dv_tile=dv_pad, **kw)
    grads = jfa.fused_sparse_attention_bwd(rp, cp, jnp.asarray(q),
                                           jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(do), m, l, **kw)
    return (out[..., :dv], m, l), grads


@pytest.mark.parametrize("heads,d,dv,with_bias", [
    (1, 8, 8, False), (3, 16, 5, True), (2, 4, 12, True)])
def test_fused_kernels_match_reference(heads, d, dv, with_bias):
    indptr, rows, cols = _pattern(seed=heads)
    n_rows, n_kv = indptr.shape[0] - 1, 24
    q, k, v, do, bias = _operands(heads, n_rows, n_kv, d, dv, rows.shape[0])
    bias = bias if with_bias else None
    scale = d ** -0.5
    want_f, want_b = _jax_kernels(rows, cols, q, k, v, do, n_rows, scale,
                                  bias)
    t = torch.from_numpy
    kw = dict(scale=scale, bias=None if bias is None else t(bias))
    got_f = tfa.fused_sparse_attention(t(indptr), t(cols), t(q), t(k), t(v),
                                       **kw)
    got_b = tfa.fused_sparse_attention_bwd(t(indptr), t(cols), t(q), t(k),
                                           t(v), t(do), got_f[1], got_f[2],
                                           **kw)
    for got, want in zip(got_f + got_b, want_f + tuple(want_b)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    empty = np.diff(indptr) == 0
    assert empty.any() and (np.diff(indptr) == 1).any()
    assert bool((got_f[1][:, empty] == tfa.NEG_INF).all())
    assert bool((got_f[2][:, empty] == 0).all())
    assert bool((got_f[0][:, empty] == 0).all())


def test_plain_backward_matches_spec_oracle():
    """The kernel's plain backward, from saved (m, l), against the
    spec-recompute VJP, per head."""
    indptr, rows, cols = _pattern(seed=7)
    q, k, v, do, bias = _operands(2, 30, 24, 6, 7, rows.shape[0], seed=8)
    t = torch.from_numpy
    _, m, l = tfa.fused_sparse_attention(t(indptr), t(cols), t(q), t(k),
                                         t(v), scale=0.3, bias=t(bias))
    got = tfa.fused_sparse_attention_bwd(t(indptr), t(cols), t(q), t(k),
                                         t(v), t(do), m, l, scale=0.3,
                                         bias=t(bias))
    for h in range(2):
        want = tfa.sparse_attention_bwd_ref(
            t(rows), t(cols), t(q[h]), t(k[h]), t(v[h]), t(do[h]),
            n_rows=30, scale=0.3, bias=t(bias))
        for g, w in zip(got, want):
            torch.testing.assert_close(g[h], w, rtol=RTOL, atol=ATOL)


def _csr_pair(n=28, seed=3):
    a_j = js.power_law_csr(n, n, avg_degree=4.0, alpha=1.6, seed=seed)
    a_t = ts.power_law_csr(n, n, avg_degree=4.0, alpha=1.6, seed=seed,
                           device="cpu")
    # non-constant stored values: a real additive score bias
    vals = np.random.default_rng(seed).standard_normal(a_t.nnz).astype(
        np.float32)
    a_j = js.CSR(indptr=a_j.indptr, indices=a_j.indices,
                 vals=jnp.asarray(vals), shape=a_j.shape)
    a_t = ts.CSR(a_t.indptr, a_t.indices, torch.from_numpy(vals), a_t.shape)
    return a_j, a_t


@pytest.mark.parametrize("multi_head", [False, True])
@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_sparse_attention_grads_match_reference(multi_head, impl):
    a_j, a_t = _csr_pair()
    n = a_t.shape[0]
    shape = (n, 2, 8) if multi_head else (n, 8)
    rng = np.random.default_rng(11)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(4))

    def jax_loss(qq, kk, vv):
        out = js.sparse_attention(a_j, qq, kk, vv, schedule=JS(nnz_tile=32),
                                  interpret=True)
        return jnp.sum(out * cot), out

    (_, want_out), want = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ts.sparse_attention(a_t, *leaves, schedule=TS(nnz_tile=32),
                              impl=impl, device="cpu")
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=RTOL, atol=ATOL)
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def test_graph_attention_over_a_pattern_tuple_matches_reference():
    indptr, rows, cols = _pattern(seed=5)
    n_rows, n_kv = indptr.shape[0] - 1, 24
    rng = np.random.default_rng(12)
    q = rng.standard_normal((n_rows, 3, 4)).astype(np.float32)
    k, v = (rng.standard_normal((n_kv, 3, 4)).astype(np.float32)
            for _ in range(2))
    cot = rng.standard_normal((n_rows, 3, 4)).astype(np.float32)

    def jax_loss(qq, kk, vv):
        out = jax_graph_attention((jnp.asarray(rows), jnp.asarray(cols),
                                   n_rows), qq, kk, vv, scale=0.7)
        return jnp.sum(out * cot)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = graph_attention((torch.from_numpy(rows), torch.from_numpy(cols),
                           n_rows), *leaves, scale=0.7, device="cpu")
    out.backward(torch.from_numpy(cot))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def test_sparse_attention_contracts(tmp_path, monkeypatch):
    a_j, a_t = _csr_pair()
    n = a_t.shape[0]
    x_j, x_t = jnp.ones((n, 4)), torch.ones(n, 4)
    parallel = dict(kernel="eb", group_size=8, nnz_tile=32,
                    strategy="parallel", split_threshold=4,
                    merge_threshold=0)
    with pytest.raises(ValueError, match="parallel"):
        js.sparse_attention(a_j, x_j, x_j, x_j, schedule=JS(**parallel))
    with pytest.raises(ValueError, match="parallel"):
        ts.sparse_attention(a_t, x_t, x_t, x_t, schedule=TS(**parallel),
                            device="cpu")
    # 'tune' runs the forward's tuner (keys in the port's own file) and
    # gives the JAX package's output
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_BENCH_ITERS", "1")
    monkeypatch.setenv("REPRO_BENCH_WARMUP", "0")
    q = np.random.default_rng(1).standard_normal((n, 4)).astype(np.float32)
    got = ts.sparse_attention(a_t, torch.from_numpy(q), x_t, x_t + 1.0,
                              schedule="tune", device="cpu")
    want = js.sparse_attention(a_j, jnp.asarray(q), x_j, x_j + 1.0,
                               impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert (tmp_path / "tune.torch-cpu.json").exists()
    rows = torch.tensor([1, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted"):
        ts.sparse_attention((rows, rows, 2), x_t[:2], x_t[:2], x_t[:2],
                            device="cpu")
    with pytest.raises(ValueError, match="columns"):
        ts.sparse_attention(a_t, x_t, x_t[:3], x_t[:3], device="cpu")
