"""Parity of the port's formats and generators (``repro_torch.sparse``)
with the JAX reference: the same seed gives the same matrix, and the
padded layouts (standard and skew GroupedCOO, ELL) are equal index for
index.  All comparisons here are exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as js
import repro_torch.sparse as ts
from repro.sparse import formats as jf
from repro_torch.sparse import formats as tf


def _eq(t, j):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


def _pair(kind, seed):
    if kind == "uniform":
        args, kw = (80, 60), dict(density=0.05, seed=seed)
        return js.random_csr(*args, **kw), ts.random_csr(*args, **kw,
                                                          device="cpu")
    if kind == "skewed":
        args, kw = (120, 90), dict(density=0.03, skew=1.2, seed=seed)
        return js.random_csr(*args, **kw), ts.random_csr(*args, **kw,
                                                          device="cpu")
    if kind == "power_law":
        kw = dict(avg_degree=5.0, alpha=1.7, seed=seed)
        return (js.power_law_csr(150, 150, **kw),
                ts.power_law_csr(150, 150, **kw, device="cpu"))
    return (js.graph_pattern_csr(kind, 200, seed=seed),
            ts.graph_pattern_csr(kind, 200, seed=seed, device="cpu"))


KINDS = ["uniform", "skewed", "power_law", "web", "social", "roadnet"]


@pytest.mark.parametrize("kind", KINDS)
def test_generators_give_the_same_matrix(kind):
    a_j, a_t = _pair(kind, seed=11)
    _eq(a_t.indptr, a_j.indptr)
    _eq(a_t.indices, a_j.indices)
    _eq(a_t.vals, a_j.vals)
    assert a_t.shape == a_j.shape
    assert ts.matrix_stats(a_t) == js.matrix_stats(a_j)
    _eq(a_t.todense(), a_j.todense())
    _eq(a_t.tocoo().rows, a_j.tocoo().rows)


@pytest.mark.parametrize("kind", ["power_law", "social", "skewed"])
@pytest.mark.parametrize("split,merge,G,tile", [
    (8, 2, 8, 32), (8, 0, 8, 32), (4, None, 4, 16), (None, 1, 8, 64),
    (16, 16, 16, 64), (1, 0, 8, 32)])
def test_skew_layout_matches(kind, split, merge, G, tile):
    a_j, _ = _pair(kind, seed=3)
    args = (np.asarray(a_j.indptr), np.asarray(a_j.indices), a_j.shape,
            tile, G, split, merge)
    for got, want in zip(tf._skew_layout(*args), jf._skew_layout(*args)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tile,skew", [
    (32, None), (64, None), (32, (8, 2, 8)), (64, (16, 0, 16)),
    (32, (None, 1, 8))])
def test_grouped_coo_matches(kind, tile, skew):
    a_j, a_t = _pair(kind, seed=5)
    kw = {} if skew is None else dict(split_threshold=skew[0],
                                      merge_threshold=skew[1],
                                      group_size=skew[2])
    g_j, g_t = a_j.grouped(tile, **kw), a_t.grouped(tile, **kw)
    for f in ("rows", "cols", "vals"):
        _eq(getattr(g_t, f), getattr(g_j, f))
    assert (g_t.nnz, g_t.nnz_tile, g_t.skew, g_t.heavy_tiles,
            g_t.num_tiles) == (g_j.nnz, g_j.nnz_tile, g_j.skew,
                               g_j.heavy_tiles, g_j.num_tiles)
    if skew is not None:
        _eq(g_t.skew_positions(), g_j.skew_positions())
    else:
        with pytest.raises(ValueError):
            g_t.skew_positions()
    _eq(g_t.todense(), g_j.todense())
    assert a_t.grouped(tile, **kw) is g_t  # memoized per instance


@pytest.mark.parametrize("src,dst", [
    ((32, None), (64, None)), ((32, None), (32, (8, 2, 8))),
    ((32, (8, 2, 8)), (64, None)), ((32, (8, 2, 8)), (64, (4, 0, 4)))])
def test_regrouped_matches(src, dst):
    a_j, a_t = _pair("power_law", seed=8)

    def kw(skew):
        return {} if skew is None else dict(
            split_threshold=skew[0], merge_threshold=skew[1],
            group_size=skew[2])
    g_j = a_j.grouped(src[0], **kw(src[1])).regrouped(dst[0], **kw(dst[1]))
    g_t0 = a_t.grouped(src[0], **kw(src[1]))
    g_t = g_t0.regrouped(dst[0], **kw(dst[1]))
    for f in ("rows", "cols", "vals"):
        _eq(getattr(g_t, f), getattr(g_j, f))
    assert g_t.skew == g_j.skew
    assert g_t0.regrouped(dst[0], **kw(dst[1])) is g_t
    assert g_t0.regrouped(src[0], **kw(src[1])) is g_t0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("row_tile,width", [(4, None), (8, None), (8, 64)])
def test_ell_matches(kind, row_tile, width):
    a_j, a_t = _pair(kind, seed=9)
    if width is not None and width < int(np.diff(np.asarray(a_j.indptr)).max()):
        with pytest.raises(ValueError):
            a_t.ell(row_tile, width)
        return
    e_j, e_t = a_j.ell(row_tile, width), a_t.ell(row_tile, width)
    _eq(e_t.cols, e_j.cols)
    _eq(e_t.vals, e_j.vals)
    assert (e_t.width, e_t.n_rows_padded) == (e_j.width, e_j.n_rows_padded)
    _eq(e_t.todense(), e_j.todense())
    assert a_t.ell(row_tile, width) is e_t


def test_ell_refuses_layouts_above_the_byte_limit(monkeypatch):
    _, a_t = _pair("social", seed=1)
    monkeypatch.setattr(tf, "ELL_MAX_BYTES", 1024)
    with pytest.raises(ValueError, match="ELL_MAX_BYTES"):
        tf.ELL.fromcsr(a_t, row_tile=8)


def test_csr_from_numpy_takes_a_jax_csr():
    a_j, _ = _pair("web", seed=2)
    a_t = ts.CSR.from_numpy(a_j.indptr, a_j.indices, a_j.vals, a_j.shape,
                            device="cpu")
    assert a_t.indptr.dtype == a_t.indices.dtype == torch.int32
    assert a_t.vals.dtype == torch.float32
    _eq(a_t.todense(), a_j.todense())
    dense = np.asarray(a_j.todense())
    _eq(ts.CSR.fromdense(dense, device="cpu").indptr,
        js.CSR.fromdense(jnp.asarray(dense)).indptr)


@pytest.mark.parametrize("bad", ["indptr_len", "decreasing", "col_range",
                                 "nnz"])
def test_csr_from_numpy_rejects_malformed_input(bad):
    indptr, indices, vals = [0, 2, 3], [0, 2, 1], [1.0, 2.0, 3.0]
    shape = (2, 3)
    if bad == "indptr_len":
        indptr = [0, 3]
    elif bad == "decreasing":
        indptr = [0, 3, 2]
    elif bad == "col_range":
        indices = [0, 3, 1]
    else:
        vals = [1.0, 2.0]
    with pytest.raises(ValueError):
        ts.CSR.from_numpy(indptr, indices, vals, shape, device="cpu")
