"""The host side of the port's CUDA EB and RB kernels: the workers' column
geometry, the EB chunk size, the row-order check, and the EB kernel's
carry walk (``spmm_eb_chunked_plain``, step by step as the kernel stores
rows and carries) held against ``spmm_eb_plain`` and against the JAX
``spmm_eb`` in interpret mode on the same numpy-seeded inputs.

Tolerance: rtol = atol = 1e-5.  The walk sums each row's products per
chunk and then the chunks' carries, the plain version per strategy
group, the JAX kernel per tile: the same f32 terms in three orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Epilogue as JE
from repro.kernels.spmm_eb import spmm_eb as jax_spmm_eb
from repro_torch.core import Epilogue as TE
from repro_torch.kernels import common
from repro_torch.kernels import spmm_eb as teb
from repro_torch.sparse import CSR

RTOL = ATOL = 1e-5
TILE = 16


def _hub_matrix(n=200, hub_len=150, seed=0):
    """CSR (n, n) with short rows (0 to 6 nnz, some empty), one hub row of
    ``hub_len`` nnz that spans several 32-lane chunks, and its last rows
    empty; values and B from a numpy seed."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 7, size=n)
    lengths[57] = hub_len
    lengths[-3:] = 0
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate([np.sort(rng.choice(n, size=k, replace=False))
                              for k in lengths]).astype(np.int32)
    vals = rng.standard_normal(indptr[-1]).astype(np.float32)
    return CSR.from_numpy(indptr, indices, vals, (n, n), device="cpu")


def _jax(g, b, *, n_rows, strategy, G, ep, bias, res):
    out = jax_spmm_eb(
        jnp.asarray(g.rows.numpy()), jnp.asarray(g.cols.numpy()),
        jnp.asarray(g.vals.numpy()), jnp.asarray(b.numpy()), n_rows=n_rows,
        nnz_tile=TILE, col_tile=b.shape[1], group_size=G, strategy=strategy,
        epilogue=JE(**ep),
        bias=None if bias is None else jnp.asarray(bias.numpy())[None, :],
        residual=None if res is None else jnp.asarray(res.numpy()),
        interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("n_cols,vec,want", [
    (40, 4, (10, 40)),     # three 10-thread workers to a warp
    (256, 4, (32, 128)),   # a warp, two 128-column slices
    (128, 4, (32, 128)),
    (64, 4, (16, 64)),     # two workers to a warp
    (33, 1, (32, 32)),     # 4-byte loads: a 32-column slice and a
                           # 1-column one
    (8, 4, (4, 16)),       # the floor of 4 threads a worker
])
def test_worker_geometry(n_cols, vec, want):
    lw, width = common.worker_geometry(n_cols, vec)
    assert (lw, width) == want
    assert width == lw * vec and 1 <= lw <= 32
    with pytest.raises(ValueError):
        common.worker_geometry(n_cols, 2)


@pytest.mark.parametrize("n_lanes,tile,per_warp", [
    (128, 128, 1), (3_043_840, 128, 1), (3_043_840, 128, 3),
    (4096 * 3, 4096, 1), (1000, 8, 8)])
def test_eb_chunk_is_whole_tiles_for_about_the_target_warps(n_lanes, tile,
                                                            per_warp):
    chunk = teb.eb_chunk(n_lanes, tile, per_warp)
    target = teb.TARGET_WARPS * per_warp
    assert chunk % tile == 0 and chunk >= tile
    assert -(-n_lanes // chunk) <= target
    assert chunk == tile or -(-n_lanes // (chunk - tile)) > target
    if n_lanes == 3_043_840:  # the social graph at N = 256 and N = 40
        assert chunk == (384 if per_warp == 1 else 128)
    lw = {1: 32, 3: 10}.get(per_warp)
    if lw and tile == 128:
        assert teb.eb_geometry(n_lanes, tile, lw * 4, 4)[2] == chunk


def test_rows_sorted_checks_order_and_range_and_follows_writes():
    rows = torch.tensor([0, 0, 2, 5, 5], dtype=torch.int32)
    assert teb.rows_sorted(rows, 6)
    assert not teb.rows_sorted(rows, 5)  # row 5 out of range
    assert not teb.rows_sorted(torch.tensor([1, 0], dtype=torch.int32), 4)
    assert not teb.rows_sorted(torch.tensor([-1, 0], dtype=torch.int32), 4)
    rows[0] = 3  # an in-place write moves the version counter
    assert not teb.rows_sorted(rows, 6)


def test_lane_rows_give_the_strategies_attribution():
    rows = torch.tensor([0, 0, 1, 1, 1, 2, 3, 3], dtype=torch.int32)
    assert teb.lane_rows(rows, group_size=4, strategy="segment").tolist() \
        == rows.tolist()
    assert teb.lane_rows(rows, group_size=4, strategy="parallel").tolist() \
        == [0, 0, 0, 0, 1, 1, 1, 1]
    # the leading heavy tile runs parallel whatever the strategy
    assert teb.lane_rows(rows, group_size=2, strategy="accumulate",
                         heavy_tiles=1, nnz_tile=4).tolist() == \
        [0, 0, 1, 1, 1, 2, 3, 3]
    assert teb.lane_rows(rows, group_size=2, strategy="accumulate",
                         heavy_tiles=2, nnz_tile=4).tolist() == \
        [0, 0, 1, 1, 1, 1, 3, 3]


def test_carry_plan_marks_the_rows_that_cross_chunks():
    a = _hub_matrix()
    g = a.grouped(TILE)
    chunk = 2 * TILE
    plan = teb.eb_carry_plan(g.rows, chunk=chunk, group_size=8,
                             strategy="segment", nnz_tile=TILE).tolist()
    rows = g.rows.tolist()
    workers = -(-len(rows) // chunk)
    assert len(plan) == 2 * workers
    spans = {}
    for t, r in enumerate(rows):
        spans.setdefault(r, set()).add(t // chunk)
    crossing = {r for r, ws in spans.items() if len(ws) > 1}
    heads = {plan[2 * w + 1] for w in range(workers)} - {-1}
    assert heads == crossing  # each crossing row has exactly one head
    assert len([r for r in plan[1::2] if r >= 0]) == len(crossing)
    hub = 57
    assert len(spans[hub]) >= 4
    assert plan[0::2].count(hub) == len(spans[hub]) - 1
    # a row over exactly one chunk boundary: one head, one continuation
    one = [r for r in crossing if len(spans[r]) == 2]
    assert one and all(plan[0::2].count(r) == 1 for r in one)


@pytest.mark.parametrize("strategy,G", [("segment", 8), ("segment", 16),
                                        ("parallel", 8), ("accumulate", 4)])
@pytest.mark.parametrize("chunk_tiles", [1, 2, 5])
@pytest.mark.parametrize("n_cols", [40, 33])
def test_chunked_walk_matches_plain_and_jax(strategy, G, chunk_tiles, n_cols):
    a = _hub_matrix(seed=chunk_tiles)
    g = a.grouped(TILE)
    rng = np.random.default_rng(7)
    b = torch.from_numpy(rng.standard_normal((200, n_cols))
                         .astype(np.float32))
    kw = dict(n_rows=200, nnz_tile=TILE, group_size=G, strategy=strategy)
    got = teb.spmm_eb_chunked_plain(g.rows, g.cols, g.vals, b,
                                    chunk=chunk_tiles * TILE, **kw)
    assert bool(torch.isfinite(got).all())  # every row stored
    want = teb.spmm_eb_plain(g.rows, g.cols, g.vals, b, **kw)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), _jax(g, b, n_rows=200, strategy=strategy, G=G, ep={},
                          bias=None, res=None), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "tanh",
                                 "sigmoid"])
def test_chunked_walk_epilogue_matches_jax(act):
    a = _hub_matrix(seed=3)
    g = a.grouped(TILE)
    rng = np.random.default_rng(8)
    b, res = (torch.from_numpy(rng.standard_normal((200, 40))
                               .astype(np.float32)) for _ in range(2))
    bias = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    ep = dict(activation=act, bias=True, residual=True)
    got = teb.spmm_eb_chunked_plain(
        g.rows, g.cols, g.vals, b, n_rows=200, nnz_tile=TILE, group_size=8,
        chunk=3 * TILE, epilogue=TE(**ep), bias=bias, residual=res)
    np.testing.assert_allclose(
        got.numpy(), _jax(g, b, n_rows=200, strategy="segment", G=8,
                          ep=ep, bias=bias, res=res),
        rtol=RTOL, atol=ATOL)


def test_chunked_walk_refuses_a_stream_out_of_order():
    a = _hub_matrix()
    g = a.grouped(TILE, group_size=8, split_threshold=40, merge_threshold=0)
    assert g.heavy_tiles > 0 and not teb.rows_sorted(g.rows, 200)
    with pytest.raises(ValueError, match="rows in order"):
        teb.spmm_eb_chunked_plain(g.rows, g.cols, g.vals,
                                  torch.zeros(200, 8), n_rows=200,
                                  nnz_tile=TILE, group_size=8)
