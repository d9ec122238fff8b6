"""The host side of the port's CUDA segment-reduce kernel: the workers'
geometry, the carry plan, the row-order check, and the kernel's carry
walk (``segment_reduce_chunked_plain``, step by step as the kernel
stores runs, identities and carries) held against
``segment_reduce_plain`` and against the JAX ``segment_reduce`` in
interpret mode on the same numpy-seeded inputs.

Tolerance: max and min exact, bit for bit (-0.0 orders below +0.0, so
their order does not matter; NaN positions equal).  add rtol = atol =
1e-5: the terms are the same and only the order of the f32 sums differs
(per chunk and then the chunks' carries in the walk, per group in the
plain version, per tile in the JAX kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce import segment_reduce as jax_segred
from repro_torch.kernels import common
from repro_torch.kernels import segment_reduce as tsr

RTOL = ATOL = 1e-5
N_SEG = 60
HUB = 23


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread for this module: its hundreds of small walks
    ran 25 times slower under the suite's parallel workers, whose
    processes' thread pools each spanned every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(t, c, seed):
    """Ids in order over N_SEG segments: the first three and the last
    four empty, others of 0 to 4 lanes (some empty between), segment
    HUB a hub of the lanes left, so that it spans many chunks; ``t``
    lanes in all, data from a numpy seed."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 5, size=N_SEG)
    lengths[:3] = 0
    lengths[-4:] = 0
    lengths[HUB] = 0
    lengths[HUB] = t - lengths.sum()
    assert lengths[HUB] >= 100
    seg = np.repeat(np.arange(N_SEG), lengths).astype(np.int32)
    data = rng.standard_normal((t, c)).astype(np.float32)
    return seg, data


def _assert_same(got, want, op):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if op in ("max", "min"):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        keep = ~np.isnan(want)
        np.testing.assert_array_equal(got[keep].view(np.int32),
                                      want[keep].view(np.int32))
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c", [1, 4, 41])
@pytest.mark.parametrize("groups", [1, 2, 7])
@pytest.mark.parametrize("G", [1, 8, 32])
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("strategy", ["segment", "parallel", "accumulate"])
def test_chunked_walk_matches_plain(strategy, op, G, groups, c):
    """T = 253 (ragged against every G and chunk); chunks of 1, 2 and 7
    groups, so the hub crosses from 4 to over 100 chunk boundaries."""
    seg, data = _stream(253, c, seed=G + groups + c)
    kw = dict(num_segments=N_SEG, group_size=G, strategy=strategy, op=op)
    got = tsr.segment_reduce_chunked_plain(
        torch.from_numpy(seg), torch.from_numpy(data), chunk=groups * G,
        **kw)
    assert not bool(torch.isnan(got).any())  # every segment stored
    want = tsr.segment_reduce_plain(torch.from_numpy(seg),
                                    torch.from_numpy(data), tile=32, **kw)
    _assert_same(got.numpy(), want.numpy(), op)
    empty = {"add": 0.0, "max": -np.inf, "min": np.inf}[op]
    for s in (0, 2, N_SEG - 1):  # below the first id, above the last
        assert np.all(got.numpy()[s] == empty)


@pytest.mark.parametrize("c", [1, 4, 41])
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("strategy", ["segment", "parallel", "accumulate"])
def test_chunked_walk_matches_jax(strategy, op, c):
    seg, data = _stream(253, c, seed=c)
    got = tsr.segment_reduce_chunked_plain(
        torch.from_numpy(seg), torch.from_numpy(data), num_segments=N_SEG,
        group_size=8, strategy=strategy, op=op, chunk=16)
    want = jax_segred(jnp.asarray(seg), jnp.asarray(data),
                      num_segments=N_SEG, tile=32, group_size=8,
                      strategy=strategy, op=op, interpret=True)
    _assert_same(got.numpy(), np.asarray(want), op)


@pytest.mark.parametrize("op", ["max", "min"])
def test_chunked_walk_signed_zeros_and_nan(op):
    """-0.0 against +0.0 and NaN lanes inside runs and across chunk
    boundaries: bit for bit as the plain version gives them."""
    vals = np.array([[-0.0, 0.0], [0.0, -0.0], [-0.0, -0.0], [0.0, 0.0],
                     [-0.0, np.inf], [0.0, -np.inf], [np.nan, 1.0],
                     [2.0, -0.0]], np.float32)
    data = torch.from_numpy(np.tile(vals, (12, 1)))
    seg = torch.from_numpy((np.arange(96) // 5).astype(np.int32))
    kw = dict(num_segments=21, group_size=4, op=op)
    got = tsr.segment_reduce_chunked_plain(seg, data, chunk=8, **kw)
    _assert_same(got.numpy(), tsr.segment_reduce_plain(seg, data, tile=8,
                                                       **kw).numpy(), op)


def test_count_column_counts_lanes():
    seg, data = _stream(253, 4, seed=1)
    seg_t, data_t = torch.from_numpy(seg), torch.from_numpy(data)
    got = tsr.segment_reduce_chunked_plain(seg_t, data_t, num_segments=N_SEG,
                                           group_size=8, chunk=16,
                                           count_column=True)
    assert got.shape == (N_SEG, 5)
    np.testing.assert_array_equal(got[:, -1].numpy(),
                                  np.bincount(seg, minlength=N_SEG))
    want = tsr.segment_reduce(seg_t, data_t, num_segments=N_SEG,
                              group_size=8, count_column=True)
    _assert_same(got.numpy(), want.numpy(), "add")
    _assert_same(want[:, :-1].numpy(), tsr.segment_reduce(
        seg_t, data_t, num_segments=N_SEG, group_size=8).numpy(), "add")


def test_carry_plan_slots_on_a_hand_made_stream():
    """Chunks of 4: a segment over one boundary takes a slot 1 and the
    next chunk's slot 0; a chunk inside one segment takes slot 0 alone."""
    a = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 3, 3, 5, 5])
    assert common.carry_plan(a, 4).tolist() == [-1, 0, 0, 1, 1, -1, -1, -1]
    hub = torch.full((12,), 2)
    assert common.carry_plan(hub, 4).tolist() == [-1, 2, 2, -1, 2, -1]
    seg = torch.tensor([0, 1, 1, 1, 1, 2, 2, 3], dtype=torch.int32)
    # parallel sends each group of 4 to its first lane's segment
    targets = common.lane_rows(seg, group_size=4, strategy="parallel")
    assert targets.tolist() == [0, 0, 0, 0, 1, 1, 1, 1]
    assert common.carry_plan(targets, 4).tolist() == [-1, -1, -1, -1]
    assert common.carry_plan(seg, 4).tolist() == [-1, 1, 1, -1]


def test_chunked_walk_refuses_a_stream_out_of_order():
    data = torch.ones(6, 2)
    for seg in ([0, 2, 1, 3, 3, 4], [0, 1, 1, 2, 2, 9], [-1, 0, 0, 1, 1, 2]):
        seg = torch.tensor(seg, dtype=torch.int32)
        assert not common.rows_sorted(seg, 5)
        with pytest.raises(ValueError, match="in order"):
            tsr.segment_reduce_chunked_plain(seg, data, num_segments=5,
                                             group_size=1, chunk=2)


@pytest.mark.parametrize("n_lanes,n_out,G,vec,want", [
    # row statistics: a warp a chunk of six 128-lane windows, 3,964 warps
    (3_043_805, 4, 32, 4, (4, 768)),
    (169_343, 4, 32, 4, (4, 128)),       # the hub row alone
    (3_043_805, 8, 32, 4, (8, 768)),     # 8 columns: still lanes
    (1000, 5, 8, 1, (8, 64)),            # a window of 64 lanes at 8
    (1000, 1, 8, 1, (1, 128)),
    (1000, 3, 12, 1, (4, 384)),          # lcm(12, 128) lanes
    # readouts: a thread a chunk and vector (41 of 4 bytes, 11 of 16
    # for the mean's 40 + counts, 64 of 16)
    (169_343, 41, 32, 1, (0, 64)),
    (169_343, 41, 32, 4, (0, 32)),
    (169_343, 256, 32, 4, (0, 96)),
])
def test_geometry(n_lanes, n_out, G, vec, want):
    if n_out <= tsr.NARROW_MAX_COLS:  # out of order: always column-wise
        assert tsr.segred_geometry(n_lanes, n_out, G, vec, False)[0] == 0
    got = tsr.segred_geometry(n_lanes, n_out, G, vec)
    assert got == want
    width, chunk = got
    unit = np.lcm(G, 64 if width == 8 else 128) if width else G
    per_chunk = 32 if width else -(-n_out // vec)  # threads a chunk
    assert chunk % unit == 0
    warps = -(-n_lanes // chunk) * per_chunk / 32
    assert warps <= tsr.TARGET_WARPS or chunk == unit


@pytest.mark.parametrize("n_out,want", [(1, 1), (4, 1), (8, 2), (41, 16),
                                        (256, 32)])
def test_finish_geometry(n_out, want):
    assert tsr.finish_geometry(n_out) == want
