"""The host side of the user-strategy kernels' geometry, on the CPU: the
combine kernel's vector width and head (``eb_partials.combine_geometry``)
and ``attn_lanes``' vector, group and chunk
(``attn_user.lanes_geometry``), and the premise of the combine's skips:
on ``common.combine_plain``, -inf under max, +inf under min and -0.0
under add leave every accumulator value's bits unchanged (-0.0 and the
infinities included; a NaN stays a NaN, as every comparison of the port
holds NaN: torch's maximum on the CPU returns a NaN of its own bits),
while +0.0 under add turns -0.0 into +0.0, so add must still read the
accumulator."""
import math

import pytest
import torch

from repro_torch.core import MONOIDS
from repro_torch.kernels import attn_user, common, eb_partials

F32, BF16, F16, E4M3 = 4, 2, 2, 1


@pytest.mark.parametrize("itemsize,d,dv,aligned,vec,group", [
    (F32, 64, 0, True, 4, 16),
    (F32, 64, 64, True, 4, 16),
    (BF16, 64, 64, True, 8, 8),
    (F16, 64, 0, True, 8, 8),
    (E4M3, 64, 64, True, 16, 4),
    (F32, 64, 64, False, 1, 32),
    (BF16, 64, 0, False, 1, 32),
    (F32, 37, 20, True, 1, 32),
    (F32, 20, 0, True, 4, 8),
    (BF16, 20, 0, True, 4, 8),
    (E4M3, 20, 0, True, 4, 8),
    (F32, 1, 0, True, 1, 1),
    (E4M3, 1, 1, True, 1, 1),
    (F32, 320, 0, True, 4, 32),
    (F32, 512, 512, True, 4, 32),
    (BF16, 320, 320, True, 8, 32),
    (E4M3, 512, 0, True, 16, 32),
    (F32, 64, 20, True, 4, 16),
    (BF16, 64, 36, True, 4, 16),
])
def test_lanes_geometry_vector_and_group(itemsize, d, dv, aligned, vec,
                                         group):
    """The vector is 16 bytes where every width and the alignment allow,
    else 4 elements, else 1; the group is the fewest threads, a power of
    two up to 32, that hold the wider row a vector each."""
    g = attn_user.lanes_geometry(10_000, d, dv, itemsize, aligned)
    assert (g.vec, g.group) == (vec, group)
    for w in (d, dv):
        assert w % g.vec == 0
    assert g.group & (g.group - 1) == 0 and 1 <= g.group <= 32
    widest = max(d, dv) // g.vec
    assert g.group >= min(widest, 32) and (g.group == 1
                                           or g.group // 2 < widest)


@pytest.mark.parametrize("n_lanes", [0, 1, 31, 32, 33, 5_000, 262_144,
                                     262_145, 3_047_424, 12_000_000])
def test_lanes_geometry_chunk(n_lanes):
    """A warp takes a whole number of 32-lane windows, and the warps
    stay at or under ``LANES_TARGET_WARPS``, using the fewest windows a
    warp that does."""
    chunk = attn_user.lanes_geometry(n_lanes, 64, 0, F32, True).chunk
    assert chunk >= 32 and chunk % 32 == 0
    target = attn_user.LANES_TARGET_WARPS
    assert -(-n_lanes // chunk) <= target
    if chunk > 32:
        assert -(-n_lanes // (chunk - 32)) > target


def test_lanes_geometry_refuses_empty_rows():
    with pytest.raises(ValueError, match="d >= 1"):
        attn_user.lanes_geometry(10, 0, 0, F32, True)


@pytest.mark.parametrize("acc_off,tile_off,n,want", [
    (0, 0, 100, (4, 0)),
    (0, 0, 3, (4, 0)),
    (1, 1, 99, (4, 3)),
    (2, 2, 98, (4, 2)),
    (3, 3, 97, (4, 1)),
    (1, 0, 99, (1, 0)),
    (0, 1, 99, (1, 0)),
    (3, 1, 97, (1, 0)),
    (1, 1, 2, (1, 0)),
    (1, 1, 3, (4, 3)),
])
def test_combine_geometry(acc_off, tile_off, n, want):
    """Vectors where the accumulator and the tile sit at the same offset
    from 16 bytes, the head up to the accumulator's first boundary (never
    past its end); else every element alone."""
    base = torch.zeros(128)
    other = torch.zeros(128)
    acc = base[acc_off:acc_off + n]
    tile = other[tile_off:tile_off + n]
    vec, head = eb_partials.combine_geometry(acc, tile)
    assert (vec, head) == want
    if vec == 4:
        assert (acc.data_ptr() + 4 * head) % 16 == 0
        assert (tile.data_ptr() + 4 * head) % 16 == 0


def _special_acc():
    """An accumulator with every class of float the combine must keep:
    zeros of both signs, NaN, both infinities, subnormals and ordinary
    values of both signs."""
    vals = [0.0, -0.0, math.nan, math.inf, -math.inf, 1e-40, -1e-40, 1.5,
            -2.25, 3.4e38, -3.4e38, 1e-30]
    return torch.tensor(vals * 3, dtype=torch.float32)


@pytest.mark.parametrize("op,empty", [("add", -0.0), ("max", -math.inf),
                                      ("min", math.inf)])
def test_combine_skip_leaves_bits(op, empty):
    """The value whose vectors the combine kernel skips leaves every
    accumulator element's bits unchanged under its monoid, a NaN a
    NaN."""
    acc = _special_acc()
    want = acc.clone()
    common.combine_plain(acc, torch.full_like(acc, empty), MONOIDS[op])
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(acc), nan)
    assert torch.equal(acc[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def test_combine_positive_zero_under_add_moves_negative_zero():
    """+0.0 is add's identity by value, not by bits: -0.0 + +0.0 is
    +0.0, so a tile of +0.0 changes an accumulator holding -0.0 (and the
    kernel must read the accumulator under it)."""
    acc = _special_acc()
    before = acc.clone()
    common.combine_plain(acc, torch.zeros_like(acc), MONOIDS["add"])
    neg_zero = (before == 0) & torch.signbit(before)
    assert bool(neg_zero.any())
    assert not bool(torch.signbit(acc[neg_zero]).any())
    same = ~neg_zero
    nan = torch.isnan(before)
    assert torch.equal(torch.isnan(acc), nan)
    assert torch.equal(acc[same & ~nan].view(torch.int32),
                       before[same & ~nan].view(torch.int32))


@pytest.mark.parametrize("op,empty", [("max", -math.inf), ("min", math.inf)])
def test_combine_empty_value_of_ordered_monoids_is_its_identity(op, empty):
    """The skipped value is the ordered monoid's own identity, the value
    a spec's result holds on the rows its tile never reached."""
    assert MONOIDS[op].identity == empty
