"""Parity of the port's segment reduce (the kernel's plain version on the
CPU) with the JAX package's, whose Pallas kernel runs in interpret mode,
on the same numpy inputs: at kernel level (every strategy, monoid and
group size, a ragged stream) and at op level (sum, max, min, mean, with
empty segments, and user strategies).

Tolerance: sums at rtol 1e-5 plus 1e-5 of the largest magnitude (each
output sums at most a few dozen standard-normal values, in another order
in XLA and in torch).  max and min are exact, bit for bit: with -0.0
ordered below +0.0 their order does not matter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as js
import repro_torch.sparse as ts
from repro.core import Schedule as JS
from repro.core import register_strategy as j_register
from repro.kernels.segment_reduce import segment_reduce as j_segred
from repro_torch.core import MONOIDS
from repro_torch.core import Schedule as TS
from repro_torch.core import register_strategy as t_register
from repro_torch.kernels import segment_reduce as tk

RTOL = 1e-5


def _inputs(t, n_seg, c, seed, *, dtype=np.float32):
    """Sorted ids in [0, n_seg) (several segments left empty) and data."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n_seg, t)).astype(np.int32)
    data = rng.standard_normal((t, c)).astype(dtype)
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
        finite = np.abs(want[np.isfinite(want)])
        scale = float(finite.max()) if finite.size else 1.0
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("G", [8, 16, 32])
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("strategy", ["segment", "parallel", "accumulate"])
def test_kernel_matches_reference(strategy, op, G):
    """T = 3 tiles + 5 lanes (ragged); ``parallel`` on unaligned ids too,
    where both sides compute the group-to-first-lane realization."""
    tile = 2 * G
    t = 3 * tile + 5
    seg, data = _inputs(t, 17, 3, seed=G)
    kw = dict(num_segments=17, tile=tile, group_size=G, strategy=strategy,
              op=op)
    want = j_segred(jnp.asarray(seg), jnp.asarray(data), interpret=True,
                    **kw)
    got = tk.segment_reduce(torch.from_numpy(seg), torch.from_numpy(data),
                            **kw)
    assert got.dtype == torch.float32 and got.shape == (17, 3)
    _assert_same(got.numpy(), want, op)


@pytest.mark.parametrize("op", ["max", "min"])
def test_signed_zeros_nan_and_inf_match_reference(op):
    """-0.0 against +0.0 in both orders inside a group, across groups and
    against the output; NaN and +-inf lanes: bit for bit as jnp.maximum
    and jnp.minimum give them."""
    vals = np.array([[-0.0, 0.0], [0.0, -0.0], [-0.0, -0.0], [0.0, 0.0],
                     [-0.0, np.inf], [0.0, -np.inf], [np.nan, 1.0],
                     [2.0, -0.0]], np.float32)
    data = np.tile(vals, (6, 1))
    seg = (np.arange(data.shape[0]) // 3).astype(np.int32)
    seg[seg > 12] = 12
    for strategy in ("segment", "accumulate"):
        kw = dict(num_segments=14, tile=16, group_size=8,
                  strategy=strategy, op=op)
        want = j_segred(jnp.asarray(seg), jnp.asarray(data), interpret=True,
                        **kw)
        got = tk.segment_reduce(torch.from_numpy(seg),
                                torch.from_numpy(data), **kw)
        _assert_same(got.numpy(), want, op)
    # the monoid itself, in both orders, against jnp
    m = MONOIDS[op]
    jfn = jnp.maximum if op == "max" else jnp.minimum
    a = np.array([-0.0, 0.0, -0.0, 0.0, np.nan, 1.0], np.float32)
    b = np.array([0.0, -0.0, -0.0, 0.0, 1.0, np.nan], np.float32)
    _assert_same(m.combine(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                 jfn(a, b), op)
    _assert_same(m.combine(torch.from_numpy(b), torch.from_numpy(a)).numpy(),
                 jfn(b, a), op)


def test_kernel_reads_bf16_data_as_f32():
    seg, data = _inputs(77, 9, 4, seed=3)
    bf = jnp.asarray(data).astype(jnp.bfloat16)
    kw = dict(num_segments=9, tile=32, group_size=8)
    want = j_segred(jnp.asarray(seg), bf, interpret=True, **kw)
    got = tk.segment_reduce(torch.from_numpy(seg),
                            torch.from_numpy(data).to(torch.bfloat16), **kw)
    _assert_same(got.numpy(), want, "add")


@pytest.mark.parametrize("op", ["sum", "max", "min", "mean"])
@pytest.mark.parametrize("t,c", [(3, 1), (150, 5)])
def test_op_matches_reference(op, t, c):
    """Empty segments come out as 0, -inf, +inf and 0."""
    seg, data = _inputs(t, 12, c, seed=t)
    seg = np.where(seg == 4, 3, seg).astype(np.int32)  # segment 4 empty
    jsched = JS("eb", nnz_tile=64, group_size=8)
    tsched = TS("eb", nnz_tile=64, group_size=8)
    want = js.segment_reduce(jnp.asarray(seg), jnp.asarray(data), 12,
                             schedule=jsched, op=op)
    got = ts.segment_reduce(torch.from_numpy(seg), torch.from_numpy(data),
                            12, schedule=tsched, op=op, device="cpu")
    _assert_same(got.numpy(), want, op)
    empty = got.numpy()[4]
    assert np.all(empty == {"sum": 0.0, "mean": 0.0, "max": -np.inf,
                            "min": np.inf}[op])


def test_op_default_schedule_matches_reference():
    seg, data = _inputs(300, 20, 6, seed=11)
    for op in ("sum", "max"):
        want = js.segment_reduce(jnp.asarray(seg), jnp.asarray(data), 20,
                                 op=op)
        got = ts.segment_reduce(torch.from_numpy(seg),
                                torch.from_numpy(data), 20, op=op,
                                device="cpu")
        _assert_same(got.numpy(), want, op)


def test_spec_only_user_strategy_matches_reference():
    """A strategy registered with only a spec runs its spec tile by tile
    on the CPU, as the reference's in-kernel fallback does."""
    name = "t_segred_spec_sum"
    j_register(name, lambda p, s, n, g: jax.ops.segment_sum(
        p, s, num_segments=n), overwrite=True)
    t_register(name, lambda p, s, n, g: torch.zeros(
        (n, p.shape[1])).index_add_(0, s.long(), p), overwrite=True)
    seg, data = _inputs(100, 10, 3, seed=5)
    want = js.segment_reduce(jnp.asarray(seg), jnp.asarray(data), 10,
                             schedule=JS("eb", nnz_tile=32, group_size=8,
                                         strategy=name))
    got = ts.segment_reduce(torch.from_numpy(seg), torch.from_numpy(data),
                            10, schedule=TS("eb", nnz_tile=32, group_size=8,
                                            strategy=name), device="cpu")
    _assert_same(got.numpy(), want, "add")


def test_custom_combine_strategy_matches_reference():
    """A strategy registered with its own max combine reduces max under
    the default op, with its -inf identity for the pad and the fill
    (``tests/test_fusion.py``'s pattern)."""
    name = "t_segred_max_combine"
    j_register(name, lambda p, s, n, g, monoid=None: jax.ops.segment_max(
        p, s, num_segments=n), combine=jnp.maximum, identity=-jnp.inf,
        overwrite=True)
    t_register(name, lambda p, s, n, g, monoid=None: torch.full(
        (n, p.shape[1]), -float("inf")).scatter_reduce_(
            0, s.long()[:, None].expand_as(p), p, "amax"),
        combine=torch.maximum, identity=-float("inf"), overwrite=True)
    seg, data = _inputs(64, 10, 3, seed=2)
    want = js.segment_reduce(jnp.asarray(seg), jnp.asarray(data), 10,
                             schedule=JS("eb", nnz_tile=64, group_size=8,
                                         strategy=name))
    got = ts.segment_reduce(torch.from_numpy(seg), torch.from_numpy(data),
                            10, schedule=TS("eb", nnz_tile=64, group_size=8,
                                            strategy=name), device="cpu")
    _assert_same(got.numpy(), want, "max")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.ops.segment_max(
            jnp.asarray(data), jnp.asarray(seg), num_segments=10)))


def test_parallel_matches_dense_oracle_on_aligned_segments():
    """``parallel`` is right wherever every group lies in one segment:
    segments of G and of 2G lanes, held against ``jax.ops.segment_sum``."""
    rng = np.random.default_rng(9)
    for G, seg_len in ((8, 8), (8, 16), (32, 32)):
        t = 5 * seg_len
        seg = (np.arange(t) // seg_len).astype(np.int32)
        data = rng.standard_normal((t, 4)).astype(np.float32)
        got = tk.segment_reduce(torch.from_numpy(seg), torch.from_numpy(data),
                                num_segments=5, tile=G * 2, group_size=G,
                                strategy="parallel")
        want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(seg),
                                   num_segments=5)
        _assert_same(got.numpy(), want, "add")


def test_schedules_the_port_refuses():
    seg, data = _inputs(40, 5, 2, seed=0)
    seg_t, data_t = torch.from_numpy(seg), torch.from_numpy(data)
    # the port's Schedule keeps 'eb' + 'parallel' for group-aligned skew
    # layouts only: a default Schedule with it is refused
    with pytest.raises(ValueError, match="parallel"):
        ts.segment_reduce(seg_t, data_t, 5,
                          schedule=TS(strategy="parallel"), device="cpu")
    with pytest.raises(ValueError, match="op"):
        ts.segment_reduce(seg_t, data_t, 5, op="prod", device="cpu")


@pytest.mark.parametrize("op", ["sum", "max", "mean"])
def test_schedule_tune_matches_the_jax_oracle(tmp_path, monkeypatch, op):
    """'tune' measures the eight (tile, group, strategy) points of the
    reference's pool on the plain version and reduces with the winner."""
    from repro_torch.tune import tune_segment_reduce

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_BENCH_ITERS", "1")
    monkeypatch.setenv("REPRO_BENCH_WARMUP", "0")
    seg, data = _inputs(300, 25, 6, seed=11)
    seg_t, data_t = torch.from_numpy(seg), torch.from_numpy(data)
    got = ts.segment_reduce(seg_t, data_t, 25, schedule="tune", op=op,
                            device="cpu")
    res = tune_segment_reduce(seg_t, 6, 25, measure=lambda s: 1 / 0)
    assert res.from_cache and res.schedule.strategy in ("segment",
                                                        "accumulate")
    sj, dj = jnp.asarray(seg), jnp.asarray(data)
    if op == "mean":
        want = (jax.ops.segment_sum(dj, sj, 25) / jnp.maximum(
            jax.ops.segment_sum(jnp.ones_like(dj[:, :1]), sj, 25), 1.0))
    else:
        want = {"sum": jax.ops.segment_sum,
                "max": jax.ops.segment_max}[op](dj, sj, 25)
    if op == "max":
        _assert_same(got.numpy(), want, op)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=RTOL)


def test_op_is_forward_only():
    seg, data = _inputs(40, 5, 2, seed=0)
    x = torch.from_numpy(data).requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.segment_reduce(torch.from_numpy(seg), x, 5, device="cpu")
    with torch.no_grad():
        out = ts.segment_reduce(torch.from_numpy(seg), x, 5, device="cpu")
    assert out.shape == (5, 2)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    before = tk.KERNEL.launches
    seg, data = _inputs(40, 5, 2, seed=0)
    tk.segment_reduce(torch.from_numpy(seg), torch.from_numpy(data),
                      num_segments=5)
    assert tk.KERNEL.launches == before
    with pytest.raises(ValueError, match="group_size"):
        tk.segment_reduce(torch.from_numpy(seg), torch.from_numpy(data),
                          num_segments=5, tile=20, group_size=8)
