"""Fused sparse attention under user-defined reduction strategies: the
port (``sparse_attention`` and ``kernels/attn_user.py``, the kernels'
plain versions on the CPU) against the JAX package's fused kernels in
interpret mode, on the same numpy inputs: out and the gradients of q, k
and v (``jax.grad`` against torch autograd), and the raw ``(out, m, l)``
and ``(dq, dk, dv)`` of the two kernels.

Strategies, registered in both packages with the same semantics: a spec
generic in the monoid; quickstart's one-hot, spec and realization (a
4-argument realization, so the row max sums scores into m, which stays
at NEG_INF, every p overflows to inf, and the one-hot product's 0 * inf
takes NaN to every row: the reference answers NaN everywhere, and so
does the port); its spec alone; a segment
max registered with ``combine="max"`` (l, out and the gradients reduced
under max: the reference's non-softmax answer); a callable combine (the
same ``ValueError`` on both sides, at the max scatter); a spec that
weights each partial by its global row id.  Inputs: 2 heads, a CSR's
values as the score bias, empty rows, a row over several nnz tiles, a
ragged nnz (pad lanes at row 0 and column 0), dv = 5 (not a multiple of
8: the forward's V is padded to 8 columns) and bf16 q, k, v.

Tolerances: f32 out, m, l and dv-wide results 1e-5 relative (1e-5
absolute): the scores are short f32 dots summed in another order, and
exp is XLA's on one side and torch's on the other, an ulp apart; f32
gradients 1e-4 (relative and absolute), as they sum products of two
such results; NaN exactly where the reference's are.  The max strategy's
results are not bit for bit: its maxima are of p V and of exp-derived
values, whose last bits differ with exp's, so they hold to the same 1e-5
(1e-4 for gradients).  bf16 gradients, rounded from the f32 ones, one
bf16 step (2^-7 relative) above those.
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
from repro.kernels import fused_attention as jfa
from repro_torch.core import Schedule as TS
from repro_torch.core import register_strategy as t_register
from repro_torch.kernels import attn_user as au
from repro_torch.kernels import eb_partials as tpart
from repro_torch.kernels import fused_attention as tfa

RTOL = ATOL = 1e-5
GRAD_TOL = 1e-4
BF16_STEP = 2.0 ** -7
NNZ_TILE, GROUP = 32, 8
N_ROWS, N_KV, HEADS, D, DV = 30, 24, 2, 8, 5


def _j_onehot_spec(partials, seg_ids, num_segments, group_size):
    onehot = (seg_ids[:, None]
              == jnp.arange(num_segments)[None, :]).astype(partials.dtype)
    return jnp.einsum("ts,tc->sc", onehot, partials)


def _j_onehot_pallas(rows, partial, out_ref, group_size):
    s = out_ref.shape[0]
    onehot = (rows[:, None] == jax.lax.broadcasted_iota(
        jnp.int32, (rows.shape[0], s), 1)).astype(partial.dtype)
    out_ref[...] += jnp.dot(onehot.T, partial,
                            preferred_element_type=jnp.float32)


def _t_onehot(ids, n, dtype):
    return (ids[:, None] == torch.arange(n)[None, :]).to(dtype)


def _t_onehot_spec(partials, seg_ids, num_segments, group_size):
    return _t_onehot(seg_ids, num_segments, partials.dtype).T @ partials


def _t_onehot_kernel(rows, partial, out, group_size):
    out += _t_onehot(rows, out.shape[0], partial.dtype).T @ partial


def _generic_spec(p, s, n, g, monoid=None):
    return monoid.seg_reduce(p, s, n)


def _j_max_spec(p, s, n, g, monoid=None):
    return jax.ops.segment_max(p, s, num_segments=n)


def _t_max_spec(p, s, n, g, monoid=None):
    return torch.full((n, p.shape[1]), -float("inf")).scatter_reduce_(
        0, s.long()[:, None].expand_as(p), p, "amax")


def _j_idweight_spec(p, s, n, g):
    return jax.ops.segment_sum(p * s[:, None].astype(p.dtype), s,
                               num_segments=n)


def _t_idweight_spec(p, s, n, g):
    return torch.zeros(n, p.shape[1]).index_add_(
        0, s.long(), p * s[:, None].to(p.dtype))


STRATEGIES = {
    # name: (JAX registration, port registration)
    "t_au_generic": (dict(spec_fn=_generic_spec),
                     dict(spec_fn=_generic_spec)),
    "t_au_onehot": (dict(spec_fn=_j_onehot_spec, pallas_fn=_j_onehot_pallas),
                    dict(spec_fn=_t_onehot_spec, kernel_fn=_t_onehot_kernel)),
    "t_au_spec": (dict(spec_fn=_j_onehot_spec), dict(spec_fn=_t_onehot_spec)),
    "t_au_max": (dict(spec_fn=_j_max_spec, combine="max"),
                 dict(spec_fn=_t_max_spec, combine="max")),
    "t_au_callable": (dict(spec_fn=_j_max_spec, combine=jnp.maximum,
                           identity=-float("inf")),
                      dict(spec_fn=_t_max_spec, combine=torch.maximum,
                           identity=-float("inf"))),
    "t_au_idweight": (dict(spec_fn=_j_idweight_spec),
                      dict(spec_fn=_t_idweight_spec)),
}


@pytest.fixture(scope="module", autouse=True)
def _registered():
    for name, (j_kw, t_kw) in STRATEGIES.items():
        j_register(name, overwrite=True, **j_kw)
        t_register(name, overwrite=True, **t_kw)


def _pattern(seed=0):
    """CSR order over (N_ROWS, N_KV): empty rows, one-nonzero rows, row 3
    over 40 nonzeros (two nnz tiles); a ragged nnz."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 6, N_ROWS)
    lengths[::7] = 0
    lengths[2::7] = 1
    lengths[3] = 40
    cols = np.concatenate([rng.choice(N_KV, int(n), replace=n > N_KV)
                           for n in lengths]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    bias = rng.standard_normal(cols.shape[0]).astype(np.float32)
    assert cols.shape[0] % NNZ_TILE and (lengths == 0).any()
    return indptr, cols, bias


def _csrs(seed=0):
    indptr, cols, bias = _pattern(seed)
    a_j = js.CSR(indptr=jnp.asarray(indptr), indices=jnp.asarray(cols),
                 vals=jnp.asarray(bias), shape=(N_ROWS, N_KV))
    a_t = ts.CSR.from_numpy(indptr, cols, bias, (N_ROWS, N_KV), device="cpu")
    return a_j, a_t


def _inputs(seed=1, bf16=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((N_ROWS, HEADS, D)).astype(np.float32)
    k = rng.standard_normal((N_KV, HEADS, D)).astype(np.float32)
    v = rng.standard_normal((N_KV, HEADS, DV)).astype(np.float32)
    cot = rng.standard_normal((N_ROWS, HEADS, DV)).astype(np.float32)
    if bf16:  # values a bf16 holds exactly, in both
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (q, k, v))
    return q, k, v, cot


def _both(strategy, bf16=False):
    """out and the q, k, v gradients of ``sum(out * cot)`` in both
    packages, q, k and v at f32 or bf16."""
    a_j, a_t = _csrs()
    q, k, v, cot = _inputs(bf16=bf16)
    kw = dict(kernel="eb", nnz_tile=NNZ_TILE, group_size=GROUP,
              strategy=strategy)
    jt = jnp.bfloat16 if bf16 else jnp.float32

    def loss(qq, kk, vv):
        out = js.sparse_attention(a_j, qq, kk, vv, schedule=JS(**kw),
                                  interpret=True)
        return jnp.sum(out * cot), out

    (_, want), grads_j = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x, jt) for x in (q, k, v)))
    tt = torch.bfloat16 if bf16 else torch.float32
    leaves = [torch.from_numpy(x).to(tt).requires_grad_() for x in (q, k, v)]
    out = ts.sparse_attention(a_t, *leaves, schedule=TS(**kw), device="cpu")
    out.backward(torch.from_numpy(cot))
    return (out.detach().numpy(), np.asarray(want),
            [(lf.grad.float().numpy(), np.asarray(g, np.float32))
             for lf, g in zip(leaves, grads_j)], a_t)


def _close(got, want, tol):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("strategy", ["t_au_generic", "t_au_onehot",
                                      "t_au_spec", "t_au_max",
                                      "t_au_idweight"])
def test_sparse_attention_under_a_user_strategy_matches_reference(strategy):
    got, want, grads, a_t = _both(strategy)
    assert got.dtype == np.float32
    _close(got, want, RTOL)
    for g, w in grads:
        _close(g, w, GRAD_TOL)
    if strategy == "t_au_onehot":
        # m never leaves NEG_INF, p overflows to inf and the one-hot
        # product's 0 * inf reaches every row: NaN, as in the reference
        assert np.isnan(got).all()
    else:
        assert np.isfinite(got).all()
    if strategy == "t_au_idweight":
        # global ids: row 0's l is 0, so its output is 0; every other
        # row's weight cancels in out / l
        assert (got[0] == 0).all() and np.abs(got[1:]).max() > 0.1
    if strategy != "t_au_max":
        return
    # the max strategy's answer is not the softmax's
    oracle = ts.sparse_attention(a_t, *(torch.from_numpy(x)
                                        for x in _inputs()[:3]),
                                 impl="ref", device="cpu").numpy()
    assert np.abs(got - oracle).max() > 0.1


def test_sparse_attention_under_a_user_strategy_at_bf16_matches_reference():
    got, want, grads, _ = _both("t_au_generic", bf16=True)
    _close(got, want, RTOL)
    for g, w in grads:
        _close(g, w, GRAD_TOL + BF16_STEP)


def test_a_callable_combine_raises_at_the_max_scatter_on_both_sides():
    a_j, a_t = _csrs()
    q, k, v, _ = _inputs()
    kw = dict(kernel="eb", nnz_tile=NNZ_TILE, group_size=GROUP,
              strategy="t_au_callable")
    with pytest.raises(ValueError, match="cannot run under op='max'"):
        js.sparse_attention(a_j, q, k, v, schedule=JS(**kw), interpret=True)
    with pytest.raises(ValueError, match="cannot run under op='max'"):
        ts.sparse_attention(a_t, *(torch.from_numpy(x) for x in (q, k, v)),
                            schedule=TS(**kw), device="cpu")


def _streams(indptr, cols, bias):
    """The stream as the reference's ``_sparse_attention_diff`` pads it:
    whole nnz tiles, pad lanes at row 0 and column 0 with bias 0."""
    rows = np.repeat(np.arange(N_ROWS), np.diff(indptr)).astype(np.int32)
    nnz = rows.shape[0]
    pad = max(-(-nnz // NNZ_TILE), 1) * NNZ_TILE - nnz
    return nnz, [np.pad(x, (0, pad)) for x in (rows, cols, bias)]


@pytest.mark.parametrize("strategy", ["t_au_generic", "t_au_max"])
def test_user_walk_matches_the_reference_kernels(strategy):
    """The raw ``(out, m, l)`` of ``fused_sparse_attention_user`` and the
    ``(dq, dk, dv)`` of its backward (from those m, l) against the JAX
    package's two kernels under the same strategy, empty rows at m =
    NEG_INF; the plain walk is the same walk."""
    indptr, cols, bias = _pattern(seed=4)
    nnz, (rows_p, cols_p, bias_p) = _streams(indptr, cols, bias)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((HEADS, N_ROWS, D)).astype(np.float32)
    k = rng.standard_normal((HEADS, N_KV, D)).astype(np.float32)
    v = rng.standard_normal((HEADS, N_KV, DV)).astype(np.float32)
    do = rng.standard_normal((HEADS, N_ROWS, DV)).astype(np.float32)
    scale = D ** -0.5
    dv_tile, dv_pad = au.dv_tiling(DV)
    jkw = dict(n_rows=N_ROWS, nnz=nnz, nnz_tile=NNZ_TILE, scale=scale,
               group_size=GROUP, strategy=strategy,
               bias=jnp.asarray(bias_p), interpret=True)
    out, m, l = jfa.fused_sparse_attention(
        jnp.asarray(rows_p), jnp.asarray(cols_p), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(np.pad(v, ((0, 0), (0, 0),
                                               (0, dv_pad - DV)))),
        dv_tile=dv_tile, **jkw)
    want_f = (np.asarray(out)[..., :DV], np.asarray(m), np.asarray(l))
    want_b = jfa.fused_sparse_attention_bwd(
        jnp.asarray(rows_p), jnp.asarray(cols_p), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(do), m, l, **jkw)
    t = torch.from_numpy
    tkw = dict(n_rows=N_ROWS, nnz=nnz, nnz_tile=NNZ_TILE, group_size=GROUP,
               strategy=strategy, scale=scale, bias=t(bias_p))
    stream = (t(rows_p), t(cols_p), t(q), t(k), t(v))
    got_f = au.fused_sparse_attention_user(*stream, **tkw)
    got_b = au.fused_sparse_attention_bwd_user(*stream, t(do), *got_f[1:],
                                               **tkw)
    for got, want in zip(got_f, want_f):
        _close(got.numpy(), want, RTOL)
    for got, want in zip(got_b, want_b):
        _close(got.numpy(), np.asarray(want), GRAD_TOL)
    empty = np.diff(indptr) == 0
    assert (got_f[1][:, empty] == tfa.NEG_INF).all()
    plain_f = au.fused_sparse_attention_user_plain(*stream, **tkw)
    plain_b = au.fused_sparse_attention_bwd_user_plain(
        *stream, t(do), *got_f[1:], **tkw)
    for got, want in zip(got_f + got_b, plain_f + plain_b):
        assert torch.equal(got, want)


def test_the_user_code_sees_global_ids_and_whole_blocks():
    """What each of the seven scatters hands a realization: the tile's
    global ids, C = 1 (m, l, delta), a dv tile (out), dv (dV) or d (dQ,
    dK), and the whole block of height n_rows, or n_kv for the scatters
    by column; the pad lanes at row 0 and column 0."""
    seen = []

    def kernel(ids, part, out, group_size, monoid=None):
        seen.append((ids.clone(), part.shape[1], out.shape, monoid.name))
        out.copy_(monoid.combine(out, monoid.seg_reduce(part, ids,
                                                        out.shape[0])))

    t_register("t_au_record", _generic_spec, kernel, overwrite=True)
    indptr, cols, bias = _pattern(seed=2)
    nnz, (rows_p, cols_p, bias_p) = _streams(indptr, cols, bias)
    n_tiles = rows_p.shape[0] // NNZ_TILE
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, N_ROWS, D), (1, N_KV, D), (1, N_KV, DV)))
    kw = dict(n_rows=N_ROWS, nnz=nnz, nnz_tile=NNZ_TILE, group_size=GROUP,
              strategy="t_au_record", scale=0.5, bias=torch.from_numpy(bias_p))
    r, c = torch.from_numpy(rows_p), torch.from_numpy(cols_p)
    _, m, l = au.fused_sparse_attention_user(r, c, q, k, v, **kw)
    fwd = [(N_ROWS, 1, "max"), (N_ROWS, 1, "add"), (N_ROWS, 8, "add")]
    assert [(s[2][0], s[1], s[3]) for s in seen] == fwd * n_tiles
    for i, (ids, *_) in enumerate(seen):
        assert torch.equal(ids, r[(i // 3) * NNZ_TILE:
                                  (i // 3 + 1) * NNZ_TILE])
    seen.clear()
    au.fused_sparse_attention_bwd_user(r, c, q, k, v, torch.ones(
        1, N_ROWS, DV), m, l, **kw)
    by = [(N_ROWS, 1, r), (N_KV, DV, c), (N_ROWS, D, r), (N_KV, D, c)]
    assert len(seen) == 4 * n_tiles
    for i, (ids, width, shape, _) in enumerate(seen):
        height, want_w, idx = by[i // n_tiles]
        t0 = (i % n_tiles) * NNZ_TILE
        assert shape == (height, want_w) and width == want_w
        assert torch.equal(ids, idx[t0:t0 + NNZ_TILE])
    assert (r[nnz:] == 0).all() and (c[nnz:] == 0).all()


def test_builtin_strategies_keep_the_fused_kernels(monkeypatch):
    """``segment`` and ``accumulate`` run the fused kernels (their result
    does not depend on the strategy); a user strategy runs the walk."""
    _, a_t = _csrs()
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs())
    calls = []
    real = au.fused_sparse_attention_user
    monkeypatch.setattr(au, "fused_sparse_attention_user",
                        lambda *a, **kw: calls.append(kw["strategy"])
                        or real(*a, **kw))
    outs = [ts.sparse_attention(a_t, q, k, v, schedule=TS(
        nnz_tile=NNZ_TILE, group_size=GROUP, strategy=s), device="cpu")
        for s in ("segment", "accumulate", "t_au_generic")]
    assert calls == ["t_au_generic"]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=RTOL, atol=ATOL)


def test_lane_wrappers_take_their_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions and count no
    launch: the scores with NEG_INF on pad lanes, the rescale's alpha 0
    for a row still at NEG_INF (and 1 where m did not move), p 0 on
    pads, the finish's division, and the f32 values on a bf16 B in the
    partials kernel's plain version."""
    rng = np.random.default_rng(9)
    rows = torch.from_numpy(np.sort(rng.integers(0, 6, 16)).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, 5, 16).astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((5, 4)).astype(np.float32))
    before = (au.LANES.launches, au.RESCALE.launches,
              tpart.KERNEL.launches)
    s = au.attn_scores(rows, cols, q, k, nnz=12, scale=0.5)
    want = (q[rows.long()] * k[cols.long()]).sum(-1) * 0.5
    assert torch.equal(s[:12], want[:12])
    assert (s[12:] == tfa.NEG_INF).all()
    m_old = torch.tensor([tfa.NEG_INF, 1.0, 2.0, 0.5, 3.0, 1.0])[:, None]
    m_new = torch.tensor([0.5, 1.0, 3.0, 0.5, 3.0, 2.0])[:, None]
    l = torch.arange(1.0, 7.0)[:, None]
    acc = torch.ones(2, 6, 3)
    p = au.attn_rescale(m_old, m_new, l, acc, s, rows, n_valid=12)
    alpha = torch.tensor([0.0, 1.0, np.exp(-1.0), 1.0, 1.0, np.exp(-1.0)],
                         dtype=torch.float32)
    torch.testing.assert_close(l[:, 0], torch.arange(1.0, 7.0) * alpha)
    torch.testing.assert_close(acc, alpha[None, :, None].expand(2, 6, 3))
    assert torch.equal(p[:12], torch.exp(s[:12] - m_new[rows[:12].long(),
                                                        0]))
    assert (p[12:] == 0).all()
    au.attn_finish(acc, l)
    assert (acc[:, 0] == 0).all()
    vals = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    b = k.to(torch.bfloat16)
    got = tpart.eb_partials(cols, cols, vals, b, n_rows=5)
    assert torch.equal(got, vals[:, None] * b.float()[cols.long()])
    assert (au.LANES.launches, au.RESCALE.launches,
            tpart.KERNEL.launches) == before
