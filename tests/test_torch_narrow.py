"""Narrow operands of the port against the JAX package on the same numpy
inputs: SDDMM at every (A, B) pair its CUDA kernel loads and at pairs it
promotes; fused sparse attention forward and gradients at bf16 and fp16
q, k and v, and at head widths above 256, with the kernels' slab walk
emulated in plain PyTorch; the grouped matmul at every operand pair of
its two routes, and the route choice for the new pairs; and the MoE
paths with e4m3 expert weights and at fp16: ``apply_moe``,
``params_from_jax`` and ``ServeEngine``.  The port runs its kernels'
plain versions on the CPU; the reference runs its Pallas kernels in
interpret mode.  Narrow values are rounded once, by JAX, and carried to
torch bit for bit, so both packages see the same stored values.

Tolerances.  SDDMM and the grouped matmul: rtol = atol = 1e-5 (f32 sums
of exactly upcast values, in another order).  Attention: the output
within 1e-5; the gradients within 1e-4 relative L2 in f32 before their
cast, and within one unit in the last place of their type after it (the
two packages' f32 gradients may round to neighbours).  The MoE layer
1e-5, the served logits 1e-4 (f32 activations, e4m3 experts) and 2^-5
relative L2 at fp16 (the LM tolerance: fp16 activations rounded in
other places by XLA and torch); greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.sparse as js
import repro_torch.sparse as ts
from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke
from repro.kernels import ops as jops
from repro.kernels.grouped_matmul import grouped_matmul as j_gmm
from repro.models import get_model as jget_model
from repro.models import moe as jmoe
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.kernels import fused_attention as tfa
from repro_torch.kernels import grouped_matmul as tgmm
from repro_torch.kernels import sddmm as tsddmm
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve import Request, ServeEngine

RTOL = ATOL = 1e-5
GRAD_REL_L2 = 1e-4
LM_TOL = 1e-4
FP16_LOGIT_REL_L2 = 2.0 ** -5

F32, BF16, F16, E4M3 = "float32", "bfloat16", "float16", "float8_e4m3fn"
#: torch's type of each name.
TORCH = {F32: torch.float32, BF16: torch.bfloat16, F16: torch.float16,
         E4M3: torch.float8_e4m3fn}
#: Mantissa bits and smallest normal exponent of the gradients' types.
ULP = {BF16: (7, -126), F16: (10, -14)}


def _narrow(x, name):
    """(JAX array, torch tensor) of the f32 numpy ``x`` rounded once to
    ``name`` by JAX, the torch tensor holding the same bits."""
    j = jnp.asarray(x).astype(jnp.dtype(name))
    a = np.asarray(j)
    if name in (BF16, E4M3):
        view = np.int16 if name == BF16 else np.uint8
        return j, torch.from_numpy(a.view(view).copy()).view(TORCH[name])
    return j, torch.from_numpy(a.copy())


def _np(t):
    return np.asarray(t, np.float32)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _within_one_ulp(got, want, name):
    """|got - want| <= one unit in the last place of ``want`` in type
    ``name`` (at the bottom of its normals below them)."""
    mant, emin = ULP[name]
    got, want = _np(got), _np(want)
    e = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** emin)))
    assert np.all(np.abs(got - want) <= 2.0 ** (e - mant)), (
        f"{np.max(np.abs(got - want) / 2.0 ** (e - mant)):.2f} ulp")


# ---------------------------------------------------------------------------
# SDDMM
# ---------------------------------------------------------------------------


def _sddmm_inputs(d=24, m=20, n=18, nnz=90, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, m, nnz)).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    a = rng.standard_normal((m, d)).astype(np.float32)
    b = rng.standard_normal((n, d)).astype(np.float32)
    scale = rng.standard_normal(nnz).astype(np.float32)
    return rows, cols, a, b, scale


@pytest.mark.parametrize("a_t,b_t", [
    (F32, F32), (BF16, BF16), (F16, F16), (E4M3, E4M3), (F32, BF16),
    (F32, F16), (F32, E4M3),  # the kernel's pairs
    (BF16, F32), (E4M3, F16)])  # promoted: the narrower operand copied
def test_sddmm_pairs_match_reference(a_t, b_t):
    rows, cols, a, b, scale = _sddmm_inputs(seed=len(a_t) + len(b_t))
    ja, ta = _narrow(a, a_t)
    jb, tb = _narrow(b, b_t)
    want = jops.sddmm(jnp.asarray(rows), jnp.asarray(cols), ja, jb,
                      jnp.asarray(scale), nnz_tile=32, interpret=True)
    got = ts.sddmm(torch.from_numpy(rows), torch.from_numpy(cols), ta, tb,
                   torch.from_numpy(scale), nnz_tile=32, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("a_t,b_t,want", [
    (F32, F32, (F32, F32)), (BF16, BF16, (BF16, BF16)),
    (E4M3, E4M3, (E4M3, E4M3)), (F32, F16, (F32, F16)),
    (F32, E4M3, (F32, E4M3)), (BF16, F32, (F32, F32)),
    (E4M3, F16, (F16, F16)), (F16, E4M3, (F16, F16)),
    (BF16, F16, (F32, F32))])
def test_sddmm_cuda_pair(a_t, b_t, want):
    assert tsddmm.cuda_pair(TORCH[a_t], TORCH[b_t]) == tuple(
        TORCH[w] for w in want)
    with pytest.raises(ValueError, match="kernels load"):
        tsddmm.cuda_pair(torch.int8, TORCH[b_t])


@pytest.mark.parametrize("d,itemsize,want", [
    (256, 2, (8, 32, 1, 1)),   # bf16 at 256: one 16-byte vector a lane
    (40, 2, (8, 5, 6, 1)),     # six workers of five lanes
    (256, 1, (16, 16, 2, 1)),  # e4m3: 16 a vector, two workers a warp
    (40, 1, (4, 10, 3, 1)),    # 40 % 16: 4-byte loads, three workers
    (36, 2, (4, 9, 3, 1)),     # 36 % 8: 8-byte loads
    (37, 2, (1, 32, 1, 2)),    # element loads
    (1024, 2, (8, 32, 1, 4)),
    (2048, 2, (8, 32, 1, 0)),  # past 32 elements a lane: the wide walk
    (1024, 1, (16, 32, 1, 2)),
    (2048, 1, (16, 32, 1, 0)),
    (256, 4, (4, 32, 1, 2)),   # f32, the default itemsize's answer
])
def test_sddmm_geometry_of_narrow_rows(d, itemsize, want):
    g = tsddmm.sddmm_geometry(d, True, itemsize)
    assert tuple(g) == want
    assert g.vpl * g.vec <= tsddmm.MAX_ELEMENTS_PER_LANE
    assert g.vpl == 0 or g.lw * g.vpl * g.vec >= d
    assert tsddmm.sddmm_geometry(d, True) == tsddmm.sddmm_geometry(d, True, 4)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attn_pattern(n_rows=24, n_kv=20, seed=0, long_row=40):
    """CSR-order pattern with empty rows and one long row."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 6, n_rows)
    lengths[::6] = 0
    lengths[3] = long_row
    cols = np.concatenate([rng.choice(n_kv, int(n), replace=n > n_kv)
                           for n in lengths]).astype(np.int32)
    rows = np.repeat(np.arange(n_rows), lengths).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return indptr, rows, cols


def _attn_operands(heads, n_rows, n_kv, d, dv, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (n_rows, heads, d), (n_kv, heads, d), (n_kv, heads, dv),
        (n_rows, heads, dv)))


def _jax_attention(pat, q, k, v, do):
    """(out, (dq, dk, dv)) of the reference's public op under jax.grad of
    <out, do>."""
    def loss(q_, k_, v_):
        out = js.sparse_attention(pat, q_, k_, v_)
        return jnp.sum(out.astype(jnp.float32) * do), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    return out, grads


def _torch_attention(pat, q, k, v, do):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = ts.sparse_attention(pat, q, k, v, device="cpu")
    (out * do).sum().backward()
    return out.detach(), (q.grad, k.grad, v.grad)


@pytest.mark.parametrize("name", [BF16, F16])
def test_attention_narrow_qkv_match_reference(name):
    indptr, rows, cols = _attn_pattern()
    n_rows, n_kv = indptr.shape[0] - 1, 20
    q, k, v, do = _attn_operands(2, n_rows, n_kv, 16, 8)
    (jq, tq), (jk, tk), (jv, tv) = (_narrow(x, name) for x in (q, k, v))
    jpat = (jnp.asarray(rows), jnp.asarray(cols), n_rows)
    tpat = (torch.from_numpy(rows), torch.from_numpy(cols), n_rows)
    want, jgrads = _jax_attention(jpat, jq, jk, jv, jnp.asarray(do))
    got, tgrads = _torch_attention(tpat, tq, tk, tv, torch.from_numpy(do))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    for g, w in zip(tgrads, jgrads):
        assert g.dtype == TORCH[name] and w.dtype == jnp.dtype(name)
        _within_one_ulp(g.float(), w, name)
    # before their cast: the kernel's f32 gradients against the reference's
    # on the same stored values in f32
    _, jf32 = _jax_attention(jpat, *(x.astype(jnp.float32)
                                     for x in (jq, jk, jv)),
                             jnp.asarray(do))
    hm = (lambda t: t.movedim(1, 0).contiguous())  # noqa: E731
    scale = 16 ** -0.5
    ip = torch.from_numpy(indptr)
    c = torch.from_numpy(cols)
    _, m, l = tfa.fused_sparse_attention(ip, c, hm(tq), hm(tk), hm(tv),
                                         scale=scale)
    f32 = tfa.fused_sparse_attention_bwd(ip, c, hm(tq), hm(tk), hm(tv),
                                         hm(torch.from_numpy(do)), m, l,
                                         scale=scale)
    for g, w in zip(f32, jf32):
        assert g.dtype == torch.float32
        assert _rel_l2(g.movedim(0, 1), w) <= GRAD_REL_L2


@pytest.mark.parametrize("d,dv", [(320, 320), (16, 300)])
def test_attention_wide_heads_match_reference(d, dv):
    """Head widths above one slab (256 columns) at f32, forward and
    backward through the public ops."""
    indptr, rows, cols = _attn_pattern(n_rows=12, n_kv=10, seed=2,
                                       long_row=12)
    n_rows = indptr.shape[0] - 1
    q, k, v, do = _attn_operands(1, n_rows, 10, d, dv, seed=3)
    jpat = (jnp.asarray(rows), jnp.asarray(cols), n_rows)
    tpat = (torch.from_numpy(rows), torch.from_numpy(cols), n_rows)
    want, jgrads = _jax_attention(jpat, *(jnp.asarray(x)
                                          for x in (q, k, v, do)))
    got, tgrads = _torch_attention(tpat, *(torch.from_numpy(x)
                                           for x in (q, k, v, do)))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    for g, w in zip(tgrads, jgrads):
        assert _rel_l2(g, w) <= GRAD_REL_L2


def test_slab_ranges():
    assert tfa.slab_ranges(1) == [(0, 1)]
    assert tfa.slab_ranges(256) == [(0, 256)]
    assert tfa.slab_ranges(257) == [(0, 256), (256, 257)]
    assert tfa.slab_ranges(600) == [(0, 256), (256, 512), (512, 600)]
    with pytest.raises(ValueError, match="width"):
        tfa.slab_ranges(0)


@pytest.mark.parametrize("d,dv", [(320, 320), (16, 300), (40, 600),
                                  (300, 8)])
def test_slab_walk_matches_plain_and_reference(d, dv):
    """The kernels' slab walk, split rows included (chunks of 8 nonzeros
    cut the long row): (m, l) derived again in every slab bit for bit,
    the slabs' columns side by side equal to the plain versions and to
    the reference's kernels."""
    indptr, rows, cols = _attn_pattern(n_rows=10, n_kv=9, seed=4,
                                       long_row=21)
    n_rows = indptr.shape[0] - 1
    q, k, v, do = _attn_operands(2, n_rows, 9, d, dv, seed=5)
    bias = np.random.default_rng(6).standard_normal(
        rows.shape[0]).astype(np.float32)
    hm = (lambda x: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        np.moveaxis(x, 1, 0))))
    ip, c, tb = (torch.from_numpy(x) for x in (indptr, cols, bias))
    tq, tk, tv, tdo = (hm(x) for x in (q, k, v, do))
    scale = d ** -0.5
    kw = dict(scale=scale, bias=tb)
    out, m, l = tfa.fused_sparse_attention_slabbed_plain(
        ip, c, tq, tk, tv, chunk=8, **kw)
    p_out, p_m, p_l = tfa.fused_sparse_attention_plain(ip, c, tq, tk, tv,
                                                       **kw)
    c_out, c_m, c_l = tfa.fused_sparse_attention_chunked_plain(
        ip, c, tq, tk, tv, chunk=8, **kw)
    # every slab derives the same (m, l) bit for bit
    for c0, c1 in tfa.slab_ranges(dv):
        _, s_m, s_l = tfa.fused_sparse_attention_chunked_plain(
            ip, c, tq, tk, tv[..., c0:c1], chunk=8, **kw)
        assert torch.equal(s_m, c_m) and torch.equal(s_l, c_l)
    assert torch.equal(m, p_m)  # the row max, exactly
    torch.testing.assert_close(out, p_out, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(l, p_l, rtol=RTOL, atol=ATOL)
    grads = tfa.fused_sparse_attention_bwd_slabbed_plain(
        ip, c, tq, tk, tv, tdo, m, l, chunk=8, **kw)
    plain = tfa.fused_sparse_attention_bwd_plain(ip, c, tq, tk, tv, tdo, m,
                                                 l, **kw)
    for g, w in zip(grads, plain):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    # the reference's public op on the same pattern, values as its bias
    adj = js.CSR(jnp.asarray(indptr), jnp.asarray(cols), jnp.asarray(bias),
                 (n_rows, 9))
    want, jgrads = _jax_attention(adj, *(jnp.asarray(x)
                                         for x in (q, k, v, do)))
    np.testing.assert_allclose(out.movedim(0, 1).numpy(), _np(want),
                               rtol=RTOL, atol=ATOL)
    for g, w in zip(grads, jgrads):
        assert _rel_l2(g.movedim(0, 1), w) <= GRAD_REL_L2


# ---------------------------------------------------------------------------
# Grouped matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_t,w_t", [
    (BF16, BF16), (F16, F16), (BF16, E4M3), (F16, E4M3), (E4M3, E4M3),
    (F32, F16), (F32, E4M3), (F32, BF16), (BF16, F16)])
def test_grouped_matmul_pairs_match_jax_kernel(x_t, w_t):
    rng = np.random.default_rng(len(x_t) * 7 + len(w_t))
    x = rng.standard_normal((5 * 4, 32)).astype(np.float32)
    te = rng.integers(0, 3, 5).astype(np.int32)
    w = (rng.standard_normal((3, 32, 16)) * 32 ** -0.5).astype(np.float32)
    (jx, tx), (jw, tw) = _narrow(x, x_t), _narrow(w, w_t)
    want = j_gmm(jx, jnp.asarray(te), jw, token_tile=4, f_tile=16,
                 d_tile=32, interpret=True)
    got = tgmm.grouped_matmul(tx, torch.from_numpy(te), tw, token_tile=4,
                              f_tile=16, d_tile=32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


_B, _H, _E, _F = (torch.bfloat16, torch.float16, torch.float8_e4m3fn,
                  torch.float32)


@pytest.mark.parametrize("x_dtype,w_dtype,d,f,x_addr,w_addr,route", [
    (_H, _H, 4096, 1536, 0, 0, "mma"),     # fp16 serving operands
    (_B, _E, 4096, 1536, 0, 0, "mma"),     # e4m3 experts, bf16 tokens
    (_H, _E, 1536, 4096, 256, 512, "mma"),
    (_E, _E, 4096, 1536, 0, 0, "mma"),     # through fp16
    (_E, _E, 4088, 1536, 0, 0, "fma"),     # D not whole 16 bytes of e4m3
    (_B, _E, 4096, 1528, 0, 0, "fma"),     # e4m3 copies 16 columns
    (_H, _H, 300, 40, 0, 0, "fma"),        # D % 8: no 16-byte x copies
    (_H, _H, 128, 64, 4, 0, "fma"),        # tokens off 16 bytes
    (_H, _E, 128, 64, 0, 8, "fma"),        # weights off 16 bytes
    (_F, _H, 4096, 1536, 0, 0, "fma"),     # f32 tokens: the down projection
    (_F, _E, 4096, 1536, 0, 0, "fma"),
    (_E, _B, 4096, 1536, 0, 0, "fma"),
    (_B, _H, 4096, 1536, 0, 0, "fma"),     # no exact 16-bit type for both
    (_B, _B, 4096, 1536, 0, 0, "mma"),     # bf16 on bf16 as before
])
def test_grouped_matmul_route_of_narrow_pairs(x_dtype, w_dtype, d, f, x_addr,
                                              w_addr, route):
    assert tgmm.gmm_route(x_dtype, w_dtype, d, f, x_addr, w_addr) == route
    assert {x_dtype, w_dtype} <= set(tgmm.CUDA_IN_DTYPES)


# ---------------------------------------------------------------------------
# The MoE paths: e4m3 experts, fp16
# ---------------------------------------------------------------------------

_ARCH = "qwen3-moe-235b-a22b"
_EXPERTS = ("wg", "wi", "wo")


def _e4m3_experts(moe):
    return {k: (v.astype(jnp.float8_e4m3fn) if k in _EXPERTS else v)
            for k, v in moe.items()}


def test_apply_moe_with_e4m3_experts_matches_jax():
    jcfg = jsmoke(JARCHS[_ARCH]).scaled(moe_pallas_dispatch=True)
    tcfg = tconfigs.smoke_config(tconfigs.ARCHS[_ARCH])
    jp = _e4m3_experts(jmoe.init_moe(jcfg, jax.random.PRNGKey(0)))
    tp = {k: _narrow(np.asarray(v, np.float32), str(v.dtype))[1]
          for k, v in jp.items()}
    assert tp["wg"].dtype == torch.float8_e4m3fn
    x = np.random.default_rng(1).normal(
        size=(24, jcfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x), None)
    got, got_aux = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x),
                                  device="cpu")
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=RTOL)
    # the einsum path refuses them, as the reference's does
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        tmoe.apply_moe(tcfg.scaled(moe_kernel_dispatch=False), tp,
                       torch.from_numpy(x), device="cpu")


def _lm(param_dtype=None, e4m3=False):
    jcfg = jsmoke(JARCHS[_ARCH]).scaled(moe_pallas_dispatch=True)
    tcfg = tconfigs.smoke_config(tconfigs.ARCHS[_ARCH])
    if param_dtype:
        jcfg = jcfg.scaled(param_dtype=param_dtype, compute_dtype=param_dtype)
        tcfg = tcfg.scaled(param_dtype=param_dtype, compute_dtype=param_dtype)
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(3))
    if e4m3:
        jparams = {**jparams, "layers": {
            **jparams["layers"],
            "moe": _e4m3_experts(jparams["layers"]["moe"])}}
    return tcfg, japi, jparams, get_model(tcfg), params_from_jax(
        tcfg, jparams, device="cpu")


@pytest.fixture(scope="module")
def e4m3_lm():
    return _lm(e4m3=True)


def test_params_from_jax_carries_e4m3_bits(e4m3_lm):
    tcfg, _, jparams, _, tparams = e4m3_lm
    for name in _EXPERTS:
        want = np.asarray(jparams["layers"]["moe"][name])
        assert want.dtype == ml_dtypes.float8_e4m3fn
        for i, layer in enumerate(tparams["layers"]):
            got = layer["moe"][name]
            assert got.dtype == torch.float8_e4m3fn
            np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                          want[i].view(np.uint8))
    assert tparams["layers"][0]["moe"]["router"].dtype == torch.float32


def _prompts(n, length, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=length, dtype=np.int32)
            for _ in range(n)]


def _logits_over_steps(japi, jparams, tapi, tparams, vocab, steps=3):
    """(port, reference) logits of a prefill and ``steps`` greedy decode
    steps on the reference's tokens."""
    toks = np.random.default_rng(1).integers(0, vocab, size=(2, 7)).astype(
        np.int32)
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, 12)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)}, 12)
    pairs = []
    for _ in range(steps + 1):
        pairs.append((tl, jl))
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        jl, jc = japi.decode_step(jparams, jc, jnp.asarray(nxt))
        tl, tc = tapi.decode_step(tparams, tc, torch.from_numpy(nxt))
    return pairs


def test_serve_engine_with_e4m3_experts_matches_reference(e4m3_lm):
    """f32 activations on e4m3 expert weights: logits of a prefill and
    three decode steps within 1e-4, greedy tokens of the engines equal."""
    tcfg, japi, jparams, tapi, tparams = e4m3_lm
    for tl, jl in _logits_over_steps(japi, jparams, tapi, tparams,
                                     tcfg.vocab_size):
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=LM_TOL,
                                   atol=LM_TOL)
    jeng = JEngine(japi, jparams, slots=2, max_len=12)
    teng = ServeEngine(tapi, tparams, slots=2, max_len=12, device="cpu")
    for rid, p in enumerate(_prompts(3, 5, tcfg.vocab_size)):
        jeng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=3))
        teng.submit(Request(rid=rid, prompt=p, max_new_tokens=3))
    got = teng.run_to_completion()
    assert got == jeng.run_to_completion() and len(got) == 3


def test_fp16_model_matches_reference():
    """param_dtype = compute_dtype = float16 on the kernel dispatch: the
    logits of a prefill and three decode steps within 2^-5 relative L2."""
    tcfg, japi, jparams, tapi, tparams = _lm(param_dtype=F16)
    assert tparams["layers"][0]["moe"]["wg"].dtype == torch.float16
    for tl, jl in _logits_over_steps(japi, jparams, tapi, tparams,
                                     tcfg.vocab_size):
        assert tl.dtype == torch.float16
        assert _rel_l2(tl.float(), jl) <= FP16_LOGIT_REL_L2
