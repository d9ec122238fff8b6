"""Low-precision SpMM of the port against the JAX package: bf16, fp16,
fp8 and int8 value storage through EB and RB (the kernels' plain
versions on the CPU, the JAX kernels in interpret mode), int8
quantization bit for bit, gradients against ``jax.grad``, the fp8
fallback, the byte model and the tuner's dtype axis.

Tolerances: forwards and gradients at rtol = atol = 1e-5 (gradients'
atol scaled by the largest JAX gradient): both packages round the same
inputs to the same storage values, upcast them exactly and sum in f32,
in other orders.  Quantized codes and scales, byte counts, keys and
picks compare exactly.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.sparse as js
import repro.tune as jt
import repro_torch.sparse as ts
import repro_torch.tune as tt
from repro.core import Epilogue as JE
from repro.core import Schedule as JS
from repro.core import cost_terms as j_cost_terms
from repro.core import dtypes as jd
from repro.roofline import analysis as jroof
from repro_torch.core import Epilogue as TE
from repro_torch.core import Schedule as TS
from repro_torch.core import cost_terms as t_cost_terms
from repro_torch.core import dtypes as td
from repro_torch.kernels import ops as kops
from repro_torch.roofline import analysis as troof

RTOL = ATOL = 1e-5
VALUE_DTYPES = ("bfloat16", "float16", "float8_e4m3fn", "int8")

#: The reference's four schedules (tests/test_lowprec.py SCHEDULES).  The
#: port's Schedule takes 'parallel' on 'eb' only over the skew layout with
#: merge_threshold=0 (every row group-aligned), so the third runs there.
SCHEDULES = [
    dict(kernel="eb", nnz_tile=128, group_size=8, strategy="segment"),
    dict(kernel="eb", nnz_tile=128, group_size=8, strategy="accumulate"),
    dict(kernel="eb", nnz_tile=128, group_size=16, strategy="parallel",
         split_threshold=8, merge_threshold=0),
    dict(kernel="rb", row_tile=8, strategy="parallel"),
]


def _pair(n=96, density=0.06, seed=0):
    """The reference's random CSR and the port's copy of it."""
    a_j = js.random_csr(n, n, density=density, seed=seed)
    a_t = ts.CSR.from_numpy(np.asarray(a_j.indptr), np.asarray(a_j.indices),
                            np.asarray(a_j.vals), a_j.shape, device="cpu")
    return a_j, a_t


def _dense(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _sid(kw):
    return "-".join(str(v) for v in kw.values())


# ---------------------------------------------------------------------------
# dtypes: the fallback rule and the itemsizes
# ---------------------------------------------------------------------------


def test_dtype_helpers_match_jax(monkeypatch):
    monkeypatch.delenv("REPRO_DISABLE_FP8", raising=False)
    assert td.fp8_supported() == jd.fp8_supported()
    for vd in (None,) + VALUE_DTYPES:
        assert str(td.storage_dtype(vd)).removeprefix("torch.") == \
            jnp.dtype(jd.storage_dtype(vd)).name
        assert str(td.operand_dtype(vd)).removeprefix("torch.") == \
            jnp.dtype(jd.operand_dtype(vd)).name
        assert td.value_itemsize(vd) == jd.value_itemsize(vd)
        assert td.operand_itemsize(vd) == jd.operand_itemsize(vd)
    assert td.canonical_value_dtype(torch.bfloat16) == "bfloat16"
    with pytest.raises(ValueError):
        td.canonical_value_dtype(torch.float64)


def test_fp8_fallback_matches_jax(monkeypatch):
    monkeypatch.setenv("REPRO_DISABLE_FP8", "1")
    assert not td.fp8_supported() and not jd.fp8_supported()
    with pytest.warns(td.Fp8Fallback):
        assert td.storage_dtype("fp8") == torch.bfloat16
    with pytest.warns(td.Fp8Fallback):
        assert td.value_itemsize("fp8") == 2 == jd.value_itemsize("fp8")
    # end to end: the degraded schedule runs and equals its bf16 twin
    a_j, a_t = _pair(64, 0.08)
    b = _dense((64, 8), 1)
    s = TS(**SCHEDULES[0])
    with pytest.warns(td.Fp8Fallback):
        out8 = ts.spmm(a_t, torch.from_numpy(b), s.replace(value_dtype="fp8"),
                       device="cpu")
    outbf = ts.spmm(a_t, torch.from_numpy(b),
                    s.replace(value_dtype="bfloat16"), device="cpu")
    assert torch.equal(out8, outbf)
    with pytest.warns(jd.Fp8Fallback):
        out_j = js.spmm(a_j, jnp.asarray(b), JS(**SCHEDULES[0]).replace(
            value_dtype="fp8"))
    _close(out8, out_j)


def test_fp8_cast_gives_what_the_reference_gives():
    """Above 448 torch's own cast saturates; ml_dtypes (the reference's
    astype) rounds to 448 up to 464 and overflows to NaN beyond."""
    x = np.array([440, 448, 455, 463.9, 464, 464.1, 470, 480, 1e6, np.inf,
                  -np.inf, np.nan, -464, -470, 2.0 ** -9, 3 * 2.0 ** -11,
                  1e-10, -0.0], np.float32)
    x = np.concatenate([x, _dense(4096, 3) * 200])
    got = td.cast(torch.from_numpy(x), torch.float8_e4m3fn).float().numpy()
    want = x.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)
    np.testing.assert_array_equal(got, want)  # NaN where NaN, else equal


# ---------------------------------------------------------------------------
# Forward parity: every schedule at every storage type
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vd", VALUE_DTYPES)
@pytest.mark.parametrize("sched", SCHEDULES, ids=_sid)
def test_forward_matches_jax(sched, vd):
    a_j, a_t = _pair()
    b = _dense((96, 16), 1)
    out_j = js.spmm(a_j, jnp.asarray(b), JS(**sched).replace(value_dtype=vd),
                    interpret=True)
    out_t = ts.spmm(a_t, torch.from_numpy(b),
                    TS(**sched).replace(value_dtype=vd), device="cpu")
    assert out_t.dtype == torch.float32
    _close(out_t, out_j)


@pytest.mark.parametrize("out_dtype", ["float16", "float8_e4m3fn"])
@pytest.mark.parametrize("sched", [SCHEDULES[0], SCHEDULES[3]], ids=_sid)
def test_epilogue_store_types_match_jax(sched, out_dtype):
    """The fp16 and e4m3 epilogue stores, on values that overflow e4m3."""
    a_j, a_t = _pair()
    b = _dense((96, 16), 1) * 64
    bias = _dense(16, 2)
    kw = dict(activation="relu", out_dtype=out_dtype)
    out_j = js.spmm(a_j, jnp.asarray(b), JS(**sched), bias=jnp.asarray(bias),
                    epilogue=JE(**kw), interpret=True)
    out_t = ts.spmm(a_t, torch.from_numpy(b), TS(**sched),
                    bias=torch.from_numpy(bias), epilogue=TE(**kw),
                    device="cpu")
    assert out_t.dtype == getattr(torch, out_dtype)
    got = out_t.float().numpy()
    want = np.asarray(out_j.astype(jnp.float32))
    if out_dtype == "float8_e4m3fn":
        assert np.isnan(want).any()  # some outputs overflow
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        keep = ~np.isnan(want)
        # one e4m3 step: the f32 sums may round to neighbours
        np.testing.assert_allclose(got[keep], want[keep], rtol=2.0 ** -3)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -10, atol=ATOL)


def test_quantized_csr_input_matches_jax():
    a_j, a_t = _pair()
    b = _dense((96, 16), 1)
    out_j = js.spmm(a_j.quantized(), jnp.asarray(b), "auto")
    out_t = ts.spmm(a_t.quantized(), torch.from_numpy(b), "auto",
                    device="cpu")
    _close(out_t, out_j)
    ref_t = kops.spmm(a_t.quantized(), torch.from_numpy(b), impl="ref")
    _close(ref_t, js.spmm(a_j.quantized(), jnp.asarray(b), impl="ref"))


# ---------------------------------------------------------------------------
# Quantization: codes and scales bit for bit
# ---------------------------------------------------------------------------


def _same_quant(q_t, q_j):
    np.testing.assert_array_equal(q_t.csr.vals.numpy(),
                                  np.asarray(q_j.csr.vals))
    np.testing.assert_array_equal(q_t.scales.numpy().view(np.int32),
                                  np.asarray(q_j.scales).view(np.int32))
    assert q_t.csr.vals.dtype == torch.int8
    np.testing.assert_array_equal(
        q_t.dequantize().vals.numpy().view(np.int32),
        np.asarray(q_j.dequantize().vals).view(np.int32))


@pytest.mark.parametrize("method,pct", [("absmax", 99.9),
                                        ("percentile", 99.9),
                                        ("percentile", 50.0)])
def test_quantize_matches_jax_bit_for_bit(method, pct):
    a_j, a_t = _pair(200, 0.05, seed=3)
    _same_quant(ts.quantize_csr(a_t, method=method, percentile=pct),
                js.quantize_csr(a_j, method=method, percentile=pct))


def test_quantize_empty_rows_and_matrix_match_jax():
    indptr = np.array([0, 2, 2, 3, 3], np.int32)
    indices = np.array([0, 2, 1], np.int32)
    vals = np.array([1.0, -3.0, 0.5], np.float32)
    a_j = js.CSR(indptr, indices, vals, (4, 3))
    a_t = ts.CSR.from_numpy(indptr, indices, vals, (4, 3), device="cpu")
    for method in ("absmax", "percentile"):
        q = ts.quantize_csr(a_t, method=method, percentile=50.0)
        assert float(q.scales[1]) == float(q.scales[3]) == 1.0
        _same_quant(q, js.quantize_csr(a_j, method=method, percentile=50.0))
    empty = ts.CSR.from_numpy(np.zeros(3), np.zeros(0), np.zeros(0), (2, 2),
                              device="cpu")
    q = ts.quantize_csr(empty)
    assert q.nnz == 0 and torch.equal(q.scales, torch.ones(2))
    with pytest.raises(ValueError):
        ts.quantize_csr(a_t, method="bogus")


def test_memos_follow_the_values():
    """quantized / astype / the feed's cast memoize per matrix and are
    rebuilt when the values change in place."""
    from repro_torch.sparse.ops import _feed

    _, a = _pair()
    q, h = a.quantized(), a.astype(torch.float16)
    assert a.quantized() is q and a.astype("float16") is h
    assert a.astype(torch.float32) is a
    s = TS(**SCHEDULES[0]).replace(value_dtype="fp16")
    f1 = _feed(a, s, a.vals)
    assert f1.vals.dtype == torch.float16
    cast_key = ("vals_astype", "torch.float16")
    cached = a.__dict__["_convcache"][cast_key][1]
    _feed(a, s, a.vals)
    assert a.__dict__["_convcache"][cast_key][1] is cached  # cast once
    with torch.no_grad():
        a.vals.mul_(2.0)
    assert a.quantized() is not q and a.astype(torch.float16) is not h
    f2 = _feed(a, s, a.vals)
    assert a.__dict__["_convcache"][cast_key][1] is not cached
    assert torch.equal(f2.vals.float(), 2 * f1.vals.float())


def test_layouts_keep_the_value_dtype():
    """The padding rules keep narrow and int8 streams (the reference's
    tests/test_lowprec.py:246 and :255)."""
    _, a = _pair(48, 0.1)
    empty = ts.CSR.from_numpy(np.zeros(3), np.zeros(0), np.zeros(0), (2, 2),
                              device="cpu")
    for dt in (torch.bfloat16, torch.float8_e4m3fn, torch.int8):
        c = a.quantized().csr if dt == torch.int8 else a.astype(dt)
        g = c.grouped(64)
        gs = c.grouped(64, group_size=8, split_threshold=4, merge_threshold=2)
        assert g.vals.dtype == gs.vals.dtype == dt
        assert g.with_vals(c.vals).vals.dtype == dt
        assert gs.with_vals(c.vals).vals.dtype == dt
        assert c.ell(row_tile=8).vals.dtype == dt
        assert g.regrouped(128).vals.dtype == dt
        if dt != torch.int8:
            assert empty.astype(dt).ell(row_tile=8).vals.dtype == dt
        # the padded lanes hold zeros, the real lanes the values
        assert torch.equal(g.vals[:c.nnz].view(torch.uint8 if dt.itemsize
                                               == 1 else torch.int16),
                           c.vals.view(torch.uint8 if dt.itemsize == 1
                                       else torch.int16))
        assert not g.vals[c.nnz:].float().any()


# ---------------------------------------------------------------------------
# Gradients against jax.grad
# ---------------------------------------------------------------------------


def _grads(vd, argnums):
    """Gradients of <w, spmm> with relu, bias and residual fused, in both
    packages, for the inputs ``argnums`` names (0 vals, 1 b, 2 bias,
    3 residual)."""
    a_j, a_t = _pair(64, 0.08, seed=5)
    b, bias, res = _dense((64, 8), 6), _dense(8, 7), _dense((64, 8), 8)
    w = _dense((64, 8), 9)
    sched = SCHEDULES[0]

    def loss_j(vals, bb, bi, rr):
        a = js.CSR(a_j.indptr, a_j.indices, vals, a_j.shape)
        out = js.spmm(a, bb, JS(**sched).replace(value_dtype=vd),
                      bias=bi, residual=rr, epilogue=JE("relu"))
        return jnp.sum(out * w)

    g_j = jax.grad(loss_j, argnums=argnums)(
        a_j.vals, jnp.asarray(b), jnp.asarray(bias), jnp.asarray(res))
    ins = [a_t.vals.clone(), torch.from_numpy(b), torch.from_numpy(bias),
           torch.from_numpy(res)]
    for i in argnums:
        ins[i].requires_grad_()
    a = ts.CSR(a_t.indptr, a_t.indices, ins[0], a_t.shape)
    out = ts.spmm(a, ins[1], TS(**sched).replace(value_dtype=vd),
                  bias=ins[2], residual=ins[3], epilogue=TE("relu"),
                  device="cpu")
    (out * torch.from_numpy(w)).sum().backward()
    return [ins[i].grad for i in argnums], g_j


@pytest.mark.parametrize("vd", ["bfloat16", "float16", "float8_e4m3fn"])
def test_gradients_narrow_float_match_jax(vd):
    g_t, g_j = _grads(vd, (0, 1, 2, 3))
    for gt, gj in zip(g_t, g_j):
        gj = np.asarray(gj)
        _close(gt, gj, atol=ATOL * max(1.0, float(np.abs(gj).max())))


def test_gradients_int8_match_jax():
    g_t, g_j = _grads("int8", (1, 2, 3))
    for gt, gj in zip(g_t, g_j):
        gj = np.asarray(gj)
        _close(gt, gj, atol=ATOL * max(1.0, float(np.abs(gj).max())))
    # the codes are data: a value stream that requires a gradient gets none
    a_j, a_t = _pair(64, 0.08, seed=5)
    vals = a_t.vals.clone().requires_grad_()
    b = torch.from_numpy(_dense((64, 8), 6)).requires_grad_()
    a = ts.CSR(a_t.indptr, a_t.indices, vals, a_t.shape)
    ts.spmm(a, b, TS(**SCHEDULES[3]).replace(value_dtype="int8"),
            device="cpu").sum().backward()
    assert vals.grad is None and b.grad is not None


# ---------------------------------------------------------------------------
# The byte model, the cost model and the tuner's dtype axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vd", (None,) + VALUE_DTYPES)
def test_byte_model_matches_jax_and_the_fed_bytes(vd):
    for args in ((10_000, 512, 64), (3_043_840, 169_343, 256)):
        for scales_rows in (0, 169_343):
            kw = dict(value_dtype=vd, scales_rows=scales_rows)
            assert troof.predict_spmm_arg_bytes(*args, **kw) == \
                jroof.predict_spmm_arg_bytes(*args, **kw)
            assert troof.predict_spmm_traffic_bytes(*args, **kw) == \
                jroof.predict_spmm_traffic_bytes(*args, **kw)
    # the EB runner feeds exactly the modeled argument bytes
    _, a = _pair()
    fn, (feed, b) = tt.make_eb_runner(a, 16, group_size=8,
                                      strategy="accumulate",
                                      value_dtype=vd)
    if vd == "int8":
        g, scales = feed.csr.grouped(256, group_size=8), feed.scales
    else:
        g, scales = feed, None
    fed = sum(t.nbytes for t in (g.rows, g.cols, g.vals, b))
    fed += 0 if scales is None else scales.nbytes
    assert fed == troof.predict_spmm_arg_bytes(
        g.nnz_padded, a.shape[1], 16, value_dtype=vd,
        scales_rows=0 if scales is None else a.shape[0])
    assert g.vals.dtype == td.storage_dtype(vd)
    assert b.dtype == td.operand_dtype(vd)


def test_cost_terms_scale_with_dtype_as_jax():
    a_j, a_t = _pair()
    for vd in (None,) + VALUE_DTYPES:
        sj = JS("eb", nnz_tile=128, group_size=8, value_dtype=vd)
        st = TS("eb", nnz_tile=128, group_size=8, value_dtype=vd)
        np.testing.assert_allclose(
            t_cost_terms(ts.matrix_stats(a_t), st, 16),
            j_cost_terms(js.matrix_stats(a_j), sj, 16), rtol=1e-12)


@pytest.mark.parametrize("favoured", ["bfloat16", "int8"])
def test_tuner_dtype_phase_matches_jax_and_replays(tmp_path, favoured):
    """One injected objective, favouring one dtype: both packages admit
    the reference's default dtypes by parity, measure the same points and
    pick the same schedule; the port's replay measures nothing."""
    a_j, a_t = _pair()

    def objective(key_fn, calls):
        def measure(s):
            calls.append(key_fn(s))
            return 0.5e-6 if s.value_dtype == favoured else 1e-6
        return measure

    calls_j, calls_t = [], []
    rj = jt.tune_schedule(a_j, 16, cache=jt.ScheduleCache(None),
                          measure=objective(jt.schedule_key, calls_j))
    cache = tt.ScheduleCache(str(tmp_path / "c.json"))
    rt = tt.tune_schedule(a_t, 16, cache=cache,
                          measure=objective(tt.schedule_key, calls_t))
    assert rt.schedule.value_dtype == favoured
    assert calls_t == calls_j
    assert tt.schedule_key(rt.schedule) == jt.schedule_key(rj.schedule)
    assert any(":v[float16]" in k for k in calls_t)  # all three admitted
    again = []
    replay = tt.tune_schedule(a_t, 16, cache=cache,
                              measure=objective(tt.schedule_key, again))
    assert replay.from_cache and replay.n_measurements == 0 and not again
    assert replay.schedule == rt.schedule
    # a budget nothing fits keeps f32 storage
    tight = tt.tune_schedule(a_t, 16, cache=tt.ScheduleCache(None),
                             measure=objective(tt.schedule_key, []),
                             error_budget=0.0)
    assert tight.schedule.value_dtype is None


def test_schedule_fits_card_admits_every_dtype_where_f32_fits():
    for vd in (None,) + VALUE_DTYPES:
        for s in (TS("eb", nnz_tile=128, group_size=8, value_dtype=vd),
                  TS("rb", row_tile=8, strategy="parallel", value_dtype=vd)):
            assert kops.schedule_fits_card(s, n_rows=100, row_max=30)
    # the ELL bound counts the bytes of the CSR the layout is built from
    n_rows, row_max = 104, 30
    limit = n_rows * row_max * 5
    import repro_torch.sparse.formats as formats

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(kops, "ELL_MAX_BYTES", limit)
        mp.setattr(formats, "ELL_MAX_BYTES", limit)
        rb = TS("rb", row_tile=8, strategy="parallel")
        assert kops.schedule_fits_card(rb.replace(value_dtype="int8"),
                                       n_rows=n_rows, row_max=row_max)
        assert not kops.schedule_fits_card(rb.replace(value_dtype="bf16"),
                                           n_rows=n_rows, row_max=row_max)
        a = ts.CSR.from_numpy(
            np.arange(0, (n_rows + 1) * row_max, row_max),
            np.tile(np.arange(row_max), n_rows),
            _dense(n_rows * row_max, 4), (n_rows, row_max), device="cpu")
        b = torch.ones(row_max, 4)
        kops.spmm(a, b, rb.replace(value_dtype="int8"))
        with pytest.raises(ValueError, match="ELL_MAX_BYTES"):
            kops.spmm(a, b, rb.replace(value_dtype="bf16"))
    finally:
        mp.undo()
