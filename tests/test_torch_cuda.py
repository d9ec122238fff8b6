"""The port's CUDA kernels (EB and RB SpMM with their fused epilogue, at
f32 and at bf16, fp16, fp8 and int8 value storage, SDDMM, fused
attention forward and backward, segment reduce, grouped matmul) against
their plain versions on the card, at small sizes, the kernel paths'
gradients against the CPU's, the launches of the planned GCN and
readout, and those of the MoE layer and an LM decode step.  Every test
here needs an NVIDIA GPU and skips, when it runs, on a machine without
one.  On the GPU machine:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerance: EB and RB per output element, K_TERMS units of 2^-24 of the
magnitude of the terms entering it (plus one step of a narrow output
type, ``OUT_STEP``; narrow inputs upcast exactly, so the f32 bound
holds for them unchanged), and so segment-reduce sums over a hub of
thousands of lanes;
other f32 kernels rtol = atol = 1e-5 (atomics reorder the sums;
SDDMM's atol grows with d, the length of its dots); bf16 one bf16 step
(2^-7).
Gradients: 1e-4, as they sum products of two such results.  Segment
max and min compare bit for bit (NaN positions equal, every other value
with the same bits): -0.0 orders below +0.0, so their order does not
matter.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

RTOL = ATOL = 1e-5
#: EB and RB against their plain versions, per output element: the two
#: sum the same f32 terms in other orders (and the epilogue's expf and
#: tanhf differ from torch's by an ulp or two), so the error is bounded by
#: K_TERMS units of 2^-24 of the magnitude of everything that enters that
#: output; a fixed atol cannot cover a row whose terms cancel.  The H100
#: runs of ``chip_smoke.py`` read k at most 4.66; 16 leaves a margin.
K_TERMS = 16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _matrix(dev, n=300, seed=0):
    import repro_torch.sparse as ts

    return ts.power_law_csr(n, n, avg_degree=6.0, alpha=1.6, seed=seed,
                            device=dev)


def _dense(dev, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dev)


def _hub_matrix(dev, n=3000, hub_len=9000, long_len=700, seed=0):
    """CSR (n, n): short rows (0 to 12 nnz, some empty), row n // 30 a hub
    of ``hub_len`` nnz over several of the kernel's chunks, and row
    2n // 3 long enough (``long_len``) to cross a chunk boundary or two;
    values from a numpy seed."""
    from repro_torch.sparse import CSR

    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 13, size=n)
    lengths[n // 30], lengths[2 * n // 3] = hub_len, long_len
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate([rng.integers(0, n, size=k)
                              for k in lengths]).astype(np.int32)
    vals = rng.standard_normal(indptr[-1]).astype(np.float32)
    return CSR.from_numpy(indptr, indices, vals, (n, n), device=dev)


def _terms(plain, *args, bias=None, residual=None, **kw):
    """Sum over the terms entering each output of their magnitudes: the
    plain version on |values| and |B|, plus |bias| and |residual|."""
    t = plain(*[a.abs() if a.is_floating_point() else a for a in args],
              **kw)
    if bias is not None:
        t = t + bias.abs()
    if residual is not None:
        t = t + residual.abs()
    return t


#: One step of a narrow output type: (relative, absolute at the bottom of
#: its subnormals).  The kernel and the plain version round f32 results
#: that differ in their last bits, so they may land on neighbours.
OUT_STEP = {torch.bfloat16: (2.0 ** -7, 0.0),
            torch.float16: (2.0 ** -10, 2.0 ** -24),
            torch.float8_e4m3fn: (2.0 ** -3, 2.0 ** -9)}


def _assert_within_terms(got, want, terms, k=K_TERMS):
    """Per output: |got - want| <= k * 2^-24 * (its terms' magnitude
    + |want|), plus one step of the output type for a narrow output
    (``OUT_STEP``); NaN (an e4m3 overflow) only where the plain version
    has it."""
    assert got.dtype == want.dtype and got.shape == want.shape
    w = want.float()
    nan = torch.isnan(w)
    assert torch.equal(torch.isnan(got.float()), nan)
    w = w.masked_fill(nan, 0.0)
    bound = k * 2.0 ** -24 * (terms + w.abs())
    if got.dtype in OUT_STEP:
        rel, floor = OUT_STEP[got.dtype]
        bound = bound + rel * w.abs() + floor
    err = (got.float().masked_fill(nan, 0.0) - w).abs()
    worst = float((err / bound.clamp_min(1e-30)).max())
    assert bool((err <= bound).all()), f"worst error {worst:.2f}x the bound"


@pytest.mark.parametrize("strategy,skew", [
    ("segment", None), ("accumulate", None), ("parallel", None),
    ("segment", (8, 2)), ("parallel", (8, 0)), ("accumulate", (8, 0))])
@pytest.mark.parametrize("G", [8, 32])
@pytest.mark.parametrize("n_dense", [40, 33, 256])
def test_eb_kernel_matches_plain(dev, strategy, skew, G, n_dense):
    from repro_torch.kernels import spmm_eb

    a = _matrix(dev)
    kw = {} if skew is None else dict(group_size=G, split_threshold=skew[0],
                                      merge_threshold=skew[1])
    g = a.grouped(128, **kw)
    assert (g.heavy_tiles > 0) == (skew is not None)
    b = _dense(dev, (a.shape[1], n_dense), 1)
    args = dict(n_rows=a.shape[0], nnz_tile=128, group_size=G,
                strategy=strategy, heavy_tiles=g.heavy_tiles)
    before = spmm_eb.KERNEL.launches
    got = spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b, col_tile=128, **args)
    assert spmm_eb.KERNEL.launches == before + 1
    want = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b, **args)
    _assert_within_terms(got, want, _terms(spmm_eb.spmm_eb_plain, g.rows,
                                           g.cols, g.vals, b, **args))


@pytest.mark.parametrize("strategy,G", [("segment", 32), ("segment", 8),
                                        ("parallel", 8), ("accumulate", 8)])
@pytest.mark.parametrize("n_dense", [40, 33, 256])
def test_eb_kernel_carry_walk_on_hub_rows(dev, strategy, G, n_dense):
    """A hub row over several chunks and a row over a chunk boundary: the
    carry rows the kernel writes equal ``eb_carry_plan``'s, the output
    matches the plain version, and a second launch gives the same bits."""
    from repro_torch.kernels import spmm_eb

    a = _hub_matrix(dev)
    g = a.grouped(128)
    b = _dense(dev, (a.shape[1], n_dense), 2)
    kw = dict(n_rows=a.shape[0], nnz_tile=128, group_size=G,
              strategy=strategy, heavy_tiles=0)
    old = spmm_eb.TARGET_WARPS
    spmm_eb.TARGET_WARPS = 16
    try:  # chunks of a few tiles: many crossings
        got, carry, chunk = spmm_eb._launch(
            g.rows, g.cols, g.vals, b, epilogue=spmm_eb._NOOP, bias=None,
            residual=None, **kw)
        again, _, _ = spmm_eb._launch(
            g.rows, g.cols, g.vals, b, epilogue=spmm_eb._NOOP, bias=None,
            residual=None, **kw)
    finally:
        spmm_eb.TARGET_WARPS = old
    plan = spmm_eb.eb_carry_plan(g.rows, chunk=chunk, group_size=G,
                                 strategy=strategy, nnz_tile=128)
    assert torch.equal(carry, plan)
    assert int((plan[0::2] == 100).sum()) >= 2  # the hub crosses chunks
    assert torch.equal(got, again)
    want = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b, **kw)
    terms = _terms(spmm_eb.spmm_eb_plain, g.rows, g.cols, g.vals, b, **kw)
    _assert_within_terms(got, want, terms)
    chunked = spmm_eb.spmm_eb_chunked_plain(
        g.rows.cpu(), g.cols.cpu(), g.vals.cpu(), b.cpu(), chunk=chunk, **kw)
    _assert_within_terms(got.cpu(), chunked, terms.cpu())


@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu", "tanh",
                                 "sigmoid"])
@pytest.mark.parametrize("out_dtype", [None, "bfloat16", "float16",
                                       "float8_e4m3fn"])
def test_epilogue_kernel_matches_plain(dev, act, out_dtype):
    """The epilogue fused into the EB kernel (rows stored in the walk,
    rows finished from carries, empty rows) and into RB, with bias and
    residual, f32, bf16, fp16 and e4m3 outputs."""
    from repro_torch.core import Epilogue
    from repro_torch.kernels import spmm_eb, spmm_rb

    a = _hub_matrix(dev, seed=3)
    n = a.shape[0]
    ep = Epilogue(act, bias=True, residual=True, out_dtype=out_dtype)
    ops = dict(bias=_dense(dev, (40,), 3), residual=_dense(dev, (n, 40), 4))
    b = _dense(dev, (n, 40), 5)
    g = a.grouped(128)
    kw = dict(n_rows=n, nnz_tile=128, group_size=32, epilogue=ep, **ops)
    got = spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b, **kw)
    want = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b, **kw)
    _assert_within_terms(got, want, _terms(
        spmm_eb.spmm_eb_plain, g.rows, g.cols, g.vals, b, n_rows=n,
        nnz_tile=128, group_size=32, **ops))
    e = a.ell(row_tile=8)
    assert e.width > 32  # the slots come in chunks of 32
    kw = dict(n_rows=n, epilogue=ep, **ops)
    got = spmm_rb.spmm_rb(e.cols, e.vals, b, **kw)
    want = spmm_rb.spmm_rb_plain(e.cols, e.vals, b, **kw)
    _assert_within_terms(got, want, _terms(spmm_rb.spmm_rb_plain, e.cols,
                                           e.vals, b, n_rows=n, **ops))


@pytest.mark.parametrize("row_tile", [4, 8, 32])
@pytest.mark.parametrize("n_dense", [40, 33, 256])
def test_rb_kernel_matches_plain(dev, row_tile, n_dense):
    from repro_torch.core import Epilogue
    from repro_torch.kernels import spmm_rb

    a = _matrix(dev, seed=5)
    e = a.ell(row_tile=row_tile)
    b = _dense(dev, (a.shape[1], n_dense), 6)
    ops = dict(bias=_dense(dev, (n_dense,), 7))
    kw = dict(n_rows=a.shape[0], epilogue=Epilogue("gelu", bias=True), **ops)
    got = spmm_rb.spmm_rb(e.cols, e.vals, b, row_tile=row_tile,
                          col_tile=128, **kw)
    want = spmm_rb.spmm_rb_plain(e.cols, e.vals, b, **kw)
    _assert_within_terms(got, want, _terms(
        spmm_rb.spmm_rb_plain, e.cols, e.vals, b, n_rows=a.shape[0], **ops))


def test_rb_kernel_takes_rows_wider_than_32_slots(dev):
    from repro_torch.kernels import spmm_rb

    a = _hub_matrix(dev, n=500, hub_len=77, long_len=40, seed=4)
    for width in (None, 100):
        e = a.ell(row_tile=8, width=width)
        assert e.width > 64
        b = _dense(dev, (500, 256), 8)
        got = spmm_rb.spmm_rb(e.cols, e.vals, b, n_rows=500)
        want = spmm_rb.spmm_rb_plain(e.cols, e.vals, b, n_rows=500)
        _assert_within_terms(got, want, _terms(spmm_rb.spmm_rb_plain, e.cols,
                                               e.vals, b, n_rows=500))


VALUE_DTYPES = ("bfloat16", "float16", "float8_e4m3fn", "int8")


def _stored(a, vd, b):
    """(the CSR whose layout is fed, per-row scales or None, B) under
    ``value_dtype`` ``vd``: values and B cast to their storage types, or
    int8 codes with the CSR's quantization scales on a bf16 B."""
    from repro_torch.core.dtypes import cast, operand_dtype, storage_dtype

    bb = cast(b, operand_dtype(vd))
    if vd == "int8":
        q = a.quantized()
        return q.csr, q.scales, bb
    return a.astype(storage_dtype(vd)), None, bb


@pytest.mark.parametrize("vd", VALUE_DTYPES)
@pytest.mark.parametrize("strategy,skew", [
    ("segment", None), ("accumulate", None), ("parallel", None),
    ("segment", (8, 2)), ("parallel", (8, 0))])
@pytest.mark.parametrize("n_dense", [40, 33, 256])
def test_eb_kernel_narrow_matches_plain(dev, vd, strategy, skew, n_dense):
    """Narrow and int8 storage through EB (skew layout included: int8
    lanes take their own row's scale under 'parallel') against the plain
    version on the same stored inputs, which upcast exactly, so the f32
    bound holds unchanged."""
    from repro_torch.kernels import eb_partials, spmm_eb

    c, scales, b = _stored(_matrix(dev), vd,
                           _dense(dev, (300, n_dense), 1))
    kw = {} if skew is None else dict(group_size=8, split_threshold=skew[0],
                                      merge_threshold=skew[1])
    g = c.grouped(128, **kw)
    assert g.vals.dtype == c.vals.dtype
    args = dict(n_rows=300, nnz_tile=128, group_size=8, strategy=strategy,
                heavy_tiles=g.heavy_tiles)
    before = spmm_eb.KERNEL.launches
    got = spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b, scales=scales, **args)
    assert spmm_eb.KERNEL.launches == before + 1
    want = spmm_eb.spmm_eb_plain(g.rows, g.cols, g.vals, b, scales=scales,
                                 **args)
    v32 = eb_partials.lane_values(g.vals, g.rows, scales)
    _assert_within_terms(got, want, _terms(spmm_eb.spmm_eb_plain, g.rows,
                                           g.cols, v32, b.float(), **args))


@pytest.mark.parametrize("vd", VALUE_DTYPES)
@pytest.mark.parametrize("n_dense", [40, 256])
def test_eb_kernel_narrow_carry_walk(dev, vd, n_dense):
    """Narrow storage over a hub row and a row across chunk boundaries:
    carry rows as ``eb_carry_plan``, the same bits over two launches, and
    the output against the plain version and its carry walk."""
    from repro_torch.kernels import eb_partials, spmm_eb

    a = _hub_matrix(dev)
    c, scales, b = _stored(a, vd, _dense(dev, (a.shape[1], n_dense), 2))
    g = c.grouped(128)
    kw = dict(n_rows=a.shape[0], nnz_tile=128, group_size=32,
              strategy="segment", heavy_tiles=0)
    old = spmm_eb.TARGET_WARPS
    spmm_eb.TARGET_WARPS = 16
    try:
        runs = [spmm_eb._launch(g.rows, g.cols, g.vals, b,
                                epilogue=spmm_eb._NOOP, bias=None,
                                residual=None, scales=scales, **kw)
                for _ in range(2)]
    finally:
        spmm_eb.TARGET_WARPS = old
    (got, carry, chunk), (again, _, _) = runs
    assert torch.equal(carry, spmm_eb.eb_carry_plan(
        g.rows, chunk=chunk, group_size=32, strategy="segment",
        nnz_tile=128))
    assert torch.equal(got, again)
    v32 = eb_partials.lane_values(g.vals, g.rows, scales)
    terms = _terms(spmm_eb.spmm_eb_plain, g.rows, g.cols, v32, b.float(),
                   **kw)
    _assert_within_terms(got, spmm_eb.spmm_eb_plain(
        g.rows, g.cols, g.vals, b, scales=scales, **kw), terms)
    chunked = spmm_eb.spmm_eb_chunked_plain(
        g.rows.cpu(), g.cols.cpu(), g.vals.cpu(), b.cpu(), chunk=chunk,
        scales=None if scales is None else scales.cpu(), **kw)
    _assert_within_terms(got.cpu(), chunked, terms.cpu())


@pytest.mark.parametrize("vd", VALUE_DTYPES)
@pytest.mark.parametrize("n_dense", [40, 33, 256])
def test_rb_kernel_narrow_matches_plain(dev, vd, n_dense):
    from repro_torch.core import Epilogue
    from repro_torch.kernels import spmm_rb

    c, scales, b = _stored(_matrix(dev, seed=5), vd,
                           _dense(dev, (300, n_dense), 6))
    e = c.ell(row_tile=8)
    assert e.vals.dtype == c.vals.dtype
    ops = dict(bias=_dense(dev, (n_dense,), 7))
    kw = dict(n_rows=300, epilogue=Epilogue("relu", bias=True), **ops)
    got = spmm_rb.spmm_rb(e.cols, e.vals, b, scales=scales, **kw)
    want = spmm_rb.spmm_rb_plain(e.cols, e.vals, b, scales=scales, **kw)
    v32 = e.vals.float() if scales is None else (
        e.vals[:300].float() * scales[:, None])
    _assert_within_terms(got, want, _terms(
        spmm_rb.spmm_rb_plain, e.cols, v32, b.float(), n_rows=300, **ops))


def test_narrow_wrappers_refuse_other_pairs(dev):
    from repro_torch.kernels import spmm_eb, spmm_rb

    a = _matrix(dev)
    g, e = a.grouped(128), a.ell(row_tile=8)
    b = _dense(dev, (300, 8), 1)
    bad = [(g.vals.to(torch.bfloat16), b, None),  # bf16 values on f32 B
           (g.vals, b.to(torch.float16), None),
           (g.vals.to(torch.float16), b.to(torch.bfloat16), None),
           (a.quantized().csr.grouped(128).vals, b.to(torch.bfloat16),
            None),  # int8 codes without scales
           (g.vals, b, torch.ones(300, device=dev))]  # scales without codes
    for vals, bb, scales in bad:
        with pytest.raises(ValueError):
            spmm_eb.spmm_eb(g.rows, g.cols, vals, bb, n_rows=300,
                            nnz_tile=128, scales=scales)
    with pytest.raises(ValueError):
        spmm_rb.spmm_rb(e.cols, e.vals.to(torch.bfloat16), b, n_rows=300)


@pytest.mark.parametrize("schedule", ["auto", "RB+PR"])
@pytest.mark.parametrize("vd", VALUE_DTYPES)
def test_narrow_spmm_and_quantization_on_cuda_match_cpu(dev, schedule, vd):
    """``spmm`` under each storage type on the card against the CPU's
    plain path; the int8 codes and scales made on the card equal the
    CPU's bit for bit; one bf16 (or int8) step's gradients match."""
    import warnings

    import repro_torch.sparse as ts
    from repro_torch.core import Schedule
    from repro_torch.core.dtypes import Fp8Fallback

    a = _matrix(dev, seed=2)
    a_cpu = ts.CSR(a.indptr.cpu(), a.indices.cpu(), a.vals.cpu(), a.shape)
    sched = (Schedule.auto(ts.matrix_stats(a), 16) if schedule == "auto"
             else Schedule.named(schedule)).replace(value_dtype=vd)
    b = _dense(dev, (300, 16), 3)
    with warnings.catch_warnings():
        warnings.simplefilter("error", Fp8Fallback)  # never on the card
        got = ts.spmm(a, b, sched, device=dev)
    want = ts.spmm(a_cpu, b.cpu(), sched, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)
    if vd == "int8":
        for method in ("absmax", "percentile"):
            qg, qc = (ts.quantize_csr(x, method=method) for x in (a, a_cpu))
            assert torch.equal(qg.csr.vals.cpu(), qc.csr.vals)
            assert torch.equal(qg.scales.cpu().view(torch.int32),
                               qc.scales.view(torch.int32))
    if vd in ("bfloat16", "int8"):
        grads = []
        for m, bb in ((a, b), (a_cpu, b.cpu())):
            vals = m.vals.clone().requires_grad_()
            bb = bb.clone().requires_grad_()
            x = ts.CSR(m.indptr, m.indices, vals, m.shape)
            ts.spmm(x, bb, sched.with_epilogue("relu"),
                    device=bb.device).square().sum().backward()
            grads.append([t.grad for t in (vals, bb) if t.grad is not None])
        for g_dev, g_cpu in zip(*grads):
            torch.testing.assert_close(g_dev.cpu(), g_cpu, rtol=1e-4,
                                       atol=1e-4)


def test_user_strategy_raises_on_cuda(dev):
    """A spec-only user strategy runs on the card through the partials
    and combine kernels, within K_TERMS of the CPU walk; the wrapper
    raises only for what no kernel takes (an nnz tile above
    ``MAX_NNZ_TILE``)."""
    import repro_torch.sparse as ts
    from repro_torch.core import Schedule, register_strategy, spec_segment
    from repro_torch.kernels import eb_partials, spmm_eb

    register_strategy("t_cuda_user", spec_segment, overwrite=True)
    a = _matrix(dev)
    b = _dense(dev, (a.shape[1], 8), 8)
    sched = Schedule(nnz_tile=64, group_size=8, strategy="t_cuda_user")
    before = (eb_partials.KERNEL.launches, eb_partials.COMBINE.launches)
    got = ts.spmm(a, b, schedule=sched)
    assert eb_partials.KERNEL.launches > before[0]
    assert eb_partials.COMBINE.launches > before[1]
    a_cpu = _matrix("cpu")
    want = ts.spmm(a_cpu, b.cpu(), schedule=sched, device="cpu")
    g = a_cpu.grouped(64)
    _assert_within_terms(got.cpu(), want, _terms(
        spmm_eb.spmm_eb_plain, g.rows, g.cols, g.vals, b.cpu(),
        n_rows=a.shape[0], nnz_tile=64, group_size=8))
    with pytest.raises(ValueError, match="nnz_tile"):
        ts.spmm(a, b, schedule=sched.replace(
            nnz_tile=2 * spmm_eb.MAX_NNZ_TILE))


@pytest.mark.parametrize("vd", ("float32",) + VALUE_DTYPES)
@pytest.mark.parametrize("n_dense", [40, 256])
def test_eb_partials_kernel_matches_plain_bit_for_bit(dev, vd, n_dense):
    """The lane partials of ragged windows of a stream (and of a B one
    element off its alignment, which takes element loads) at every
    storage pair: each partial the plain version's single product."""
    from repro_torch.kernels import eb_partials

    a = _hub_matrix(dev, n=1000, hub_len=2000, long_len=300)
    dense = _dense(dev, (a.shape[1], n_dense), 3)
    if vd == "float32":
        c, scales, b = a, None, dense
    else:
        c, scales, b = _stored(a, vd, dense)
    g = c.grouped(128)
    off = torch.empty(b.numel() + 1, dtype=b.dtype, device=dev)[1:]
    b_off = off.view(b.shape).copy_(b)
    assert eb_partials.partials_vec(b_off) == 1
    for bb in (b, b_off):
        for t0, t1 in ((0, 1000), (1000, 1337), (1337, g.vals.shape[0])):
            r, k, v = g.rows[t0:t1], g.cols[t0:t1], g.vals[t0:t1]
            before = eb_partials.KERNEL.launches
            got = eb_partials.eb_partials(r, k, v, bb, n_rows=a.shape[0],
                                          scales=scales)
            assert eb_partials.KERNEL.launches == before + 1
            want = eb_partials.eb_partials_plain(r, k, v, bb, scales)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_user_combine_kernel_matches_plain(dev, op):
    """The combine on a span of an accumulator's rows, in place: add the
    same f32 sums, max and min bit for bit with signed zeros and NaN; the
    rows outside the span stay as they were."""
    from repro_torch.core import MONOIDS
    from repro_torch.kernels import common, eb_partials

    g = torch.Generator().manual_seed(11)
    acc = torch.randn(40, 33, generator=g)
    tile = torch.randn(17, 33, generator=g)
    for t in (acc, tile):  # zeros of both signs, NaN, infinities
        flat = t.view(-1)
        flat[::7], flat[3::11], flat[5::13] = 0.0, -0.0, float("nan")
        flat[2::17] = float("inf")
    want = acc.clone()
    common.combine_plain(want[9:26], tile, MONOIDS[op])
    got = acc.to(dev)
    before = eb_partials.COMBINE.launches
    eb_partials.combine(got[9:26], tile.to(dev), MONOIDS[op])
    assert eb_partials.COMBINE.launches == before + 1
    if op == "add":
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got.cpu()), nan)
        assert torch.equal(got.cpu()[~nan], want[~nan])
    else:
        _assert_segred_same(got.cpu(), want, op)
    with pytest.raises(ValueError, match="tile result"):
        eb_partials.combine(got[9:26], tile[:, :5].to(dev), MONOIDS[op])


def _mostly(value, n, gen):
    """n f32 values, all ``value`` but a ninth of them scattered: ordinary
    values, zeros of both signs, NaN and the infinities."""
    t = torch.full((n,), value)
    idx = torch.randperm(n, generator=gen)[:max(1, n // 9)]
    t[idx] = torch.randn(idx.numel(), generator=gen)
    special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                            -float("inf")])
    t[idx[:5]] = special[:min(5, idx.numel())]
    return t


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("empty", [-0.0, 0.0, -float("inf"), float("inf")])
@pytest.mark.parametrize("n,acc_off,tile_off", [
    (1027, 0, 0), (1027, 1, 1), (1026, 1, 0), (4099, 2, 2), (7, 3, 3),
    (2, 1, 1), (5_000_003, 1, 1)])
def test_user_combine_kernel_vectors_and_skips(dev, op, empty, n, acc_off,
                                               tile_off):
    """The combine's 16-byte vectors, scalar head and tail and skips:
    sizes that are no multiple of 4, an accumulator one or more elements
    off 16 bytes (with a tile at the same offset, vectors; at another,
    element by element), tiles mostly -0.0, +0.0, -inf or +inf with
    scattered changes, against accumulators holding zeros of both signs,
    NaN and the infinities.  Every element equals ``combine_plain``'s bit
    for bit (a NaN a NaN), and nothing outside the accumulator moves."""
    from repro_torch.core import MONOIDS
    from repro_torch.kernels import common, eb_partials

    g = torch.Generator().manual_seed(n + acc_off + 7 * tile_off)
    acc = torch.randn(n, generator=g)
    acc[::3] = _mostly(-0.0, n, g)[::3]
    acc[1::5] = float("nan")
    acc[2::7] = float("inf")
    acc[4::11] = -float("inf")
    tile = _mostly(empty, n, g)
    want = acc.clone()
    common.combine_plain(want, tile, MONOIDS[op])
    acc_buf = torch.full((n + 8,), 7.0, device=dev)
    tile_buf = torch.full((n + 8,), 5.0, device=dev)
    got = acc_buf[acc_off:acc_off + n]
    got.copy_(acc)
    tile_d = tile_buf[tile_off:tile_off + n]
    tile_d.copy_(tile)
    vec, head = eb_partials.combine_geometry(got, tile_d)
    assert vec == (4 if (acc_off - tile_off) % 4 == 0
                   and (-acc_off) % 4 <= n else 1)
    before = eb_partials.COMBINE.launches
    eb_partials.combine(got, tile_d, MONOIDS[op])
    assert eb_partials.COMBINE.launches == before + 1
    out = got.cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
    rest = torch.cat([acc_buf[:acc_off], acc_buf[acc_off + n:]])
    assert bool((rest == 7.0).all())
    assert torch.equal(tile_d.cpu().view(torch.int32),
                       tile.view(torch.int32))


def _cuda_user_strategies():
    """Quickstart's one-hot (spec and realization), the one-hot spec
    alone, a segment max registered with ``combine="max"`` and one with
    a callable combine: each creates its tensors on the partials'
    device."""
    from repro_torch.core import register_strategy

    def onehot(ids, n, dtype):
        return (ids[:, None] == torch.arange(n, device=ids.device)).to(dtype)

    def spec(p, ids, n, group_size):
        return onehot(ids, n, p.dtype).T @ p

    def kernel(ids, p, out, group_size):
        out += onehot(ids, out.shape[0], p.dtype).T @ p

    def seg_max(p, ids, n, group_size):
        return torch.full((n, p.shape[1]), -float("inf"),
                          device=p.device).scatter_reduce_(
            0, ids.long()[:, None].expand_as(p), p, "amax")

    register_strategy("t_cuda_onehot", spec, kernel, overwrite=True)
    register_strategy("t_cuda_spec", spec, overwrite=True)
    register_strategy("t_cuda_max", seg_max, combine="max", overwrite=True)
    register_strategy("t_cuda_callable", seg_max, combine=torch.maximum,
                      identity=-float("inf"), overwrite=True)


@pytest.mark.parametrize("strategy,ep", [
    ("t_cuda_onehot", None), ("t_cuda_onehot", "relu"),
    ("t_cuda_onehot", "float16"), ("t_cuda_spec", None),
    ("t_cuda_max", None), ("t_cuda_callable", None)])
@pytest.mark.parametrize("skew", [None, (16, 0)])
def test_user_strategy_on_cuda_matches_the_cpu_walk(dev, strategy, ep,
                                                      skew, monkeypatch):
    """EB under a user strategy on the card (partials in windows of one
    and of many tiles, the user's code per tile, the combine, the
    finishing launch's epilogue) against the same walk on the CPU: add
    within K_TERMS, max and the callable exact (as values) where no
    epilogue follows."""
    from repro_torch.core import Epilogue
    from repro_torch.kernels import common, eb_partials, spmm_eb

    _cuda_user_strategies()
    a = _hub_matrix(dev, n=1200, hub_len=3000, long_len=500)
    kw = {} if skew is None else dict(group_size=8, split_threshold=skew[0],
                                      merge_threshold=skew[1])
    g = a.grouped(128, **kw)
    b = _dense(dev, (a.shape[1], 40), 5)
    bias = _dense(dev, (40,), 6)
    epilogue = {None: Epilogue(), "relu": Epilogue("relu", bias=True),
                "float16": Epilogue(out_dtype="float16")}[ep]
    args = dict(n_rows=a.shape[0], nnz_tile=128, group_size=8,
                strategy=strategy, heavy_tiles=g.heavy_tiles,
                epilogue=epilogue, bias=bias if epilogue.bias else None)
    before = eb_partials.KERNEL.launches
    got = spmm_eb.spmm_eb(g.rows, g.cols, g.vals, b, **args)
    assert eb_partials.KERNEL.launches == before + 1
    with monkeypatch.context() as m:
        m.setattr(common, "WINDOW_BYTES", 128 * 40 * 4)
        windows = spmm_eb.spmm_eb_user(g.rows, g.cols, g.vals, b, **args)
    assert eb_partials.KERNEL.launches > before + 2
    cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in args.items()}
    want = spmm_eb.spmm_eb_user(g.rows.cpu(), g.cols.cpu(), g.vals.cpu(),
                                b.cpu(), **cpu)
    for out in (got, windows):
        if strategy in ("t_cuda_max", "t_cuda_callable") and skew is None:
            assert torch.equal(out.cpu(), want)
        else:
            _assert_within_terms(out.cpu(), want, _terms(
                spmm_eb.spmm_eb_plain, g.rows.cpu(), g.cols.cpu(),
                g.vals.cpu(), b.cpu(), **{**cpu, "strategy": "accumulate",
                                          "epilogue": Epilogue()}))


@pytest.mark.parametrize("schedule", ["auto", "RB+PR"])
def test_gcn_forward_on_cuda_matches_cpu(dev, schedule):
    from repro_torch.models import GCN, normalized_adjacency

    import repro_torch.sparse as ts

    raw = ts.graph_pattern_csr("social", 500, seed=0, device="cpu")
    adj_cpu = normalized_adjacency(raw, device="cpu")
    adj = normalized_adjacency(raw, device=dev)
    x = _dense("cpu", (500, 16), 9)
    params = {k: np.random.default_rng(i).standard_normal(s).astype(
        np.float32) * 0.1 for i, (k, s) in enumerate(
        (("w1", (16, 32)), ("b1", (32,)), ("w2", (32, 4))))}
    with torch.no_grad():
        want = GCN.from_jax_params(params, schedule=schedule, device="cpu")(
            adj_cpu, x)
        got = GCN.from_jax_params(params, schedule=schedule, device=dev)(
            adj, x.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# --- SDDMM, the SpMM backward, fused attention ----------------------------


@pytest.mark.parametrize("nnz", [1, 300, 1000])
@pytest.mark.parametrize("d", [1, 37, 40, 64, 256])
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("shuffled", [False, True])
def test_sddmm_kernel_matches_plain(dev, nnz, d, with_scale, shuffled):
    """Sorted streams (runs of one row crossing warp and block edges) and
    the same streams shuffled, nnz not a multiple of 32."""
    from repro_torch.kernels import sddmm

    rng = np.random.default_rng(nnz + d)
    rows = np.sort(rng.integers(0, 50, nnz))
    if shuffled:
        rows = rng.permutation(rows)
    rows = torch.from_numpy(rows.astype(np.int32)).to(dev)
    cols = torch.from_numpy(rng.integers(0, 70, nnz).astype(np.int32)).to(dev)
    a, b = _dense(dev, (50, d), 10), _dense(dev, (70, d), 11)
    scale = _dense(dev, (nnz,), 12) if with_scale else None
    before = sddmm.KERNEL.launches
    got = sddmm.sddmm(rows, cols, a, b, scale, nnz_tile=128)
    assert sddmm.KERNEL.launches == before + 1
    torch.testing.assert_close(got, sddmm.sddmm_plain(rows, cols, a, b, scale),
                               rtol=RTOL, atol=RTOL * d)


@pytest.mark.parametrize("d,aligned", [(40, True), (40, False), (300, True),
                                       (1032, True), (301, True)])
@pytest.mark.parametrize("nnz_tile", [100, 256])
def test_sddmm_kernel_long_runs_and_geometries(dev, d, aligned, nnz_tile):
    """Runs of one row of 1 to 300 entries over tiles that are not a
    multiple of 32, on every geometry: 16-byte workers, 4-byte loads of a
    misaligned A, 4 vectors a lane, and the wide walk."""
    from repro_torch.kernels import sddmm

    rng = np.random.default_rng(d + nnz_tile)
    lengths = rng.integers(1, 300, 12)
    rows = np.repeat(rng.permutation(40)[:12], lengths).astype(np.int32)
    nnz = rows.shape[0]
    cols = rng.integers(0, 60, nnz).astype(np.int32)
    rows, cols = (torch.from_numpy(x).to(dev) for x in (rows, cols))
    a = _dense(dev, (40 * d + 1,), 13)
    a = (a[:40 * d] if aligned else a[1:]).view(40, d)
    b = _dense(dev, (60, d), 14)
    scale = _dense(dev, (nnz,), 15)
    g = sddmm.sddmm_geometry(d, a.data_ptr() % 16 == 0)
    assert (g.vec == 4) == (aligned and d % 4 == 0)
    before = sddmm.KERNEL.launches
    got = sddmm.sddmm(rows, cols, a, b, scale, nnz_tile=nnz_tile)
    assert sddmm.KERNEL.launches == before + 1
    torch.testing.assert_close(got, sddmm.sddmm_plain(rows, cols, a, b, scale),
                               rtol=RTOL, atol=RTOL * d)


@pytest.mark.parametrize("schedule", ["auto", "RB+PR", "EB+SR"])
def test_spmm_backward_on_cuda_matches_cpu(dev, schedule):
    import repro_torch.sparse as ts
    from repro_torch.core import Epilogue
    from repro_torch.kernels import sddmm, spmm_eb

    grads = {}
    for where in ("cpu", dev):
        a = _matrix(where, seed=3)
        a.vals.requires_grad_()
        b = _dense(where, (a.shape[1], 40), 13).requires_grad_()
        bias = _dense(where, (40,), 14).requires_grad_()
        res = _dense(where, (a.shape[0], 40), 15).requires_grad_()
        before = (sddmm.KERNEL.launches, spmm_eb.KERNEL.launches)
        out = ts.spmm(a, b, schedule, bias=bias, residual=res,
                      epilogue=Epilogue("relu"), device=where)
        out.backward(_dense(where, tuple(out.shape), 16))
        grads[str(where)] = [t.grad.cpu() for t in (a.vals, b, bias, res)]
        if where == dev:
            # dvals on the SDDMM kernel, dB on the EB kernel
            assert sddmm.KERNEL.launches == before[0] + 1
            assert spmm_eb.KERNEL.launches > before[1]
    for g_cuda, g_cpu in zip(grads[str(dev)], grads["cpu"]):
        torch.testing.assert_close(g_cuda, g_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shuffled", [False, True])
def test_make_spmm_kernel_on_cuda_matches_cpu(dev, shuffled):
    import repro_torch.sparse as ts
    from repro_torch.kernels import sddmm, spmm_eb

    coo = _matrix("cpu", seed=6).tocoo()
    order = (torch.from_numpy(np.random.default_rng(6).permutation(
        coo.nnz)) if shuffled else torch.arange(coo.nnz))
    results = {}
    for where in ("cpu", dev):
        rows, cols = coo.rows[order].to(where), coo.cols[order].to(where)
        fn = ts.make_spmm(rows, cols, *coo.shape, impl="kernel",
                          device=where)
        vals = coo.vals.detach()[order].to(where).requires_grad_()
        b = _dense(where, (coo.shape[1], 40), 21).requires_grad_()
        before = (sddmm.KERNEL.launches, spmm_eb.KERNEL.launches)
        out = fn(vals, b)
        out.backward(_dense(where, tuple(out.shape), 22))
        results[str(where)] = [t.cpu() for t in (out.detach(), vals.grad,
                                                 b.grad)]
        if where == dev:
            # forward and dB on the EB kernel, dvals on the SDDMM kernel
            assert sddmm.KERNEL.launches == before[0] + 1
            assert spmm_eb.KERNEL.launches == before[1] + 2
    for g_cuda, g_cpu in zip(results[str(dev)], results["cpu"]):
        torch.testing.assert_close(g_cuda, g_cpu, rtol=1e-4, atol=1e-4)


def _attention_case(dev, n_rows, n_kv, heads, d, dv, seed):
    """A pattern with empty rows, single-nonzero rows, a long row, and
    columns in no order within a row (so the dK/dV scatters hit columns
    unsorted)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 6, n_rows)
    lengths[::7] = 0
    lengths[1::7] = 1
    lengths[3] = 100  # a row longer than three warp chunks
    cols = np.concatenate([rng.choice(n_kv, int(n), replace=n > n_kv)
                           for n in lengths]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(heads, n, w, generator=g).to(dev)
                   for n, w in ((n_rows, d), (n_kv, d), (n_kv, dv),
                                (n_rows, dv)))
    bias = torch.randn(len(cols), generator=g).to(dev)
    return (torch.from_numpy(indptr).to(dev), torch.from_numpy(cols).to(dev),
            q, k, v, do, bias)


@pytest.mark.parametrize("heads,d,dv", [(1, 16, 16), (4, 64, 64),
                                        (2, 37, 130), (3, 256, 8)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_attention_kernels_match_plain(dev, heads, d, dv, with_bias):
    from repro_torch.kernels import fused_attention as fa

    indptr, cols, q, k, v, do, bias = _attention_case(dev, 90, 70, heads, d,
                                                      dv, heads + d)
    bias = bias if with_bias else None
    kw = dict(scale=d ** -0.5, bias=bias)
    before = (fa.FWD_KERNEL.launches, fa.BWD_KERNEL.launches)
    got = fa.fused_sparse_attention(indptr, cols, q, k, v, **kw)
    want = fa.fused_sparse_attention_plain(indptr, cols, q, k, v, **kw)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=RTOL, atol=RTOL)
    empty = (indptr[1:] == indptr[:-1]).nonzero()[:, 0]
    assert bool((got[1][:, empty] == fa.NEG_INF).all())
    assert bool((got[2][:, empty] == 0).all())
    got_b = fa.fused_sparse_attention_bwd(indptr, cols, q, k, v, do, got[1],
                                          got[2], **kw)
    want_b = fa.fused_sparse_attention_bwd_plain(indptr, cols, q, k, v, do,
                                                 want[1], want[2], **kw)
    for g_, w_ in zip(got_b, want_b):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)
    assert (fa.FWD_KERNEL.launches, fa.BWD_KERNEL.launches) == (
        before[0] + 1, before[1] + 1)


def test_fused_attention_bwd_splits_long_rows(dev):
    """Rows longer than ``BWD_CHUNK`` (one of about 5,000 nonzeros, one of
    a chunk and one, one of two chunks and seven) are walked in chunks in
    three launches; one of exactly a chunk is not split.  The gradients
    match the plain version and the chunk walk's plain version at the
    backward's 1e-4, and dQ (split rows' included) is the same bit for
    bit over two launches."""
    from repro_torch.kernels import fused_attention as fa

    rng = np.random.default_rng(11)
    n_rows, n_kv, heads, d = 64, 6000, 2, 64
    chunk = fa.BWD_CHUNK
    lengths = rng.integers(0, 6, n_rows)
    lengths[::9] = 0
    lengths[[5, 20, 30, 40]] = (5000, chunk, chunk + 1, 2 * chunk + 7)
    cols = np.concatenate([rng.choice(n_kv, int(n), replace=False)
                           for n in lengths]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    g = torch.Generator().manual_seed(12)
    q, k, v, do = (torch.randn(heads, n, d, generator=g).to(dev)
                   for n in (n_rows, n_kv, n_kv, n_rows))
    bias = torch.randn(len(cols), generator=g).to(dev)
    ip, cc = (torch.from_numpy(a).to(dev) for a in (indptr, cols))
    plan = fa.attn_row_plan(ip, chunk)
    assert plan.split_rows.tolist() == [5, 30, 40]
    kw = dict(scale=d ** -0.5, bias=bias)
    _, m, l = fa.fused_sparse_attention(ip, cc, q, k, v, **kw)
    before = fa.BWD_KERNEL.launches
    got = fa.fused_sparse_attention_bwd(ip, cc, q, k, v, do, m, l, **kw)
    assert fa.BWD_KERNEL.launches == before + 3
    again = fa.fused_sparse_attention_bwd(ip, cc, q, k, v, do, m, l, **kw)
    assert torch.equal(got[0].view(torch.int32), again[0].view(torch.int32))
    args = (ip, cc, q, k, v, do, m, l)
    for want in (fa.fused_sparse_attention_bwd_plain(*args, **kw),
                 fa.fused_sparse_attention_bwd_chunked_plain(
                     *args, chunk=chunk, **kw)):
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dv", [64, 40])
def test_fused_attention_fwd_splits_long_rows(dev, dv):
    """Rows longer than ``FWD_CHUNK`` (one of 5,000 nonzeros, one of a
    chunk and one, one of two chunks and seven) are walked in chunks and
    merged in a second launch; one of exactly a chunk is not split.  out,
    m and l match the plain version and the chunk walk's plain version,
    and out (split rows' included) is the same bit for bit over two
    launches.  dv 64 takes the 16-byte V walk, dv 40 the 4-byte one."""
    from repro_torch.kernels import fused_attention as fa

    rng = np.random.default_rng(13)
    n_rows, n_kv, heads, d = 64, 6000, 2, 64
    chunk = fa.FWD_CHUNK
    lengths = rng.integers(0, 6, n_rows)
    lengths[::9] = 0
    lengths[[5, 20, 30, 40]] = (5000, chunk, chunk + 1, 2 * chunk + 7)
    cols = np.concatenate([rng.choice(n_kv, int(n), replace=False)
                           for n in lengths]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    g = torch.Generator().manual_seed(14)
    q, k = (torch.randn(heads, n, d, generator=g).to(dev)
            for n in (n_rows, n_kv))
    v = torch.randn(heads, n_kv, dv, generator=g).to(dev)
    bias = torch.randn(len(cols), generator=g).to(dev)
    ip, cc = (torch.from_numpy(a).to(dev) for a in (indptr, cols))
    plan = fa.attn_row_plan(ip, chunk)
    assert plan.split_rows.tolist() == [5, 30, 40]
    kw = dict(scale=d ** -0.5, bias=bias)
    before = fa.FWD_KERNEL.launches
    got = fa.fused_sparse_attention(ip, cc, q, k, v, **kw)
    assert fa.FWD_KERNEL.launches == before + 2
    again = fa.fused_sparse_attention(ip, cc, q, k, v, **kw)
    for g_, a_ in zip(got, again):
        assert torch.equal(g_.view(torch.int32), a_.view(torch.int32))
    args = (ip, cc, q, k, v)
    for want in (fa.fused_sparse_attention_plain(*args, **kw),
                 fa.fused_sparse_attention_chunked_plain(*args, chunk=chunk,
                                                         **kw)):
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=RTOL, atol=RTOL)
    empty = (ip[1:] == ip[:-1]).nonzero()[:, 0]
    assert bool((got[1][:, empty] == fa.NEG_INF).all())
    assert bool((got[2][:, empty] == 0).all())
    assert bool((got[0][:, empty] == 0).all())


def test_graph_attention_grads_on_cuda_match_cpu(dev):
    from repro_torch.models import graph_attention

    grads, outs = {}, {}
    for where in ("cpu", dev):
        a = _matrix(where, n=120, seed=4)
        q, k, v = (_dense(where, (120, 2, 32), s).requires_grad_()
                   for s in (17, 18, 19))
        out = graph_attention(a, q, k, v, device=where)
        out.backward(_dense(where, tuple(out.shape), 20))
        outs[str(where)] = out.detach().cpu()
        grads[str(where)] = [t.grad.cpu() for t in (q, k, v)]
    torch.testing.assert_close(outs[str(dev)], outs["cpu"], rtol=RTOL,
                               atol=RTOL)
    for g_cuda, g_cpu in zip(grads[str(dev)], grads["cpu"]):
        torch.testing.assert_close(g_cuda, g_cpu, rtol=1e-4, atol=1e-4)


# --- attention under a user strategy (kernels/attn_user.py) ---------------

#: ulps within which an exp-derived value of the attention's user kernels
#: (expf) may differ from the plain version's (torch.exp on the card): each
#: is within 2 ulp of exp, so they stay within 4 of each other.
EXP_ULPS = 4


def _ulps(got, want):
    """Largest distance in f32 ulps (of ``want``) between two tensors,
    NaN and infinities required at the same places with the same
    values."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    fin = torch.isfinite(want)
    assert torch.equal(got[~fin & ~nan], want[~fin & ~nan])
    g, w = got[fin].double(), want[fin].double()
    ulp = torch.abs(w).clamp(min=2.0 ** -126) * 2.0 ** -23
    return float(((g - w).abs() / ulp).max()) if w.numel() else 0.0


def _attn_stream(dev, n_rows, n_kv, heads, d, dv, seed, tile):
    """A padded stream of ``_attention_case``'s pattern (pad lanes at row
    0 and column 0, bias 0) in whole tiles of ``tile``, and its
    operands."""
    from repro_torch.kernels.fused_attention import rows_of

    indptr, cols, q, k, v, do, bias = _attention_case(dev, n_rows, n_kv,
                                                      heads, d, dv, seed)
    nnz = cols.numel()
    pad = -(-nnz // tile) * tile - nnz
    z = torch.zeros(pad, dtype=torch.int32, device=dev)
    rows = torch.cat([rows_of(indptr).to(torch.int32), z])
    return (nnz, rows, torch.cat([cols, z]), q, k, v, do,
            torch.cat([bias, z.float()]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("d,dv", [(64, 64), (37, 20)])
def test_attn_lanes_kernel_matches_plain(dev, dtype, d, dv):
    """``attn_lanes``' three modes against their plain versions: the
    scores and dw per lane within K_TERMS units of 2^-24 of the terms
    entering them (zero-mean operands), w within that error of its score
    carried through exp plus EXP_ULPS, NEG_INF and 0 on the pad lanes,
    and ds (from the same w, dw, delta) bit for bit."""
    from repro_torch.kernels import attn_user as au

    nnz, rows, cols, q, k, v, do, bias = _attn_stream(dev, 90, 70, 1, d, dv,
                                                      d + dv, 128)
    q, k, v = (x[0].to(dtype) for x in (q, k, v))
    do = do[0]
    scale = d ** -0.5
    before = au.LANES.launches
    s = au.attn_scores(rows, cols, q, k, nnz=nnz, scale=scale, bias=bias)
    want_s = au.attn_scores_plain(rows, cols, q, k, nnz=nnz, scale=scale,
                                  bias=bias)
    r, c = rows.long(), cols.long()
    qf, kf, vf = (x.float() for x in (q, k, v))
    terms_s = (qf[r] * kf[c]).abs().sum(-1) * scale + bias.abs()
    _assert_within_terms(s, want_s, terms_s)
    assert bool((s[nnz:] == au.NEG_INF).all())
    m = torch.full((90,), au.NEG_INF, device=dev).scatter_reduce(
        0, r[:nnz], want_s[:nnz], "amax")
    l = torch.zeros(90, device=dev).index_add_(
        0, r[:nnz], torch.exp(want_s[:nnz] - m[r[:nnz]]))
    got = au.attn_weights(rows, cols, q, k, v, do, m, l, nnz=nnz,
                          scale=scale, bias=bias)
    want = au.attn_weights_plain(rows, cols, q, k, v, do, m, l, nnz=nnz,
                                 scale=scale, bias=bias)
    _assert_within_terms(got[1], want[1],
                         (do[r] * vf[c]).abs().sum(-1))
    err_w = K_TERMS * 2.0 ** -24 * (terms_s + want_s.abs()) * want[0]
    assert bool(((got[0] - want[0]).abs()
                 <= err_w + EXP_ULPS * 2.0 ** -23 * want[0]).all())
    assert bool((got[0][nnz:] == 0).all())
    delta = torch.randn(90, generator=torch.Generator().manual_seed(3)).to(
        dev)
    ds = au.attn_ds(rows, want[0], want[1], delta, scale=scale)
    assert torch.equal(ds, au.attn_ds_plain(rows, want[0], want[1], delta,
                                            scale=scale))
    assert au.LANES.launches == before + 3


def _check_attn_lanes(rows, cols, nnz, q, k, v, do, bias, n_rows):
    """``attn_lanes`` modes 0 and 1 over a stream against their plain
    versions, as ``test_attn_lanes_kernel_matches_plain`` holds them."""
    from repro_torch.kernels import attn_user as au

    dev = q.device
    scale = q.shape[1] ** -0.5
    before = au.LANES.launches
    s = au.attn_scores(rows, cols, q, k, nnz=nnz, scale=scale, bias=bias)
    want_s = au.attn_scores_plain(rows, cols, q, k, nnz=nnz, scale=scale,
                                  bias=bias)
    r, c = rows.long(), cols.long()
    qf, kf, vf = (x.float() for x in (q, k, v))
    terms_s = (qf[r] * kf[c]).abs().sum(-1) * scale
    if bias is not None:
        terms_s = terms_s + bias.abs()
    _assert_within_terms(s, want_s, terms_s)
    assert bool((s[nnz:] == au.NEG_INF).all())
    m = torch.full((n_rows,), au.NEG_INF, device=dev).scatter_reduce(
        0, r[:nnz], want_s[:nnz], "amax")
    l = torch.zeros(n_rows, device=dev).index_add_(
        0, r[:nnz], torch.exp(want_s[:nnz] - m[r[:nnz]]))
    got = au.attn_weights(rows, cols, q, k, v, do, m, l, nnz=nnz,
                          scale=scale, bias=bias)
    want = au.attn_weights_plain(rows, cols, q, k, v, do, m, l, nnz=nnz,
                                 scale=scale, bias=bias)
    _assert_within_terms(got[1], want[1], (do[r] * vf[c]).abs().sum(-1))
    err_w = K_TERMS * 2.0 ** -24 * (terms_s + want_s.abs()) * want[0]
    assert bool(((got[0] - want[0]).abs()
                 <= err_w + EXP_ULPS * 2.0 ** -23 * want[0]).all())
    assert bool((got[0][nnz:] == 0).all())
    assert torch.equal(got[2], got[0] * got[1])
    assert au.LANES.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float8_e4m3fn])
@pytest.mark.parametrize("d", [1, 20, 37, 64, 320, 512])
def test_attn_lanes_kernel_widths(dev, dtype, d):
    """Modes 0 and 1 at every vector width and group a head width takes
    (16-byte vectors, 4 elements, single elements; one step or several),
    at each type of q, k and v."""
    nnz, rows, cols, q, k, v, do, bias = _attn_stream(dev, 90, 70, 1, d, d,
                                                      d + 5, 128)
    q, k, v = (x[0].to(dtype) for x in (q, k, v))
    _check_attn_lanes(rows, cols, nnz, q, k, v, do[0], bias, 90)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["unsorted", "hub", "hub-long-chunks",
                                  "pads"])
def test_attn_lanes_kernel_streams(dev, monkeypatch, dtype, case):
    """Modes 0 and 1 on streams the row cache must survive: rows in no
    order (no bias), a hub row of 5,000 lanes crossing chunks of one
    window and, with few warps, chunks of many windows, and pad lanes
    returning to row 0 after the last row."""
    from repro_torch.kernels import attn_user as au

    n_rows, n_kv, d = 300, 200, 64
    rng = np.random.default_rng(17)
    g = torch.Generator().manual_seed(17)
    bias = None
    if case == "pads":
        nnz, rows, cols, q, k, v, do, bias = _attn_stream(
            dev, n_rows, n_kv, 1, d, d, 3, 512)
        q, k, v, do = q[0], k[0], v[0], do[0]
        assert rows.numel() - nnz > 100 and int(rows[nnz - 1]) > 0
    else:
        lengths = rng.integers(0, 9, n_rows)
        if case != "unsorted":
            lengths[7] = 5000
            monkeypatch.setattr(au, "LANES_TARGET_WARPS",
                                4 if case == "hub-long-chunks" else 8192)
        rows_np = np.repeat(np.arange(n_rows), lengths)
        if case == "unsorted":
            rows_np = rng.permutation(rows_np)
        nnz = rows_np.size
        rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
        cols = torch.from_numpy(rng.integers(0, n_kv, nnz).astype(
            np.int32)).to(dev)
        q, k, v, do = (torch.randn(n, d, generator=g).to(dev)
                       for n in (n_rows, n_kv, n_kv, n_rows))
        if case != "unsorted":
            bias = torch.randn(nnz, generator=g).to(dev)
    geo = au.lanes_geometry(rows.numel(), d, d, 4, True)
    if case == "hub-long-chunks":
        assert geo.chunk > 32 * 8 and 5000 > 2 * geo.chunk
    q, k, v = (x.to(dtype) for x in (q, k, v))
    _check_attn_lanes(rows, cols, nnz, q, k, v, do, bias, n_rows)


def test_attn_rescale_kernel_matches_plain(dev):
    """``attn_rescale`` against its plain version: alpha 0 where m_old is
    NEG_INF, 1 where m did not move, a NaN m; l, the accumulator's two dv
    tiles and p within EXP_ULPS, p 0 on pads; the finishing mode's
    division bit for bit (a NaN l too)."""
    from repro_torch.kernels import attn_user as au

    g = torch.Generator().manual_seed(21)
    n_rows, tile = 500, 256
    m_new = torch.randn(n_rows, 1, generator=g)
    m_old = m_new - torch.rand(n_rows, 1, generator=g)
    m_old[::5] = m_new[::5]
    m_old[1::7] = au.NEG_INF
    m_new[2::97] = m_old[2::97] = float("nan")
    l = torch.rand(n_rows, 1, generator=g) * 10
    acc = torch.randn(2, n_rows, 24, generator=g)
    rows = torch.randint(0, n_rows, (tile,), generator=g, dtype=torch.int32)
    s = torch.randn(tile, generator=g)
    want = (m_old, m_new, l.clone(), acc.clone(), s, rows)
    p_want = au.attn_rescale_plain(*want, n_valid=200)
    got = [x.to(dev) for x in (m_old, m_new, l, acc, s, rows)]
    before = au.RESCALE.launches
    p = au.attn_rescale(*got, n_valid=200)
    assert au.RESCALE.launches == before + 1
    for a, b in ((p, p_want), (got[2], want[2]), (got[3], want[3])):
        assert _ulps(a.cpu(), b) <= EXP_ULPS
    assert bool((p[200:] == 0).all())
    want[2][3] = float("nan")
    got[2].copy_(want[2])  # the finish on the same inputs
    got[3].copy_(want[3])
    au.attn_finish_plain(want[3], want[2])
    au.attn_finish(got[3], got[2])
    assert au.RESCALE.launches == before + 2
    _assert_segred_same(got[3].cpu(), want[3], "max")


@pytest.mark.parametrize("b_dtype", [torch.bfloat16, torch.float16,
                                     torch.float8_e4m3fn])
@pytest.mark.parametrize("n_dense", [64, 24, 20])
def test_eb_partials_f32_values_on_a_narrow_b(dev, b_dtype, n_dense):
    """The attention's value partials: f32 lane values on a bf16, fp16 or
    e4m3 B, bit for bit with the plain version at 16-byte, 4-element and
    element loads (B one element off its alignment too)."""
    from repro_torch.kernels import eb_partials

    g = torch.Generator().manual_seed(n_dense)
    b = torch.randn(70, n_dense, generator=g).to(b_dtype).to(dev)
    vals = torch.randn(3000, generator=g).to(dev)
    idx = torch.randint(0, 70, (3000,), generator=g,
                        dtype=torch.int32).to(dev)
    off = torch.empty(b.numel() + 1, dtype=b.dtype, device=dev)[1:]
    b_off = off.view(b.shape).copy_(b)
    for bb in (b, b_off):
        before = eb_partials.KERNEL.launches
        got = eb_partials.eb_partials(idx, idx, vals, bb, n_rows=70)
        assert eb_partials.KERNEL.launches == before + 1
        want = eb_partials.eb_partials_plain(idx, idx, vals, bb)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="int8"):
        eb_partials.eb_partials(idx, idx, vals, b, n_rows=70,
                                scales=torch.ones(70, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_user_attention_on_cuda_matches_the_builtin_kernels(dev, dtype):
    """``sparse_attention`` under a spec that computes the segment
    reduction under any monoid (a user strategy; ``spec_segment`` would
    not do: it assumes ids in order, and dV and dK scatter by column) on
    the card: the walk's kernels all launch, out within RTOL of the
    built-in fused kernels' and the q, k, v gradients within 1e-4; a spec
    under ``combine="max"`` against the same walk with the plain versions
    on the card."""
    import repro_torch.sparse as ts
    from repro_torch.core import Schedule, register_strategy
    from repro_torch.kernels import attn_user as au
    from repro_torch.kernels import eb_partials

    def generic(p, ids, n, group_size, monoid):
        return monoid.seg_reduce(p, ids, n)

    _cuda_user_strategies()
    register_strategy("t_cuda_seg", generic, overwrite=True)
    a = _hub_matrix(dev, n=900, hub_len=1500, long_len=300)
    outs, grads = {}, {}
    counters = (au.LANES, au.RESCALE, eb_partials.KERNEL,
                eb_partials.COMBINE)
    for strategy in ("segment", "t_cuda_seg"):
        q, k, v = (_dense(dev, (900, 2, 32), s).to(dtype).requires_grad_()
                   for s in (31, 32, 33))
        before = [c.launches for c in counters]
        out = ts.sparse_attention(a, q, k, v, schedule=Schedule(
            nnz_tile=256, group_size=32, strategy=strategy))
        out.backward(_dense(dev, tuple(out.shape), 34))
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert (all(launched) if strategy != "segment"
                else not any(launched))
        outs[strategy] = out.detach()
        grads[strategy] = [t.grad.float() for t in (q, k, v)]
    torch.testing.assert_close(outs["t_cuda_seg"], outs["segment"],
                               rtol=RTOL, atol=RTOL)
    for got, want in zip(grads["t_cuda_seg"], grads["segment"]):
        tol = 1e-4 if dtype == torch.float32 else 1e-4 + 2.0 ** -7
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    from repro_torch.kernels.fused_attention import rows_of

    nnz = a.indices.numel()
    pad = -(-nnz // 256) * 256 - nnz
    z = torch.zeros(pad, dtype=torch.int32, device=dev)
    rows = torch.cat([rows_of(a.indptr).to(torch.int32), z])
    cols = torch.cat([a.indices, z])
    bias = torch.cat([a.vals, z.float()])
    q, k, v = (_dense(dev, (2, 900, 32), s) for s in (41, 42, 43))
    kw = dict(n_rows=900, nnz=nnz, nnz_tile=256, group_size=32,
              strategy="t_cuda_max", scale=32 ** -0.5, bias=bias)
    got = au.fused_sparse_attention_user(rows, cols, q, k, v, **kw)
    want = au.fused_sparse_attention_user_plain(rows, cols, q, k, v, **kw)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=RTOL, atol=RTOL)


# --- segment reduce, the planner's GCN and readout -------------------------


def _segments(dev, t, n_seg, c, seed, *, aligned=0):
    """Sorted ids (segment n_seg // 2 left empty) or, with ``aligned``,
    segments of exactly that many lanes; standard-normal data."""
    rng = np.random.default_rng(seed)
    if aligned:
        seg = np.arange(t) // aligned
    else:
        seg = np.sort(rng.integers(0, n_seg, t))
        seg[seg == n_seg // 2] = n_seg // 2 - 1
    data = rng.standard_normal((t, c)).astype(np.float32)
    return (torch.from_numpy(seg.astype(np.int32)).to(dev),
            torch.from_numpy(data).to(dev))


def _assert_segred_same(got, want, op):
    assert got.shape == want.shape and got.dtype == want.dtype
    if op in ("max", "min"):
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32))
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("strategy", ["segment", "parallel", "accumulate"])
@pytest.mark.parametrize("G,c", [(8, 1), (32, 4), (16, 37), (32, 256)])
def test_segment_reduce_kernel_matches_plain(dev, strategy, op, G, c):
    """A ragged stream (T not a multiple of G or of the tile); ``parallel``
    on unsorted-group ids, where kernel and plain version both compute
    the group-to-first-lane realization."""
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segments(dev, 1000 + G // 2 + 3, 60, c, seed=G + c)
    kw = dict(num_segments=60, tile=4 * G, group_size=G, strategy=strategy,
              op=op)
    before = sr.KERNEL.launches
    got = sr.segment_reduce(seg, data, **kw)
    assert sr.KERNEL.launches == before + 1
    _assert_segred_same(got, sr.segment_reduce_plain(seg, data, **kw), op)
    empty = {"add": 0.0, "max": -float("inf"), "min": float("inf")}[op]
    assert bool((got[30] == empty).all())  # an untouched segment


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("strategy", ["segment", "accumulate"])
def test_segment_reduce_signed_zeros_nan_and_inf(dev, strategy, op):
    from repro_torch.kernels import segment_reduce as sr

    vals = torch.tensor([[-0.0, 0.0], [0.0, -0.0], [-0.0, -0.0],
                         [0.0, 0.0], [-0.0, float("inf")],
                         [0.0, -float("inf")], [float("nan"), 1.0],
                         [2.0, -0.0]])
    data = vals.repeat(40, 1).to(dev)
    seg = (torch.arange(data.shape[0]) // 3).to(torch.int32).to(dev)
    kw = dict(num_segments=int(seg[-1]) + 2, tile=64, group_size=8,
              strategy=strategy, op=op)
    got = sr.segment_reduce(seg, data, **kw)
    _assert_segred_same(got, sr.segment_reduce_plain(seg, data, **kw), op)
    zeros = got[:-1][got[:-1] == 0]
    assert zeros.numel() > 0 and bool(
        (torch.signbit(zeros) == (op == "min")).all())


def test_segment_reduce_edges(dev):
    """Fewer lanes than a group, an empty stream, and ids outside
    [0, num_segments) (not written)."""
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segments(dev, 5, 4, 3, seed=1)
    for op in ("add", "max"):
        _assert_segred_same(
            sr.segment_reduce(seg, data, num_segments=4, op=op),
            sr.segment_reduce_plain(seg, data, num_segments=4, op=op), op)
    out = sr.segment_reduce(seg[:0], data[:0], num_segments=3, op="min")
    assert bool((out == float("inf")).all()) and out.shape == (3, 3)
    bad = torch.tensor([-1, 0, 7, 1], dtype=torch.int32, device=dev)
    out = sr.segment_reduce(bad, torch.ones(4, 2, device=dev),
                            num_segments=2, group_size=1, tile=4,
                            strategy="accumulate")
    assert out.tolist() == [[1.0, 1.0], [1.0, 1.0]]


def _segred_hub_stream(dev, t, c, seed, *, shuffled=False):
    """Ids in order over 200 segments (the first five and the last five
    empty, others of 0 to 6 lanes, segment 97 a hub of the lanes left,
    over many of the kernel's chunks), or the same ids shuffled."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 7, size=200)
    lengths[:5] = lengths[-5:] = lengths[97] = 0
    lengths[97] = t - lengths.sum()
    seg = np.repeat(np.arange(200), lengths).astype(np.int32)
    if shuffled:
        seg = rng.permutation(seg)
    data = rng.standard_normal((t, c)).astype(np.float32)
    return (torch.from_numpy(seg).to(dev), torch.from_numpy(data).to(dev))


def _assert_segred_within_terms(sr, got, want, seg, data, op, **kw):
    """max and min bit for bit; add per output element within K_TERMS
    units of 2^-24 of the magnitude of the terms entering it (the sum of
    |data| its lanes send there, and itself): the hub's sums of thousands
    of terms cancel, so a tolerance relative to the output alone does not
    hold its order of summation."""
    if op != "add":
        _assert_segred_same(got, want, op)
        return
    terms = sr.segment_reduce_plain(seg, data.abs(), **{**kw, "op": "add"})
    _assert_within_terms(got, want, terms)


def _poisoned_segment_reduce(sr, seg, data, **kw):
    """The kernel's call just after a NaN-filled tensor of its output's
    size is freed, so the output's ``torch.empty`` likely reuses it and a
    segment the walk never writes shows as NaN."""
    n_out = data.shape[1] + int(kw.get("count_column", False))
    poison = torch.full((kw["num_segments"], n_out), float("nan"),
                        device=data.device)
    del poison
    return sr.segment_reduce(seg, data, **kw)


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("strategy", ["segment", "parallel", "accumulate"])
@pytest.mark.parametrize("G,c", [(32, 4), (8, 1), (1, 3), (32, 41),
                                 (16, 40), (32, 256)])
def test_segment_reduce_carry_walk_on_poisoned_memory(dev, strategy, op, G,
                                                      c):
    """Ids in order with a hub over many chunks (its chain of carries
    longer than a finishing worker walks alone) and empty segments below,
    between and above the ids: the walk and its finishing launch write
    every output element, over NaN-poisoned memory, and match the plain
    version; C = 4 and 1 lane-parallel, 41 (4-byte loads), 40 (16-byte)
    and 256 column-parallel."""
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segred_hub_stream(dev, 6007, c, seed=G + c)
    kw = dict(num_segments=200, group_size=G, strategy=strategy, op=op)
    before = (sr.KERNEL.launches, sr.FINISH.launches)
    got = _poisoned_segment_reduce(sr, seg, data, **kw)
    assert (sr.KERNEL.launches, sr.FINISH.launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = sr.segment_reduce_plain(seg, data, **kw)
    assert not bool(torch.isnan(got).any())
    _assert_segred_within_terms(sr, got, want, seg, data, **kw)
    empty = {"add": 0.0, "max": -float("inf"), "min": float("inf")}[op]
    assert bool((got[:5] == empty).all()) and bool((got[-5:] == empty).all())


@pytest.mark.parametrize("c", [1, 4, 41, 256])
def test_segment_reduce_add_same_bits_over_two_launches(dev, c):
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segred_hub_stream(dev, 6007, c, seed=3)
    kw = dict(num_segments=200, op="add")
    first = sr.segment_reduce(seg, data, **kw)
    assert torch.equal(first.view(torch.int32),
                       sr.segment_reduce(seg, data, **kw).view(torch.int32))


@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("c", [4, 41, 256])
def test_segment_reduce_out_of_order_takes_the_atomic_path(dev, op, c):
    """Shuffled ids: one launch (no finishing launch), atomic write-backs
    into an identity-filled output, the plain version's result."""
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segred_hub_stream(dev, 6007, c, seed=c, shuffled=True)
    kw = dict(num_segments=200, group_size=1, strategy="accumulate", op=op)
    before = (sr.KERNEL.launches, sr.FINISH.launches)
    got = sr.segment_reduce(seg, data, **kw)
    assert (sr.KERNEL.launches, sr.FINISH.launches) == (before[0] + 1,
                                                        before[1])
    _assert_segred_within_terms(sr, got,
                                sr.segment_reduce_plain(seg, data, **kw),
                                seg, data, **kw)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("c", [2, 41])
def test_segment_reduce_atomic_path_signed_zeros_nan_and_inf(dev, op, c):
    """The atomic path's single atomicMax / atomicMin on the value's bits:
    -0.0 against +0.0 in both orders, NaN and +-inf, on shuffled ids, bit
    for bit as the plain version gives them."""
    from repro_torch.kernels import segment_reduce as sr

    vals = torch.tensor([-0.0, 0.0, -0.0, 0.0, float("inf"),
                         -float("inf"), float("nan"), 2.0, -3.0])
    rng = np.random.default_rng(c)
    data = vals[torch.from_numpy(rng.integers(0, 9, (900, c)))].to(dev)
    seg = torch.from_numpy(rng.integers(0, 300, 900).astype(np.int32))
    seg = seg.to(dev)
    for strategy in ("segment", "accumulate"):
        kw = dict(num_segments=301, group_size=4, strategy=strategy, op=op)
        got = sr.segment_reduce(seg, data, **kw)
        _assert_segred_same(got, sr.segment_reduce_plain(seg, data, **kw),
                            op)


@pytest.mark.parametrize("c", [3, 40, 41])
@pytest.mark.parametrize("shuffled", [False, True])
def test_segment_reduce_count_column_matches_plain(dev, c, shuffled):
    """The mean's virtual column of ones: the lane counts beside the
    sums, as the plain version's concatenated column gives them."""
    from repro_torch.kernels import segment_reduce as sr

    seg, data = _segred_hub_stream(dev, 3001, c, seed=c, shuffled=shuffled)
    kw = dict(num_segments=200, count_column=True)
    got = _poisoned_segment_reduce(sr, seg, data, **kw)
    assert got.shape == (200, c + 1)
    _assert_segred_within_terms(sr, got,
                                sr.segment_reduce_plain(seg, data, **kw),
                                seg, data, op="add", **kw)
    assert torch.equal(got[:, -1].long(),
                       torch.bincount(seg.long(), minlength=200))


def test_segment_reduce_op_on_cuda_matches_cpu(dev):
    import repro_torch.sparse as ts
    from repro_torch.core import Schedule, register_strategy, spec_segment

    seg, data = _segments("cpu", 700, 50, 6, seed=5)
    for op in ("sum", "max", "min", "mean"):
        want = ts.segment_reduce(seg, data, 50, op=op, device="cpu")
        got = ts.segment_reduce(seg.to(dev), data.to(dev), 50, op=op)
        _assert_segred_same(got.cpu(), want, op)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ts.segment_reduce(seg.to(dev), data.to(dev).requires_grad_(), 50)
    # a user strategy: the combine kernel folds its spec's results in
    register_strategy("t_cuda_segred_user", spec_segment, overwrite=True)
    sched = Schedule(strategy="t_cuda_segred_user", nnz_tile=128,
                     group_size=8)
    for op in ("sum", "max", "min", "mean"):
        want = ts.segment_reduce(seg, data, 50, sched, op=op, device="cpu")
        got = ts.segment_reduce(seg.to(dev), data.to(dev), 50, sched, op=op)
        _assert_segred_same(got.cpu(), want, op)


@pytest.mark.parametrize("schedule", ["eb", "rb"])
def test_planned_gcn_and_readout_launches(dev, schedule):
    """``run_plan`` on the two-layer GCN chain takes 2 planned launches:
    EB 2 and its finishing launch 2 (the epilogue is fused into EB), or
    RB 2; the readout chain adds one segment-reduce launch.  Outputs match
    the CPU's."""
    import repro_torch.fuse as tf
    import repro_torch.sparse as ts
    from repro_torch.core import Schedule
    from repro_torch.kernels import spmm_eb, spmm_rb
    from repro_torch.kernels import segment_reduce as sr

    sched = (Schedule("eb", nnz_tile=128, group_size=32)
             if schedule == "eb" else Schedule.named("RB+PR"))
    counters = (spmm_eb.KERNEL, spmm_eb.FINISH, spmm_rb.KERNEL, sr.KERNEL)
    want_counts = (2, 2, 0, 0) if schedule == "eb" else (0, 0, 2, 0)
    outs = {}
    for where in ("cpu", dev):
        a = _matrix(where, n=300, seed=2)
        w0, w1, b0 = (_dense(where, s, i) for i, s in
                      enumerate(((16, 32), (32, 8), (32,))))
        x = _dense(where, (300, 16), 7)
        seg = (torch.arange(300) // 26).to(torch.int32).to(where)
        for op in (None, "mean", "max"):
            chain, params = tf.gcn_chain(a, (w0, w1), (b0, None),
                                         schedule=sched)
            if op is not None:
                chain += (tf.segment_reduce_node(op),)
                params += [{"seg_ids": seg, "num_segments": 12}]
            p = tf.plan(chain)
            assert p.n_launches == (2 if op is None else 3)
            before = [k.launches for k in counters]
            with torch.no_grad():
                outs[(str(where), op)] = tf.run_plan(p, x, params,
                                                     device=where).cpu()
            delta = tuple(k.launches - b for k, b in zip(counters, before))
            if where != "cpu":
                assert delta == want_counts[:3] + (int(op is not None),)
                torch.testing.assert_close(
                    outs[(str(where), op)],
                    tf.run_chain_ref(chain, x, params).cpu(), rtol=1e-4,
                    atol=1e-4)
    for op in (None, "mean", "max"):
        torch.testing.assert_close(outs[(str(dev), op)], outs[("cpu", op)],
                                   rtol=1e-4, atol=1e-4)


def _gmm_operands(dev, tile, n_tiles, e, d, f, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n_tiles * tile, d, generator=g).to(dtype).to(dev)
    w = (torch.randn(e, d, f, generator=g) * d ** -0.5).to(dtype).to(dev)
    te = torch.randint(0, e, (n_tiles,), generator=g,
                       dtype=torch.int32).to(dev)
    b = torch.randn(e, f, generator=g).to(dev)
    return x, te, w, b


@pytest.mark.parametrize("f", [64, 40, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [1, 4, 10, 17, 128])
def test_grouped_matmul_kernel_matches_plain(dev, tile, dtype, f):
    """Both routes: bf16 with F = 64 and 40 on the tensor cores (``mma``;
    D = 300 takes 4-byte token copies and a ragged last ring stage, F =
    40 a ragged slab), bf16 with F = 20 and f32 on the CUDA cores
    (``fma``; both row-chunk sizes, 4 and 8, ragged above 8; F = 40 in
    bf16 and F = 20 in f32 would take scalar loads there); token tiles
    of 1 to 128 (the tensor-core route takes 32 rows a pass); no
    epilogue, bias + SiLU, and a bf16 output."""
    from repro_torch.core import Epilogue
    from repro_torch.kernels import grouped_matmul as gm

    x, te, w, b = _gmm_operands(dev, tile, 5, 6, 300, f, dtype, tile + f)
    route = "mma" if dtype == torch.bfloat16 and f % 8 == 0 else "fma"
    for ep, bias in ((Epilogue(), None),
                     (Epilogue("silu", bias=True), b),
                     (Epilogue(out_dtype="bfloat16"), None)):
        kw = dict(bias=bias, epilogue=ep, token_tile=tile)
        before = gm.KERNEL.launches
        taken = gm.ROUTE_LAUNCHES[route]
        got = gm.grouped_matmul(x, te, w, f_tile=f, d_tile=300, **kw)
        assert gm.KERNEL.launches == before + 1
        assert gm.ROUTE_LAUNCHES[route] == taken + 1
        want = gm.grouped_matmul_plain(x, te, w, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        rtol = RTOL + (2.0 ** -7 if ep.out_dtype else 0.0)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=ATOL)


@pytest.mark.parametrize("out_dtype", ["float16", "float8_e4m3fn"])
@pytest.mark.parametrize("dtype,f", [(torch.bfloat16, 64),
                                     (torch.float32, 20)])
def test_grouped_matmul_fp16_and_e4m3_outputs(dev, dtype, f, out_dtype):
    """The fp16 and e4m3 epilogue stores on both routes, with values
    large enough that some e4m3 outputs overflow to NaN."""
    from repro_torch.core import Epilogue
    from repro_torch.kernels import grouped_matmul as gm

    x, te, w, b = _gmm_operands(dev, 10, 5, 6, 300, f, dtype, 11)
    x = (x.float() * 256).to(dtype)
    for ep, bias in ((Epilogue(out_dtype=out_dtype), None),
                     (Epilogue("silu", bias=True, out_dtype=out_dtype), b)):
        kw = dict(bias=bias, epilogue=ep, token_tile=10)
        got = gm.grouped_matmul(x, te, w, f_tile=f, d_tile=300, **kw)
        want = gm.grouped_matmul_plain(x, te, w, **kw)
        assert got.dtype == want.dtype == getattr(torch, out_dtype)
        nan = torch.isnan(want.float())
        assert torch.equal(torch.isnan(got.float()), nan)
        rel, floor = OUT_STEP[got.dtype]
        g, wv = got.float()[~nan], want.float()[~nan]
        assert bool(((g - wv).abs() <= (rel + RTOL) * wv.abs() + floor
                     + ATOL).all())
    if out_dtype == "float8_e4m3fn":
        assert bool(nan.any())  # the overflow was exercised


@pytest.mark.parametrize("case", ["odd_d", "tokens_off_4_bytes"])
@pytest.mark.parametrize("tile", [4, 10, 17])
def test_grouped_matmul_cuda_core_route_takes_bf16_16_byte_loads(dev, tile,
                                                                  case):
    """bf16 tokens on bf16 weights whose rows the tensor-core copies cannot
    take (odd D, or tokens 2 bytes off a 4-byte boundary) but whose F % 8
    and aligned weights give the CUDA-core route its 16-byte weight loads;
    row chunks of 4 and 8, ragged above 8; no epilogue, bias + SiLU, and a
    bf16 output."""
    from repro_torch.core import Epilogue
    from repro_torch.kernels import grouped_matmul as gm

    d = 301 if case == "odd_d" else 300
    x, te, w, b = _gmm_operands(dev, tile, 5, 6, d, 64, torch.bfloat16,
                                tile + d)
    if case == "tokens_off_4_bytes":
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        x_off = flat[1:].view(x.shape)
        x_off.copy_(x)
        x = x_off
    assert gm.gmm_route(x.dtype, w.dtype, d, 64, x.data_ptr(),
                        w.data_ptr()) == "fma"
    for ep, bias in ((Epilogue(), None),
                     (Epilogue("silu", bias=True), b),
                     (Epilogue(out_dtype="bfloat16"), None)):
        kw = dict(bias=bias, epilogue=ep, token_tile=tile)
        before = (gm.KERNEL.launches, gm.ROUTE_LAUNCHES["fma"])
        got = gm.grouped_matmul(x, te, w, f_tile=64, d_tile=d, **kw)
        assert (gm.KERNEL.launches, gm.ROUTE_LAUNCHES["fma"]) == (
            before[0] + 1, before[1] + 1)
        want = gm.grouped_matmul_plain(x, te, w, **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        rtol = RTOL + (2.0 ** -7 if ep.out_dtype else 0.0)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=ATOL)


def test_grouped_matmul_kernel_mixed_misaligned_and_bad_experts(dev):
    """f32 tokens on bf16 weights; weights 2 bytes off a 16-byte boundary
    (scalar loads); a tile whose expert id lies outside [0, E) is NaN;
    fp16 tokens on bf16 weights run on the CUDA cores; int8 operands are
    refused."""
    from repro_torch.kernels import grouped_matmul as gm

    x, te, w, _ = _gmm_operands(dev, 4, 6, 3, 128, 64, torch.bfloat16, 0)
    got = gm.grouped_matmul(x.float(), te, w, token_tile=4, f_tile=64,
                            d_tile=128)
    torch.testing.assert_close(
        got, gm.grouped_matmul_plain(x.float(), te, w, token_tile=4),
        rtol=RTOL, atol=ATOL)
    flat = torch.empty(w.numel() + 1, dtype=w.dtype, device=dev)
    w_off = flat[1:].view(w.shape)
    w_off.copy_(w)
    torch.testing.assert_close(
        gm.grouped_matmul(x, te, w_off, token_tile=4, f_tile=64, d_tile=128),
        gm.grouped_matmul_plain(x, te, w, token_tile=4), rtol=RTOL,
        atol=ATOL)
    bad = te.clone()
    bad[2] = 7
    out = gm.grouped_matmul(x, bad, w, token_tile=4, f_tile=64, d_tile=128)
    assert bool(out[8:12].isnan().all()) and not bool(
        out[:8].isnan().any())
    before = gm.ROUTE_LAUNCHES["fma"]
    torch.testing.assert_close(
        gm.grouped_matmul(x.half(), te, w, token_tile=4, f_tile=64,
                          d_tile=128),
        gm.grouped_matmul_plain(x.half(), te, w, token_tile=4), rtol=RTOL,
        atol=ATOL)
    assert gm.ROUTE_LAUNCHES["fma"] == before + 1
    with pytest.raises(NotImplementedError, match="loads"):
        gm.grouped_matmul(x.to(torch.int8), te, w, token_tile=4, f_tile=64,
                          d_tile=128)


#: The tensor-core route's per-element bound, in units of 2^-24 of the
#: magnitude of the terms entering an output (``_assert_within_terms``):
#: ``mma.sync`` adds each k16 step's products into its f32 sum with
#: truncation, up to 2 units of the sum's magnitude a step, so the bound
#: is 2 units per step of D plus K_TERMS for the plain version's own f32
#: order and the epilogue's expf and tanhf.  A wrong fragment, stage or
#: expert moves an output by whole products, far above it.
def _mma_k(d):
    return 2 * -(-d // 16) + K_TERMS


@pytest.mark.parametrize("d,f", [(300, 40), (4096, 1536)])
@pytest.mark.parametrize("tile", [1, 4, 10, 16, 17, 32, 64, 80, 96, 128])
def test_grouped_matmul_tensor_core_route_matches_plain(dev, tile, d, f):
    """The tensor-core route at the tiles of decode (4), prefill (10),
    one and two mma.sync n8 tiles, a ragged third, the dispatch tuner's
    tiles at 1024 tokens (one to three passes of 32 rows, a ragged half
    pass at 80) and four passes (128), at the MoE width (D 4096, F 1536)
    and at ragged D and F,
    for every activation with and without bias and both output types,
    per element against the plain version."""
    from repro_torch.core import Epilogue
    from repro_torch.kernels import grouped_matmul as gm

    x, te, w, b = _gmm_operands(dev, tile, 5, 6, d, f, torch.bfloat16,
                                tile + d)
    assert gm.gmm_route(x.dtype, w.dtype, d, f, x.data_ptr(),
                        w.data_ptr()) == "mma"
    terms = gm.grouped_matmul_plain(x.abs(), te, w.abs(), token_tile=tile)
    for ep, bias in ((Epilogue(), None),
                     (Epilogue("relu", bias=True), b),
                     (Epilogue("gelu"), None),
                     (Epilogue("silu", bias=True), b),
                     (Epilogue("tanh", bias=True), b),
                     (Epilogue("sigmoid"), None),
                     (Epilogue(out_dtype="bfloat16"), None),
                     (Epilogue("silu", bias=True, out_dtype="bfloat16"), b)):
        kw = dict(bias=bias, epilogue=ep, token_tile=tile)
        before = (gm.KERNEL.launches, gm.ROUTE_LAUNCHES["mma"])
        got = gm.grouped_matmul(x, te, w, f_tile=f, d_tile=d, **kw)
        assert (gm.KERNEL.launches, gm.ROUTE_LAUNCHES["mma"]) == (
            before[0] + 1, before[1] + 1)
        want = gm.grouped_matmul_plain(x, te, w, **kw)
        t = terms if bias is None else terms + bias[te.long()].abs(
        ).repeat_interleave(tile, 0)
        _assert_within_terms(got, want, t, _mma_k(d))


def test_grouped_matmul_tensor_core_route_is_deterministic(dev):
    """One block sums each output over all of D in a fixed order: two
    launches at the decode shape give the same bits."""
    from repro_torch.kernels import grouped_matmul as gm

    x, te, w, _ = _gmm_operands(dev, 4, 8, 8, 4096, 1536, torch.bfloat16, 3)
    kw = dict(token_tile=4, f_tile=1536, d_tile=4096)
    a, b = (gm.grouped_matmul(x, te, w, **kw) for _ in range(2))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_moe_and_decode_step_launches(dev):
    """``apply_moe`` on the kernel path is 3 grouped-matmul launches and
    matches the einsum path and the CPU; a decode step of the 2-layer
    smoke MoE model is 6, and its logits match the CPU's."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models import get_model
    from repro_torch.models.moe import apply_moe

    cfg = smoke_config(ARCHS["qwen3-moe-235b-a22b"])
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_dev(v) for v in tree]
        return tree.to(dev)

    p_dev = to_dev(params)
    x = _dense("cpu", (24, cfg.d_model), 3)
    moe_cpu, moe_dev = params["layers"][0]["moe"], p_dev["layers"][0]["moe"]
    with torch.no_grad():
        before = gm.KERNEL.launches
        got, _ = apply_moe(cfg, moe_dev, x.to(dev))
        assert gm.KERNEL.launches == before + 3
        einsum, _ = apply_moe(cfg.scaled(moe_kernel_dispatch=False),
                              moe_dev, x.to(dev))
        want, _ = apply_moe(cfg, moe_cpu, x, device="cpu")
        torch.testing.assert_close(got, einsum, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        toks = torch.randint(0, cfg.vocab_size, (2, 6))
        lc, cc = api.prefill(params, {"tokens": toks}, 10)
        ld, cd = api.prefill(p_dev, {"tokens": toks.to(dev)}, 10)
        before = gm.KERNEL.launches
        lc, _ = api.decode_step(params, cc, lc.argmax(-1))
        ld, _ = api.decode_step(p_dev, cd, ld.argmax(-1))
        assert gm.KERNEL.launches == before + 3 * cfg.n_layers
        torch.testing.assert_close(ld.cpu(), lc, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The tuner on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def tuner_env(dev, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_BENCH_ITERS", "3")
    monkeypatch.setenv("REPRO_BENCH_WARMUP", "1")
    return dev


def test_time_fn_synchronizes_and_returns_a_positive_median(tuner_env):
    from repro_torch.tune import time_fn

    x = torch.randn(4096, 4096, device=tuner_env)
    t = time_fn(lambda a: a @ a, x, iters=5)
    # a 4096^3 f32 product takes well over 100 us on any H100: the events
    # were read after the device finished, not after the enqueue
    assert 1e-4 < t < 10.0


@pytest.mark.parametrize("sched", [
    dict(kernel="eb", nnz_tile=256, group_size=16),
    dict(kernel="eb", nnz_tile=128, group_size=8, split_threshold=8,
         merge_threshold=0, strategy="parallel"),
    dict(kernel="rb", row_tile=16, strategy="parallel")])
def test_measure_schedule_launches_the_kernels(tuner_env, sched):
    from repro_torch.core import Schedule
    from repro_torch.kernels import spmm_eb, spmm_rb
    from repro_torch.tune import measure_schedule
    from repro_torch.tune.measure import bench_iters, bench_warmup

    a = _matrix(tuner_env)
    s = Schedule(**sched)
    kernel = spmm_eb.KERNEL if s.kernel == "eb" else spmm_rb.KERNEL
    before = kernel.launches
    assert measure_schedule(a, 40, s) > 0
    assert kernel.launches - before == bench_iters() + bench_warmup()


def test_tuned_spmm_matches_plain_per_element(tuner_env):
    """The tuned schedule's kernel against its plain version on the same
    feed (the grouping of the sums is the schedule's), per element."""
    import repro_torch.sparse as ts
    from repro_torch.core import Epilogue
    from repro_torch.kernels import eb_partials, spmm_eb, spmm_rb
    from repro_torch.tune import tune_schedule

    a = _matrix(tuner_env, n=2000)
    b = _dense(tuner_env, (a.shape[1], 40), 3)
    bias = _dense(tuner_env, (40,), 4)
    ep = Epilogue("relu", bias=True)
    res = tune_schedule(a, 40, epilogue=ep)
    assert res.n_measurements >= 5
    before = spmm_eb.KERNEL.launches + spmm_rb.KERNEL.launches
    got = ts.spmm(a, b, schedule="tune", bias=bias, epilogue=Epilogue("relu"))
    assert spmm_eb.KERNEL.launches + spmm_rb.KERNEL.launches == before + 1
    s = res.schedule
    # the feed at the pick's storage (the dtype axis may narrow it)
    c, scales, bq = (a, None, b) if s.value_dtype is None else _stored(
        a, s.value_dtype, b)
    if s.kernel == "eb":
        g = c.grouped(s.nnz_tile, group_size=s.group_size,
                      split_threshold=s.split_threshold,
                      merge_threshold=s.merge_threshold)
        plain = spmm_eb.spmm_eb_plain
        args = (g.rows, g.cols, g.vals, bq)
        terms_args = (g.rows, g.cols,
                      eb_partials.lane_values(g.vals, g.rows, scales),
                      bq.float())
        kw = dict(n_rows=a.shape[0], nnz_tile=s.nnz_tile,
                  group_size=s.group_size, strategy=s.strategy,
                  heavy_tiles=g.heavy_tiles)
    else:
        e = c.ell(row_tile=s.row_tile)
        plain, args, kw = spmm_rb.spmm_rb_plain, (e.cols, e.vals, bq), dict(
            n_rows=a.shape[0])
        v = e.vals[:a.shape[0]].float()
        terms_args = (e.cols, v if scales is None else v * scales[:, None],
                      bq.float())
    want = plain(*args, epilogue=ep, scales=scales, bias=bias, **kw)
    _assert_within_terms(got, want, _terms(plain, *terms_args, bias=bias,
                                           **kw))


def test_schedule_fits_card_refuses_what_the_cuda_wrappers_refuse(tuner_env):
    import repro_torch.sparse as ts
    from repro_torch.core import Schedule, register_strategy, spec_segment
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import spmm_eb

    register_strategy("t_fits_user", spec_segment, overwrite=True)
    register_strategy("t_fits_max", spec_segment, combine="max",
                      overwrite=True)
    a = _matrix(tuner_env)
    b = _dense(tuner_env, (a.shape[1], 8), 8)
    st = ts.matrix_stats(a)
    cases = [Schedule(nnz_tile=64, group_size=8),
             Schedule(nnz_tile=spmm_eb.MAX_NNZ_TILE, group_size=32),
             Schedule(nnz_tile=2 * spmm_eb.MAX_NNZ_TILE, group_size=32),
             Schedule(nnz_tile=64, group_size=8, strategy="t_fits_user"),
             Schedule(nnz_tile=64, group_size=8, strategy="t_fits_max"),
             Schedule(nnz_tile=2 * spmm_eb.MAX_NNZ_TILE, group_size=32,
                      strategy="t_fits_user"),
             Schedule(nnz_tile=64, group_size=8, value_dtype="bf16"),
             Schedule("rb", row_tile=8, strategy="parallel")]
    narrow = [Schedule(nnz_tile=64, group_size=8, value_dtype=vd)
              for vd in ("fp16", "fp8", "int8")]
    narrow += [Schedule("rb", row_tile=8, strategy="parallel",
                        value_dtype=vd)
               for vd in ("bf16", "fp16", "fp8", "int8")]
    for s in narrow:  # narrow and int8 storage run wherever f32 does
        assert kops.schedule_fits_card(s, n_rows=st["n_rows"],
                                       row_max=st["row_max"])
    for s in cases + narrow:
        fits = kops.schedule_fits_card(s, n_rows=st["n_rows"],
                                       row_max=st["row_max"])
        try:
            kops.spmm(a, b, s)
            took = True
        except (ValueError, NotImplementedError):
            took = False
        assert fits == took, s


def test_moe_dispatch_tuner_on_cuda(dev, tmp_path, monkeypatch):
    """``tune_moe_dispatch`` times the kernel's three launches on the
    card, every one on the tensor-core route; a replay measures nothing;
    ``apply_moe`` at the pick matches the CPU's plain version."""
    from repro_torch import tune
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models import moe as tmoe
    from repro_torch.tune import moe as tm

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_BENCH_ITERS", "2")
    tune.set_default_cache(None)
    cfg = smoke_config(ARCHS["qwen3-moe-235b-a22b"]).scaled(
        d_model=256, moe_d_ff=128, n_experts=8, param_dtype="bfloat16",
        compute_dtype="bfloat16")
    lengths = tmoe.skewed_expert_lengths(cfg, 512)
    before = dict(gm.ROUTE_LAUNCHES)
    res = tmoe.moe_tune_dispatch(cfg, 512, expert_lengths=lengths, device=dev)
    assert res.n_measurements > 0
    assert {r for r, n in gm.ROUTE_LAUNCHES.items() if n != before[r]} == {
        "mma"}
    again = tmoe.moe_tune_dispatch(cfg, 512, expert_lengths=lengths,
                                   device=dev)
    assert again.from_cache and again.schedule == res.schedule
    assert tmoe.moe_dispatch_schedule(cfg, 512, expert_lengths=lengths,
                                      device=dev) == res.schedule
    assert tm.dropped_tokens(lengths, tm.moe_capacity(
        lengths, res.schedule.capacity_factor, max_tokens=512)) <= (
        tm.dropped_tokens(lengths, tm.moe_capacity(
            lengths, cfg.capacity_factor, max_tokens=512)))
    p = tmoe.init_moe(cfg, torch.Generator().manual_seed(0))
    x = _dense("cpu", (512, cfg.d_model), 5).to(torch.bfloat16)
    with torch.no_grad():
        got, _ = tmoe.apply_moe(cfg, {k: v.to(dev) for k, v in p.items()},
                                x.to(dev), dispatch=res.schedule)
        want, _ = tmoe.apply_moe(cfg, p, x, dispatch=res.schedule,
                                 device="cpu")
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               rtol=2.0 ** -7, atol=2e-2)
    tune.set_default_cache(None)


# ---------------------------------------------------------------------------
# Narrow operands: SDDMM, attention and the grouped matmul
# ---------------------------------------------------------------------------

_NARROW = (torch.bfloat16, torch.float16, torch.float8_e4m3fn)


def _launch_args(monkeypatch, kernel):
    """Record the arguments of every launch of ``kernel`` (a CudaKernel)."""
    seen = []
    launch = kernel.launch

    def spy(device, *args):
        seen.append(args)
        return launch(device, *args)

    monkeypatch.setitem(kernel.__dict__, "launch", spy)
    return seen


def _no_plain(monkeypatch, module, *names):
    """Make the named plain versions raise: a CUDA wrapper must not take
    them."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA wrapper ran its plain version")

    for n in names:
        monkeypatch.setattr(module, n, refuse)


@pytest.mark.parametrize("a_dtype,b_dtype", [
    *((t, t) for t in _NARROW), *((torch.float32, t) for t in _NARROW),
    (torch.bfloat16, torch.float32), (torch.float8_e4m3fn, torch.float16)])
@pytest.mark.parametrize("d,aligned", [(1, True), (40, True), (64, True),
                                       (256, True), (300, True),
                                       (2056, True), (256, False)])
def test_sddmm_kernel_narrow_pairs(dev, monkeypatch, a_dtype, b_dtype, d,
                                   aligned):
    """Every (A, B) pair the kernel loads, at every geometry (16-byte
    vectors of 8 or 16 narrow elements, element loads where d or the
    alignment does not allow them, the wide walk), and two promoted
    pairs: within the f32 kernel's bound of the plain version on the same
    stored values, one launch, the kernel handed the caller's narrow
    operands themselves (no f32 copy) and no plain version taken."""
    from repro_torch.kernels import sddmm

    rng = np.random.default_rng(d)
    nnz = 700
    rows = torch.from_numpy(np.sort(rng.integers(0, 50, nnz)).astype(
        np.int32)).to(dev)
    cols = torch.from_numpy(rng.integers(0, 70, nnz).astype(np.int32)).to(dev)
    a = _dense(dev, (50 * d + 16,), 10).to(a_dtype)
    a = (a[:50 * d] if aligned else a[1:50 * d + 1]).view(50, d)
    b = _dense(dev, (70, d), 11).to(b_dtype)
    scale = _dense(dev, (nnz,), 12)
    want = sddmm.sddmm_plain(rows, cols, a, b, scale)
    seen = _launch_args(monkeypatch, sddmm.KERNEL)
    _no_plain(monkeypatch, sddmm, "sddmm_plain")
    got = sddmm.sddmm(rows, cols, a, b, scale, nnz_tile=128)
    assert len(seen) == 1
    native = (a_dtype, b_dtype) in sddmm.CUDA_PAIRS
    assert (seen[0][2] == a.data_ptr()) == (native or a_dtype == torch.float32)
    assert seen[0][3] == b.data_ptr() or not native
    torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * d)


@pytest.mark.parametrize("dtype", [torch.float32, *_NARROW])
@pytest.mark.parametrize("heads,d,dv", [(2, 64, 64), (1, 37, 130),
                                        (2, 320, 320), (1, 512, 512),
                                        (1, 16, 300), (1, 300, 8)])
def test_fused_attention_narrow_and_wide(dev, monkeypatch, dtype, heads, d,
                                         dv):
    """q, k and v of one type at head widths of one and of several column
    slabs (256 a slab): forward and backward against the plain versions
    on the same stored values, the kernels handed the caller's q, k and v
    (no f32 copy), no plain version taken, f32 outputs and gradients."""
    from repro_torch.kernels import fused_attention as fa

    indptr, cols, q, k, v, do, bias = _attention_case(dev, 90, 70, heads, d,
                                                      dv, d + dv)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    kw = dict(scale=d ** -0.5, bias=bias)
    want = fa.fused_sparse_attention_plain(indptr, cols, q, k, v, **kw)
    want_b = fa.fused_sparse_attention_bwd_plain(indptr, cols, q, k, v, do,
                                                 want[1], want[2], **kw)
    fwd = _launch_args(monkeypatch, fa.FWD_KERNEL)
    bwd = _launch_args(monkeypatch, fa.BWD_KERNEL)
    _no_plain(monkeypatch, fa, "fused_sparse_attention_plain",
              "fused_sparse_attention_bwd_plain")
    got = fa.fused_sparse_attention(indptr, cols, q, k, v, **kw)
    got_b = fa.fused_sparse_attention_bwd(indptr, cols, q, k, v, do, got[1],
                                          got[2], **kw)
    for args in fwd + bwd:
        assert args[3:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        torch.testing.assert_close(g_, w_, rtol=RTOL, atol=RTOL)
    for g_, w_ in zip(got_b, want_b):
        assert g_.dtype == torch.float32
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", [(320, 320), (64, 600)])
def test_fused_attention_wide_heads_split_rows(dev, dtype, d, dv):
    """Rows longer than a chunk at head widths of several slabs: out, m,
    l and dQ the same bits over two launches, against the plain versions
    and the slab walk's plain version."""
    from repro_torch.kernels import fused_attention as fa

    rng = np.random.default_rng(d + dv)
    n_rows, n_kv, heads = 40, 3000, 1
    lengths = rng.integers(0, 6, n_rows)
    lengths[[3, 17]] = (2500, fa.FWD_CHUNK + 1)
    cols = np.concatenate([rng.choice(n_kv, int(n), replace=False)
                           for n in lengths]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    g = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn(heads, n, w, generator=g).to(dev)
                   for n, w in ((n_rows, d), (n_kv, d), (n_kv, dv),
                                (n_rows, dv)))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    ip, cc = (torch.from_numpy(a).to(dev) for a in (indptr, cols))
    kw = dict(scale=d ** -0.5)
    got = fa.fused_sparse_attention(ip, cc, q, k, v, **kw)
    again = fa.fused_sparse_attention(ip, cc, q, k, v, **kw)
    for g_, a_ in zip(got, again):
        assert torch.equal(g_.view(torch.int32), a_.view(torch.int32))
    for want in (fa.fused_sparse_attention_plain(ip, cc, q, k, v, **kw),
                 fa.fused_sparse_attention_slabbed_plain(ip, cc, q, k, v,
                                                         **kw)):
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=RTOL, atol=RTOL)
    b1 = fa.fused_sparse_attention_bwd(ip, cc, q, k, v, do, got[1], got[2],
                                       **kw)
    b2 = fa.fused_sparse_attention_bwd(ip, cc, q, k, v, do, got[1], got[2],
                                       **kw)
    assert torch.equal(b1[0].view(torch.int32), b2[0].view(torch.int32))
    want_b = fa.fused_sparse_attention_bwd_slabbed_plain(
        ip, cc, q, k, v, do, got[1], got[2], **kw)
    for g_, w_ in zip(b1, want_b):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)


def test_fused_attention_refuses_rows_past_shared_memory(dev):
    """d + dv past what a block's shared memory stages (4 warps of f32
    rows, 227 KB) is refused with the bound named; d = 14,000 forward
    alone fits."""
    from repro_torch.kernels import fused_attention as fa

    indptr, cols, q, k, v, do, _ = _attention_case(dev, 10, 8, 1, 8, 8, 0)
    big = torch.zeros(1, 10, 14_000, device=dev)
    kbig = torch.zeros(1, 8, 14_000, device=dev)
    out, m, l = fa.fused_sparse_attention(indptr, cols, big, kbig, v,
                                          scale=1.0)
    assert bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="232448 bytes"):
        fa.fused_sparse_attention_bwd(indptr, cols, big, kbig, kbig[..., :600]
                                      .contiguous(),
                                      torch.zeros(1, 10, 600, device=dev), m,
                                      l, scale=1.0)


_GMM_PAIRS = [(x, w) for x in (torch.float32, *_NARROW)
              for w in (torch.float32, *_NARROW)]


@pytest.mark.parametrize("x_dtype,w_dtype", _GMM_PAIRS,
                         ids=[f"{x}-{w}".replace("torch.", "")
                              for x, w in _GMM_PAIRS])
@pytest.mark.parametrize("tile,d,f", [(4, 4096, 1536), (10, 4096, 1536),
                                      (17, 320, 48), (4, 300, 40)])
def test_grouped_matmul_every_operand_pair(dev, x_dtype, w_dtype, tile, d,
                                           f):
    """Every pair of f32, bf16, fp16 and e4m3 tokens and weights, per
    element against the plain version on the same stored values (the
    upcasts are exact, so the f32 bound holds, with the tensor cores'
    steps of D on route ``mma``), with bias + SiLU and a bf16 output; the
    route the wrapper names is the one counted, and at the serving widths
    every pair that becomes one 16-bit type exactly takes the tensor
    cores."""
    from repro_torch.core import Epilogue
    from repro_torch.kernels import grouped_matmul as gm

    x, te, w, b = _gmm_operands(dev, tile, 4, 5, d, f, torch.float32,
                                tile + d + f)
    x, w = x.to(x_dtype), w.to(w_dtype)
    route = gm.gmm_route(x.dtype, w.dtype, d, f, x.data_ptr(), w.data_ptr())
    if d == 4096:  # the serving widths: every exact 16-bit pair on mma
        exact16 = ((x_dtype, w_dtype) == (torch.bfloat16, torch.bfloat16)
                   or (x_dtype, w_dtype) in gm.MMA_NARROW_PAIRS)
        assert (route == "mma") == exact16
    terms = gm.grouped_matmul_plain(x.float().abs(), te, w.float().abs(),
                                    token_tile=tile)
    for ep, bias in ((Epilogue("silu", bias=True), b),
                     (Epilogue(out_dtype="bfloat16"), None)):
        kw = dict(bias=bias, epilogue=ep, token_tile=tile)
        before = gm.ROUTE_LAUNCHES[route]
        got = gm.grouped_matmul(x, te, w, f_tile=f, d_tile=d, **kw)
        assert gm.ROUTE_LAUNCHES[route] == before + 1
        want = gm.grouped_matmul_plain(x, te, w, **kw)
        t = terms if bias is None else terms + bias[te.long()].abs(
        ).repeat_interleave(tile, 0)
        _assert_within_terms(got, want, t,
                             _mma_k(d) if route == "mma" else K_TERMS)


def test_moe_with_e4m3_experts_and_fp16_on_cuda(dev):
    """``apply_moe`` with e4m3 expert weights beside bf16 tokens takes the
    tensor cores for its gate and up projections and the down projection
    (bf16 h), and matches the same layer with the experts upcast to bf16
    bit for bit; at fp16 it matches the CPU."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.core.dtypes import cast
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models.moe import apply_moe, init_moe

    cfg = smoke_config(ARCHS["qwen3-moe-235b-a22b"]).scaled(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    p = init_moe(cfg, torch.Generator(device=dev).manual_seed(0))
    p8 = {k: cast(v, torch.float8_e4m3fn) if k != "router" else v
          for k, v in p.items()}
    p16 = {k: v.to(torch.bfloat16) if k != "router" else v
           for k, v in p8.items()}
    x = _dense(dev, (24, cfg.d_model), 3).to(torch.bfloat16)
    with torch.no_grad():
        before = gm.ROUTE_LAUNCHES["mma"]
        got, _ = apply_moe(cfg, p8, x)
        assert gm.ROUTE_LAUNCHES["mma"] == before + 3
        want, _ = apply_moe(cfg, p16, x)
        assert torch.equal(got, want)
        cfg16 = cfg.scaled(param_dtype="float16", compute_dtype="float16")
        ph = {k: v.to(torch.float16) if k != "router" else v
              for k, v in p.items()}
        xh = x.to(torch.float16)
        before = gm.ROUTE_LAUNCHES["mma"]
        got, _ = apply_moe(cfg16, ph, xh)
        assert gm.ROUTE_LAUNCHES["mma"] == before + 3
        want, _ = apply_moe(cfg16, {k: v.cpu() for k, v in ph.items()},
                            xh.cpu(), device="cpu")
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=2.0 ** -9, atol=1e-3)

