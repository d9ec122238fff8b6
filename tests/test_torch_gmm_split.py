"""The grouped matmul backward's tensor-core route, on the CPU: the split
of an f32 gradient into three bf16 parts (``split_bf16x3``, the
arithmetic ``csrc/spmm.cuh``'s ``split_mma`` runs in shared memory), the
exactness of each part's product with a bf16 partner, the dx and dW that
the three products give against ``jax.grad`` through the reference's
custom VJP, and the route :func:`gmm_bwd_route` fixes for every pair of
token and weight types.  The CUDA kernels themselves are held to their
plain versions in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Epilogue as JEp
from repro.kernels import ops as jops
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import grouped_matmul_dw as gmd

#: Per output, the error allowed against the reference: K_TERMS units of
#: 2^-24 of the magnitude of the terms entering it (the f32 sums are
#: taken in other orders), as ``chip_smoke.py`` holds the kernels.
K_TERMS = 16
_TYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float8_e4m3fn)


def _values(seed, lo, hi, n=1 << 16):
    """f32 values with exponents drawn from [lo, hi], both signs, and
    every significand bit random."""
    rng = np.random.default_rng(seed)
    sig = rng.uniform(1.0, 2.0, n)
    exp = rng.integers(lo, hi + 1, n)
    sign = rng.choice([-1.0, 1.0], n)
    z = (sign * np.ldexp(sig, exp)).astype(np.float32)
    bits = z.view(np.uint32) | rng.integers(0, 1 << 23, n, dtype=np.uint32)
    return torch.from_numpy(bits.view(np.float32).copy())


def _sum64(parts):
    return sum(p.double() for p in parts)


@pytest.mark.parametrize("lo,hi", [(-100, -60), (-60, -1), (0, 60),
                                   (60, 100)])
def test_split_is_exact_over_the_exponent_range(lo, hi):
    """h + m + l equals z bit for bit (summed in f64, where the three
    need no rounding) for exponents in [-100, 100]; h is z rounded to
    bf16 and each remainder is exact in f32."""
    z = _values(lo + 1000, lo, hi)
    h, m, l = gm.split_bf16x3(z)
    assert h.dtype == m.dtype == l.dtype == torch.bfloat16
    assert torch.equal(_sum64((h, m, l)).float(), z)
    assert torch.equal(_sum64((h, m, l)), z.double())
    assert torch.equal(h, z.to(torch.bfloat16))
    assert torch.equal(m.float(), (z - h.float()).to(torch.bfloat16).float())
    # each part is at most half a step of the one above it
    assert bool((m.double().abs() <= h.double().abs() * 2.0 ** -8).all())
    assert bool((l.double().abs() <= m.double().abs() * 2.0 ** -8).all())


def test_split_keeps_signed_zeros_inf_and_nan():
    """A zero keeps its sign in h and the other parts are +0; inf stays
    inf in h with m = l = 0 (so its products are inf, not NaN); NaN stays
    NaN; beyond bf16's largest finite value h is inf."""
    z = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                      3.4e38, -3.4e38])
    h, m, l = gm.split_bf16x3(z)
    assert torch.equal(h[:2].view(torch.int16),
                       z[:2].to(torch.bfloat16).view(torch.int16))
    assert torch.equal(torch.signbit(h[:2]), torch.tensor([False, True]))
    assert not bool(m.float().isnan().any()) and not bool(
        l.float().isnan().any())
    assert not bool(m.float().any()) and not bool(l.float().any())
    assert torch.equal(h[2:4].float(), z[2:4]) and bool(h[4].isnan())
    assert bool(h[5:].float().isinf().all())


def test_split_loses_under_2_pow_minus_133_below_2_pow_minus_110():
    """Below about 2^-110, l falls under bf16's smallest subnormal
    (2^-133) and the part lost stays below it; at and above 2^-110 the
    split is exact."""
    low = _values(7, -126, -111)
    h, m, l = gm.split_bf16x3(low)
    lost = (_sum64((h, m, l)) - low.double()).abs()
    assert bool((lost < 2.0 ** -133).all())
    assert bool(lost.any())  # the range really loses somewhere
    edge = _values(8, -110, -100)
    assert torch.equal(_sum64(gm.split_bf16x3(edge)), edge.double())


@pytest.mark.parametrize("partner", [torch.bfloat16, torch.float8_e4m3fn])
def test_split_parts_times_a_bf16_partner_are_exact(partner):
    """Each part's f32 product with a bf16 value (or an e4m3 value
    widened to bf16) equals the f64 product, and the three f64-summed
    products equal z times the partner exactly: the tensor cores' bf16 x
    bf16 -> f32 products lose nothing."""
    z = _values(11, -40, 40)
    rng = np.random.default_rng(12)
    b = torch.from_numpy(rng.normal(size=z.numel()).astype(np.float32)).to(
        partner).to(torch.bfloat16)
    parts = gm.split_bf16x3(z)
    for p in parts:
        assert torch.equal((p.float() * b.float()).double(),
                           p.double() * b.double())
    prods = [(p.float() * b.float()) for p in parts]
    assert torch.equal(_sum64(prods), z.double() * b.double())


def _split_matmul(z, w):
    """z (R, K) f32 times w (K, N) of bf16 values as the kernels run it:
    the three parts' products, each exact, summed in f32."""
    wf = w.float()
    return sum(p.float() @ wf for p in reversed(gm.split_bf16x3(z)))


def _within_terms(got, want, terms):
    err = (got.double() - want.double()).abs()
    bound = K_TERMS * 2.0 ** -24 * (terms.double() + want.double().abs())
    return float((err / bound.clamp_min(1e-300)).max())


@pytest.mark.parametrize("partner", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("tile,te_list", [(4, [3, 0, 3, 1, 0, 3]),
                                          (10, [2, 2, 0, 4])])
def test_split_products_match_jax_custom_vjp(partner, tile, te_list):
    """dx = dz W[e]^T on weights of ``partner``'s values and dW = x^T dz
    on tokens of them, each as the sum of the three split products, per
    element within K_TERMS of ``jax.grad`` through the reference's
    custom VJP (its Pallas kernel in interpret mode, its f32 einsums);
    dW through the port's CSR of tiles, an expert with no tile 0."""
    rng = np.random.default_rng(tile)
    te = np.asarray(te_list, np.int32)
    e, d, f = 5, 48, 32
    t = len(te) * tile
    widen = lambda a: torch.from_numpy(a).to(partner).float().numpy()  # noqa: E731
    x = widen(rng.normal(size=(t, d)).astype(np.float32))
    w = widen((rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32))
    g = rng.normal(size=(t, f)).astype(np.float32)

    def jloss(xx, ww):
        y = jops.grouped_matmul(xx, jnp.asarray(te), ww, epilogue=JEp(),
                                token_tile=tile, f_tile=f, d_tile=d,
                                interpret=True)
        return jnp.sum(y * g)

    jdx, jdw = (np.array(a, np.float32) for a in jax.grad(
        jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w)))
    gz = torch.from_numpy(g).reshape(len(te), tile, f)
    wt = torch.from_numpy(w)[torch.from_numpy(te).long()]
    dx = torch.stack([_split_matmul(gz[i], wt[i].t().to(torch.bfloat16))
                      for i in range(len(te))]).reshape(t, d)
    tdx = torch.stack([gz[i].abs() @ wt[i].t().abs()
                       for i in range(len(te))]).reshape(t, d)
    assert _within_terms(dx, torch.from_numpy(jdx), tdx) <= 1.0
    xt = torch.from_numpy(x)
    offsets, order = gmd.tile_csr(torch.from_numpy(te), e)
    for ex in range(e):
        rows = (order[offsets[ex]:offsets[ex + 1]].long()[:, None] * tile
                + torch.arange(tile)).reshape(-1)
        want = torch.from_numpy(jdw[ex])
        if rows.numel() == 0:
            assert not bool(want.any())
            continue
        got = _split_matmul(torch.from_numpy(g)[rows].t().contiguous(),
                            xt[rows].to(torch.bfloat16)).t()
        terms = xt[rows].abs().t() @ torch.from_numpy(g)[rows].abs()
        assert _within_terms(got, want, terms) <= 1.0


@pytest.mark.parametrize("w_dtype", _TYPES, ids=str)
@pytest.mark.parametrize("x_dtype", _TYPES, ids=str)
def test_bwd_route_for_every_operand_pair(x_dtype, w_dtype):
    """dx takes the tensor cores exactly when the weights are bf16 or
    e4m3, dW exactly when the tokens are, at Qwen3-MoE's widths (D 4096,
    F 1536) with aligned operands; f32 and fp16 partners keep the CUDA
    cores."""
    d, f = 4096, 1536
    split = (torch.bfloat16, torch.float8_e4m3fn)
    for k in (d, f):  # dx's contraction: F for wg and wi, D for wo
        assert gm.gmm_bwd_route(w_dtype, k, k) == (
            "mma" if w_dtype in split else "fma")
    for dd, ff in ((d, f), (f, d)):
        assert gm.gmm_bwd_route(x_dtype, dd, ff) == (
            "mma" if x_dtype in split else "fma")


@pytest.mark.parametrize("dtype,row,z_row,p_addr,z_addr,route", [
    (torch.bfloat16, 72, 40, 0, 0, "mma"),     # rows of whole 16-byte copies
    (torch.bfloat16, 300, 20, 0, 0, "fma"),    # 600 bytes: not whole
    (torch.float8_e4m3fn, 40, 40, 0, 0, "fma"),
    (torch.float8_e4m3fn, 48, 20, 0, 0, "mma"),
    (torch.bfloat16, 64, 22, 0, 0, "fma"),     # dz rows of 22 f32
    (torch.bfloat16, 64, 64, 2, 0, "fma"),     # partner off 16 bytes
    (torch.bfloat16, 64, 64, 0, 8, "fma"),     # dz off 16 bytes
    (torch.float16, 64, 64, 0, 0, "fma")])
def test_bwd_route_refuses_rows_the_copies_cannot_take(dtype, row, z_row,
                                                       p_addr, z_addr,
                                                       route):
    assert gm.gmm_bwd_route(dtype, row, z_row, p_addr, z_addr) == route


def test_cpu_backward_wrappers_keep_their_plain_versions():
    """On CPU tensors both wrappers run their plain versions whatever the
    route would be on the card, and count no launch of either route."""
    g = torch.Generator().manual_seed(3)
    te = torch.tensor([1, 0, 1], dtype=torch.int32)
    dz = torch.randn(12, 32, generator=g)
    w = torch.randn(2, 48, 32, generator=g).bfloat16()
    before = (dict(gm.ROUTE_LAUNCHES), dict(gmd.ROUTE_LAUNCHES))
    got = gm.grouped_matmul(dz, te, w, token_tile=4, f_tile=48, d_tile=32,
                            w_trans=True)
    assert torch.equal(got, gm.grouped_matmul_plain(dz, te, w, token_tile=4,
                                                    w_trans=True))
    x = torch.randn(12, 48, generator=g).bfloat16()
    dw, _ = gmd.grouped_matmul_dw(x, dz, te, 2, token_tile=4,
                                  w_dtype=torch.float32)
    want, _ = gmd.grouped_matmul_dw_plain(x, dz, te, 2, token_tile=4,
                                          w_dtype=torch.float32)
    assert torch.equal(dw, want)
    assert (dict(gm.ROUTE_LAUNCHES), dict(gmd.ROUTE_LAUNCHES)) == before
