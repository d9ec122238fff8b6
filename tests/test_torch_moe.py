"""Parity of the port's MoE pieces with the JAX package on the same numpy
inputs: the grouped matmul (``repro_torch.kernels.grouped_matmul``, its
plain version on the CPU) against the JAX Pallas kernel in interpret
mode, ``expert_tile_map``, the op-level checks of
``kernels.ops.grouped_matmul``, and ``models.moe.apply_moe`` on both
dispatch paths (the grouped matmul and the einsum path) under the sum,
min and mean combines; the gradients of the grouped matmul (dx, dW, db)
and of ``apply_moe`` against ``jax.grad`` through the reference's
custom VJP.

Tolerance: f32 rtol = atol = 1e-5 for the grouped matmul (sums of 64
products taken in another order), plus one bf16 step (2^-7 of the
value) for a bf16 output; 1e-5 for ``apply_moe`` at the smoke size (64
wide, 4 experts top-2, f32), whose outputs are sums of a few such
products weighted by the gates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke
from repro.core import Epilogue as JEp
from repro.kernels.grouped_matmul import fit_tile as j_fit_tile
from repro.kernels.grouped_matmul import grouped_matmul as j_gmm
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import Epilogue as TEp
from repro_torch.kernels import grouped_matmul as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe

RTOL = ATOL = 1e-5
BF16_RTOL = 2.0 ** -7

EPILOGUES = {
    "none": {},
    "silu": {"activation": "silu"},
    "bias+silu": {"activation": "silu", "bias": True},
    "bf16": {"out_dtype": "bfloat16"},
}


def _gmm_inputs(tile, n_tiles, e=5, d=64, f=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_tiles * tile, d)).astype(np.float32)
    te = rng.integers(0, e, size=(n_tiles,)).astype(np.int32)
    w = (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32)
    b = rng.normal(size=(e, f)).astype(np.float32)
    return x, te, w, b


#: token_tile, f_tile and d_tile for the (4-row tiles, D 64, F 32) inputs
TILES = {"token_tile": 4, "f_tile": 32, "d_tile": 64}


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("ep_name", list(EPILOGUES))
@pytest.mark.parametrize("tile,n_tiles", [(4, 6), (10, 5), (128, 2)])
def test_grouped_matmul_matches_jax_kernel(tile, n_tiles, ep_name):
    x, te, w, b = _gmm_inputs(tile, n_tiles, seed=tile)
    kw = EPILOGUES[ep_name]
    bias = kw.get("bias", False)
    want = j_gmm(
        jnp.asarray(x), jnp.asarray(te), jnp.asarray(w),
        bias=jnp.asarray(b) if bias else None, epilogue=JEp(**kw),
        token_tile=tile, f_tile=16, d_tile=32, interpret=True)
    got = tgmm.grouped_matmul(
        torch.from_numpy(x), torch.from_numpy(te), torch.from_numpy(w),
        bias=torch.from_numpy(b) if bias else None, epilogue=TEp(**kw),
        token_tile=tile, f_tile=16, d_tile=32)
    assert got.dtype == (torch.bfloat16 if ep_name == "bf16"
                         else torch.float32)
    rtol = RTOL + (BF16_RTOL if ep_name == "bf16" else 0.0)
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=rtol,
                               atol=ATOL)


def test_grouped_matmul_bf16_operands_match_jax_kernel():
    """bf16 x and weights, upcast exactly on load and summed in f32."""
    x, te, w, _ = _gmm_inputs(10, 4, seed=3)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = j_gmm(jx, jnp.asarray(te), jw, token_tile=10,
                               f_tile=32, d_tile=64, interpret=True)
    got = tgmm.grouped_matmul(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(te),
                              torch.from_numpy(w).bfloat16(), token_tile=10,
                              f_tile=32, d_tile=64)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gs", [[40, 0, 70, 17], [1, 1, 1, 1],
                                [0, 0, 128, 0]])
def test_expert_tile_map_matches_jax(gs):
    gs = np.asarray(gs)
    for tt in (4, 10, 32):
        np.testing.assert_array_equal(tops.expert_tile_map(gs, tt),
                                      jops.expert_tile_map(gs, tt))


def test_fit_tile_matches_jax():
    for n in (1, 6, 64, 96, 1536, 4096):
        for t in (1, 4, 128, 512):
            assert tgmm.fit_tile(n, t) == j_fit_tile(n, t)


def test_grouped_matmul_refuses_what_the_reference_asserts():
    x, te, w, b = (torch.from_numpy(a) for a in _gmm_inputs(4, 3))
    tgmm.grouped_matmul(x, te, w, token_tile=4, f_tile=32, d_tile=64)
    with pytest.raises(ValueError, match="must divide"):
        tgmm.grouped_matmul(x, te, w, token_tile=4)  # 128 tiles, as JAX
    with pytest.raises(ValueError, match="residual"):
        tgmm.grouped_matmul(x, te, w, epilogue=TEp(residual=True),
                            **TILES)
    with pytest.raises(ValueError, match="bias"):
        tgmm.grouped_matmul(x, te, w, bias=b, **TILES)
    with pytest.raises(ValueError, match="per-expert"):
        tgmm.grouped_matmul(x, te, w, bias=b[:, :4],
                            epilogue=TEp(bias=True), **TILES)
    with pytest.raises(ValueError, match="multiple of token_tile"):
        tgmm.grouped_matmul(x, te, w, **{**TILES, "token_tile": 5})
    with pytest.raises(ValueError, match="one expert per token tile"):
        tgmm.grouped_matmul(x, te[:2], w, **TILES)
    with pytest.raises(ValueError, match="must divide"):
        tgmm.grouped_matmul(x, te, w, **{**TILES, "d_tile": 48})


def test_grouped_matmul_op_is_forward_only_and_checks_its_device():
    """The op's forward is the kernel wrapper's, under autograd or not;
    its gradients in x, the weights and the bias are the reference's
    custom VJP's (``src/repro/kernels/ops.py:304-325``; the name of this
    test predates the backward)."""
    x, te, w, b = (torch.from_numpy(a) for a in _gmm_inputs(4, 3))
    ep = TEp(activation="silu", bias=True)
    got = tops.grouped_matmul(x, te, w, bias=b, epilogue=ep, device="cpu",
                              **TILES)
    want = tgmm.grouped_matmul_plain(x, te, w, bias=b, epilogue=ep,
                                     token_tile=TILES["token_tile"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    wg = w.clone().requires_grad_()
    y = tops.grouped_matmul(x, te, wg, device="cpu", **TILES)
    torch.testing.assert_close(y.detach(), tgmm.grouped_matmul_plain(
        x, te, w, token_tile=TILES["token_tile"]), rtol=0, atol=0)
    y.sum().backward()
    assert wg.grad is not None and wg.grad.shape == w.shape
    with torch.no_grad():
        tops.grouped_matmul(x, te, wg, device="cpu", **TILES)
    with pytest.raises(ValueError, match="lies on"):
        tops.grouped_matmul(x.to("meta"), te, w, device="cpu", **TILES)


GRAD_CASES = {
    "silu+bias, unsorted, an empty expert": (
        {"activation": "silu", "bias": True}, [3, 0, 3, 1, 0, 3]),
    "none, sorted": ({}, [0, 0, 1, 2, 3, 4]),
    "gelu, tiles of 10": ({"activation": "gelu"}, [4, 2, 2, 0]),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_grouped_matmul_gradients_match_jax_custom_vjp(case):
    """dx, dW and db of ``kernels.ops.grouped_matmul`` (the port's custom
    VJP: z recomputed, the activation's VJP, dx through the transposed
    read, dW and db through the gradient kernel's plain version) against
    ``jax.grad`` through the reference's Pallas kernel and custom VJP in
    interpret mode, 1e-5 relative to each gradient's largest magnitude;
    an expert with no tile gets exactly 0."""
    kw, te_list = GRAD_CASES[case]
    tile = 10 if "10" in case else 4
    te = np.asarray(te_list, np.int32)
    rng = np.random.default_rng(len(case))
    e, d, f = 5, 64, 32
    x = rng.normal(size=(len(te) * tile, d)).astype(np.float32)
    w = (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32)
    b = rng.normal(size=(e, f)).astype(np.float32)
    g = rng.normal(size=(len(te) * tile, f)).astype(np.float32)
    bias = kw.get("bias", False)

    def jloss(xx, ww, bb):
        y = jops.grouped_matmul(xx, jnp.asarray(te), ww,
                                bias=bb if bias else None,
                                epilogue=JEp(**kw), token_tile=tile,
                                f_tile=32, d_tile=64, interpret=True)
        return jnp.sum(y * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(b))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = tops.grouped_matmul(xt, torch.from_numpy(te), wt,
                            bias=bt if bias else None, epilogue=TEp(**kw),
                            device="cpu", token_tile=tile, f_tile=32,
                            d_tile=64)
    (y * torch.from_numpy(g)).sum().backward()
    got = [xt.grad, wt.grad] + ([bt.grad] if bias else [])
    for name, gt, wn in zip(("dx", "dW", "db"), got, want):
        wn = _np(wn)
        err = float(np.abs(gt.numpy() - wn).max() / np.abs(wn).max())
        assert err <= RTOL, (name, err)
    for i in set(range(e)) - set(te_list):
        assert not wt.grad[i].any()


@pytest.mark.parametrize("kernel_dispatch", [True, False])
def test_apply_moe_gradients_match_jax(kernel_dispatch):
    """Gradients of a loss of ``apply_moe``'s output and aux loss in the
    tokens, the router (through the stable sort's top values and the
    combine's scatter) and the three expert weights, on both dispatch
    paths, against ``jax.grad`` of the reference's (its Pallas kernel in
    interpret mode on the kernel path), 1e-5 relative to each gradient's
    largest magnitude."""
    jcfg, tcfg, jp, tp, x = _moe_case(kernel_dispatch, t=24, seed=2)
    g = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.apply_moe(jcfg, p, xx, None)
        return jnp.sum(out * g) + 0.5 * aux

    want = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.apply_moe(tcfg, tp, xt, device="cpu")
    ((out * torch.from_numpy(g)).sum() + 0.5 * aux).backward()
    for name, gt, wn in [("x", xt.grad, want[1])] + [
            (k, tp[k].grad, want[0][k]) for k in ("router", "wg", "wi",
                                                   "wo")]:
        wn = _np(wn)
        err = float(np.abs(gt.numpy() - wn).max() / np.abs(wn).max())
        assert err <= RTOL, (name, err)


def _moe_case(kernel_dispatch, t=24, seed=0):
    jcfg = jsmoke(JARCHS["qwen3-moe-235b-a22b"]).scaled(
        moe_pallas_dispatch=kernel_dispatch)
    tcfg = smoke_config(ARCHS["qwen3-moe-235b-a22b"]).scaled(
        moe_kernel_dispatch=kernel_dispatch)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed + 1).normal(
        size=(t, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("combine", ["sum", "min", "mean"])
@pytest.mark.parametrize("kernel_dispatch", [True, False])
def test_apply_moe_matches_jax(kernel_dispatch, combine):
    jcfg, tcfg, jp, tp, x = _moe_case(kernel_dispatch)
    want, want_aux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x), None,
                                    combine=combine)
    got, got_aux = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x),
                                  combine=combine, device="cpu")
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=RTOL)


def test_apply_moe_paths_agree_and_mesh_raises():
    _, tcfg, _, tp, x = _moe_case(True, t=40, seed=5)
    xt = torch.from_numpy(x)
    k, _ = tmoe.apply_moe(tcfg, tp, xt, device="cpu")
    e, _ = tmoe.apply_moe(tcfg.scaled(moe_kernel_dispatch=False), tp, xt,
                          device="cpu")
    torch.testing.assert_close(k, e, rtol=RTOL, atol=ATOL)
    for t in (1, 4, 10, 40, 128, 4096):
        assert tmoe._capacity(tcfg, t) == jmoe._capacity(tcfg, t)
    ctx = tmoe.ShardingCtx(mesh=object(), data_axes=("data",),
                           model_axis="model")
    with pytest.raises(NotImplementedError, match="item 5"):
        tmoe.apply_moe(tcfg, tp, xt, ctx, device="cpu")
