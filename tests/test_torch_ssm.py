"""Parity of the port's Mamba-2 mixer (``repro_torch.models.mamba2``) and
SSM language model (``models.ssm_lm``) with the JAX package, on the same
numpy-seeded inputs and the reference's parameters (``params_from_jax``),
at the reference's smoke sizes (2 layers, d_model 64, SSM state 8, heads
of 16, chunk 16, vocab 128; f32).

Tolerance: rtol = atol = 1e-5 for one mixer (the same f32 terms summed
in another order: the port's two-operand products against XLA's einsums);
``LM_TOL`` 1e-4 for a whole model, as ``test_torch_lm.py``.

The SSD's masked exponential: the reference forms ``exp(decay)`` above
the diagonal before it masks it, which overflows once a chunk's sum of
``dt * |a|`` passes about 88 and turns its gradients NaN; the port masks
first (ROADMAP.md §3 item 13).  At chunk 128 and ``dt = 1.0`` the test
shows the reference's ``d/d dt`` non-finite and the port's finite and
within ``REC_TOL`` relative L2 of an f64 token-by-token recurrence; at
``dt = 0.5`` both are finite and equal within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models import mamba2 as jm
from repro.models import ssm_lm as jssm
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.models import get_model
from repro_torch.models import mamba2 as tm
from repro_torch.models import ssm_lm as tssm
from repro_torch.models.transformer import params_from_jax

RTOL = ATOL = 1e-5
LM_TOL = 1e-4
#: The port's f32 chunked scan against the f64 recurrence, relative L2 of
#: the gradient: f32 cumulative sums of 128 decays of about 1 each.
REC_TOL = 1e-4
ARCH = "mamba2-2.7b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread for this module: its problems are small, and
    under the suite's parallel workers every process's thread pool
    spanning all cores made them tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def model():
    """The smoke config, both packages' APIs and the same parameters."""
    jcfg = jsmoke(JARCHS[ARCH])
    tcfg = tconfigs.smoke_config(tconfigs.get_config(ARCH))
    japi = jget_model(jcfg)
    jparams = jax.jit(japi.init)(jax.random.PRNGKey(5))
    return jcfg, tcfg, japi, jparams, get_model(tcfg), params_from_jax(
        tcfg, jparams, device="cpu")


def _mixer_params(model, layer=0):
    jcfg, tcfg, _, jparams, _, tparams = model
    jp = jax.tree.map(lambda a: a[layer], jparams["layers"]["mixer"])
    return jcfg, tcfg, jp, tparams["layers"][layer]["mixer"]


def _ssd_inputs(seed, s, h=4, p=8, g=2, n=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(2, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    b_in = rng.normal(size=(2, s, g, n)).astype(np.float32)
    c_in = rng.normal(size=(2, s, g, n)).astype(np.float32)
    d = rng.normal(size=(h,)).astype(np.float32)
    init = rng.normal(size=(2, h, n, p)).astype(np.float32)
    return x, dt, a, b_in, c_in, d, init


def test_conv1d_causal_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    _close(tm._conv1d_causal(*map(torch.from_numpy, (x, w, b))),
           jm._conv1d_causal(*map(jnp.asarray, (x, w, b))), RTOL)


@pytest.mark.parametrize("s, chunk", [(32, 8), (29, 8), (5, 16), (40, 40)])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_reference(s, chunk, with_init):
    """Padded sequences (29 and 5 are no multiple of their chunk), grouped
    heads (G = 2 of H = 4), with and without an initial state."""
    x, dt, a, b_in, c_in, d, init = _ssd_inputs(s, s)
    init = init if with_init else None
    jy, jst = jm.ssd_chunked(
        *map(jnp.asarray, (x, dt, a, b_in, c_in)), chunk, jnp.asarray(d),
        None if init is None else jnp.asarray(init))
    ty, tst = tm.ssd_chunked(
        *map(torch.from_numpy, (x, dt, a, b_in, c_in)), chunk,
        torch.from_numpy(d), None if init is None else torch.from_numpy(init))
    assert ty.shape == (2, s, 4, 8) and tst.shape == (2, 4, 6, 8)
    _close(ty, jy, RTOL)
    _close(tst, jst, RTOL)


def test_mixer_fwd_and_its_state_match_reference(model):
    jcfg, tcfg, jp, tp = _mixer_params(model)
    for s in (23, 2):  # 2 < conv_kernel - 1: the window is zero-padded
        x = np.random.default_rng(s).normal(
            size=(2, s, tcfg.d_model)).astype(np.float32)
        jout, jst = jm.mixer_fwd(jcfg, jp, jnp.asarray(x), return_state=True)
        tout, tst = tm.mixer_fwd(tcfg, tp, torch.from_numpy(x),
                                 return_state=True)
        _close(tout, jout, RTOL)
        assert set(tst) == set(jst)
        for k in jst:
            assert tst[k].shape == jst[k].shape, k
            _close(tst[k], jst[k], RTOL)
        _close(tm.mixer_fwd(tcfg, tp, torch.from_numpy(x)), jout, RTOL)


def test_mixer_decode_matches_reference(model):
    """Three tokens through the recurrence from a prefilled state."""
    jcfg, tcfg, jp, tp = _mixer_params(model, layer=1)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, tcfg.d_model)).astype(np.float32)
    _, jc = jm.mixer_fwd(jcfg, jp, jnp.asarray(x), return_state=True)
    _, tc = tm.mixer_fwd(tcfg, tp, torch.from_numpy(x), return_state=True)
    for step in range(3):
        tok = rng.normal(size=(2, tcfg.d_model)).astype(np.float32)
        jy, jc = jm.mixer_decode(jcfg, jp, jc, jnp.asarray(tok))
        ty, tc = tm.mixer_decode(tcfg, tp, tc, torch.from_numpy(tok))
        _close(ty, jy, RTOL)
        for k in jc:
            _close(tc[k], jc[k], RTOL)
    zero = tm.init_mixer_cache(tcfg, 2, device="cpu")
    jzero = jm.init_mixer_cache(jcfg, 2)
    assert {k: tuple(v.shape) for k, v in zero.items()} == {
        k: v.shape for k, v in jzero.items()}
    assert zero["ssm"].dtype == torch.float32


def _tokens(model, s=21, seed=1):
    return np.random.default_rng(seed).integers(
        0, model[1].vocab_size, size=(2, s)).astype(np.int32)


def test_forward_loss_and_gradients_match_reference(model):
    jcfg, tcfg, japi, jparams, tapi, tparams = model
    toks = _tokens(model)
    jf, _ = jssm.forward(jcfg, jparams, jnp.asarray(toks))
    tf, taux = tssm.forward(tcfg, tparams, torch.from_numpy(toks))
    _close(tf, jf, LM_TOL)
    assert float(taux) == 0.0
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(
        jparams, {"tokens": jnp.asarray(toks)})
    want = params_from_jax(tcfg, jg, device="cpu")
    leaves = tree_leaves_with_path(tparams)
    for _, p in leaves:
        p.requires_grad_(True)
    try:
        tl = tapi.loss(tparams, {"tokens": torch.from_numpy(toks)})
        grads = torch.autograd.grad(tl, [p for _, p in leaves])
    finally:
        for _, p in leaves:
            p.requires_grad_(False)
    _close(tl.detach(), jl, LM_TOL)
    wanted = dict(tree_leaves_with_path(want))
    assert len(wanted) == len(leaves)
    for (path, _), g in zip(leaves, grads):
        assert bool(torch.isfinite(g).all()), path
        np.testing.assert_allclose(g.numpy(), _np(wanted[path]),
                                   rtol=LM_TOL, atol=LM_TOL,
                                   err_msg=str(path))


def test_prefill_and_decode_match_reference(model):
    """Prefill of a 20-token prompt, then three greedy decode steps, the
    cache (L, B, ...) leaf by leaf; then teacher forcing: the decode of
    token 21 after a prefill of 20 equals the prefill of all 21."""
    jcfg, tcfg, japi, jparams, tapi, tparams = model
    toks = _tokens(model)
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks[:, :-1])}, 32)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :-1])},
                          32)
    assert tc["pos"] == int(jc["pos"]) == 20
    for step in range(3):
        _close(tl, jl, LM_TOL)
        for k in ("ssm", "conv_x", "conv_bc"):
            assert tuple(tc["layers"][k].shape) == jc["layers"][k].shape
            _close(tc["layers"][k], jc["layers"][k], LM_TOL)
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        if step == 0:
            nxt = toks[:, -1]
        jl, jc = japi.decode_step(jparams, jc, jnp.asarray(nxt))
        tl, tc = tapi.decode_step(tparams, tc, torch.from_numpy(nxt))
        assert tc["pos"] == int(jc["pos"]) == 21 + step
        if step == 0:
            full, _ = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                   32)
            _close(tl, full, LM_TOL)
    empty = tapi.init_cache(2, 32, device="cpu")
    jempty = japi.init_cache(2, 32)
    assert {k: tuple(v.shape) for k, v in empty["layers"].items()} == {
        k: v.shape for k, v in jempty["layers"].items()}


# --------------------------------------------------- the masked exponential

SSD_B, SSD_S, SSD_H, SSD_P, SSD_N = 1, 128, 2, 4, 4


def _ssd_case(dt_value):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(SSD_B, SSD_S, SSD_H, SSD_P)).astype(np.float32)
    b_in = (0.5 * rng.normal(size=(SSD_B, SSD_S, 1, SSD_N))).astype(
        np.float32)
    c_in = (0.5 * rng.normal(size=(SSD_B, SSD_S, 1, SSD_N))).astype(
        np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    dt = np.full((SSD_B, SSD_S, SSD_H), dt_value, np.float32)
    a = -np.ones(SSD_H, np.float32)
    d = np.ones(SSD_H, np.float32)
    return x, dt, a, b_in, c_in, d, w


def _jax_dt_grad(x, dt, a, b_in, c_in, d, w):
    def objective(dt):
        y, _ = jm.ssd_chunked(jnp.asarray(x), dt, jnp.asarray(a),
                              jnp.asarray(b_in), jnp.asarray(c_in), 128,
                              jnp.asarray(d))
        return jnp.sum(y * w)

    return np.asarray(jax.grad(objective)(jnp.asarray(dt)))


def _port_dt_grad(x, dt, a, b_in, c_in, d, w):
    tdt = torch.from_numpy(dt).requires_grad_(True)
    y, _ = tm.ssd_chunked(torch.from_numpy(x), tdt, torch.from_numpy(a),
                          torch.from_numpy(b_in), torch.from_numpy(c_in), 128,
                          torch.from_numpy(d))
    (y * torch.from_numpy(w)).sum().backward()
    return tdt.grad.numpy()


def _recurrence_dt_grad(x, dt, a, b_in, c_in, d, w):
    """d/d dt of the same objective through the token-by-token
    recurrence in f64: state = exp(dt a) state + dt B x^T, y = C state +
    D x."""
    x, a, b_in, c_in, d, w = (torch.from_numpy(t).double()
                              for t in (x, a, b_in, c_in, d, w))
    tdt = torch.from_numpy(dt).double().requires_grad_(True)
    state = torch.zeros(SSD_B, SSD_H, SSD_N, SSD_P, dtype=torch.float64)
    total = 0.0
    for t in range(SSD_S):
        state = (state * torch.exp(tdt[:, t] * a)[..., None, None]
                 + (tdt[:, t, :, None] * b_in[:, t, 0][:, None, :])[..., None]
                 * x[:, t][:, :, None, :])
        y = (torch.einsum("bn,bhnp->bhp", c_in[:, t, 0], state)
             + d[None, :, None] * x[:, t])
        total = total + (y * w[:, t]).sum()
    total.backward()
    return tdt.grad.numpy()


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """dt = 1 and a = -1 sum to 128 over a chunk of 128: the reference's
    exp(decay) overflows above the diagonal and its d/d dt is NaN; the
    port's forward is the same bits and its gradient is finite and that
    of the f64 recurrence."""
    case = _ssd_case(1.0)
    jgrad = _jax_dt_grad(*case)
    assert not np.isfinite(jgrad).all()
    got = _port_dt_grad(*case)
    assert np.isfinite(got).all()
    want = _recurrence_dt_grad(*case)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < REC_TOL
    x, dt, a, b_in, c_in, d, _ = case
    jy, _ = jm.ssd_chunked(*map(jnp.asarray, (x, dt, a, b_in, c_in)), 128,
                           jnp.asarray(d))
    ty, _ = tm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, b_in, c_in)),
                           128, torch.from_numpy(d))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_ssd_gradient_matches_the_reference_where_it_is_finite():
    case = _ssd_case(0.5)
    jgrad = _jax_dt_grad(*case)
    assert np.isfinite(jgrad).all()
    got = _port_dt_grad(*case)
    np.testing.assert_allclose(got, jgrad, rtol=RTOL,
                               atol=RTOL * np.abs(jgrad).max())
    want = _recurrence_dt_grad(*case)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < REC_TOL
