"""Parity of the port's LM serving path with the JAX package: the configs
(``repro_torch.configs``), the norms, rotary embedding and attention of
``models.layers`` and ``models.attention``, ``forward``, ``prefill``
and ``decode_step`` of ``models.transformer`` on the reference's
parameters (``params_from_jax``) for a dense and a MoE config, and the
serving engine's greedy tokens, all at the reference's smoke sizes (2 layers,
d_model 64, 4 heads of 16 over 2 kv heads, vocab 128; MoE 4 experts
top-2; f32).  The port's MoE runs its grouped-matmul path (the plain
version on the CPU), the reference its einsum path.

Tolerance: rtol = atol = 1e-5 for single layers and attention (f32 sums
in another order: torch's products against XLA's, and
``scaled_dot_product_attention`` against the chunked online softmax);
1e-4 for logits and caches through the two layers and the tied
unembedding.  Greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import get_model as jget_model
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import get_model
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve import Request, ServeEngine

RTOL = ATOL = 1e-5
LM_TOL = 1e-4

#: Fields of the reference's ModelConfig the port leaves out (XLA only).
DROPPED = {"remat", "seq_parallel_attn", "scan_unroll", "ssd_unroll",
           "decode_inplace_cache", "moe_pallas_dispatch"}


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("name", sorted(tconfigs.ARCHS))
def test_configs_match_reference(name):
    t, j = tconfigs.get_config(name), JARCHS[name]
    tf = {f.name for f in dataclasses.fields(t)}
    jf = {f.name for f in dataclasses.fields(j)}
    assert tf == (jf - DROPPED) | {"moe_kernel_dispatch"}
    for f in tf - {"moe_kernel_dispatch"}:
        assert getattr(t, f) == getattr(j, f), f
    assert t.moe_kernel_dispatch is True
    ts, js = tconfigs.smoke_config(t), jsmoke(j)
    for f in tf - {"moe_kernel_dispatch"}:
        assert getattr(ts, f) == getattr(js, f), f
    assert (t.attn_dim, t.kv_dim) == (j.attn_dim, j.kv_dim)


def test_other_families_are_not_ported():
    assert set(tconfigs.ARCHS) | set(tconfigs.NOT_PORTED) == set(JARCHS)
    for name, family in tconfigs.NOT_PORTED.items():
        assert JARCHS[name].family == family
        with pytest.raises(NotImplementedError, match="item 6"):
            tconfigs.get_config(name)
        with pytest.raises(NotImplementedError, match="item 6"):
            get_model(JARCHS[name])
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")


def test_norms_rope_and_dense_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    jx, js, jb = (jnp.asarray(a) for a in (x, scale, bias))
    np.testing.assert_allclose(tlayers.rmsnorm(tx, ts).numpy(),
                               _np(jlayers.rmsnorm(jx, js)), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tlayers.layernorm(tx, ts, tb).numpy(),
                               _np(jlayers.layernorm(jx, js, jb)),
                               rtol=RTOL, atol=ATOL)
    for pos in (np.arange(5), np.array([[7.0] * 5, [3.0] * 5])):
        np.testing.assert_allclose(
            tlayers.apply_rope(tx, torch.from_numpy(pos), 1e6).numpy(),
            _np(jlayers.apply_rope(jx, jnp.asarray(pos), 1e6)), rtol=RTOL,
            atol=ATOL)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.dense(tx, torch.from_numpy(w), tb[:8]).numpy(),
        _np(jlayers.dense(jx, jnp.asarray(w), jb[:8])), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kv_heads", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_reference(causal, kv_heads):
    """GQA: query head h reads kv head h // (H / KH)."""
    rng = np.random.default_rng(kv_heads)
    q = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 12, kv_heads, 16)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = _np(jattn.flash_attention(jq, jk, jv, causal, 4, 4))
    np.testing.assert_allclose(
        tattn.flash_attention(tq, tk, tv, causal).numpy(), want, rtol=RTOL,
        atol=ATOL)
    np.testing.assert_allclose(
        tattn.attention_ref(tq, tk, tv, causal).numpy(),
        _np(jattn.attention_ref(jq, jk, jv, causal)), rtol=RTOL, atol=ATOL)
    pos = 6  # cache entries 0..6 valid, the rest ignored
    np.testing.assert_allclose(
        tattn.decode_attention(tq[:, 0], tk, tv, pos).numpy(),
        _np(jattn.decode_attention(jq[:, 0], jk, jv, jnp.asarray(pos))),
        rtol=RTOL, atol=ATOL)


def _models(name):
    jcfg = jsmoke(JARCHS[name])
    tcfg = tconfigs.smoke_config(tconfigs.ARCHS[name])
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(3))
    tparams = params_from_jax(tcfg, jparams, device="cpu")
    return jcfg, tcfg, japi, jparams, get_model(tcfg), tparams


@pytest.mark.parametrize("name", ["qwen2-7b", "qwen3-moe-235b-a22b"])
def test_prefill_and_decode_match_reference(name):
    jcfg, tcfg, japi, jparams, tapi, tparams = _models(name)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                             size=(2, 9)).astype(np.int32)
    max_len = 12
    jf, jaux = jtransformer.forward(jcfg, jparams, jnp.asarray(toks))
    tf, taux = ttransformer.forward(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tf.numpy(), _np(jf), rtol=LM_TOL,
                               atol=LM_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=LM_TOL,
                               atol=LM_TOL)
    jl, jc = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tc = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                          max_len)
    assert tc["k"].shape == (tcfg.n_layers, 2, max_len, tcfg.n_kv_heads,
                             tcfg.d_head)
    for step in range(3):
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=LM_TOL,
                                   atol=LM_TOL, err_msg=f"step {step}")
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]),
                                       rtol=LM_TOL, atol=LM_TOL)
        assert tc["pos"] == int(jc["pos"]) == 9 + step
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jc = japi.decode_step(jparams, jc, jnp.asarray(nxt))
        tl, tc = tapi.decode_step(tparams, tc, torch.from_numpy(nxt))


def _prompts(n, length, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=length, dtype=np.int32)
            for _ in range(n)]


def test_serve_engine_matches_reference():
    """Greedy serving of 5 equal-length prompts over 2 slots (three
    waves); the engines share the reference's one ``pos`` for all
    slots."""
    _, tcfg, japi, jparams, tapi, tparams = _models("qwen3-moe-235b-a22b")
    prompts = _prompts(5, 7, tcfg.vocab_size)
    jeng = JEngine(japi, jparams, slots=2, max_len=16)
    teng = ServeEngine(tapi, tparams, slots=2, max_len=16, device="cpu")
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=5))
        teng.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
    want = jeng.run_to_completion()
    got = teng.run_to_completion()
    assert got == want and len(got) == 5
    assert all(len(v) == 5 for v in got.values())


def test_serve_engine_matches_reference_at_an_exact_fit():
    """A request whose last decode step writes the cache's last position
    (``len(prompt) + max_new_tokens - 1 == max_len``) is served, and its
    tokens equal the JAX engine's."""
    _, tcfg, japi, jparams, tapi, tparams = _models("qwen2-7b")
    prompts = _prompts(2, 7, tcfg.vocab_size, seed=4)
    jeng = JEngine(japi, jparams, slots=2, max_len=10)
    teng = ServeEngine(tapi, tparams, slots=2, max_len=10, device="cpu")
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=4))
        teng.submit(Request(rid=rid, prompt=p, max_new_tokens=4))
    got = teng.run_to_completion()
    assert got == jeng.run_to_completion()
    assert sorted(got) == [0, 1] and all(len(v) == 4 for v in got.values())


def test_submit_refuses_a_request_past_max_len():
    cfg = tconfigs.smoke_config(tconfigs.ARCHS["qwen2-7b"])
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(api, params, slots=2, max_len=10, device="cpu")
    prompt = _prompts(1, 7, cfg.vocab_size)[0]
    with pytest.raises(ValueError, match="need 11 cache positions, more "
                                         "than max_len 10"):
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=5))
    assert not eng.queue
    eng.submit(Request(rid=1, prompt=prompt, max_new_tokens=4))
    assert len(eng.queue) == 1


def test_decode_step_refuses_pos_past_max_len():
    """``decode_step`` raises before it writes the cache when ``pos`` is
    not a position of it."""
    cfg = tconfigs.smoke_config(tconfigs.ARCHS["qwen2-7b"])
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    cache = api.init_cache(2, 10, device="cpu")
    cache["pos"] = 10
    toks = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="pos 10 is outside the cache's "
                                         "max_len 10"):
        api.decode_step(params, cache, toks)
    assert not cache["k"].any() and not cache["v"].any()
    cache["pos"] = 9
    logits, cache = api.decode_step(params, cache, toks)
    assert cache["pos"] == 10 and bool(torch.isfinite(logits).all())


def test_temperature_sampling_is_seeded():
    cfg = tconfigs.smoke_config(tconfigs.ARCHS["qwen2-7b"])
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    outs = []
    for seed in (7, 7, 8):
        eng = ServeEngine(api, params, slots=2, max_len=16, temperature=1.0,
                          seed=seed, device="cpu")
        for rid, p in enumerate(_prompts(2, 5, cfg.vocab_size)):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=8))
        outs.append(eng.run_to_completion())
    assert outs[0] == outs[1] and outs[0] != outs[2]


def test_launcher_serves_on_the_cpu():
    from repro_torch.launch.serve import main

    res = main(["--arch", "qwen3-moe-235b-a22b", "--requests", "3",
                "--max-new", "4", "--device", "cpu"])
    assert sorted(res) == [0, 1, 2] and all(len(v) == 4
                                            for v in res.values())


def test_lm_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import main
    from repro_torch.models.moe import apply_moe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.smoke_config(tconfigs.ARCHS["qwen3-moe-235b-a22b"])
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    moe = params["layers"][0]["moe"]
    x = torch.zeros(8, cfg.d_model)
    te = torch.zeros(2, dtype=torch.int32)
    for call in (lambda: api.init(torch.Generator().manual_seed(0)),
                 lambda: api.init_cache(2, 8),
                 lambda: ServeEngine(api, params),
                 lambda: apply_moe(cfg, moe, x),
                 lambda: kops.grouped_matmul(x, te, moe["wg"], token_tile=4,
                                             f_tile=64, d_tile=64),
                 lambda: main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="generator lies on"):
        api.init(torch.Generator().manual_seed(0), device="meta")
