"""Parity of the port's other model families with the JAX package: the
hybrid (``models.hybrid``), the encoder-decoder (``models.encdec``) and
the VLM (``models.vlm``) on the reference's parameters
(``models.registry.params_from_jax``) at the reference's smoke sizes (2
layers, d_model 64, 4 heads of 16 over 2 kv heads, or 1 for PaliGemma,
vocab 128; SSM state 8, heads of 16, chunk 16; 2 encoder layers over 24
frames; 8 vision tokens; f32), on the same numpy-seeded batches:
forward, loss and every gradient, prefill, teacher-forced decode and
greedy decode steps.  Then the registry and configs of all ten
architectures (parameter and cache trees leaf for leaf against the
reference's), and ``ServeEngine`` on the two state models against the
JAX engine.

Tolerance ``LM_TOL`` 1e-4 for a whole model, as ``test_torch_lm.py``;
greedy tokens must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke
from repro.models import encdec as jencdec
from repro.models import get_model as jget_model
from repro.models import hybrid as jhybrid
from repro.models import vlm as jvlm
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.models import get_model
from repro_torch.models.registry import MODULES, params_from_jax
from repro_torch.serve import Request, ServeEngine

LM_TOL = 1e-4
MAX_LEN = 32
FAMILY_ARCHS = ["hymba-1.5b", "whisper-large-v3", "paligemma-3b"]
JAX_MODULES = {"hybrid": jhybrid, "encdec": jencdec, "vlm": jvlm}


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


def _close(got, want, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=LM_TOL,
                               atol=LM_TOL, err_msg=msg)


def _jax_paths(tree):
    """{path: leaf} of a JAX tree, each path the tuple of dict keys and
    sequence indices, as ``tree_leaves_with_path`` gives the port's."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): v
            for p, v in flat}


@pytest.fixture(scope="module")
def built():
    """name -> (jcfg, tcfg, japi, jparams, tapi, tparams), built once."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg = jsmoke(JARCHS[name])
            tcfg = tconfigs.smoke_config(tconfigs.get_config(name))
            japi = jget_model(jcfg)
            jparams = jax.jit(japi.init)(jax.random.PRNGKey(7))
            cache[name] = (jcfg, tcfg, japi, jparams, get_model(tcfg),
                           params_from_jax(tcfg, jparams, device="cpu"))
        return cache[name]

    return get


def _batch(cfg, s=17, seed=2):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.normal(
            size=(2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["encoder_embeds"] = rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def _sides(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_forward_loss_and_gradients_match_reference(built, name):
    jcfg, tcfg, japi, jparams, tapi, tparams = built(name)
    jb, tb = _sides(_batch(tcfg))
    jmod, tmod = JAX_MODULES[jcfg.family], MODULES[tcfg.family]
    jout = jmod.forward(jcfg, jparams,
                        jb if tcfg.family in ("encdec", "vlm")
                        else jb["tokens"])
    tout = tmod.forward(tcfg, tparams,
                        tb if tcfg.family in ("encdec", "vlm")
                        else tb["tokens"])
    if tcfg.family == "encdec":  # logits alone, as the reference's
        jout, tout = (jout, None), (tout, None)
    _close(tout[0], jout[0])
    jl, jg = jax.jit(jax.value_and_grad(japi.loss))(jparams, jb)
    want = _jax_paths(jg)
    leaves = tree_leaves_with_path(tparams)
    for _, p in leaves:
        p.requires_grad_(True)
    try:
        tl = tapi.loss(tparams, tb)
        grads = torch.autograd.grad(tl, [p for _, p in leaves])
    finally:
        for _, p in leaves:
            p.requires_grad_(False)
    _close(tl.detach(), jl)
    def stacked(path):  # the reference's path: layers on a leading axis
        return path[0] in ("layers", "enc_layers", "dec_layers")

    assert set(want) == {(p[0],) + p[2:] if stacked(p) else p
                         for p, _ in leaves}
    for (path, _), g in zip(leaves, grads):
        assert bool(torch.isfinite(g).all()), path
        w = (want[(path[0],) + path[2:]][path[1]] if stacked(path)
             else want[path])
        _close(g, w, str(path))


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_prefill_and_decode_match_reference(built, name):
    """Prefill of 16 tokens, then decode of token 17 (teacher forced: it
    equals the prefill of all 17, on both sides) and two greedy steps,
    the logits and every leaf of the cache against the reference's."""
    jcfg, tcfg, japi, jparams, tapi, tparams = built(name)
    batch = _batch(tcfg)
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    jb, tb = _sides(short)
    jl, jc = japi.prefill(jparams, jb, MAX_LEN)
    tl, tc = tapi.prefill(tparams, tb, MAX_LEN)
    n_prefix = tcfg.n_vision_tokens if tcfg.family == "vlm" else 0
    for step in range(3):
        _close(tl, jl, f"step {step}")
        jleaves = _jax_paths(jc)
        tleaves = dict(tree_leaves_with_path(tc))
        assert set(jleaves) == set(tleaves)
        for path, w in jleaves.items():
            assert np.shape(tleaves[path]) == w.shape, path
            _close(tleaves[path], w, str(path))
        assert tc["pos"] == n_prefix + 16 + step
        nxt = (batch["tokens"][:, -1] if step == 0
               else np.array(jnp.argmax(jl, axis=-1), np.int32))
        if step:
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jc = japi.decode_step(jparams, jc, jnp.asarray(nxt))
        tl, tc = tapi.decode_step(tparams, tc, torch.from_numpy(nxt))
        if step == 0:
            full, _ = tapi.prefill(tparams, _sides(batch)[1], MAX_LEN)
            _close(tl, full, "teacher-forced decode against prefill")


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_registry_builds_every_architecture(name):
    """The config equals the reference's, and the port's parameters and
    cache have the reference's tree: the same leaves at the same paths,
    shapes and types (the reference's layers unstacked)."""
    jcfg, tcfg = jsmoke(JARCHS[name]), tconfigs.smoke_config(
        tconfigs.get_config(name))
    assert tcfg.family == jcfg.family
    for f in ("d_inner", "ssm_heads", "sub_quadratic", "has_decode"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    shapes = jax.eval_shape(japi.init, jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = {p: (tuple(t.shape), t.dtype)
            for p, t in tree_leaves_with_path(
                params_from_jax(tcfg, zeros, device="cpu"))}
    got = {p: (tuple(t.shape), t.dtype) for p, t in tree_leaves_with_path(
        tapi.init(torch.Generator().manual_seed(0), device="cpu"))}
    assert got == want
    jcache = _jax_paths(jax.eval_shape(lambda: japi.init_cache(2, MAX_LEN)))
    tcache = dict(tree_leaves_with_path(tapi.init_cache(2, MAX_LEN,
                                                        device="cpu")))
    assert {p: np.shape(v) for p, v in tcache.items()} == {
        p: v.shape for p, v in jcache.items()}


@pytest.mark.parametrize("name", ["mamba2-2.7b", "hymba-1.5b"])
def test_serve_engine_matches_reference(built, name):
    """Greedy serving of 5 equal-length prompts over 2 slots (three
    waves): the engine splices every leaf of the state models' caches
    (keys and values, the mixer's states and conv windows)."""
    _, tcfg, japi, jparams, tapi, tparams = built(name)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, size=7, dtype=np.int32)
               for _ in range(5)]
    jeng = JEngine(japi, jparams, slots=2, max_len=16)
    teng = ServeEngine(tapi, tparams, slots=2, max_len=16, device="cpu")
    for rid, p in enumerate(prompts):
        jeng.submit(JRequest(rid=rid, prompt=p, max_new_tokens=5))
        teng.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
    got = teng.run_to_completion()
    assert got == jeng.run_to_completion() and len(got) == 5
    assert all(len(v) == 5 for v in got.values())
