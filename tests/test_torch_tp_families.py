"""The reference's specs as the port applies them in the ssm, hybrid and
encdec families, held against the JAX package.

Four gloo ranks on the CPU (``python -c`` children, ``PYTHONPATH=src``,
meeting at a ``FileStore`` under ``tmp_path``, each under its own
timeout, all killed at the first failure) run the smoke mamba2-2.7b,
hymba-1.5b and whisper-large-v3 on (data, model) meshes (2, 2) and
(1, 4), with numpy-built weights (by path, shared verbatim with the JAX
side) carried across by ``params_from_jax`` and cut by
``sharding.shard_params``: the mamba rules, the FSDP attention weights,
the dense MLP's split, the vocab-sharded embedding, and the caches'
splits (the KV caches' sequence, the cross-attention's head_dim, the
SSM state's heads and the conv windows' channels).  The widths:

- hymba at ``d_model=48``: d_inner 96, H = 6 heads of 16 channels, so at
  (1, 4) a rank holds 24 channels, 1.5 heads (its heads straddle ranks,
  ``dt_proj``, ``A_log``, ``D`` and ``dt_bias`` fall back to whole and
  so does the SSM state, gathered after each step), at (2, 2) 3 heads;
- whisper at a vocabulary of 130, which splits over a model axis of 2
  and falls back to whole over 4 (as whisper's 51866 does at 2 and 4);
  its cross-attention cache splits head_dim 16 into 8 and 4;
- mamba2 as the smoke config (H = 8: every leaf splits on both meshes).

The JAX side runs the same weights once per module on 4 forced host
devices (``conftest.run_distributed``, one program a family, the three
side by side) under ``param_shardings`` and ``cache_shardings`` with
``jax.jit``, as ``tests/test_torch_tp.py`` does, concurrently with the
ranks.  Held: prefill logits and three
decode steps' logits and the tokens fed (1e-4 of the largest
magnitude), the loss (2^-16 relative), the gradients gathered whole
(1e-4 relative L2; a gradient that is zero in exact arithmetic, whisper's
key biases, which shift each query's scores alike with no rotary
embedding, is rounding noise on both sides and is held to 1e-4 of the
tree's largest gradient norm instead), one ``Trainer`` step under ZeRO-1
(its loss 2^-16 relative, its parameters 1e-4 relative L2; a key bias,
which AdamW moves by about the learning rate along its noise's sign,
within twice the learning rate per element) and every
leaf's round trip through ``shard_params`` / ``gather_params`` (bit for
bit).  The ranks also serve mamba2 and hymba through ``ServeEngine(ctx=)``
on (2, 2) against one process's engine (the same greedy tokens).
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from conftest import run_distributed

WORLD = 4
CHILD_TIMEOUT = 150
SRC = str(Path(__file__).resolve().parents[1] / "src")
LOGIT_TOL = 1e-4
LOSS_RTOL = 2.0 ** -16
GRAD_REL_L2 = 1e-4
LR = 1e-3
KINDS = ("ssm", "hybrid", "encdec")
MESHES = (2, 4)

# Weights, inputs and sizes, shared verbatim by both sides.
COMMON = r"""
import zlib
import numpy as np
ARCHS = {"ssm": "mamba2-2.7b", "hybrid": "hymba-1.5b",
         "encdec": "whisper-large-v3"}
MESHES = (2, 4)  # model-parallel sizes of (data, model) meshes of 4 ranks
MAX_LEN, N_DECODE, LR = 32, 3, 1e-3
rng = np.random.default_rng(35)
TOKENS = rng.integers(0, 128, size=(4, 15), dtype=np.int32)
BATCH = rng.integers(0, 128, size=(8, 16), dtype=np.int32)
FRAMES = rng.standard_normal((4, 24, 64)).astype(np.float32)
BATCH_FRAMES = rng.standard_normal((8, 24, 64)).astype(np.float32)

def fam_cfg(cfgs, kind):
    cfg = cfgs.smoke_config(cfgs.ARCHS[ARCHS[kind]])
    if kind == "hybrid":
        return cfg.scaled(d_model=48)
    if kind == "encdec":
        return cfg.scaled(vocab_size=130)
    return cfg

def inputs(kind):
    # (the prompt batch, the training batch) as numpy dicts
    if kind == "encdec":
        return ({"tokens": TOKENS, "encoder_embeds": FRAMES},
                {"tokens": BATCH, "encoder_embeds": BATCH_FRAMES})
    return {"tokens": TOKENS}, {"tokens": BATCH}

def param(path, shape, kind):
    # a parameter at a port path (a layer's leaves under <stack>/<i>/);
    # layer norms' scales about 1, every other leaf about 0
    r = np.random.default_rng(zlib.crc32(path.encode()))
    x = (r.standard_normal(shape) * 0.05).astype(np.float32)
    if kind == "encdec" and path.endswith("scale"):
        x += np.float32(1.0)
    return x
"""

JAX_SIDE = COMMON + r"""
import jax, jax.numpy as jnp
import repro.configs as jcfgs
from repro.distributed.sharding import cache_shardings, param_shardings
from repro.launch.mesh import make_local_mesh
from repro.models import get_model
from repro.models.moe import ShardingCtx
from repro.train.optimizer import AdamW
from repro.train.train_step import TrainState, make_train_step

STACKS = ("layers", "enc_layers", "dec_layers")

def path_str(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)

def flat(prefix, tree):
    return {f"{prefix}/{path_str(p)}": v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

out = {}
for kind in JAX_KINDS:
    cfg = fam_cfg(jcfgs, kind)
    api = get_model(cfg)
    shapes = jax.eval_shape(api.init, jax.random.PRNGKey(0))

    def jax_param(path, s):
        p = path_str(path)
        top, _, rest = p.partition("/")
        if top in STACKS:
            return jnp.asarray(np.stack([
                param(f"{top}/{i}/{rest}", s.shape[1:], kind)
                for i in range(s.shape[0])]))
        return jnp.asarray(param(p, s.shape, kind))

    params = jax.tree_util.tree_map_with_path(jax_param, shapes)
    prompt, train = inputs(kind)
    prompt = {k: jnp.asarray(v) for k, v in prompt.items()}
    train = {k: jnp.asarray(v) for k, v in train.items()}
    for mp in MESHES:
        key = f"{kind}/{mp}"
        mesh = make_local_mesh(mp)
        ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model")
        params_s = jax.device_put(params, param_shardings(mesh, shapes))
        with mesh:
            logits, cache = jax.jit(lambda p, b: api.prefill(
                p, b, MAX_LEN, ctx))(params_s, prompt)
        out[f"{key}/prefill"] = logits
        cache = jax.device_put(cache, cache_shardings(
            mesh, cfg, jax.eval_shape(lambda: cache)))
        step = jax.jit(lambda p, c, t: api.decode_step(p, c, t, ctx))
        for i in range(N_DECODE):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            out[f"{key}/fed{i}"] = tok
            with mesh:
                logits, cache = step(params_s, cache, tok)
            out[f"{key}/decode{i}"] = logits
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: api.loss(p, b, ctx)))(params_s, train)
        out[f"{key}/loss"] = loss
        out.update(flat(f"{key}/grad", grads))
        opt = AdamW(lr=LR)
        state = TrainState(params=params_s, opt=opt.init(params_s))
        with mesh:
            state, metrics = jax.jit(make_train_step(api, opt, ctx))(
                state, train)
        out[f"{key}/step_loss"] = metrics["loss"]
        out.update(flat(f"{key}/stepped", state.params))
np.savez(OUT + ".npz", **{k: np.asarray(v, np.float32)
                          for k, v in out.items()})
print("jax side done")
"""

CHILD = COMMON + r"""
import json, os, sys, math
import torch
import torch.distributed as dist
rank, out_dir = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(out_dir, "store"), 4), rank=rank, world_size=4)
import repro_torch.configs as tcfgs
from repro_torch.core.tree import (key_str, tree_leaves,
                                   tree_leaves_with_path, tree_unflatten)
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import get_model
from repro_torch.models.registry import params_from_jax
from repro_torch.models.moe import ShardingCtx
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import TrainState, reduce_grads, \
    zero1_shapes
from repro_torch.train.trainer import Trainer, TrainerConfig
out, meta = {}, {}
STACKS = ("layers", "enc_layers", "dec_layers")

def whole_params(cfg, api, kind):
    # the numpy weights in the reference's layout (each stack of layers
    # on a leading axis), carried across by params_from_jax
    like = api.init(torch.Generator(), device="meta")
    ref = {}
    for path, v in tree_leaves_with_path(like):
        name = key_str(path)
        keys = name.split("/")
        stacked = keys[0] in STACKS
        if stacked:
            keys = [keys[0]] + keys[2:]
        node = ref
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if not stacked:
            node[keys[-1]] = param(name, tuple(v.shape), kind)
        elif keys[-1] not in node:
            n = (cfg.n_encoder_layers if keys[0] == "enc_layers"
                 else cfg.n_layers)
            rest = "/".join(keys[1:])
            node[keys[-1]] = np.stack([
                param(f"{keys[0]}/{i}/{rest}", tuple(v.shape), kind)
                for i in range(n)])
    return params_from_jax(cfg, ref, device="cpu")

def grads_of(api, params, batch, ctx):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = api.loss(params, batch, ctx)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), tree_unflatten(params, list(grads))

def torch_batch(b):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in b.items()}

for kind in ARCHS:
    cfg = fam_cfg(tcfgs, kind)
    api = get_model(cfg)
    prompt, train = map(torch_batch, inputs(kind))
    for mp in MESHES:
        key = f"{kind}/{mp}"
        whole = whole_params(cfg, api, kind)
        mesh = make_local_mesh(mp, device="cpu")
        ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model")
        specs = sharding.applied_shardings(mesh, whole, cfg.family)
        params = sharding.shard_params(mesh, whole, cfg.family)
        back = sharding.gather_params(mesh, params, specs)
        meta[f"{key}/roundtrip"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                              tree_leaves(whole)))
        meta[f"{key}/shapes"] = {key_str(p): list(v.shape)
                                 for p, v in tree_leaves_with_path(params)}
        with torch.no_grad():
            logits, cache = api.prefill(params, prompt, MAX_LEN, ctx)
            meta[f"{key}/cache"] = {
                key_str(p): list(v.shape)
                for p, v in tree_leaves_with_path(cache)
                if isinstance(v, torch.Tensor)}
            out[f"{key}/prefill"] = logits
            for i in range(N_DECODE):
                fed = torch.argmax(logits, -1)  # the rank's slots'
                out[f"{key}/fed{i}"] = fed
                fed = coll.all_gather(fed, mesh.axis("data"), 0)
                logits, cache = api.decode_step(params, cache, fed, ctx)
                out[f"{key}/decode{i}"] = logits
        loss, grads = grads_of(api, params, train, ctx)
        grads = sharding.gather_params(
            mesh, reduce_grads(ctx, grads, specs), specs)
        out[f"{key}/loss"] = loss
        for p, g in tree_leaves_with_path(grads):
            out[f"{key}/grad/{key_str(p)}"] = g
        opt = AdamW(lr=LR)
        tr = Trainer(api, opt, iter([train]),
                     ckpt_dir=os.path.join(out_dir, f"ckpt_{kind}_{mp}"),
                     tcfg=TrainerConfig(total_steps=1, ckpt_every=2,
                                        log_every=100),
                     ctx=ctx, device="cpu")
        tr.monitor.straggler_factor = math.inf
        state = TrainState(params=params, opt=opt.init(
            params, zero1_shapes(mesh, api)))
        meta[f"{key}/moments"] = {
            key_str(p): list(v.shape)
            for p, v in tree_leaves_with_path(state.opt.mu)}
        state = tr.run(state)
        out[f"{key}/step_loss"] = torch.tensor(tr.losses()[0])
        for p, v in tree_leaves_with_path(
                sharding.gather_params(mesh, state.params, specs)):
            out[f"{key}/stepped/{key_str(p)}"] = v

# the serving engine on (2, 2) against one process's
mesh = make_local_mesh(2, device="cpu")
ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model")
for kind in ("ssm", "hybrid"):
    cfg = fam_cfg(tcfgs, kind)
    api = get_model(cfg)
    whole = whole_params(cfg, api, kind)
    results = []
    for c, params in ((ctx, sharding.shard_params(mesh, whole, cfg.family)),
                      (None, whole)):
        eng = ServeEngine(api, params, slots=4, max_len=MAX_LEN,
                          device="cpu", ctx=c)
        for rid in range(6):
            eng.submit(Request(rid=rid, prompt=TOKENS[rid % 4][:8],
                               max_new_tokens=5))
        results.append(eng.run_to_completion())
    meta[f"engine/{kind}"] = [{str(k): v for k, v in r.items()}
                              for r in results]
np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
         **{k: v.detach().numpy() for k, v in out.items()})
json.dump(meta, open(os.path.join(out_dir, f"rank{rank}.json"), "w"))
dist.destroy_process_group()
"""


def _env(out_dir):
    return dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
                REPRO_TUNE_CACHE=str(out_dir / "tune.json"))


def _wait_ranks(procs):
    """Wait for every rank within CHILD_TIMEOUT; on the first failure or
    the timeout kill them all and fail with the failing rank's output."""
    deadline = time.monotonic() + CHILD_TIMEOUT
    while True:
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            r = bad[0] if bad else codes.index(None)
            out = procs[r].communicate()[0]
            why = (f"exited {codes[r]}" if bad
                   else f"outlasted {CHILD_TIMEOUT} s")
            pytest.fail(f"rank {r} {why}:\n{out[-4000:]}")
        if all(c == 0 for c in codes):
            return
        time.sleep(0.05)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("tp_families")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD,
                               str(r), str(out_dir)], env=_env(out_dir),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    side = {}

    def run_jax_side(kind):  # one program a family, side by side
        try:
            side[kind] = run_distributed(
                f"OUT = {str(out_dir / kind)!r}\nJAX_KINDS = ({kind!r},)\n"
                + JAX_SIDE, timeout=300, device_count=WORLD)
        except BaseException as e:  # re-raised in the test's thread
            side[kind] = e

    threads = [threading.Thread(target=run_jax_side, args=(k,))
               for k in KINDS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for kind in KINDS:
        if not isinstance(side[kind], str) or "jax side done" not in \
                side[kind]:
            for p in procs:
                p.kill()
            raise AssertionError(f"the JAX side of {kind}: {side[kind]}")
    _wait_ranks(procs)
    jax_out = {}
    for kind in KINDS:
        jax_out.update(np.load(out_dir / f"{kind}.npz"))
    return {"ranks": [dict(np.load(out_dir / f"rank{r}.npz"))
                      for r in range(WORLD)],
            "metas": [json.loads((out_dir / f"rank{r}.json").read_text())
                      for r in range(WORLD)],
            "jax": jax_out}


def _close(got, want, tol=LOGIT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (err, tol * scale)


def _l2(x):
    return float(np.linalg.norm(np.asarray(x, np.float64)))


def _jax_leaf(jax_out, prefix, name):
    """The reference's leaf at a port path (each stack of layers stacked
    there)."""
    top = name.split("/")[0]
    if top in ("layers", "enc_layers", "dec_layers"):
        _, i, rest = name.split("/", 2)
        return jax_out[f"{prefix}/{top}/{rest}"][int(i)]
    return jax_out[f"{prefix}/{name}"]


def _block(mp, rank, n):
    """The rows of rank ``rank``'s data block of ``n`` on (4 / mp, mp)."""
    d = rank // mp
    size = n // (WORLD // mp)
    return slice(d * size, (d + 1) * size)


def _noise_leaves(jax_out, prefix):
    """The leaves whose reference gradient under ``prefix`` is below
    GRAD_REL_L2 of the tree's largest: zero in exact arithmetic (see the
    module docstring)."""
    grads = {k[len(prefix):]: _l2(v) for k, v in jax_out.items()
             if k.startswith(prefix)}
    top = max(grads.values())
    return {k for k, n in grads.items() if n < GRAD_REL_L2 * top}


def _hold_tree(got, jax_out, prefix, jprefix, noise=None):
    """Every leaf of ``got`` under ``prefix`` within GRAD_REL_L2 relative
    L2 of the reference's, a leaf whose reference norm is below
    GRAD_REL_L2 of the tree's largest within GRAD_REL_L2 of that largest
    (absolute L2; see the module docstring).  A parameter in ``noise``
    (its gradient zero in exact arithmetic, rounding noise on both
    sides) is held per element within 2 x LR of the reference's: AdamW
    moves it by about LR a step whatever the noise's size, in the
    direction of the noise's sign."""
    names = [k[len(prefix):] for k in got if k.startswith(prefix)]
    assert len(names) > 10
    wants = {n: _jax_leaf(jax_out, jprefix, n) for n in names}
    top = max(_l2(w) for w in wants.values())
    for name in names:
        g, w = got[prefix + name], wants[name]
        assert g.shape == w.shape, name
        diff = np.asarray(g, np.float64) - np.asarray(w, np.float64)
        if noise is not None and _stacked(name) in noise:
            assert np.abs(diff).max() <= 2 * LR, name
            continue
        scale = max(_l2(w), GRAD_REL_L2 * top)
        assert _l2(diff) <= GRAD_REL_L2 * scale, (name, _l2(diff), scale)


def _stacked(name):
    """A port path as the reference names it (each stack of layers on
    one leaf)."""
    top = name.split("/")[0]
    if top in ("layers", "enc_layers", "dec_layers"):
        _, _, rest = name.split("/", 2)
        return f"{top}/{rest}"
    return name


@pytest.mark.parametrize("mp", MESHES, ids=["mesh2x2", "mesh1x4"])
@pytest.mark.parametrize("kind", KINDS)
def test_prefill_logits_match_the_reference_program(runs, kind, mp):
    """Each rank's data block of the last token's logits (the whole
    vocabulary) against the reference's jitted prefill on the sharded
    parameters."""
    want = runs["jax"][f"{kind}/{mp}/prefill"]
    for r, got in enumerate(runs["ranks"]):
        _close(got[f"{kind}/{mp}/prefill"], want[_block(mp, r, 4)])


@pytest.mark.parametrize("mp", MESHES, ids=["mesh2x2", "mesh1x4"])
@pytest.mark.parametrize("kind", KINDS)
def test_three_decode_steps_match_the_reference_program(runs, kind, mp):
    """Three decode steps over the rank's blocks of the cache: the tokens
    fed (each step's greedy tokens) equal, each step's logits within
    1e-4 of the reference's over its ``cache_shardings`` cache."""
    for r, got in enumerate(runs["ranks"]):
        blk = _block(mp, r, 4)
        for i in range(3):
            np.testing.assert_array_equal(
                got[f"{kind}/{mp}/fed{i}"],
                runs["jax"][f"{kind}/{mp}/fed{i}"][blk])
            _close(got[f"{kind}/{mp}/decode{i}"],
                   runs["jax"][f"{kind}/{mp}/decode{i}"][blk])


@pytest.mark.parametrize("mp", MESHES, ids=["mesh2x2", "mesh1x4"])
@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_gathered_gradients_match_the_reference(runs, kind, mp):
    """The loss on every rank within 2^-16 relative and every gradient,
    reduced over the axes its leaf is not split over and gathered whole,
    within 1e-4 relative L2 of ``jax.value_and_grad`` of the reference's
    loss on the sharded parameters."""
    want = runs["jax"][f"{kind}/{mp}/loss"]
    for got in runs["ranks"]:
        np.testing.assert_allclose(got[f"{kind}/{mp}/loss"], want,
                                   rtol=LOSS_RTOL)
        _hold_tree(got, runs["jax"], f"{kind}/{mp}/grad/",
                   f"{kind}/{mp}/grad")


@pytest.mark.parametrize("mp", MESHES, ids=["mesh2x2", "mesh1x4"])
@pytest.mark.parametrize("kind", KINDS)
def test_zero1_trainer_step_matches_the_reference_step(runs, kind, mp):
    """One ``Trainer`` step with ZeRO-1's moment blocks against the
    reference's ``make_train_step`` on the sharded state: the loss within
    2^-16 relative, every parameter after it, gathered whole, within
    1e-4 relative L2 (whisper's key biases, whose gradient is rounding
    noise, within 2 x the learning rate per element).  The moments are
    the reference's ZeRO-1 blocks: its rule splits a stack of 2 layers
    over the data axis, so at (2, 2) data rank d holds layer d's moments
    (shaped (1, ...)) and not the other's ((0, ...)), at (1, 4) the one
    data rank holds both; the embedding's are split along D at (2, 2),
    and the FSDP attention weights' keep their parameter's block."""
    for got in runs["ranks"]:
        np.testing.assert_allclose(got[f"{kind}/{mp}/step_loss"],
                                   runs["jax"][f"{kind}/{mp}/step_loss"],
                                   rtol=LOSS_RTOL)
        _hold_tree(got, runs["jax"], f"{kind}/{mp}/stepped/",
                   f"{kind}/{mp}/stepped",
                   _noise_leaves(runs["jax"], f"{kind}/{mp}/grad/"))
    for r, meta in enumerate(runs["metas"]):
        moments = meta[f"{kind}/{mp}/moments"]
        shapes = meta[f"{kind}/{mp}/shapes"]
        for name, shape in shapes.items():
            if "attn/" in name and name.endswith("/w"):
                # already split over the data axis (FSDP): kept
                assert moments[name] == shape, name
            elif name.split("/")[0] in ("layers", "enc_layers",
                                        "dec_layers"):
                # the reference splits the moments over the 2 layers
                mine = mp == 4 or int(name.split("/")[1]) == r // mp
                assert moments[name] == [int(mine)] + shape, name
        if mp == 2:
            emb = shapes["embed"]
            assert moments["embed"] == [emb[0], emb[1] // 2]
        else:
            assert moments["embed"] == shapes["embed"]


@pytest.mark.parametrize("mp", MESHES, ids=["mesh2x2", "mesh1x4"])
@pytest.mark.parametrize("kind", KINDS)
def test_shard_and_gather_round_trip_every_leaf(runs, kind, mp):
    """Every leaf back bit for bit from the ranks' blocks, and the blocks
    the specs give: the mixer's channels over the model axis (hymba's
    per-head leaves whole where its 6 heads do not split over 4), the
    vocabulary where it divides, the attention weights over the data
    axis, the MLP's F over the model axis, the caches' blocks."""
    n_data = WORLD // mp
    for meta in runs["metas"]:
        assert meta[f"{kind}/{mp}/roundtrip"]
        shapes = meta[f"{kind}/{mp}/shapes"]
        cache = meta[f"{kind}/{mp}/cache"]
        if kind == "ssm":
            assert shapes["embed"] == [128 // mp, 64]
            assert shapes["layers/0/mixer/x_proj"] == [64, 128 // mp]
            assert shapes["layers/0/mixer/out_proj"] == [128 // mp, 64]
            assert shapes["layers/0/mixer/dt_proj"] == [64, 8 // mp]
            assert shapes["layers/0/mixer/bc_proj"] == [64, 16]
            assert cache["layers/ssm"] == [2, 4 // n_data, 8 // mp, 8, 16]
            assert cache["layers/conv_bc"] == [2, 4 // n_data, 3, 16 // mp]
        elif kind == "hybrid":
            assert shapes["embed"] == [128 // mp, 48]
            assert shapes["layers/0/mixer/x_proj"] == [48, 96 // mp]
            heads = 6 // mp if mp == 2 else 6
            assert shapes["layers/0/mixer/A_log"] == [heads]
            assert shapes["layers/0/attn/wq/w"] == [48 // n_data, 64]
            assert shapes["layers/0/mlp/wi"] == [48, 128 // mp]
            assert cache["mixer/ssm"][2] == heads
            assert cache["k"][2] == 32 // mp
        else:
            assert shapes["embed"] == ([65, 64] if mp == 2 else [130, 64])
            assert shapes["dec_layers/0/cross_attn/wk/w"] == [
                64 // n_data, 32]
            assert shapes["dec_layers/0/cross_attn/wk/b"] == [32]
            assert shapes["enc_layers/1/mlp/wo"] == [128 // mp, 64]
            assert cache["ck"] == [2, 4 // n_data, 24, 2, 16 // mp]
            assert cache["k"] == [2, 4 // n_data, 32 // mp, 2, 16]


@pytest.mark.parametrize("kind", ("ssm", "hybrid"))
def test_serve_engine_serves_the_state_models_under_a_mesh(runs, kind):
    """``ServeEngine`` on (2, 2) serving mamba2 and hymba (the mixer's
    blocks spliced slot by slot): six requests in two waves give one
    process's greedy tokens on every rank."""
    for meta in runs["metas"]:
        sharded, one = meta[f"engine/{kind}"]
        assert sharded == one and len(one) == 6
