"""The reference's tensor-parallel specs as the port applies them, and the
layers' recomputation (``cfg.remat``), held against the JAX package.

Across processes: four gloo ranks on the CPU (``python -c`` children,
``PYTHONPATH=src``, meeting at a ``FileStore`` under ``tmp_path``, each
under its own timeout, all killed at the first failure) run the smoke
qwen2-7b (``n_kv_heads=2``) and the smoke Qwen3-MoE (capacity factor 4:
nothing drops) on (data, model) meshes (2, 2) and (1, 4), with numpy-built
weights (by path, shared verbatim with the JAX side) carried across by
``params_from_jax`` and cut by ``sharding.shard_params``: the
vocab-sharded embedding, the FSDP attention weights, the dense MLP's
column and row split or the experts, the sequence-sharded KV cache.
The JAX side runs the same weights once per module on 4 forced host
devices (``conftest.run_distributed``) as ``tests/test_distributed.py``
does (``jax.device_put(params, param_shardings(...))``, the cache under
``cache_shardings``, ``jax.jit``), concurrently with the ranks.  Held:
prefill logits, three decode steps' logits and the tokens fed (1e-4 of
the largest magnitude), the loss (2^-16 relative) and the gradients
gathered whole (1e-4 relative L2), one ``Trainer`` step (its loss 2^-16
relative, its parameters 1e-4 relative L2), the round trip of every
leaf through ``shard_params`` / ``gather_params`` (bit for bit) and the
(2, 2) dense trainer's whole checkpoint restored in this process.  The
ranks also hold, against the one-piece arithmetic on the same rank: the
vocab-parallel loss and its gradients (2^-20 relative; 1e-5 relative
L2), the sequence-split ``decode_attention`` at a position in each
shard, one shard all masked (1e-6), a vocabulary of 130 that does not
split over 4 model ranks running replicated (logits and loss 1e-5), and
recomputation on the (1, 4) mesh (loss and gradients bit for bit).

In one process: every family's loss and gradients at ``remat=True``
against ``remat=False`` bit for bit and against the JAX package's
``remat=True`` gradients (rtol = atol = 1e-4 per element,
``tests/test_torch_families.py``'s tolerance: a gradient that is zero in
exact arithmetic, e.g. whisper's key bias, is rounding noise on both
sides; the JAX side jitted, in a second subprocess), and a training
step's peak counted on ``meta`` at depth 4 against depth 2: under
recomputation two more layers add their inputs and their parameters'
gradients, not their activations.
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
import torch

from conftest import run_distributed

WORLD = 4
CHILD_TIMEOUT = 120
SRC = str(Path(__file__).resolve().parents[1] / "src")
LOGIT_TOL = 1e-4
LOSS_RTOL = 2.0 ** -16
GRAD_REL_L2 = 1e-4
FAMILY_TOL = 1e-4
KINDS = ("dense", "moe")
MESHES = (2, 4)

# Weights, inputs and sizes, shared verbatim by both sides.
COMMON = r"""
import json, zlib
import numpy as np
ARCHS = {"dense": "qwen2-7b", "moe": "qwen3-moe-235b-a22b"}
MESHES = (2, 4)  # model-parallel sizes of (data, model) meshes of 4 ranks
MAX_LEN, N_DECODE = 32, 3
rng = np.random.default_rng(34)
TOKENS = rng.integers(0, 128, size=(4, 15), dtype=np.int32)
BATCH = rng.integers(0, 128, size=(8, 16), dtype=np.int32)

def tp_cfg(cfgs, kind):
    cfg = cfgs.smoke_config(cfgs.ARCHS[ARCHS[kind]])
    if kind == "dense":
        return cfg.scaled(n_kv_heads=2)
    return cfg.scaled(capacity_factor=4.0)

def param(path, shape):
    # a parameter at a port path (a layer's leaves under layers/<i>/)
    r = np.random.default_rng(zlib.crc32(path.encode()))
    return (r.standard_normal(shape) * 0.05).astype(np.float32)
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

def path_str(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)

def jax_param(path, s):
    p = path_str(path)
    if p.startswith("layers/"):
        return jnp.asarray(np.stack([
            param(p.replace("layers/", f"layers/{i}/", 1), s.shape[1:])
            for i in range(s.shape[0])]))
    return jnp.asarray(param(p, s.shape))

def flat(prefix, tree):
    return {f"{prefix}/{path_str(p)}": v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

out = {}
for kind in ARCHS:
    cfg = tp_cfg(jcfgs, kind)
    api = get_model(cfg)
    shapes = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(jax_param, shapes)
    for mp in MESHES:
        key = f"{kind}/{mp}"
        mesh = make_local_mesh(mp)
        ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model")
        params_s = jax.device_put(params, param_shardings(mesh, shapes))
        with mesh:
            logits, cache = jax.jit(lambda p, t: api.prefill(
                p, {"tokens": t}, MAX_LEN, ctx))(params_s,
                                                  jnp.asarray(TOKENS))
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
        batch = {"tokens": jnp.asarray(BATCH)}
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: api.loss(p, b, ctx)))(params_s, batch)
        out[f"{key}/loss"] = loss
        out.update(flat(f"{key}/grad", grads))
        opt = AdamW(lr=1e-3)
        state = TrainState(params=params_s, opt=opt.init(params_s))
        with mesh:
            state, metrics = jax.jit(make_train_step(api, opt, ctx))(
                state, batch)
        out[f"{key}/step_loss"] = metrics["loss"]
        out.update(flat(f"{key}/stepped", state.params))
np.savez(OUT + ".npz", **{k: np.asarray(v, np.float32)
                          for k, v in out.items()})
print("jax side done")
"""

JAX_REMAT = r"""
import jax, jax.numpy as jnp, numpy as np
import repro.configs as jcfgs
from repro.models import get_model
ARCHS = ("qwen2-7b", "qwen3-moe-235b-a22b", "mamba2-2.7b", "hymba-1.5b",
         "whisper-large-v3", "paligemma-3b")
out = {}
for name in ARCHS:
    cfg = jcfgs.smoke_config(jcfgs.ARCHS[name]).scaled(remat=True)
    api = get_model(cfg)
    params = jax.jit(api.init)(jax.random.PRNGKey(0))
    batch = dict(np.load(BATCHES + f"/{name}.npz"))
    loss, grads = jax.jit(jax.value_and_grad(api.loss))(params, batch)
    out[f"{name}/loss"] = loss
    for p, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"{name}/grad/" + "/".join(str(getattr(k, "key", k))
                                       for k in p)] = v
    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"{name}/param/" + "/".join(str(getattr(k, "key", k))
                                        for k in p)] = v
np.savez(OUT + ".npz", **{k: np.asarray(v, np.float32)
                          for k, v in out.items()})
print("jax remat done")
"""

CHILD = COMMON + r"""
import os, sys, math
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
from repro_torch.models.attention import decode_attention
from repro_torch.models.layers import lm_loss_from_features
from repro_torch.models.moe import ShardingCtx
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import TrainState, reduce_grads
from repro_torch.train.trainer import Trainer, TrainerConfig
out, meta = {}, {}

def whole_params(cfg, api):
    # the numpy weights in the reference's layout (layers stacked on a
    # leading L axis), carried across by params_from_jax
    like = api.init(torch.Generator(), device="meta")
    ref = {}
    for path, v in tree_leaves_with_path(like):
        name = key_str(path)
        node, keys = ref, name.split("/")
        if keys[0] == "layers":
            keys = ["layers"] + keys[2:]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if name.startswith("layers/"):
            if keys[-1] not in node:
                node[keys[-1]] = np.stack([
                    param(f"layers/{i}/" + "/".join(keys[1:]),
                          tuple(v.shape)) for i in range(cfg.n_layers)])
        else:
            node[keys[-1]] = param(name, tuple(v.shape))
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

tok = torch.from_numpy(TOKENS).long()
batch = {"tokens": torch.from_numpy(BATCH).long()}
for kind in ARCHS:
    cfg = tp_cfg(tcfgs, kind)
    api = get_model(cfg)
    for mp in MESHES:
        key = f"{kind}/{mp}"
        # drawn anew: the trainer updates the replicated leaves, which
        # the rank shares with the whole tree, in place
        whole = whole_params(cfg, api)
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
            logits, cache = api.prefill(params, {"tokens": tok}, MAX_LEN,
                                        ctx)
            out[f"{key}/prefill"] = logits
            meta[f"{key}/cache"] = list(cache["k"].shape)
            for i in range(N_DECODE):
                fed = torch.argmax(logits, -1)  # the rank's slots'
                out[f"{key}/fed{i}"] = fed
                fed = coll.all_gather(fed, mesh.axis("data"), 0)
                logits, cache = api.decode_step(params, cache, fed, ctx)
                out[f"{key}/decode{i}"] = logits
        loss, grads = grads_of(api, params, batch, ctx)
        grads = sharding.gather_params(
            mesh, reduce_grads(ctx, grads, specs), specs)
        out[f"{key}/loss"] = loss
        for p, g in tree_leaves_with_path(grads):
            out[f"{key}/grad/{key_str(p)}"] = g
        opt = AdamW(lr=1e-3)
        writes = kind == "dense" and mp == 2
        tr = Trainer(api, opt, iter([batch]),
                     ckpt_dir=os.path.join(out_dir, f"ckpt_{kind}_{mp}"),
                     tcfg=TrainerConfig(total_steps=1,
                                        ckpt_every=1 if writes else 2,
                                        log_every=100),
                     ctx=ctx, device="cpu")
        tr.monitor.straggler_factor = math.inf
        state = tr.run(TrainState(params=params, opt=opt.init(params)))
        out[f"{key}/step_loss"] = torch.tensor(tr.losses()[0])
        for p, v in tree_leaves_with_path(
                sharding.gather_params(mesh, state.params, specs)):
            out[f"{key}/stepped/{key_str(p)}"] = v

# the serving engine on (2, 2) against one process's, and its refusal
from repro_torch.serve import Request, ServeEngine
cfg = tp_cfg(tcfgs, "dense")
api = get_model(cfg)
whole = whole_params(cfg, api)
mesh = make_local_mesh(2, device="cpu")
ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model")
results = []
for c, params in ((ctx, sharding.shard_params(mesh, whole, cfg.family)),
                  (None, whole)):
    eng = ServeEngine(api, params, slots=4, max_len=MAX_LEN, device="cpu",
                      ctx=c)
    for rid in range(6):
        eng.submit(Request(rid=rid, prompt=TOKENS[rid % 4][:8],
                           max_new_tokens=5))
    results.append(eng.run_to_completion())
meta["engine"] = [{str(k): v for k, v in r.items()} for r in results]
meta["engine_cache"] = list(ServeEngine(
    api, sharding.shard_params(mesh, whole, cfg.family), slots=4,
    max_len=MAX_LEN, device="cpu", ctx=ctx).cache["k"].shape)
try:
    ServeEngine(api, whole, slots=4, max_len=31, device="cpu", ctx=ctx)
except ValueError as e:
    meta["engine_refused"] = str(e)

# the plain checks, each against the one-piece arithmetic on this rank
mesh = make_local_mesh(4, device="cpu")
ax = mesh.axis("model")
r = np.random.default_rng(3)
table = torch.from_numpy(r.standard_normal((128, 16)).astype(np.float32))
x = torch.from_numpy(r.standard_normal((2, 5, 16)).astype(np.float32))
labels = torch.from_numpy(r.integers(0, 128, (2, 5)))
block = table[32 * ax.index:32 * (ax.index + 1)].clone()
xs, ts = x.clone().requires_grad_(True), block.requires_grad_(True)
got = lm_loss_from_features(ts, xs, labels, axis=ax)
got.backward()
xw, tw = x.clone().requires_grad_(True), table.clone().requires_grad_(True)
want = lm_loss_from_features(tw, xw, labels)
want.backward()
meta["vocab_loss"] = [float(got), float(want)]
meta["vocab_gx"] = float((xs.grad - xw.grad).norm() / xw.grad.norm())
tb = tw.grad[32 * ax.index:32 * (ax.index + 1)]
meta["vocab_gtable"] = float((ts.grad - tb).norm() / tb.norm())
q = torch.from_numpy(r.standard_normal((2, 4, 16)).astype(np.float32))
kc = torch.from_numpy(r.standard_normal((2, 32, 2, 16)).astype(np.float32))
vc = torch.from_numpy(r.standard_normal((2, 32, 2, 16)).astype(np.float32))
errs = {}
for pos in (3, 11, 20, 31):  # rank 0's block alone valid at pos 3
    mine = slice(8 * ax.index, 8 * (ax.index + 1))
    o = decode_attention(q, kc[:, mine], vc[:, mine], pos, ax)
    errs[pos] = [float((o - decode_attention(q, kc, vc, pos)).abs().max()),
                 bool(torch.isfinite(o).all())]
meta["decode_attention"] = errs
# a vocabulary of 130 does not split over 4: the embedding runs whole
cfg = tp_cfg(tcfgs, "dense").scaled(vocab_size=130)
api = get_model(cfg)
whole = whole_params(cfg, api)
ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model")
params = sharding.shard_params(mesh, whole, cfg.family)
meta["fallback_embed"] = list(params["embed"].shape)
with torch.no_grad():
    got, _ = api.prefill(params, {"tokens": tok}, MAX_LEN, ctx)
    want, _ = api.prefill(whole, {"tokens": tok}, MAX_LEN)
meta["fallback_logits"] = float((got - want).abs().max())
loss_m, _ = grads_of(api, params, batch, ctx)
loss_1, _ = grads_of(api, whole, batch, None)
meta["fallback_loss"] = [float(loss_m), float(loss_1)]
# recomputation on the mesh: the same bits, collectives recomputed alike
cfg = tp_cfg(tcfgs, "dense")
whole = whole_params(cfg, get_model(cfg))
params = sharding.shard_params(mesh, whole, cfg.family)
runs = [grads_of(get_model(cfg.scaled(remat=flag)), params, batch, ctx)
        for flag in (False, True)]
meta["remat_bits"] = bool(torch.equal(runs[0][0], runs[1][0])) and all(
    torch.equal(a, b) for a, b in zip(tree_leaves(runs[0][1]),
                                      tree_leaves(runs[1][1])))
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


REMAT_ARCHS = ("qwen2-7b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
               "hymba-1.5b", "whisper-large-v3", "paligemma-3b")


def _family_batch(cfg, seed):
    """A seeded batch of 2 x 16 tokens (and the family's frames or
    patches), as numpy arrays."""
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (2, 16),
                                  dtype=np.int32)}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = r.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = r.standard_normal(
            (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import repro_torch.configs as tcfgs

    out_dir = tmp_path_factory.mktemp("tp_ranks")
    batches = out_dir / "batches"
    batches.mkdir()
    for name in REMAT_ARCHS:
        cfg = tcfgs.smoke_config(tcfgs.ARCHS[name])
        np.savez(batches / f"{name}.npz", **_family_batch(cfg, 11))
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r),
                               str(out_dir)], env=_env(out_dir),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    jax_out, remat_out = str(out_dir / "jax"), str(out_dir / "jax_remat")
    side = {}

    def run_remat_side():  # the second JAX program, beside the first
        try:
            side["stdout"] = run_distributed(
                f"OUT = {remat_out!r}\nBATCHES = {str(batches)!r}\n"
                + JAX_REMAT, timeout=300, device_count=WORLD)
        except BaseException as e:  # re-raised in the test's thread
            side["error"] = e

    thread = threading.Thread(target=run_remat_side)
    thread.start()
    try:
        stdout = run_distributed(f"OUT = {jax_out!r}\n" + JAX_SIDE,
                                 timeout=300, device_count=WORLD)
        assert "jax side done" in stdout
        thread.join()
        if "error" in side:
            raise side["error"]
        assert "jax remat done" in side["stdout"]
    except BaseException:
        for p in procs:
            p.kill()
        raise
    _wait_ranks(procs)
    return {"ranks": [dict(np.load(out_dir / f"rank{r}.npz"))
                      for r in range(WORLD)],
            "metas": [json.loads((out_dir / f"rank{r}.json").read_text())
                      for r in range(WORLD)],
            "jax": dict(np.load(jax_out + ".npz")),
            "remat": dict(np.load(remat_out + ".npz")),
            "batches": batches, "out_dir": out_dir}


def _close(got, want, tol=LOGIT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (err, tol * scale)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_leaf(jax_out, prefix, name):
    """The reference's leaf at a port path (layers stacked there)."""
    if name.startswith("layers/"):
        _, i, rest = name.split("/", 2)
        return jax_out[f"{prefix}/layers/{rest}"][int(i)]
    return jax_out[f"{prefix}/{name}"]


def _block(mp, rank, n):
    """The rows of rank ``rank``'s data block of ``n`` on (4 / mp, mp)."""
    d = rank // mp
    size = n // (WORLD // mp)
    return slice(d * size, (d + 1) * size)


@pytest.mark.parametrize("mp", MESHES, ids=["mesh2x2", "mesh1x4"])
@pytest.mark.parametrize("kind", KINDS)
def test_prefill_logits_match_the_reference_program(runs, kind, mp):
    """Each rank's data block of the last token's logits (the whole
    vocabulary, gathered from the blocks) against the reference's jitted
    prefill on the sharded parameters; the cache holds the rank's slots
    and its 32 / mp positions."""
    want = runs["jax"][f"{kind}/{mp}/prefill"]
    for r, got in enumerate(runs["ranks"]):
        _close(got[f"{kind}/{mp}/prefill"], want[_block(mp, r, 4)])
        cache = runs["metas"][r][f"{kind}/{mp}/cache"]
        assert cache[1:3] == [4 * mp // WORLD, 32 // mp]


@pytest.mark.parametrize("mp", MESHES, ids=["mesh2x2", "mesh1x4"])
@pytest.mark.parametrize("kind", KINDS)
def test_three_decode_steps_match_the_reference_program(runs, kind, mp):
    """Three decode steps over the sequence-sharded cache: the tokens fed
    (each step's greedy tokens) equal, each step's logits within 1e-4 of
    the reference's over its ``cache_shardings`` cache."""
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
        prefix = f"{kind}/{mp}/grad/"
        names = [k[len(prefix):] for k in got if k.startswith(prefix)]
        assert len(names) > 10
        for name in names:
            w = _jax_leaf(runs["jax"], f"{kind}/{mp}/grad", name)
            g = got[prefix + name]
            assert g.shape == w.shape, name
            assert _rel_l2(g, w) <= GRAD_REL_L2, name


@pytest.mark.parametrize("mp", MESHES, ids=["mesh2x2", "mesh1x4"])
@pytest.mark.parametrize("kind", KINDS)
def test_trainer_step_matches_the_reference_step(runs, kind, mp):
    """One ``Trainer`` step (AdamW, the data-parallel mean, the clip by
    the whole tree's norm) against the reference's ``make_train_step``
    on the sharded state: the loss within 2^-16 relative, every
    parameter after it, gathered whole, within 1e-4 relative L2."""
    for got in runs["ranks"]:
        np.testing.assert_allclose(got[f"{kind}/{mp}/step_loss"],
                                   runs["jax"][f"{kind}/{mp}/step_loss"],
                                   rtol=LOSS_RTOL)
        prefix = f"{kind}/{mp}/stepped/"
        for key in (k for k in got if k.startswith(prefix)):
            name = key[len(prefix):]
            w = _jax_leaf(runs["jax"], f"{kind}/{mp}/stepped", name)
            assert _rel_l2(got[key], w) <= GRAD_REL_L2, name


@pytest.mark.parametrize("mp", MESHES, ids=["mesh2x2", "mesh1x4"])
@pytest.mark.parametrize("kind", KINDS)
def test_shard_and_gather_round_trip_the_new_leaves(runs, kind, mp):
    """Every leaf back bit for bit from the ranks' blocks; the blocks the
    specs give: the vocabulary, the MLP's F (or the experts' E) split
    over the model axis, the attention weights' input dim over the data
    axis, the biases and norms whole."""
    n_data = WORLD // mp
    for meta in runs["metas"]:
        assert meta[f"{kind}/{mp}/roundtrip"]
        shapes = meta[f"{kind}/{mp}/shapes"]
        assert shapes["embed"] == [128 // mp, 64]
        assert shapes["layers/0/attn/wq/w"] == [64 // n_data, 64]
        assert shapes["layers/1/attn/wo/w"] == [64 // n_data, 64]
        assert shapes["layers/0/ln1/scale"] == [64]
        if kind == "dense":
            assert shapes["layers/0/attn/wq/b"] == [64]
            assert shapes["layers/0/mlp/wi"] == [64, 128 // mp]
            assert shapes["layers/0/mlp/wo"] == [128 // mp, 64]
        else:
            assert shapes["layers/0/moe/wg"] == [4 // mp, 64, 64]
            assert shapes["layers/0/moe/router"] == [64, 4]


def test_checkpoint_written_on_a_mesh_restores_whole_in_one_process(runs):
    """The (2, 2) dense trainer's checkpoint holds whole leaves (each
    split leaf gathered over its axes): it restores here into a
    one-process state equal to the ranks' gathered parameters bit for
    bit and within 1e-4 relative L2 of the reference's step."""
    import repro_torch.configs as tcfgs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import key_str, tree_leaves_with_path
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import TrainState

    ns = {}
    exec(COMMON, ns)
    like = get_model(ns["tp_cfg"](tcfgs, "dense")).init(
        torch.Generator().manual_seed(0), device="cpu")
    state, step = CheckpointManager(
        runs["out_dir"] / "ckpt_dense_2").restore(
        TrainState(params=like, opt=AdamW().init(like)))
    assert step == 1
    for path, got in tree_leaves_with_path(state.params):
        name = key_str(path)
        np.testing.assert_array_equal(
            got.numpy(), runs["ranks"][0][f"dense/2/stepped/{name}"])
        w = _jax_leaf(runs["jax"], "dense/2/stepped", name)
        assert _rel_l2(got, w) <= GRAD_REL_L2, name


def test_serve_engine_under_a_mesh_matches_one_process(runs):
    """``ServeEngine`` on (2, 2): each rank's cache holds its 2 of the 4
    slots and its 16 of the 32 positions; six requests in two waves give
    one process's greedy tokens on every rank; a ``max_len`` that does
    not split over the model axis is refused, naming the sizes."""
    for meta in runs["metas"]:
        sharded, one = meta["engine"]
        assert sharded == one and len(one) == 6
        assert meta["engine_cache"][1:3] == [2, 16]
        assert "max_len 31" in meta["engine_refused"]
        assert "model axis of 2" in meta["engine_refused"]


def test_vocab_parallel_loss_matches_the_whole_vocabulary(runs):
    """Each model rank's block of a 128-word table (4 ranks): the loss
    from the blocks (``pmax`` of the maxima, ``psum`` of the exponential
    sums and of the gold logit) within 2^-20 of the whole table's, the
    features' gradient and the block's within 1e-5 relative L2."""
    for meta in runs["metas"]:
        got, want = meta["vocab_loss"]
        assert abs(got - want) <= 2.0 ** -20 * abs(want)
        assert meta["vocab_gx"] <= 1e-5 and meta["vocab_gtable"] <= 1e-5


def test_sequence_split_decode_attention_matches_one_piece(runs):
    """A 32-position cache in blocks of 8: at a position in each block
    (at 3 the other three ranks' positions are all masked) every rank's
    output is finite and within 1e-6 of the one-piece attention."""
    for meta in runs["metas"]:
        for pos, (err, finite) in meta["decode_attention"].items():
            assert finite and err <= 1e-6, (pos, err)


def test_fit_fallback_vocabulary_runs_replicated(runs):
    """A vocabulary of 130 does not split over a model axis of 4: the
    embedding falls back to whole (``_fit``), and the model code, which
    reads its spec from ``applied_spec``, runs it whole: the logits
    within 1e-5 and the loss within 1e-5 relative of one process's."""
    for meta in runs["metas"]:
        assert meta["fallback_embed"] == [130, 64]
        assert meta["fallback_logits"] <= 1e-5
        got, want = meta["fallback_loss"]
        assert abs(got - want) <= 1e-5 * abs(want)


def test_recomputation_on_a_mesh_keeps_every_bit(runs):
    """On (1, 4), ``remat=True``'s loss and gradients (each layer's
    collectives run again in the backward, in the same order on every
    rank) equal ``remat=False``'s bit for bit."""
    assert all(meta["remat_bits"] for meta in runs["metas"])


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", REMAT_ARCHS)
def test_recomputation_keeps_every_bit_and_the_reference_gradients(
        runs, name):
    """Every family's loss and gradients at ``remat=True`` equal
    ``remat=False``'s bit for bit (the same forward, recomputed), and
    the loss and the gradients stand within rtol = atol = 1e-4 of the
    JAX package's at ``remat=True`` on the same parameters
    (``params_from_jax``)."""
    import repro_torch.configs as tcfgs
    from repro_torch.core.tree import key_str, tree_leaves, \
        tree_leaves_with_path
    from repro_torch.models import get_model
    from repro_torch.models.registry import params_from_jax

    jout = runs["remat"]
    cfg = tcfgs.smoke_config(tcfgs.ARCHS[name])
    batch = _torch_batch(dict(np.load(runs["batches"] / f"{name}.npz")))
    tree = {}
    for key, v in jout.items():
        if key.startswith(f"{name}/param/"):
            node = tree
            keys = key[len(f"{name}/param/"):].split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = v
    results = []
    for flag in (False, True):
        api = get_model(cfg.scaled(remat=flag))
        params = params_from_jax(cfg, tree, device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = api.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        results.append((loss.detach(), params, grads))
    (l0, _, g0), (l1, params, g1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert (a is None and b is None) or torch.equal(a, b)
    np.testing.assert_allclose(float(l1), jout[f"{name}/loss"],
                               rtol=FAMILY_TOL)
    for (path, _), g in zip(tree_leaves_with_path(params), g1):
        key = key_str(path)
        if key.split("/")[0] in ("layers", "enc_layers", "dec_layers"):
            top, i, rest = key.split("/", 2)
            want = jout[f"{name}/grad/{top}/{rest}"][int(i)]
        else:
            want = jout[f"{name}/grad/{key}"]
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=FAMILY_TOL,
                                   atol=FAMILY_TOL, err_msg=key)


def _counted_peak(cfg, batch_shape):
    """(the counted peak of one loss-and-gradient step of ``cfg`` on
    ``meta``, beside its arguments and its outputs, the gradients; the
    bytes of one layer's input)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import get_model
    from repro_torch.roofline.analysis import count_costs

    api = get_model(cfg)
    params = api.init(torch.Generator(), device="meta")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.empty(batch_shape, dtype=torch.int64, device="meta")
    with count_costs() as c:
        loss = api.loss(params, {"tokens": tokens})
        grads = torch.autograd.grad(loss, leaves)
    peak = c.memory((params, tokens), (loss, grads)).temp_size_in_bytes
    return peak, batch_shape[0] * batch_shape[1] * cfg.d_model * 2  # bf16


def test_recomputation_holds_one_input_a_layer_on_meta():
    """qwen2-7b at full width, 8 x 4096 tokens, counted on ``meta``: two
    more layers (depth 4 against 2) add to a recomputing step's peak
    their two inputs (T x D bf16 each) and nothing more (1 MiB of
    slack), where the step without recomputation holds each layer's
    activations (the MLP alone several (T, F) tensors)."""
    import repro_torch.configs as tcfgs

    base = tcfgs.get_config("qwen2-7b")
    shape = (8, 4096)
    peaks = {}
    for flag in (True, False):
        for depth in (2, 4):
            peaks[flag, depth], x = _counted_peak(
                base.scaled(n_layers=depth, remat=flag), shape)
    grown = peaks[True, 4] - peaks[True, 2]
    assert 2 * x <= grown <= 2 * x + (1 << 20), (grown, x)
    mlp = shape[0] * shape[1] * base.d_ff * 2  # one (T, F) bf16 tensor
    assert peaks[False, 4] - peaks[False, 2] >= grown + 2 * 3 * mlp
    assert peaks[True, 4] < peaks[False, 4]
