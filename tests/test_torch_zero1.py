"""ZeRO-1's moments as the port applies them, and every spec of the
reference applied, held against the JAX package.

The specs: for every leaf of all ten architectures of the catalog on the
(16, 16) and (2, 16, 16) meshes, ``sharding.applied_shardings`` equals
the reference's ``param_shardings`` and ``sharding.zero1_shardings``
over it equals the reference's ``launch.dryrun.zero1_shardings``.  The
JAX side runs once per module in a subprocess that imports
``repro.launch.dryrun`` first (its ``XLA_FLAGS`` line forces 512 host
devices, but only before JAX starts), on ``jax.eval_shape`` trees.  The
reference stacks each stack of layers on a leading L axis: a layer's
parameter spec is the reference's without its leading None, and so is a
layer's moment spec unless the rule picks L (L divides the data axes:
mamba2's 64 layers, starcoder2's, hymba's and whisper's 32, over 16 or
32), where the port's spec is the reference's whole, one entry longer
than the layer's leaf (the rank holds its block of the layers'
moments).

The step: four gloo ranks on (2, 2) (``python -c`` children, as in
``tests/test_torch_tp.py``) train the smoke qwen2-7b, Qwen3-MoE
(capacity factor 4) and mamba2-2.7b for two ``Trainer`` steps from
numpy-built weights, once under ZeRO-1 and once with whole moments.
Held: the parameters after each run bit for bit alike, the whole
checkpoints of both runs bit for bit alike and restoring whole in this
process, the ZeRO-1 moments (gathered whole from the blocks) within
1e-5 relative L2 of the reference's jitted step on 4 forced host devices
with its state under ``zero1_shardings``, and each rank's moment blocks
of the shapes the specs give.  The moments are linear (``mu``) and
quadratic (``nu``) in the gradients, on which two f32 programs agree to
a few 1e-6 (reductions over every token in another order): after two
steps the worst leaves stood at 7.9e-6 relative L2 (mamba2's ``D``,
``dt_proj`` and ``conv_bc_b``, sums over every token and channel) and
the embeddings at up to 2.9e-6, so 1e-6 does not hold.

The guard: ``launch.dryrun``'s record of every runnable cell of the ten
archs on both meshes, built on ``meta`` without running a program, has
``savings == {}`` (every spec of the reference applied) and, for a
training cell, ``zero1_applied``.
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
CHILD_TIMEOUT = 150
SRC = str(Path(__file__).resolve().parents[1] / "src")
MOMENT_REL_L2 = 1e-5
ARCHS = ("starcoder2-7b", "deepseek-coder-33b", "yi-34b", "qwen2-7b",
         "paligemma-3b", "mamba2-2.7b", "qwen3-moe-235b-a22b", "dbrx-132b",
         "hymba-1.5b", "whisper-large-v3")
MESHES = ("16x16", "2x16x16")
STACKS = ("layers", "enc_layers", "dec_layers")

JAX_SPECS = r"""
import repro.launch.dryrun as jdry  # forces 512 host devices first
import json
import jax
from repro.configs import ARCHS, get_config
from repro.distributed.sharding import param_shardings
from repro.launch.mesh import make_production_mesh
from repro.models import get_model

def enc(spec, ndim):
    out = [list(e) if isinstance(e, tuple) else e for e in spec]
    return out + [None] * (ndim - len(out))

def path_str(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    tag = "2x16x16" if multi else "16x16"
    for arch in ARCHS:
        shapes = jax.eval_shape(get_model(get_config(arch)).init,
                                jax.random.PRNGKey(0))
        ps = param_shardings(mesh, shapes)
        zs = jdry.zero1_shardings(mesh, shapes, ps)
        leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
        flat_p = jax.tree_util.tree_leaves(ps)
        flat_z = jax.tree_util.tree_leaves(zs)
        for (path, leaf), p, z in zip(leaves, flat_p, flat_z):
            key = f"{tag}/{arch}/{path_str(path)}"
            out[key] = {"param": enc(p.spec, leaf.ndim),
                        "zero1": enc(z.spec, leaf.ndim)}
json.dump(out, open(OUT, "w"))
print("jax specs done")
"""

COMMON = r"""
import zlib
import numpy as np
ARCHS = {"dense": "qwen2-7b", "moe": "qwen3-moe-235b-a22b",
         "ssm": "mamba2-2.7b"}
STEPS = 2
rng = np.random.default_rng(135)
BATCHES = [rng.integers(0, 128, size=(8, 16), dtype=np.int32)
           for _ in range(STEPS)]

def z_cfg(cfgs, kind):
    cfg = cfgs.smoke_config(cfgs.ARCHS[ARCHS[kind]])
    if kind == "dense":
        return cfg.scaled(n_kv_heads=2)
    if kind == "moe":
        return cfg.scaled(capacity_factor=4.0)
    return cfg

def param(path, shape):
    r = np.random.default_rng(zlib.crc32(path.encode()))
    return (r.standard_normal(shape) * 0.05).astype(np.float32)
"""

JAX_STEP = COMMON + r"""
import jax, jax.numpy as jnp
import repro.configs as jcfgs
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed.sharding import param_shardings
# JAX runs on its 4 devices already: this import's XLA_FLAGS line is moot
from repro.launch.dryrun import zero1_shardings
from repro.launch.mesh import make_local_mesh
from repro.models import get_model
from repro.models.moe import ShardingCtx
from repro.train.optimizer import AdamState, AdamW
from repro.train.train_step import TrainState, make_train_step

def path_str(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)

out = {}
mesh = make_local_mesh(2)
for kind in ARCHS:
    cfg = z_cfg(jcfgs, kind)
    api = get_model(cfg)
    shapes = jax.eval_shape(api.init, jax.random.PRNGKey(0))

    def jax_param(path, s):
        p = path_str(path)
        if p.startswith("layers/"):
            return jnp.asarray(np.stack([
                param(p.replace("layers/", f"layers/{i}/", 1), s.shape[1:])
                for i in range(s.shape[0])]))
        return jnp.asarray(param(p, s.shape))

    params = jax.tree_util.tree_map_with_path(jax_param, shapes)
    ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    pshard = param_shardings(mesh, shapes)
    zsh = zero1_shardings(mesh, shapes, pshard)
    opt = AdamW(lr=1e-3)
    state = TrainState(params=params, opt=opt.init(params))
    state = jax.device_put(state, TrainState(
        params=pshard, opt=AdamState(step=NamedSharding(mesh, P()),
                                     mu=zsh, nu=zsh)))
    step = jax.jit(make_train_step(api, opt, ctx))
    with mesh:
        for b in BATCHES:
            state, _ = step(state, {"tokens": jnp.asarray(b)})
    for name, tree in (("mu", state.opt.mu), ("nu", state.opt.nu),
                       ("params", state.params)):
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"{kind}/{name}/{path_str(p)}"] = v
np.savez(OUT + ".npz", **{k: np.asarray(v, np.float32)
                          for k, v in out.items()})
print("jax step done")
"""

CHILD = COMMON + r"""
import json, math, os, sys
import torch
import torch.distributed as dist
rank, out_dir = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(out_dir, "store"), 4), rank=rank, world_size=4)
import repro_torch.configs as tcfgs
from repro_torch.core.tree import (key_str, tree_leaves,
                                   tree_leaves_with_path, tree_unflatten)
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import get_model
from repro_torch.models.moe import ShardingCtx
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import (TrainState, gather_state,
                                          init_state, state_shardings,
                                          zero1_shapes)
from repro_torch.train.trainer import Trainer, TrainerConfig
out, meta = {}, {}
mesh = make_local_mesh(2, device="cpu")
ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model")
batches = [{"tokens": torch.from_numpy(b).long()} for b in BATCHES]
for kind in ARCHS:
    cfg = z_cfg(tcfgs, kind)
    api = get_model(cfg)
    like = api.init(torch.Generator(), device="meta")
    whole = tree_unflatten(like, [
        torch.from_numpy(param(key_str(p), tuple(v.shape)))
        for p, v in tree_leaves_with_path(like)])
    runs = {}
    for z in (True, False):
        # copied: the trainer updates in place the replicated leaves,
        # which the rank shares with the whole tree
        params = sharding.shard_params(
            mesh, tree_unflatten(whole, [t.clone() for t in
                                         tree_leaves(whole)]), cfg.family)
        opt = AdamW(lr=1e-3)
        state = TrainState(params=params, opt=opt.init(
            params, zero1_shapes(mesh, api) if z else None))
        tr = Trainer(api, opt, iter(batches),
                     ckpt_dir=os.path.join(out_dir, f"ckpt_{kind}_{z}"),
                     tcfg=TrainerConfig(total_steps=len(batches),
                                        ckpt_every=len(batches),
                                        log_every=100),
                     ctx=ctx, device="cpu")
        tr.monitor.straggler_factor = math.inf
        state = tr.run(state)
        runs[z] = state
        if z:
            meta[f"{kind}/moments"] = {
                key_str(p): list(v.shape)
                for p, v in tree_leaves_with_path(state.opt.mu)}
            meta[f"{kind}/params"] = {
                key_str(p): list(v.shape)
                for p, v in tree_leaves_with_path(state.params)}
            specs = state_shardings(mesh, api, state)
            wlike = init_state(api, opt, torch.Generator(), device="meta")
            for path, v in gather_state(mesh, state, specs, wlike):
                name = key_str(path)
                if name.startswith(("opt/mu/", "opt/nu/")):
                    out[f"{kind}/{name[4:]}"] = v
            # a restart restores the checkpoint into the same blocks
            again = Trainer(api, opt, iter(batches),
                            ckpt_dir=os.path.join(out_dir,
                                                  f"ckpt_{kind}_{z}"),
                            ctx=ctx, device="cpu").init_or_restore(
                torch.Generator().manual_seed(9))
            meta[f"{kind}/restored"] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(again),
                                                  tree_leaves(state)))
    meta[f"{kind}/bits"] = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(runs[True].params),
                                          tree_leaves(runs[False].params)))
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
    out_dir = tmp_path_factory.mktemp("zero1")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r),
                               str(out_dir)], env=_env(out_dir),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    specs_out = out_dir / "specs.json"
    side = {}

    def run_specs():  # the 512-device program, beside the step's
        try:
            env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
            env.pop("XLA_FLAGS", None)
            r = subprocess.run(
                [sys.executable, "-c", f"OUT = {str(specs_out)!r}\n"
                 + JAX_SPECS], capture_output=True, text=True, timeout=300,
                env=env)
            side["specs"] = r.stdout + r.stderr
        except BaseException as e:  # re-raised in the test's thread
            side["specs"] = e

    thread = threading.Thread(target=run_specs)
    thread.start()
    jax_out = str(out_dir / "jax")
    try:
        stdout = run_distributed(f"OUT = {jax_out!r}\n" + JAX_STEP,
                                 timeout=300, device_count=WORLD)
        assert "jax step done" in stdout
        thread.join()
        assert "jax specs done" in str(side["specs"]), side["specs"]
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
            "specs": json.loads(specs_out.read_text()),
            "out_dir": out_dir}


def _json(spec):
    """A spec as the reference's reads back: a split over one axis names
    it (``PartitionSpec`` writes ``("data",)`` as ``"data"``)."""
    return [_entry(e) for e in spec]


def _entry(e):
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else list(e)
    return e


def _ref_name(name):
    """(the reference's path of a port leaf, whether it is a layer's)."""
    keys = name.split("/")
    if keys[0] in STACKS:
        return "/".join([keys[0]] + keys[2:]), True
    return name, False


def _dry_mesh(tag):
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=tag == "2x16x16", dry=True)


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_applied_and_moment_specs_equal_the_reference(runs, arch, tag):
    """Every leaf's applied spec equals the reference's
    ``param_shardings`` (a layer's without its leading None), and its
    ZeRO-1 spec the reference's ``zero1_shardings`` (a layer's without
    its leading None, or whole where the rule splits the layers)."""
    import repro_torch.configs as tcfgs
    from repro_torch.core.tree import key_str, tree_leaves_with_path
    from repro_torch.distributed import sharding
    from repro_torch.models import get_model

    mesh = _dry_mesh(tag)
    cfg = tcfgs.get_config(arch)
    whole = get_model(cfg).init(torch.Generator(), device="meta")
    applied = sharding.applied_shardings(mesh, whole, cfg.family)
    z = sharding.zero1_shardings(mesh, whole, applied)
    split_layers = 0
    for path, leaf in tree_leaves_with_path(whole):
        name = key_str(path)
        ref_name, layer = _ref_name(name)
        ref = runs["specs"][f"{tag}/{arch}/{ref_name}"]
        want_p = ref["param"][1:] if layer else ref["param"]
        assert _json(applied[name]) == _json(want_p), name
        if layer and len(z[name]) == leaf.dim() + 1:
            split_layers += 1
            assert _json(z[name]) == _json(ref["zero1"]), name
        else:
            assert (ref["zero1"][0] is None) or not layer, name
            want_z = ref["zero1"][1:] if layer else ref["zero1"]
            assert _json(z[name]) == _json(want_z), name
    n_layers = {"mamba2-2.7b": 64, "starcoder2-7b": 32, "hymba-1.5b": 32,
                "whisper-large-v3": 32}.get(arch)
    dp = 32 if tag == "2x16x16" else 16
    assert (split_layers > 0) == (n_layers is not None
                                  and n_layers % dp == 0), split_layers


@pytest.mark.parametrize("kind", ("dense", "moe", "ssm"))
def test_zero1_step_keeps_every_bit_of_the_whole_moments_step(runs, kind):
    """Two ``Trainer`` steps on (2, 2) under ZeRO-1 leave every parameter
    bit for bit as the steps with whole moments leave it, on every rank,
    and a restart restores the checkpoint into the same blocks."""
    for meta in runs["metas"]:
        assert meta[f"{kind}/bits"]
        assert meta[f"{kind}/restored"]


@pytest.mark.parametrize("kind", ("dense", "moe", "ssm"))
def test_zero1_moments_match_the_reference_step(runs, kind):
    """The moments after two steps, gathered whole from the ranks'
    blocks, within 1e-5 relative L2 of the reference's jitted step with
    its state under ``zero1_shardings``; every rank holds the blocks the
    specs give (the layers' over the data axis: rank d's own layer
    (1, ...), the other (0, ...))."""
    jax_out = runs["jax"]
    for r, got in enumerate(runs["ranks"]):
        names = [k for k in got if k.startswith(f"{kind}/mu/")]
        assert len(names) > 5
        for key in names + [k.replace("/mu/", "/nu/") for k in names]:
            head, rest = key.split("/", 1)
            moment, name = rest.split("/", 1)
            ref, layer = _ref_name(name)
            want = jax_out[f"{kind}/{moment}/{ref}"]
            if layer:
                want = want[int(name.split("/")[1])]
            g = np.asarray(got[key], np.float64)
            err = np.linalg.norm(g - want) / max(np.linalg.norm(want),
                                                 1e-30)
            assert g.shape == want.shape and err <= MOMENT_REL_L2, key
        moments = runs["metas"][r][f"{kind}/moments"]
        params = runs["metas"][r][f"{kind}/params"]
        for name, shape in params.items():
            if name.startswith("layers/") and not (
                    "attn/" in name and name.endswith("/w")):
                mine = int(name.split("/")[1]) == r // 2
                assert moments[name] == [int(mine)] + shape, name


@pytest.mark.parametrize("kind", ("dense", "moe", "ssm"))
def test_zero1_checkpoint_is_whole_and_equal(runs, kind):
    """The whole checkpoints written under ZeRO-1 and with whole moments
    hold the same leaves bit for bit (moments included), and restore
    whole in this process."""
    import repro_torch.configs as tcfgs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import TrainState

    ns = {}
    exec(COMMON, ns)
    like = get_model(ns["z_cfg"](tcfgs, kind)).init(
        torch.Generator().manual_seed(0), device="cpu")
    states = []
    for z in (True, False):
        state, step = CheckpointManager(
            runs["out_dir"] / f"ckpt_{kind}_{z}").restore(
            TrainState(params=like, opt=AdamW().init(like)))
        assert step == 2
        states.append(state)
    for a, b, w in zip(tree_leaves(states[0]), tree_leaves(states[1]),
                       tree_leaves(TrainState(params=like,
                                              opt=AdamW().init(like)))):
        assert a.shape == w.shape and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_spec_is_applied_in_every_runnable_cell(arch):
    """The dry run's record of every runnable cell of ``arch`` on (16, 16)
    and (2, 16, 16), built on ``meta`` (``lower_cell``, no program run):
    no saving left (``unapplied_savings`` is ``{}``), and a training
    cell's moments are ZeRO-1's (``zero1_applied``, the group named)."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    cells = 0
    for tag in MESHES:
        mesh = _dry_mesh(tag)
        for shape in SHAPES:
            program, meta = dryrun.lower_cell(arch, shape, mesh=mesh)
            if program is None:
                continue
            cells += 1
            assert meta["savings"] == {}, (tag, shape, meta["savings"])
            train = meta["kind"] == "train"
            assert meta["zero1_applied"] is train
            assert ("ZeRO-1 moments" in meta["applied"]) is train
    assert cells >= 4
