"""The port's distributed programs across processes, held against the JAX
package's under ``shard_map``.

Four gloo ranks run on the CPU as ``python -c`` children (``PYTHONPATH=
src``) meeting at a ``FileStore`` under ``tmp_path`` (and two more run
``hillclimb --dist --backend gloo`` under torchrun's variables on
localhost); each has its own
timeout, and the first child to fail (or to outlast it) takes the others
down, so a hang cannot eat the run.  Every rank runs, on the same
numpy-built inputs: the collectives over a reduction mesh and over both
axes of a 2 x 2 local mesh; ``spmm_shard_map`` and
``dist_attention_shard_map`` in all three modes (attention with and
without the bias lanes, 3-D and 2-D q, dv = 20, not a multiple of 8);
``spmm_shard_map`` under a relu epilogue in each mode; ``dist_spmm``
under a ``Schedule`` (and bf16 storage) and under ``schedule="tune"``
with an injected objective and a cache file, then a replay with zero
measurements on every rank; ``ServeEngine.prepare_dist`` and ``launch.
hillclimb --dist --device cpu`` twice (real measurements, one timed call
each: which point wins is the host's, so only the ranks' agreement and
the replay are held); and, on (data, model) meshes (2, 2) and (1, 4) of
the same ranks, the expert-parallel ``apply_moe`` of the smoke Qwen3-MoE
under None, nnz_ar and nnz_rs with its gradients, ``moe_tune_collective``
under the injected objective and its replay, ``shard_params`` /
``gather_params``, and two data-parallel ``Trainer`` steps on (2, 2)
writing a whole checkpoint.  Each rank saves what it holds (its row
block under row and nnz_rs) and the test gathers them.

The JAX side runs once per module on 4 forced host devices
(``conftest.run_distributed``), as two programs side by side (the MoE
one, ``JAX_MOE``, in a thread), concurrently with the ranks, and saves
its outputs to ``.npz`` files.  Tolerances: outputs within 1e-4 of their
largest magnitude (``tests/test_dist_strategies.py:57``); the tuner's
pick, the points it measured, in order, and its time equal to the
reference's under the same injected objective.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from conftest import run_distributed

WORLD = 4
CHILD_TIMEOUT = 120
TOL = 1e-4
MODES = ("row", "nnz_ar", "nnz_rs")
ATTN_CASES = ("plain", "bias", "2d")
SRC = str(Path(__file__).resolve().parents[1] / "src")

# Inputs and the objective, shared verbatim by both sides.
COMMON = r"""
import json, zlib
import numpy as np
N_ROWS, N_KV, N_DENSE = 128, 96, 20
H, D, DV = 2, 16, 20
rng = np.random.default_rng(1)
B = rng.standard_normal((N_KV, N_DENSE)).astype(np.float32)
rng = np.random.default_rng(2)
Q = rng.standard_normal((H, N_ROWS, D)).astype(np.float32)
K = rng.standard_normal((H, N_KV, D)).astype(np.float32)
V = rng.standard_normal((H, N_KV, DV)).astype(np.float32)
SCALE = 1.0 / float(np.sqrt(D))
MODES = ("row", "nnz_ar", "nnz_rs")

def crc_measure(key_fn, calls):
    def measure(s):
        calls.append(key_fn(s))
        return (zlib.crc32(key_fn(s).encode()) % 997 + 1) * 1e-6
    return measure

# the expert-parallel MoE: the smoke Qwen3-MoE at a capacity that drops
# nothing in either layout (tests/test_distributed.py:66-68)
MOE_ARCH, MOE_CF, MOE_T = "qwen3-moe-235b-a22b", 4.0, 32
MOE_MESHES, MOE_MODES = (2, 4), (None, "nnz_ar", "nnz_rs")
rng = np.random.default_rng(5)
MOE_X = rng.standard_normal((MOE_T, 64)).astype(np.float32)
MOE_W = rng.standard_normal((MOE_T, 64)).astype(np.float32)
MOE_P = {"router": (rng.standard_normal((64, 4)) / 8).astype(np.float32),
         "wg": (rng.standard_normal((4, 64, 64)) / 8).astype(np.float32),
         "wi": (rng.standard_normal((4, 64, 64)) / 8).astype(np.float32),
         "wo": (rng.standard_normal((4, 64, 64)) / 8).astype(np.float32)}
TRAIN_BATCHES = [rng.integers(0, 128, size=(8, 16), dtype=np.int32)
                 for _ in range(2)]

def train_param(path, shape):
    # the training case's parameter at a port path (a layer's leaves
    # under layers/<i>/), drawn from numpy
    r = np.random.default_rng(zlib.crc32(path.encode()))
    return (r.standard_normal(shape) * 0.05).astype(np.float32)

def moe_cfg(cfgs):
    return cfgs.smoke_config(cfgs.ARCHS[MOE_ARCH]).scaled(
        capacity_factor=MOE_CF)

def attn_inputs(case, part, csr):
    pattern = case != "bias"
    r, c, bias, _ = part(csr, 4, 64, pattern_only=pattern,
                         phantom_row=True)
    q, k, v = Q, K, V
    if case == "2d":
        q, k, v = Q[0], K[0], V[0]
    return r, c, bias, q, k, v
"""

JAX_SIDE = COMMON + r"""
import jax, jax.numpy as jnp
from repro.launch.mesh import make_reduction_mesh
from repro.sparse import power_law_csr, Schedule
from repro.sparse.distributed import (dist_attention_shard_map, dist_spmm,
                                      partition_nnz_coo, partition_rows_coo,
                                      spmm_shard_map)
from repro.tune import ScheduleCache, schedule_key, tune_dist_spmm
mesh = make_reduction_mesh()
csr = power_law_csr(N_ROWS, N_KV, avg_degree=6.0, alpha=1.6, seed=0)
b = jnp.asarray(B)
out = {}
for mode in MODES:
    part = partition_rows_coo if mode == "row" else partition_nnz_coo
    r, c, v, _ = part(csr, 4, 64)
    s = Schedule(nnz_tile=64, group_size=8, collective=mode)
    out[f"spmm_{mode}"] = spmm_shard_map(r, c, v, b, n_rows=N_ROWS,
                                         mesh=mesh, axis="shards",
                                         schedule=s)
    out[f"relu_{mode}"] = spmm_shard_map(
        r, c, v, b, n_rows=N_ROWS, mesh=mesh, axis="shards",
        schedule=s.with_epilogue("relu"))
    out[f"dist_{mode}"] = dist_spmm(csr, b, mesh=mesh, axis="shards",
                                    schedule=s)
    for case in ("plain", "bias", "2d"):
        r, c, bias, q, k, vv = attn_inputs(case, part, csr)
        out[f"attn_{case}_{mode}"] = dist_attention_shard_map(
            r, c, jnp.asarray(q), jnp.asarray(k), jnp.asarray(vv),
            n_rows=N_ROWS, mesh=mesh, axis="shards", schedule=s,
            scale=SCALE, bias=bias)
out["dist_bf16"] = dist_spmm(csr, b, mesh=mesh, axis="shards",
                             schedule=Schedule(nnz_tile=64, group_size=8,
                                               collective="nnz_rs",
                                               value_dtype="bfloat16"))
calls = []
cache = ScheduleCache(path=None)
res = tune_dist_spmm(csr, N_DENSE, mesh=mesh, axis="shards", cache=cache,
                     measure=crc_measure(schedule_key, calls))
out["tuned"] = dist_spmm(csr, b, mesh=mesh, axis="shards",
                         schedule="tune", cache=cache)
np.savez(OUT + ".npz", **{k: np.asarray(v) for k, v in out.items()})
json.dump({"key": res.key, "pick": schedule_key(res.schedule),
           "us": res.us_per_call, "calls": calls}, open(OUT + ".json", "w"))
print("jax side done")
"""

JAX_MOE = COMMON + r"""
import jax, jax.numpy as jnp
import repro.configs as jcfgs
from repro.launch.mesh import make_local_mesh
from repro.models import get_model
from repro.models.moe import ShardingCtx, apply_moe, moe_tune_collective
from repro.train.optimizer import AdamW
from repro.train.train_step import TrainState, make_train_step
from repro.tune import ScheduleCache
from repro.tune.moe import MoeDispatchSchedule, moe_schedule_key
cfg = moe_cfg(jcfgs)
mp_ = {k: jnp.asarray(v) for k, v in MOE_P.items()}
mx, mw = jnp.asarray(MOE_X), jnp.asarray(MOE_W)
out, meta = {}, {}
single = MoeDispatchSchedule(capacity_factor=MOE_CF)

@jax.jit
def block_grad(p, x, w):  # single-shard math on one data block
    def obj(p, x):
        o, a = apply_moe(cfg, p, x, None, dispatch=single)
        return jnp.sum(w * o) + a
    return jax.grad(obj, argnums=(0, 1))(p, x)

for n_data in (1, 2):
    t = MOE_T // n_data
    for b in range(n_data):
        sl = slice(b * t, (b + 1) * t)
        gp, gx = block_grad(mp_, mx[sl], mw[sl])
        out[f"moe_gx_{n_data}_{b}"] = gx
        for k, v in gp.items():
            out[f"moe_g{k}_{n_data}_{b}"] = v
for mp in MOE_MESHES:
    mesh = make_local_mesh(mp)
    ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    for mode in MOE_MODES:
        disp = MoeDispatchSchedule(capacity_factor=MOE_CF, collective=mode)
        with mesh:
            o, a = jax.jit(lambda p, x: apply_moe(cfg, p, x, ctx,
                                                  dispatch=disp))(mp_, mx)
        out[f"moe_{mp}_{mode}"], out[f"moe_aux_{mp}_{mode}"] = o, a
    if mp != 2:
        continue
    # the reference's own sharded gradient against the single-shard math
    # of the same global objective (the blocks' aux losses averaged)
    def sharded_obj(p, x):
        o, a = apply_moe(cfg, p, x, ctx, dispatch=single)
        return jnp.sum(mw * o) + a
    def global_obj(p, x):
        outs = [apply_moe(cfg, p, x[b * 16:(b + 1) * 16], None,
                          dispatch=single) for b in range(2)]
        return (sum(jnp.sum(mw[b * 16:(b + 1) * 16] * o)
                    for b, (o, _) in enumerate(outs))
                + sum(a for _, a in outs) / 2)
    with mesh:
        gp, gx = jax.jit(jax.grad(sharded_obj, argnums=(0, 1)))(mp_, mx)
    wp, wx = jax.jit(jax.grad(global_obj, argnums=(0, 1)))(mp_, mx)
    for k, v, w in (("x", gx, wx), ("router", gp["router"], wp["router"]),
                    ("wg", gp["wg"], wp["wg"])):
        out[f"moe_sharded_g{k}"], out[f"moe_global_g{k}"] = v, w
    calls_m = []
    res_m = moe_tune_collective(cfg, mp_, mx, ctx,
                                cache=ScheduleCache(path=None),
                                measure=crc_measure(moe_schedule_key,
                                                    calls_m))
    meta["moe_tune"] = {"key": res_m.key,
                        "pick": moe_schedule_key(res_m.schedule),
                        "us": res_m.us_per_call, "calls": calls_m}

# two training steps: of the whole batch on one device, and the
# reference's own data-parallel step on (2, 2)
def path_str(path):
    return "/".join(str(getattr(k, "key", k)) for k in path)
def jax_param(path, s):
    p = path_str(path)
    if p.startswith("layers/"):
        return jnp.asarray(np.stack([
            train_param(p.replace("layers/", f"layers/{i}/", 1), s.shape[1:])
            for i in range(s.shape[0])]))
    return jnp.asarray(train_param(p, s.shape))
api = get_model(cfg)
params = jax.tree_util.tree_map_with_path(
    jax_param, jax.eval_shape(api.init, jax.random.PRNGKey(0)))
opt = AdamW(lr=1e-3)
mesh = make_local_mesh(2)
for label, ctx in (("one", None), ("mesh", ShardingCtx(
        mesh=mesh, data_axes=("data",), model_axis="model"))):
    state = TrainState(params=params, opt=opt.init(params))
    step = jax.jit(make_train_step(api, opt, ctx))
    losses = []
    with mesh:
        for tok in TRAIN_BATCHES:
            state, m = step(state, {"tokens": jnp.asarray(tok)})
            losses.append(float(m["loss"]))
    meta[f"train_losses_{label}"] = losses
    if label == "mesh":
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state.params)[0]:
            out["train/" + path_str(path)] = leaf
np.savez(OUT + ".npz", **{k: np.asarray(v) for k, v in out.items()})
json.dump(meta, open(OUT + ".json", "w"))
print("jax moe side done")
"""

CHILD = COMMON + r"""
import contextlib, io, os, sys
import torch
import torch.distributed as dist
rank, out_dir = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(out_dir, "store"), 4), rank=rank, world_size=4)
from repro_torch.distributed import collectives as coll
from repro_torch.launch import hillclimb
from repro_torch.launch.mesh import make_local_mesh, make_reduction_mesh
from repro_torch.serve.engine import ServeEngine
from repro_torch.sparse import Schedule, power_law_csr, random_csr
from repro_torch.sparse.distributed import (dist_attention_shard_map,
                                            dist_spmm, partition_nnz_coo,
                                            partition_rows_coo,
                                            spmm_shard_map)
from repro_torch.tune import ScheduleCache, schedule_key, tune_dist_spmm
mesh = make_reduction_mesh(device="cpu")
ax = mesh.axis("shards")
assert ax.index == rank and ax.size == 4
out, meta = {}, {}

# the collectives themselves, on a reduction mesh and a 2 x 2 mesh
x = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3) + rank
out["psum"] = coll.psum(x, ax)
out["pmax"] = coll.pmax(-x, ax)
out["scatter0"] = coll.psum_scatter(x, ax, scatter_dimension=0)
out["scatter1"] = coll.psum_scatter(x, ax, scatter_dimension=1)
try:
    coll.psum_scatter(x, ax, scatter_dimension=2)
except ValueError as e:
    meta["scatter2"] = str(e)
local = make_local_mesh(2, device="cpu")
out["local_data"] = coll.psum(x, local.axis("data"))
out["local_model"] = coll.psum(x, local.axis("model"))
meta["local"] = [local.axis("data").index, local.axis("model").index]

csr = power_law_csr(N_ROWS, N_KV, avg_degree=6.0, alpha=1.6, seed=0,
                    device="cpu")
b = torch.from_numpy(B)
for mode in MODES:
    part = partition_rows_coo if mode == "row" else partition_nnz_coo
    r, c, v, _ = part(csr, 4, 64)
    s = Schedule(nnz_tile=64, group_size=8, collective=mode)
    out[f"spmm_{mode}"] = spmm_shard_map(r, c, v, b, n_rows=N_ROWS,
                                         mesh=mesh, axis="shards",
                                         schedule=s)
    out[f"relu_{mode}"] = spmm_shard_map(
        r, c, v, b, n_rows=N_ROWS, mesh=mesh, axis="shards",
        schedule=s.with_epilogue("relu"))
    out[f"dist_{mode}"] = dist_spmm(csr, b, mesh=mesh, axis="shards",
                                    schedule=s)
    for case in ("plain", "bias", "2d"):
        r, c, bias, q, k, vv = attn_inputs(case, part, csr)
        out[f"attn_{case}_{mode}"] = dist_attention_shard_map(
            r, c, torch.from_numpy(q), torch.from_numpy(k),
            torch.from_numpy(vv), n_rows=N_ROWS, mesh=mesh, axis="shards",
            schedule=s, scale=SCALE, bias=bias)
out["dist_bf16"] = dist_spmm(csr, b, mesh=mesh, axis="shards",
                             schedule=Schedule(nnz_tile=64, group_size=8,
                                               collective="nnz_rs",
                                               value_dtype="bfloat16"))

# the tuner under the injected objective, a cache file, then a replay
path = os.path.join(out_dir, "dist_tune.json")
calls = []
res = tune_dist_spmm(csr, N_DENSE, mesh=mesh, axis="shards",
                     cache=ScheduleCache(path),
                     measure=crc_measure(schedule_key, calls))
def boom(s):
    raise AssertionError("a replay measured")
again = tune_dist_spmm(csr, N_DENSE, mesh=mesh, axis="shards",
                       cache=ScheduleCache(path), measure=boom)
out["tuned"] = dist_spmm(csr, b, mesh=mesh, axis="shards", schedule="tune",
                         cache=ScheduleCache(path))
meta["tune"] = {"key": res.key, "pick": schedule_key(res.schedule),
                "us": res.us_per_call, "calls": calls,
                "n_measurements": res.n_measurements,
                "replay": [again.from_cache, again.n_measurements,
                           schedule_key(again.schedule)]}

# the engine and the launcher, on real (one-call) measurements
class Api:
    def init_cache(self, slots, max_len, device=None):
        return {}
small = random_csr(64, 64, density=0.1, seed=5, device="cpu")
eng_path = os.path.join(out_dir, "engine.json")
eng = ServeEngine(Api(), {"embed": torch.zeros(1)}, slots=1, device="cpu",
                  tuner_cache=ScheduleCache(eng_path))
picked = eng.prepare_dist(small, 8, mesh=mesh, axis="shards")
eng2 = ServeEngine(Api(), {"embed": torch.zeros(1)}, slots=1, device="cpu",
                   tuner_cache=ScheduleCache(eng_path))
replayed = eng2.prepare_dist(small, 8, mesh=mesh, axis="shards")
check = tune_dist_spmm(small, 8, mesh=mesh, axis="shards",
                       cache=ScheduleCache(eng_path), measure=boom)
meta["engine"] = [schedule_key(picked), schedule_key(replayed),
                  check.from_cache, list(eng._sched_memo)]
runs = []
for _ in range(2):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hillclimb.main(["--dist", "--device", "cpu"])
    runs.append(buf.getvalue())
meta["hillclimb"] = runs

# the expert-parallel MoE: each rank's blocks, its gradients, the tuner
import math
import repro_torch.configs as tcfgs
from repro_torch.core.tree import (key_str, tree_leaves,
                                   tree_leaves_with_path, tree_unflatten)
from repro_torch.distributed import sharding
from repro_torch.models import get_model
from repro_torch.models.moe import (ShardingCtx, apply_moe,
                                    moe_tune_collective)
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import TrainState, zero1_shapes
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tune.moe import MoeDispatchSchedule, moe_schedule_key
cfg = moe_cfg(tcfgs)
whole = {k: torch.from_numpy(v) for k, v in MOE_P.items()}
for mp in MOE_MESHES:
    mesh = make_local_mesh(mp, device="cpu")
    ctx = ShardingCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    m_ax = mesh.axis("model")
    pb = sharding.shard_params(mesh, {"moe": whole}, "moe")["moe"]
    back = sharding.gather_params(mesh, {"moe": pb}, sharding.
                                  applied_shardings(mesh, {"moe": whole},
                                                    "moe"))["moe"]
    meta[f"moe_roundtrip_{mp}"] = all(torch.equal(back[k], whole[k])
                                      for k in whole)
    xb = sharding.data_block(mesh, ("data",), torch.from_numpy(MOE_X))
    wb = sharding.data_block(mesh, ("data",), torch.from_numpy(MOE_W))
    for mode in MOE_MODES:
        disp = MoeDispatchSchedule(capacity_factor=MOE_CF, collective=mode)
        x = xb.clone().requires_grad_(True)
        p = {k: v.clone().requires_grad_(True) for k, v in pb.items()}
        o, a = apply_moe(cfg, p, x, ctx, dispatch=disp, device="cpu")
        w = wb if o.shape[0] == wb.shape[0] else sharding.data_block(
            mesh, ("model",), wb)
        ((w * o).sum() + a).backward()
        out[f"moe_{mp}_{mode}"], out[f"moe_aux_{mp}_{mode}"] = o.detach(), a
        out[f"moe_gx_{mp}_{mode}"] = x.grad
        for k in p:
            out[f"moe_g{k}_{mp}_{mode}"] = p[k].grad
    if mp == 2:
        calls_m = []
        res_m = moe_tune_collective(
            cfg, pb, xb, ctx, cache=ScheduleCache(os.path.join(
                out_dir, "moe_tune.json")),
            measure=crc_measure(moe_schedule_key, calls_m))
        again_m = moe_tune_collective(
            cfg, pb, xb, ctx, cache=ScheduleCache(os.path.join(
                out_dir, "moe_tune.json")), measure=boom)
        meta["moe_tune"] = {
            "key": res_m.key, "pick": moe_schedule_key(res_m.schedule),
            "us": res_m.us_per_call, "calls": calls_m,
            "replay": [again_m.from_cache, again_m.n_measurements,
                       moe_schedule_key(again_m.schedule)]}
        # two data-parallel Trainer steps of the global batch, a whole
        # checkpoint, and its restore on the mesh into the rank's blocks
        api = get_model(cfg)
        like = api.init(torch.Generator().manual_seed(0), device="cpu")
        params = sharding.shard_params(mesh, tree_unflatten(like, [
            torch.from_numpy(train_param(key_str(p), tuple(v.shape)))
            for p, v in tree_leaves_with_path(like)]), cfg.family)
        opt = AdamW(lr=1e-3)
        def trainer():
            tr = Trainer(api, opt, iter([{"tokens": t}
                                         for t in TRAIN_BATCHES]),
                         ckpt_dir=os.path.join(out_dir, "ckpt"),
                         tcfg=TrainerConfig(total_steps=2, ckpt_every=2,
                                            log_every=100),
                         ctx=ctx, device="cpu")
            tr.monitor.straggler_factor = math.inf
            return tr
        tr = trainer()
        # ZeRO-1's moment blocks, the layout init_or_restore makes
        state = tr.run(TrainState(params=params, opt=opt.init(
            params, zero1_shapes(mesh, api))))
        meta["train_losses"] = tr.losses().tolist()
        restored = trainer().init_or_restore(torch.Generator().manual_seed(1))
        meta["restored_blocks_equal"] = all(
            torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                              tree_leaves(state)))
        meta["expert_block"] = list(state.params["layers"][0]["moe"][
            "wg"].shape)

np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
         **{k: v.detach().numpy() for k, v in out.items()})
json.dump(meta, open(os.path.join(out_dir, f"rank{rank}.json"), "w"))
dist.destroy_process_group()
"""


def _env(out_dir, **kw):
    return dict(os.environ, PYTHONPATH=SRC,
                REPRO_TUNE_CACHE=str(out_dir / "tune.json"),
                REPRO_BENCH_ITERS="1", REPRO_BENCH_WARMUP="0",
                OMP_NUM_THREADS="1", **kw)


def _start_ranks(out_dir):
    return [subprocess.Popen([sys.executable, "-c", CHILD, str(r),
                              str(out_dir)], env=_env(out_dir),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]


def _start_cli(out_dir):
    """``python -m repro_torch.launch.hillclimb --dist`` as 2 ranks under
    torchrun's environment, joining a world of their own on localhost."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cli = out_dir / "cli"
    cli.mkdir()
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.hillclimb", "--dist",
         "--device", "cpu", "--backend", "gloo"],
        env=_env(cli, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


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
    out_dir = tmp_path_factory.mktemp("dist_ranks")
    cli = _start_cli(out_dir)
    procs = _start_ranks(out_dir) + cli
    jax_out, moe_out = str(out_dir / "jax"), str(out_dir / "jax_moe")
    moe_side = {}

    def run_moe_side():  # the second JAX program, beside the first
        try:
            moe_side["stdout"] = run_distributed(
                f"OUT = {moe_out!r}\n" + JAX_MOE, timeout=300,
                device_count=WORLD)
        except BaseException as e:  # re-raised in the test's thread
            moe_side["error"] = e

    thread = threading.Thread(target=run_moe_side)
    thread.start()
    try:
        stdout = run_distributed(f"OUT = {jax_out!r}\n" + JAX_SIDE,
                                 timeout=300, device_count=WORLD)
        assert "jax side done" in stdout
        thread.join()
        if "error" in moe_side:
            raise moe_side["error"]
        assert "jax moe side done" in moe_side["stdout"]
    except BaseException:
        for p in procs:
            p.kill()
        raise
    _wait_ranks(procs)
    cli_out = [p.communicate()[0] for p in cli]
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]
    metas = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return {"ranks": ranks, "metas": metas, "cli": cli_out,
            "jax": {**np.load(jax_out + ".npz"), **np.load(moe_out + ".npz")},
            "jax_meta": {**json.loads(Path(jax_out + ".json").read_text()),
                         **json.loads(Path(moe_out + ".json").read_text())},
            "out_dir": out_dir}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (err, tol * scale)


def _gathered(runs, name, mode, row_axis=0):
    """The full result from the ranks: their row blocks concatenated
    (row, nnz_rs), or rank 0's whole copy after checking every rank holds
    the same (nnz_ar)."""
    parts = [r[name] for r in runs["ranks"]]
    if mode == "nnz_ar":
        for p in parts[1:]:
            np.testing.assert_array_equal(p, parts[0])
        return parts[0]
    return np.concatenate(parts, axis=row_axis)


def test_collectives_over_four_ranks(runs):
    xs = [np.arange(96, dtype=np.float32).reshape(4, 8, 3) + r
          for r in range(WORLD)]
    total = sum(xs)
    for r, got in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(got["psum"], total)
        np.testing.assert_array_equal(got["pmax"], -xs[0])
        np.testing.assert_array_equal(got["scatter0"], total[r:r + 1])
        np.testing.assert_array_equal(got["scatter1"],
                                      total[:, 2 * r:2 * r + 2])
        assert "does not split over 4 ranks" in runs["metas"][r]["scatter2"]
        d, m = runs["metas"][r]["local"]
        assert (d, m) == (r // 2, r % 2)
        np.testing.assert_array_equal(got["local_model"],
                                      xs[2 * d] + xs[2 * d + 1])
        np.testing.assert_array_equal(got["local_data"], xs[m] + xs[m + 2])


@pytest.mark.parametrize("mode", MODES)
def test_spmm_shard_map_matches_jax(runs, mode):
    _close(_gathered(runs, f"spmm_{mode}", mode), runs["jax"][f"spmm_{mode}"])


@pytest.mark.parametrize("mode", MODES)
def test_dist_spmm_under_a_schedule_matches_jax(runs, mode):
    _close(_gathered(runs, f"dist_{mode}", mode), runs["jax"][f"dist_{mode}"])


def test_dist_spmm_at_bf16_storage_matches_jax(runs):
    _close(_gathered(runs, "dist_bf16", "nnz_rs"), runs["jax"]["dist_bf16"])


@pytest.mark.parametrize("mode", MODES)
def test_epilogue_under_each_mode_matches_jax(runs, mode):
    """The reference applies a schedule's epilogue to each rank's partial
    (ROADMAP §3 item 11): under row that is the relu of the product, under
    the nnz modes the sum of relu'd partials, which is not.  The port
    gives the reference's answer in every mode; this pins the fault."""
    got = _gathered(runs, f"relu_{mode}", mode)
    want = runs["jax"][f"relu_{mode}"]
    _close(got, want)
    relu_of_product = np.maximum(runs["jax"]["spmm_row"], 0.0)
    if mode == "row":
        _close(got, relu_of_product)
    else:
        assert float(np.abs(want - relu_of_product).max()) > 1.0
        assert float(np.abs(got - relu_of_product).max()) > 1.0


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_dist_attention_matches_jax(runs, mode, case):
    axis = 0 if case == "2d" else 1
    got = _gathered(runs, f"attn_{case}_{mode}", mode, row_axis=axis)
    _close(got, runs["jax"][f"attn_{case}_{mode}"])


def test_tuner_picks_the_reference_point_on_every_rank(runs):
    want = runs["jax_meta"]
    for meta in runs["metas"]:
        t = meta["tune"]
        assert t["key"] == want["key"] and t["key"].endswith("|mesh:4")
        assert t["calls"] == want["calls"]
        assert t["pick"] == want["pick"] and t["us"] == want["us"]
        assert t["n_measurements"] == len(set(want["calls"]))
        assert t["replay"] == [True, 0, want["pick"]]


def test_tuned_dist_spmm_matches_jax(runs):
    mode = runs["jax_meta"]["pick"].split(":w[")[1].split("]")[0]
    _close(_gathered(runs, "tuned", mode), runs["jax"]["tuned"])


def test_prepare_dist_agrees_across_ranks_and_replays(runs):
    engines = [m["engine"] for m in runs["metas"]]
    for picked, replayed, from_cache, memo in engines:
        assert picked == replayed == engines[0][0]
        assert from_cache
        assert len(memo) == 1 and memo[0].endswith("|mesh:4")
        assert memo[0].startswith("dist:")


def test_hillclimb_dist_second_run_replays(runs):
    first, second = runs["metas"][0]["hillclimb"]
    assert first.count(" meas] ---") == 2 and "mesh=4" in first
    assert second.count("[cache] ---") == 2
    for meta in runs["metas"][1:]:
        assert meta["hillclimb"] == ["", ""]  # rank 0 prints
    picks = [line for line in first.splitlines() if "tuned" in line]
    assert [p.split(":")[0] for p in picks] == [
        p.split(":")[0] for p in second.splitlines() if "tuned" in p]


def test_hillclimb_dist_joins_a_world_from_torchrun_environment(runs):
    """``--dist --backend gloo`` under torchrun's variables initialises
    the world itself: its rank 0 tunes on a 2-rank mesh."""
    lead, other = runs["cli"]
    assert lead.count("mesh=2 [") == 2 and lead.count(" meas] ---") == 2
    assert "mesh=" not in other


# ---------------------------------------------------------------------------
# The expert-parallel MoE, its tuner and the data-parallel trainer
# ---------------------------------------------------------------------------

GRAD_REL_L2 = 1e-4
LOSS_RTOL = 2.0 ** -10


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _coords(r, mp):
    return r // mp, r % mp  # (data, model): ranks row-major on the mesh


@pytest.mark.parametrize("mode", ["None", "nnz_ar", "nnz_rs"])
@pytest.mark.parametrize("mp", [2, 4], ids=["mesh2x2", "mesh1x4"])
def test_expert_parallel_moe_matches_jax_shard_map(runs, mp, mode):
    """Each rank's block against the reference's ``shard_map`` output
    (global, rows data-major): (T_loc, D) under None and nnz_ar, the
    rank's (T_loc / M, D) slice under nnz_rs; the aux loss on every rank
    equal to the reference's; within 1e-4 of the largest magnitude."""
    want = runs["jax"][f"moe_{mp}_{mode}"]
    n_data = WORLD // mp
    t_loc = want.shape[0] // n_data
    for r, got in enumerate(runs["ranks"]):
        d, m = _coords(r, mp)
        block = want[d * t_loc:(d + 1) * t_loc]
        if mode == "nnz_rs":
            n = t_loc // mp
            block = block[m * n:(m + 1) * n]
        _close(got[f"moe_{mp}_{mode}"], block)
        _close(got[f"moe_aux_{mp}_{mode}"],
               runs["jax"][f"moe_aux_{mp}_{mode}"])


@pytest.mark.parametrize("mode", ["None", "nnz_ar", "nnz_rs"])
@pytest.mark.parametrize("mp", [2, 4], ids=["mesh2x2", "mesh1x4"])
def test_expert_parallel_moe_gradients_match_single_shard(runs, mp, mode):
    """Each rank's gradients of its objective (the weighted sum of its
    output block, or slice under nnz_rs, plus the aux loss) with respect
    to its token block, the router and its expert block, against
    ``jax.grad`` of the single-shard layer on the rank's data block (the
    einsum path): the weighted sum of the block's output plus the
    block's aux loss, within 1e-4 relative L2.  The collectives'
    adjoints count the experts' partial gradients once over the model
    axis and the aux loss's path once (``collectives.copy_to``)."""
    n_data = WORLD // mp
    e_loc = 4 // mp
    for r, got in enumerate(runs["ranks"]):
        d, m = _coords(r, mp)
        ref = {k: runs["jax"][f"moe_g{k}_{n_data}_{d}"]
               for k in ("x", "router", "wg", "wi", "wo")}
        assert _rel_l2(got[f"moe_gx_{mp}_{mode}"], ref["x"]) <= GRAD_REL_L2
        assert _rel_l2(got[f"moe_grouter_{mp}_{mode}"],
                       ref["router"]) <= GRAD_REL_L2
        for k in ("wg", "wi", "wo"):
            assert _rel_l2(got[f"moe_g{k}_{mp}_{mode}"],
                           ref[k][m * e_loc:(m + 1) * e_loc]) <= GRAD_REL_L2


def test_reference_sharded_moe_gradient_matches_its_single_shard(runs):
    """The check behind ROADMAP §3 (no item 13): ``jax.grad`` through the
    reference's ``shard_map`` layer on (2, 2), replication checking off,
    equals ``jax.grad`` of the same global objective (the weighted sum of
    the whole output plus the mean of the data blocks' aux losses) in
    single-shard math, within 1e-4 relative L2, so the port is held to
    the same math the reference computes."""
    for k in ("x", "router", "wg"):
        assert _rel_l2(runs["jax"][f"moe_sharded_g{k}"],
                       runs["jax"][f"moe_global_g{k}"]) <= GRAD_REL_L2, k


def test_moe_tune_collective_picks_the_reference_point(runs):
    want = runs["jax_meta"]["moe_tune"]
    assert want["key"].startswith("moedist:")
    assert want["key"].endswith("|mesh:2")
    for meta in runs["metas"]:
        t = meta["moe_tune"]
        assert t["key"] == want["key"]
        assert t["calls"] == want["calls"] and len(t["calls"]) == 2
        assert t["pick"] == want["pick"] and t["us"] == want["us"]
        assert t["replay"] == [True, 0, want["pick"]]


def test_shard_and_gather_params_round_trip_on_the_ranks(runs):
    for meta in runs["metas"]:
        assert meta["moe_roundtrip_2"] and meta["moe_roundtrip_4"]
        assert meta["expert_block"] == [2, 64, 64]


def test_data_parallel_trainer_matches_one_device_step(runs):
    """Two ``Trainer`` steps on (2, 2) (the global batch sliced by data
    coordinate, the gradients all-reduced over the data axis, the clip by
    the whole tree's norm) against the reference's ``make_train_step``
    on one device over the whole batch, and against its own step on a
    (2, 2) mesh: losses within 2^-10 relative on every rank."""
    for meta in runs["metas"]:
        for label in ("one", "mesh"):
            np.testing.assert_allclose(
                meta["train_losses"],
                runs["jax_meta"][f"train_losses_{label}"], rtol=LOSS_RTOL)


def test_checkpoint_written_on_a_mesh_restores_whole_in_one_process(runs):
    """The (2, 2) trainer's checkpoint holds whole leaves (the expert
    leaves gathered over the model axis, ZeRO-1's moment blocks over the
    data axis): it restores in this process into a one-process state
    whose parameters are the reference's after its two data-parallel
    steps on (2, 2) within 1e-4 relative L2; every rank restored it on
    the mesh into the same blocks it trained, moments included.  (The
    reference's one-device step is not the yardstick for parameters: its
    aux loss averages over the whole batch where a mesh averages over
    each data block, and AdamW's first step moves every element by about
    its learning rate whatever its gradient's size, so the reference's
    two steps differ from each other by 0.57 % on the embedding.)"""
    import torch

    import repro_torch.configs as tcfgs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import key_str, tree_leaves_with_path
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import TrainState

    ns = {}
    exec(COMMON, ns)
    like = get_model(ns["moe_cfg"](tcfgs)).init(
        torch.Generator().manual_seed(0), device="cpu")
    state, step = CheckpointManager(runs["out_dir"] / "ckpt").restore(
        TrainState(params=like, opt=AdamW().init(like)))
    assert step == 2
    for path, got in tree_leaves_with_path(state.params):
        name = key_str(path)
        if name.startswith("layers/"):
            _, i, rest = name.split("/", 2)
            want = runs["jax"]["train/layers/" + rest][int(i)]
        else:
            want = runs["jax"]["train/" + name]
        assert tuple(got.shape) == want.shape, name
        assert _rel_l2(got, want) <= GRAD_REL_L2, name
    assert all(meta["restored_blocks_equal"] for meta in runs["metas"])
