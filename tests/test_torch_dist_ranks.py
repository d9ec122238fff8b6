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
the replay are held).  Each rank saves what it holds (its row block
under row and nnz_rs) and the test gathers them.

The JAX side runs once per module on 4 forced host devices
(``conftest.run_distributed``), concurrently with the ranks, and saves
its outputs to an ``.npz``.  Tolerances: outputs within 1e-4 of their
largest magnitude (``tests/test_dist_strategies.py:57``); the tuner's
pick, the points it measured, in order, and its time equal to the
reference's under the same injected objective.
"""
import json
import os
import socket
import subprocess
import sys
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
np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
         **{k: v.numpy() for k, v in out.items()})
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
    try:
        jax_out = str(out_dir / "jax")
        stdout = run_distributed(f"OUT = {jax_out!r}\n" + JAX_SIDE,
                                 timeout=300, device_count=WORLD)
        assert "jax side done" in stdout
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
            "jax": dict(np.load(jax_out + ".npz")),
            "jax_meta": json.loads(Path(jax_out + ".json").read_text())}


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
