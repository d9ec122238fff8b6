"""Parity of the port's distributed pieces with the JAX package's, in one
process and with no process group (the cross-rank programs are
``test_torch_dist_ranks.py``): the partition helpers bit for bit,
``shard_nnz_counts``, ``_resolve_collective``, ``_feasible_collectives``,
the distributed cost model and the two collective byte predictors equal;
every shard's local SpMM (``_local_spmm``) and local attention pass
(``_local_attention``) on each slice the helpers give against the
reference's (interpret mode); and a one-member mesh, the counterpart of
``tests/test_dist_strategies.py``'s degenerate-mesh and cache tests:
every mode equals the single-device product and the tuned record
round-trips under a ``mesh:1`` key.

Inputs come from the generators both packages share (``power_law_csr``,
``random_csr``) and numpy seeds.  Tolerance: outputs within 1e-4 of
their largest magnitude (``tests/test_dist_strategies.py:57``); the
attention's row statistics m and l per element within 1e-5 of each
value plus 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.roofline.analysis as jra
import repro.sparse as js
import repro.sparse.distributed as jd
import repro.tune as jt
import repro.tune.search as jsearch
import repro_torch.core as tc
import repro_torch.roofline as tra
import repro_torch.sparse as ts
import repro_torch.sparse.distributed as td
import repro_torch.tune as tt
import repro_torch.tune.search as tsearch
from repro_torch.distributed import collectives as coll
from repro_torch.launch import mesh as tmesh
from repro_torch.serve.engine import ServeEngine

TOL = 1e-4
MODES = ("row", "nnz_ar", "nnz_rs")


def _pair(maker, *args, **kw):
    return (getattr(js, maker)(*args, **kw),
            getattr(ts, maker)(*args, **kw, device="cpu"))


CSRS = {
    "powerlaw": lambda: _pair("power_law_csr", 128, 96, avg_degree=6.0,
                              alpha=1.6, seed=0),
    "random": lambda: _pair("random_csr", 120, 80, density=0.05, seed=3),
    "empty_rows": lambda: _pair("random_csr", 64, 64, density=0.01,
                                skew=1.5, seed=1),
}


def _np(x):
    return None if x is None else np.asarray(
        x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol=TOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (err, tol * scale)


@pytest.fixture
def tuner_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_BENCH_ITERS", "1")
    monkeypatch.setenv("REPRO_BENCH_WARMUP", "0")
    tt.set_default_cache(None)
    yield tmp_path
    tt.set_default_cache(None)


# ---------------------------------------------------------------------------
# Host-side helpers and the cost model: equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CSRS))
@pytest.mark.parametrize("axis_size", [1, 3, 4])
@pytest.mark.parametrize("pattern_only,phantom_row",
                         [(False, False), (True, True), (False, True)])
def test_partition_nnz_coo_matches_jax_bit_for_bit(kind, axis_size,
                                                   pattern_only,
                                                   phantom_row):
    a_j, a_t = CSRS[kind]()
    want = jd.partition_nnz_coo(a_j, axis_size, 32,
                                pattern_only=pattern_only,
                                phantom_row=phantom_row)
    got = td.partition_nnz_coo(a_t, axis_size, 32,
                               pattern_only=pattern_only,
                               phantom_row=phantom_row)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert (g is None) == (w is None)
        if w is not None:
            assert _np(g).dtype == _np(w).dtype
            np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("kind", sorted(CSRS))
@pytest.mark.parametrize("axis_size", [1, 2, 3, 4])
@pytest.mark.parametrize("pattern_only,phantom_row",
                         [(False, False), (True, True)])
def test_partition_rows_coo_matches_jax_bit_for_bit(kind, axis_size,
                                                    pattern_only,
                                                    phantom_row):
    a_j, a_t = CSRS[kind]()
    kw = dict(pattern_only=pattern_only, phantom_row=phantom_row)
    if a_t.shape[0] % axis_size:
        with pytest.raises(ValueError, match="divisible"):
            jd.partition_rows_coo(a_j, axis_size, 32, **kw)
        with pytest.raises(ValueError, match="divisible"):
            td.partition_rows_coo(a_t, axis_size, 32, **kw)
        return
    want = jd.partition_rows_coo(a_j, axis_size, 32, **kw)
    got = td.partition_rows_coo(a_t, axis_size, 32, **kw)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("kind", sorted(CSRS))
@pytest.mark.parametrize("axis_size", [1, 3, 4, 8])
@pytest.mark.parametrize("collective", MODES)
def test_shard_nnz_counts_match_jax(kind, axis_size, collective):
    a_j, a_t = CSRS[kind]()
    assert (td.shard_nnz_counts(a_t, axis_size, collective)
            == jd.shard_nnz_counts(a_j, axis_size, collective))


@pytest.mark.parametrize("mode,collective", [
    (None, None), ("row", None), ("nnz_ar", None), (None, "nnz_ar"),
    ("nnz_rs", "nnz_rs"), ("row", "nnz_ar"), ("bogus", None)])
def test_resolve_collective_matches_jax(mode, collective):
    sched_j = jc.Schedule(collective=collective)
    sched_t = tc.Schedule(collective=collective)
    try:
        want = jd._resolve_collective(mode, sched_j)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(";")[0][:20]):
            td._resolve_collective(mode, sched_t)
        return
    assert td._resolve_collective(mode, sched_t) == want
    assert td._resolve_collective(mode, None) == jd._resolve_collective(
        mode, None)


@pytest.mark.parametrize("n_rows", [169_343, 169_344, 128, 7])
@pytest.mark.parametrize("axis_size", [1, 2, 3, 4])
def test_feasible_collectives_match_jax(n_rows, axis_size):
    stats = {"n_rows": n_rows}
    assert (tsearch._feasible_collectives(stats, axis_size)
            == jsearch._feasible_collectives(stats, axis_size))


@pytest.mark.parametrize("kind", sorted(CSRS))
@pytest.mark.parametrize("axis_size", [1, 2, 4])
def test_dist_cost_model_matches_jax(kind, axis_size):
    a_j, a_t = CSRS[kind]()
    stats = js.matrix_stats(a_j)
    assert tc.WIRE_COST_WEIGHT == jc.WIRE_COST_WEIGHT
    for n in (8, 20, 256):
        for base_j, base_t in zip(jc.candidate_schedules(n),
                                  tc.candidate_schedules(n)):
            for mode in (None,) + MODES:
                sj = base_j.replace(collective=mode)
                st = base_t.replace(collective=mode)
                shard = jd.shard_nnz_counts(a_j, axis_size, mode or "nnz_ar")
                kw = dict(n_rows=stats["n_rows"], n_dense_cols=n,
                          axis_size=axis_size, shard_nnz=shard)
                assert (tc.collective_cost_terms(mode, **kw)
                        == jc.collective_cost_terms(mode, **kw))
                assert tc.predict_dist_cost(
                    stats, st, n, axis_size=axis_size, shard_nnz=shard) == (
                    jc.predict_dist_cost(stats, sj, n, axis_size=axis_size,
                                         shard_nnz=shard))
    with pytest.raises(ValueError, match="unknown collective"):
        tc.collective_cost_terms("bogus", n_rows=8, n_dense_cols=4,
                                 axis_size=2)


@pytest.mark.parametrize("axis_size", [1, 2, 3, 4])
@pytest.mark.parametrize("collective", (None,) + MODES)
def test_collective_byte_predictors_match_jax(axis_size, collective):
    for shape in ((169_344, 256), (128, 20), (7, 3)):
        for itemsize in (4, 2):
            kw = dict(axis_size=axis_size, itemsize=itemsize)
            assert tra.predict_collective_bytes(collective, shape, **kw) == (
                jra.predict_collective_bytes(collective, shape, **kw))
    for h, r, dv in ((4, 169_344, 64), (2, 128, 24), (1, 9, 8)):
        kw = dict(n_heads=h, n_rows=r, dv_pad=dv, axis_size=axis_size)
        assert tra.predict_attention_collective_bytes(collective, **kw) == (
            jra.predict_attention_collective_bytes(collective, **kw))


# ---------------------------------------------------------------------------
# Each shard's local pass against the reference's, on every slice
# ---------------------------------------------------------------------------


def _slices(n, axis_size):
    block = n // axis_size
    return [slice(s * block, (s + 1) * block) for s in range(axis_size)]


LOCAL_SCHEDULES = {
    "eb": dict(kernel="eb", nnz_tile=64, group_size=8),
    "eb_accumulate": dict(kernel="eb", nnz_tile=32, group_size=16,
                          strategy="accumulate"),
    "rb": dict(kernel="rb", row_tile=8, strategy="parallel"),
    "skew": dict(kernel="eb", nnz_tile=64, group_size=8,
                 split_threshold=16, merge_threshold=4),
}


@pytest.mark.parametrize("name", sorted(LOCAL_SCHEDULES))
@pytest.mark.parametrize("part", ["rows", "nnz"])
def test_local_spmm_matches_jax_on_every_shard(name, part):
    a_j, a_t = CSRS["powerlaw"]()
    axis_size = 4
    b = np.random.default_rng(1).standard_normal((96, 20)).astype(np.float32)
    helper = "partition_rows_coo" if part == "rows" else "partition_nnz_coo"
    rj, cj, vj, _ = getattr(jd, helper)(a_j, axis_size, 64)
    rt, ct, vt, _ = getattr(td, helper)(a_t, axis_size, 64)
    n_rows = 128 // axis_size if part == "rows" else 128
    sj = jc.Schedule(**LOCAL_SCHEDULES[name])
    st = tc.Schedule(**LOCAL_SCHEDULES[name])
    for sl in _slices(rt.shape[0], axis_size):
        want = jd._local_spmm(rj[sl], cj[sl], vj[sl], jnp.asarray(b),
                              n_rows, sj, interpret=True)
        got = td._local_spmm(rt[sl], ct[sl], vt[sl], torch.from_numpy(b),
                             n_rows, st)
        _close(got, want)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("part", ["rows", "nnz"])
def test_local_attention_matches_jax_on_every_shard(bias, part):
    a_j, a_t = CSRS["powerlaw"]()
    axis_size, h, d, dv = 4, 2, 16, 24
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((h, 128, d), (h, 96, d), (h, 96, dv)))
    helper = "partition_rows_coo" if part == "rows" else "partition_nnz_coo"
    kw = dict(pattern_only=not bias, phantom_row=True)
    rj, cj, bj, _ = getattr(jd, helper)(a_j, axis_size, 64, **kw)
    rt, ct, bt, _ = getattr(td, helper)(a_t, axis_size, 64, **kw)
    block = 128 // axis_size
    scale = 1.0 / np.sqrt(d)
    for s, sl in enumerate(_slices(rt.shape[0], axis_size)):
        qq = q[:, s * block:(s + 1) * block] if part == "rows" else q
        n_rows = block if part == "rows" else 128
        want = jd._local_attention(
            rj[sl], cj[sl], jnp.asarray(qq), jnp.asarray(k), jnp.asarray(v),
            n_rows=n_rows, dv_tile=24, scale=scale,
            sched=jc.Schedule(nnz_tile=64, group_size=8),
            bias=None if bj is None else bj[sl], interpret=True)
        got = td._local_attention(
            rt[sl], ct[sl], torch.from_numpy(qq), torch.from_numpy(k),
            torch.from_numpy(v), n_rows=n_rows, scale=scale,
            bias=None if bt is None else bt[sl])
        _close(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            g, w = _np(g), _np(w)
            assert np.all(np.abs(g - w) <= 1e-5 * np.abs(w) + 1e-6)


def test_local_spmm_applies_the_epilogue_to_each_partial_as_jax():
    """The reference hands the schedule's epilogue to each shard's
    partial (ROADMAP §3 item 11): a relu shard by shard, before any
    combine.  The port keeps that; the cross-rank consequence is pinned
    in ``test_torch_dist_ranks.py``."""
    a_j, a_t = CSRS["powerlaw"]()
    b = np.random.default_rng(1).standard_normal((96, 20)).astype(np.float32)
    rj, cj, vj, _ = jd.partition_nnz_coo(a_j, 4, 64)
    rt, ct, vt, _ = td.partition_nnz_coo(a_t, 4, 64)
    sj = jc.Schedule(nnz_tile=64, group_size=8).with_epilogue("relu")
    st = tc.Schedule(nnz_tile=64, group_size=8).with_epilogue("relu")
    for sl in _slices(rt.shape[0], 4):
        got = td._local_spmm(rt[sl], ct[sl], vt[sl], torch.from_numpy(b),
                             128, st)
        _close(got, jd._local_spmm(rj[sl], cj[sl], vj[sl], jnp.asarray(b),
                                   128, sj, interpret=True))
        assert float(got.min()) >= 0.0
    with pytest.raises(ValueError, match="bias"):
        td._local_spmm(rt, ct, vt, torch.from_numpy(b), 128,
                       tc.Schedule().with_epilogue(None, bias=True))


# ---------------------------------------------------------------------------
# A one-member mesh: no process group, no collective call
# ---------------------------------------------------------------------------


def test_meshes_without_a_process_group():
    m = tmesh.make_reduction_mesh(device="cpu")
    assert m.shape == {"shards": 1} and m.axis_names == ("shards",)
    assert m.axis("shards") == tmesh.MeshAxis("shards", 1, 0, None)
    assert m.device == torch.device("cpu")
    loc = tmesh.make_local_mesh(device="cpu")
    assert loc.shape == {"data": 1, "model": 1}
    assert loc.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_reduction_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_local_mesh(3, device="cpu")
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            tmesh.make_production_mesh(multi_pod=multi, device="cpu")
    with pytest.raises(KeyError, match="no axis"):
        m.axis("model")


def test_collectives_on_a_one_member_axis_are_the_identity():
    ax = tmesh.make_reduction_mesh(device="cpu").axis("shards")
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert coll.psum(x, ax) is x and coll.pmax(x, ax) is x
    assert coll.psum_scatter(x, ax, scatter_dimension=1) is x
    coll.barrier(ax)


@pytest.mark.parametrize("mode", MODES)
def test_one_member_mesh_matches_spmm(mode):
    """Counterpart of ``test_dist_strategies.py:174``: on one member
    every mode is the single-device product."""
    a_j, a_t = _pair("power_law_csr", 64, 48, avg_degree=5.0, alpha=1.5,
                     seed=0)
    mesh = tmesh.make_reduction_mesh(device="cpu")
    b = np.random.default_rng(1).standard_normal((48, 12)).astype(np.float32)
    want = js.spmm(a_j, jnp.asarray(b))
    sched = tc.Schedule(nnz_tile=32, group_size=8, collective=mode)
    part = td.partition_rows_coo if mode == "row" else td.partition_nnz_coo
    r, c, v, _ = part(a_t, 1, 32)
    bt = torch.from_numpy(b)
    _close(ts.spmm_shard_map(r, c, v, bt, n_rows=64, mesh=mesh,
                             axis="shards", schedule=sched), want)
    _close(ts.dist_spmm(a_t, bt, mesh=mesh, axis="shards", schedule=sched),
           want)
    _close(ts.dist_spmm(a_t, bt, mesh=mesh, axis="shards",
                        schedule=sched.replace(value_dtype="bfloat16")),
           js.spmm(a_j, jnp.asarray(b), schedule=jc.Schedule(
               nnz_tile=32, group_size=8, value_dtype="bfloat16")))


@pytest.mark.parametrize("mode", MODES)
def test_one_member_mesh_attention_matches_sparse_attention(mode):
    a_j, a_t = _pair("power_law_csr", 64, 48, avg_degree=5.0, alpha=1.5,
                     seed=0)
    mesh = tmesh.make_reduction_mesh(device="cpu")
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((64, 16), (48, 16), (48, 12)))
    coo = a_j.tocoo()
    want = js.sparse_attention((coo.rows, coo.cols, 64), jnp.asarray(q),
                               jnp.asarray(k), jnp.asarray(v))
    part = td.partition_rows_coo if mode == "row" else td.partition_nnz_coo
    r, c, _, _ = part(a_t, 1, 32, pattern_only=True, phantom_row=True)
    got = ts.dist_attention_shard_map(
        r, c, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        n_rows=64, mesh=mesh, axis="shards", mode=mode)
    _close(got, want)


def _crc(key_fn):
    import zlib

    calls = []

    def measure(s):
        calls.append(s)
        return (zlib.crc32(key_fn(s).encode()) % 997 + 1) * 1e-6

    return measure, calls


def test_dist_tune_cache_roundtrip_one_member(tuner_env):
    """Counterpart of ``test_dist_strategies.py:233``: the pick under one
    injected objective is the reference's, its record round-trips on disk
    under a ``mesh:1`` key and replays with no measurement."""
    a_j, a_t = _pair("power_law_csr", 64, 48, avg_degree=5.0, alpha=1.5,
                     seed=0)
    mesh = tmesh.make_reduction_mesh(device="cpu")
    path = tuner_env / "dist.json"
    m_t, calls_t = _crc(tt.schedule_key)
    m_j, calls_j = _crc(jt.schedule_key)
    got = tt.tune_dist_spmm(a_t, 12, mesh=mesh, axis="shards",
                            cache=tt.ScheduleCache(path), measure=m_t)
    want = jt.tune_dist_spmm(a_j, 12, mesh=jax.make_mesh((1,), ("shards",)),
                             axis="shards", cache=jt.ScheduleCache(None),
                             measure=m_j)
    assert got.key == want.key == f"dist:{tt.cache_key(a_t, 12)}|mesh:1"
    assert [tt.schedule_key(s) for s in calls_t] == [
        jt.schedule_key(s) for s in calls_j]
    assert tt.schedule_key(got.schedule) == jt.schedule_key(want.schedule)
    assert got.us_per_call == want.us_per_call

    def boom(_s):
        raise AssertionError("replay must not measure")

    again = tt.tune_dist_spmm(a_t, 12, mesh=mesh, axis="shards",
                              cache=tt.ScheduleCache(path), measure=boom)
    assert again.from_cache and again.n_measurements == 0
    assert again.schedule == got.schedule
    # the engine's memo under the reference's key, and a replay through it
    eng = ServeEngine(type("A", (), {"init_cache": lambda *a, **k: {}})(),
                      {"embed": torch.zeros(1)}, slots=1, device="cpu",
                      tuner_cache=tt.ScheduleCache(path))
    assert eng.prepare_dist(a_t, 12, mesh=mesh, axis="shards") == (
        got.schedule)
    assert eng._sched_memo[got.key] == got.schedule
    b = torch.randn(48, 12)
    out = ts.dist_spmm(a_t, b, mesh=mesh, axis="shards", schedule="tune",
                       cache=tt.ScheduleCache(path))
    _close(out, ts.spmm(a_t, b, schedule=got.schedule.replace(
        collective=None), device="cpu"))


def test_dist_cache_key_includes_mesh_size(tuner_env):
    """Counterpart of ``test_dist_strategies.py:290``."""
    a_t = ts.power_law_csr(64, 48, avg_degree=5.0, alpha=1.5, seed=0,
                           device="cpu")
    res = tt.tune_dist_spmm(a_t, 12, mesh=tmesh.make_reduction_mesh(
        device="cpu"), axis="shards", cache=tt.ScheduleCache(None),
        measure=lambda s: 1.0, top_k=1, hill_steps=0)
    assert res.key == f"dist:{tt.cache_key(a_t, 12)}|mesh:1"


def test_dist_measurement_runs_the_shard_program(tuner_env):
    a_t = ts.power_law_csr(64, 48, avg_degree=5.0, alpha=1.5, seed=0,
                           device="cpu")
    mesh = tmesh.make_reduction_mesh(device="cpu")
    for mode in MODES:
        sched = tc.Schedule(nnz_tile=32, group_size=8, collective=mode)
        fn, args = tt.make_dist_runner(a_t, 12, sched, mesh=mesh,
                                       axis="shards")
        _close(fn(*args), ts.spmm(a_t, args[3], device="cpu"))
        assert tt.measure_dist_schedule(a_t, 12, sched, mesh=mesh,
                                        axis="shards") > 0.0


def test_hillclimb_dist_under_torchrun_needs_a_backend(monkeypatch):
    from repro_torch.launch import hillclimb

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="needs --backend"):
        hillclimb.main(["--dist", "--device", "cpu"])


# ---------------------------------------------------------------------------
# Sharding rules (distributed/sharding.py) against the reference's
# ---------------------------------------------------------------------------


class _ShapeMesh:
    """What the rule functions read of a mesh: its axes and their sizes."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


class _RankMesh(_ShapeMesh):
    """A (data, model) mesh seen from one rank's coordinates, with no
    process group (``shard_params`` reads only ``axis(name).index``)."""

    def __init__(self, shape, coords):
        super().__init__(shape, ("data", "model"))
        self._axes = {n: tmesh.MeshAxis(n, s, i, None)
                      for n, s, i in zip(self.axis_names, shape, coords)}

    def axis(self, name):
        return self._axes[name]


def _canon(spec):
    """A spec as a tuple, one-axis tuples as their axis (PartitionSpec
    prints and compares them so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


SHARDING_MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
                   ((2, 2, 2), ("pod", "data", "model")), ((1, 1),
                                                           ("data", "model"))]


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "qwen2-7b"])
@pytest.mark.parametrize("shape,names", SHARDING_MESHES)
def test_param_shardings_match_reference(arch, shape, names):
    """Every leaf's spec equals the reference's on its parameter paths:
    ``_param_spec`` on the reference's own paths and ranks (the stacked L
    axis included), and ``param_shardings`` on the port's tree, whose
    layer leaves carry no L axis (the reference's spec without its
    leading None); ``_fit`` drops every dim that does not divide."""
    from jax.sharding import AbstractMesh

    import repro.configs as jcfgs
    import repro.distributed.sharding as jsh
    import repro.models as jmodels
    import repro_torch.configs as tcfgs
    import repro_torch.distributed.sharding as tsh
    from repro_torch.core.tree import key_str, tree_leaves_with_path
    from repro_torch.models.transformer import params_from_jax

    cfg_j = jcfgs.smoke_config(jcfgs.ARCHS[arch])
    cfg_t = tcfgs.smoke_config(tcfgs.ARCHS[arch])
    jmesh, tmesh_ = AbstractMesh(shape, names), _ShapeMesh(shape, names)
    jshape = jax.eval_shape(jmodels.get_model(cfg_j).init,
                            jax.random.PRNGKey(0))
    leaves = {jsh._path_str(p): v
              for p, v in jax.tree_util.tree_flatten_with_path(jshape)[0]}
    for p, leaf in leaves.items():
        want = [tsh.DATA if e == jsh.DATA else e
                for e in jsh._param_spec(p, leaf.ndim)]
        assert _canon(tsh._param_spec(p, leaf.ndim)) == _canon(want), p
    params = params_from_jax(cfg_t, jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), jshape), device="cpu")
    got = tsh.param_shardings(tmesh_, params)
    assert list(got) == [key_str(p) for p, _ in tree_leaves_with_path(
        params)]
    want = jsh.param_shardings(jmesh, jshape)
    for path, sh in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        p = jsh._path_str(path)
        full = _canon(tuple(sh.spec))
        full += (None,) * (leaves[p].ndim - len(full))
        if p.startswith("layers/"):
            for i in range(cfg_t.n_layers):
                q = p.replace("layers/", f"layers/{i}/", 1)
                assert _canon(got[q]) == full[1:], (q, got[q], full)
        else:
            assert _canon(got[p]) == full, (p, got[p], full)


@pytest.mark.parametrize("shape,names", SHARDING_MESHES)
def test_batch_and_cache_shardings_match_reference(shape, names):
    from jax.sharding import AbstractMesh

    import repro.distributed.sharding as jsh
    import repro_torch.distributed.sharding as tsh

    jmesh, tmesh_ = AbstractMesh(shape, names), _ShapeMesh(shape, names)
    batch = {"tokens": (8, 16), "mask": (8, 15), "odd": (3, 5)}
    want = jsh.batch_shardings(jmesh, {
        k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in batch.items()})
    got = tsh.batch_shardings(tmesh_, {k: torch.zeros(s)
                                       for k, s in batch.items()})
    for k in batch:
        assert _canon(got[k]) == _canon(tuple(want[k].spec)), k
    cache = {"k": (2, 8, 32, 4, 16), "v": (2, 8, 32, 4, 16),
             "ck": (2, 8, 1500, 20, 64), "ssm": (2, 8, 16, 4, 8),
             "conv": (2, 8, 3, 32), "other": (3,)}
    want = jsh.cache_shardings(jmesh, None, {
        **{k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in cache.items()},
        "pos": jax.ShapeDtypeStruct((), jnp.int32)})
    got = tsh.cache_shardings(tmesh_, None, {
        **{k: torch.zeros(s) for k, s in cache.items()}, "pos": 7})
    for k in list(cache) + ["pos"]:
        assert _canon(got[k]) == _canon(tuple(want[k].spec)), k
    assert tsh.replicated(tmesh_) == tuple(jsh.replicated(jmesh).spec)
    assert tsh.data_axes(tmesh_) == jsh.data_axes(jmesh)


def test_fit_matches_reference():
    import repro.distributed.sharding as jsh
    import repro_torch.distributed.sharding as tsh
    from jax.sharding import PartitionSpec as P

    mesh = _ShapeMesh((2, 4, 2), ("pod", "data", "model"))
    cases = [(("model", None), (6, 3)), ((("pod", "data"), None), (8, 3)),
             ((("pod", "data"), "model"), (12, 6)), ((None, "data"), (5, 6)),
             (("model", "data", None), (7, 8, 9))]
    for spec, shape in cases:
        assert _canon(tsh._fit(mesh, spec, shape)) == _canon(
            tuple(jsh._fit(mesh, P(*spec), shape)))


def test_shard_params_blocks_tile_the_whole_and_init_draws_them():
    """Over every coordinate of a (2, 2) mesh the blocks of each leaf
    the MoE family applies a spec to tile the whole: the experts along E
    and the embedding along the vocabulary in model order, the attention
    weights along their input dim in data order (FSDP; the biases and
    norms whole); every other leaf stays whole; a data block of a batch
    is its rows in data order, and ``init_params(mesh=)`` holds the same
    bits as the whole draw's blocks; on a one-member mesh
    ``gather_params`` is the identity."""
    import repro_torch.configs as tcfgs
    import repro_torch.distributed.sharding as tsh
    from repro_torch.core.tree import key_str, tree_leaves_with_path
    from repro_torch.models import get_model

    cfg = tcfgs.smoke_config(tcfgs.ARCHS["qwen3-moe-235b-a22b"])
    api = get_model(cfg)
    whole = api.init(torch.Generator().manual_seed(0), device="cpu")
    wl = tree_leaves_with_path(whole)
    blocks = {}
    for d in range(2):
        for m in range(2):
            mesh = _RankMesh((2, 2), (d, m))
            got = tree_leaves_with_path(tsh.shard_params(mesh, whole, "moe"))
            drawn = tree_leaves_with_path(api.init(
                torch.Generator().manual_seed(0), device="cpu", mesh=mesh))
            for (p, a), (_, b) in zip(got, drawn):
                assert torch.equal(a, b), key_str(p)
            blocks[(d, m)] = got
            x = torch.arange(8 * 3).reshape(8, 3)
            assert torch.equal(tsh.data_block(mesh, ("data",), x),
                               x[4 * d:4 * d + 4])
    split = {"model": [], "data": []}
    for i, (path, leaf) in enumerate(wl):
        name = key_str(path)
        if "/moe/w" in name or name == "embed":
            for d in range(2):  # along dim 0 in model order
                parts = [blocks[(d, m)][i][1] for m in range(2)]
                assert parts[0].shape[0] == leaf.shape[0] // 2
                assert torch.equal(torch.cat(parts), leaf), name
            split["model"].append(name)
        elif "/attn/" in name and name.endswith("/w"):
            for m in range(2):  # along the input dim in data order
                parts = [blocks[(d, m)][i][1] for d in range(2)]
                assert parts[0].shape[0] == leaf.shape[0] // 2
                assert torch.equal(torch.cat(parts), leaf), name
            split["data"].append(name)
        else:
            assert all(torch.equal(b[i][1], leaf)
                       for b in blocks.values()), name
    assert len(split["model"]) == 1 + 3 * cfg.n_layers
    assert len(split["data"]) == 4 * cfg.n_layers
    one = tmesh.make_local_mesh(1, device="cpu")
    specs = tsh.applied_shardings(one, whole, "moe")
    for (p, a), (_, b) in zip(wl, tree_leaves_with_path(
            tsh.gather_params(one, tsh.shard_params(one, whole, "moe"),
                              specs))):
        assert torch.equal(a, b), key_str(p)
    with pytest.raises(ValueError, match="does not split"):
        tsh.data_block(_RankMesh((3, 1), (0, 0)), ("data",),
                       torch.zeros(8))
