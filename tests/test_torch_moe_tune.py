"""Parity of the port's MoE dispatch tuner (``repro_torch.tune.moe``), the
tuning half of ``repro_torch.models.moe`` and the serving engine's tuned
side channel with the JAX package (``repro.tune.moe``,
``repro.models.moe``, ``repro.serve.engine``) on the CPU, on the same
numpy-built inputs:

* keys and the cost model byte for byte: ``moe_schedule_key``,
  ``moe_cache_key``, ``moe_capacity``, ``dropped_tokens``, ``moe_cost``
  and the ``candidate_moe_schedules`` keys, over balanced, skewed and
  random histograms, both shrink modes, with and without ``max_tokens``;
* the reference's properties (``tests/test_moe_tuner.py``): no pick drops
  more than the default, an assumed histogram never shrinks, the shrink
  flag keys separate records, the capacity clamps, the resolver never
  measures, a replay measures nothing, validation;
* the search under one injected objective of ``(tile, cap_pad,
  capacity_factor)``: the port, which dedupes on its kernel's program
  ``(tile, cap_pad)``, never measures a program twice and picks the
  reference's program at its time, except where the reference's pool
  spends its five points on d/f tilings of fewer programs: there the
  port reaches a faster one (one case, held as such);
* ``apply_moe(dispatch=)`` against the JAX ``apply_moe(dispatch=)`` on
  the einsum path and on the kernel path (the JAX kernel in interpret
  mode, the port's plain version), token tiles 8 and 16, capacity
  factors 1.0, 1.25 and 2.0, combines sum, min and mean;
* ``ServeEngine``'s ``prepare_sparse`` / ``spmm`` and ``prepare_moe`` /
  ``moe_dispatch_schedule`` against the JAX engine's, replaying with no
  measurement; ``launch.hillclimb --moe --device cpu`` twice.

Every test that tunes sets ``REPRO_TUNE_CACHE`` to its ``tmp_path`` (many
also keep their cache in memory); default measurements take one timed call
(``REPRO_BENCH_ITERS=1``, ``REPRO_BENCH_WARMUP=0``).  Tolerance: f32
rtol = atol = 1e-5, the bound ``test_torch_moe.py`` holds ``apply_moe``
to.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sparse as js
import repro.tune as jt
import repro.tune.moe as jm
import repro_torch.sparse as ts
import repro_torch.tune as tt
import repro_torch.tune.moe as tm
from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_config as jsmoke
from repro.models import get_model as jget_model
from repro.models import moe as jmoe
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import hillclimb
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import params_from_jax
from repro_torch.serve import ServeEngine

RTOL = ATOL = 1e-5

SKEWED = np.array([300, 200, 100, 50, 25, 12, 6, 3])
BALANCED = np.full(8, 128)


def _random_hist(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 400, size=int(rng.integers(4, 64)))


HISTS = {"balanced": BALANCED, "skewed": SKEWED,
         "balanced128": np.full(128, 64),
         **{f"random{s}": _random_hist(s) for s in range(4)}}


@pytest.fixture
def tuner_env(tmp_path, monkeypatch):
    """A tmp cache base, one timed call per measurement, the default
    caches restored afterwards."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_BENCH_ITERS", "1")
    monkeypatch.setenv("REPRO_BENCH_WARMUP", "0")
    tt.set_default_cache(None)
    jt.set_default_cache(None)
    yield tmp_path
    tt.set_default_cache(None)
    jt.set_default_cache(None)


def _fake_measure():
    """The reference tests' instant objective, keyed on the schedule
    string.  Returns (measure, points measured)."""
    calls = []

    def measure(s):
        calls.append(s)
        h = sum(ord(c) for c in tm.moe_schedule_key(s))
        return 1e-3 * (1.0 + (h % 89) / 89.0)

    return measure, calls


def _program_measure(lengths, max_tokens):
    """One objective of ``(tile, cap_pad, capacity_factor)`` for both
    packages: padded rows, a per-tile overhead, a tie-break on the
    factor.  Returns (measure, programs measured)."""
    calls = []

    def measure(s):
        tile, cap_pad = tm.moe_program(lengths, s, max_tokens)
        calls.append((tile, cap_pad))
        return (cap_pad + 50.0 / tile + 0.01 * s.capacity_factor) * 1e-6

    return measure, calls


def _jsched(s):
    return jm.MoeDispatchSchedule(**dataclasses.asdict(s))


# ---------------------------------------------------------------------------
# Keys and the cost model: the reference's bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(HISTS))
@pytest.mark.parametrize("shrink", [True, False])
@pytest.mark.parametrize("max_tokens", [None, 256])
def test_keys_capacity_and_cost_equal_jax(name, shrink, max_tokens):
    h = HISTS[name]
    for d, f, dtype in ((128, 256, "float32"), (4096, 1536, "bfloat16")):
        assert tm.moe_cache_key(h, d, f, dtype, shrink=shrink,
                                max_tokens=max_tokens) == jm.moe_cache_key(
            h, d, f, dtype, shrink=shrink, max_tokens=max_tokens)
    # a torch histogram keys as its numpy copy does
    assert tm.moe_cache_key(torch.from_numpy(h), 64, 64) == (
        jm.moe_cache_key(h, 64, 64))
    default = tm.MoeDispatchSchedule(capacity_factor=1.25)
    cands = tm.candidate_moe_schedules(h, default=default,
                                       allow_capacity_shrink=shrink,
                                       max_tokens=max_tokens)
    jcands = jm.candidate_moe_schedules(h, default=_jsched(default),
                                        allow_capacity_shrink=shrink,
                                        max_tokens=max_tokens)
    assert [tm.moe_schedule_key(s) for s in cands] == [
        jm.moe_schedule_key(s) for s in jcands]
    for cf in tm.CAPACITY_FACTORS + (0.5, 3.0):
        cap = tm.moe_capacity(h, cf, max_tokens=max_tokens)
        assert cap == jm.moe_capacity(h, cf, max_tokens=max_tokens)
        assert tm.dropped_tokens(h, cap) == jm.dropped_tokens(h, cap)
    for s in cands[::7]:
        assert tm.moe_cost(h, s, 128, 256, max_tokens) == jm.moe_cost(
            h, _jsched(s), 128, 256, max_tokens)


def test_schedule_keys_and_validation_equal_jax():
    for kw in ({}, {"token_tile": 32, "capacity_factor": 1.5},
               {"f_tile": 64, "d_tile": 256, "collective": "nnz_rs"},
               {"capacity_factor": 2.0, "collective": "nnz_ar"}):
        s = tm.MoeDispatchSchedule(**kw)
        assert tm.moe_schedule_key(s) == jm.moe_schedule_key(
            jm.MoeDispatchSchedule(**kw))
    for bad in ({"token_tile": 4}, {"capacity_factor": 0.0},
                {"f_tile": 8.0}, {"collective": "row"}):
        with pytest.raises(ValueError):
            tm.MoeDispatchSchedule(**bad)
        with pytest.raises(ValueError):
            jm.MoeDispatchSchedule(**bad)


def test_moe_records_round_trip_and_read_back_through_jax(tuner_env):
    s = tm.MoeDispatchSchedule(token_tile=64, capacity_factor=1.5,
                               collective="nnz_rs")
    rec = tt.TuneRecord(schedule=s, us_per_call=3.5,
                        measured={tm.moe_schedule_key(s): 3.5})
    assert rec.to_json()["kind"] == "moe"
    assert tt.TuneRecord.from_json(rec.to_json()) == rec
    assert jt.TuneRecord.from_json(rec.to_json()).schedule == _jsched(s)
    jrec = jt.TuneRecord(schedule=_jsched(s), us_per_call=3.5)
    assert tt.TuneRecord.from_json(jrec.to_json()).schedule == s
    # a tuned file the port saved reads back through the JAX classes
    path = tuner_env / "moe.json"
    measure, _ = _fake_measure()
    res = tm.tune_moe_dispatch(SKEWED, 128, 256, cache=tt.ScheduleCache(path),
                               measure=measure)
    assert jt.ScheduleCache(path).get(res.key).schedule == _jsched(
        res.schedule)
    assert jm.moe_cached_or_default(
        SKEWED, 128, 256, cache=jt.ScheduleCache(path)) == _jsched(
            res.schedule)


# ---------------------------------------------------------------------------
# The reference's properties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths", [SKEWED, BALANCED])
def test_tuned_never_loses_to_default_and_never_drops_more(tuner_env,
                                                           lengths):
    measure, _ = _fake_measure()
    default = tm.MoeDispatchSchedule(capacity_factor=1.25)
    res = tm.tune_moe_dispatch(lengths, 128, 256, default=default,
                               cache=tt.ScheduleCache(None), measure=measure)
    key = tm.moe_schedule_key(default)
    assert key in res.measured  # the default is always in the pool
    assert res.us_per_call <= res.measured[key] + 1e-12
    budget = tm.dropped_tokens(lengths, tm.moe_capacity(lengths, 1.25))
    for s in tm.candidate_moe_schedules(lengths, default=default):
        assert tm.dropped_tokens(
            lengths, tm.moe_capacity(lengths, s.capacity_factor)) <= budget


def test_assumed_histogram_never_shrinks_and_keys_apart(tuner_env):
    default = tm.MoeDispatchSchedule(capacity_factor=1.25)
    assert all(s.capacity_factor >= 1.25
               for s in tm.candidate_moe_schedules(
                   BALANCED, default=default, allow_capacity_shrink=False))
    assert min(s.capacity_factor for s in tm.candidate_moe_schedules(
        BALANCED, default=default)) < 1.25
    cache = tt.ScheduleCache(tuner_env / "c.json")
    measure, _ = _fake_measure()
    obs = tm.tune_moe_dispatch(BALANCED, 128, 256, cache=cache,
                               measure=measure)
    measure2, calls2 = _fake_measure()
    ass = tm.tune_moe_dispatch(BALANCED, 128, 256, cache=cache,
                               measure=measure2, allow_capacity_shrink=False)
    assert calls2 and ass.key != obs.key and ass.key.endswith("|ns")
    assert ass.schedule.capacity_factor >= 1.25
    assert tm.moe_cached_or_default(BALANCED, 128, 256, cache=cache,
                                    allow_capacity_shrink=False) == (
        ass.schedule)
    assert tm.moe_cached_or_default(BALANCED, 128, 256,
                                    cache=cache) == obs.schedule
    # the model-level tuner withholds shrinking on an assumed histogram
    cfg = smoke_config(ARCHS["qwen3-moe-235b-a22b"])
    res = tmoe.moe_tune_dispatch(cfg, 256, cache=tt.ScheduleCache(None),
                                 measure=_fake_measure()[0])
    assert res.schedule.capacity_factor >= cfg.capacity_factor


def test_capacity_clamps_at_the_deployed_token_count():
    lengths = np.full(2, 256)
    assert tm.moe_capacity(lengths, 1.25, max_tokens=256) == 256
    assert tm.moe_capacity(lengths, 1.25) == 320


def test_resolver_never_measures_and_replay_measures_nothing(tuner_env):
    path = tuner_env / "c.json"
    default = tm.MoeDispatchSchedule(capacity_factor=1.5)
    assert tm.moe_cached_or_default(SKEWED, 128, 256, default=default,
                                    cache=tt.ScheduleCache(path)) == default
    measure, calls = _fake_measure()
    res = tm.tune_moe_dispatch(SKEWED, 128, 256, cache=tt.ScheduleCache(path),
                               measure=measure)
    assert calls and not res.from_cache
    measure2, calls2 = _fake_measure()
    again = tm.tune_moe_dispatch(SKEWED, 128, 256,
                                 cache=tt.ScheduleCache(path),
                                 measure=measure2)
    assert again.from_cache and calls2 == [] and again.n_measurements == 0
    assert again.schedule == res.schedule
    assert tm.moe_cached_or_default(SKEWED, 128, 256,
                                    cache=tt.ScheduleCache(path)) == (
        res.schedule)
    # the default cache is the port's namespace file, not the JAX one's
    tm.tune_moe_dispatch(SKEWED, 128, 256, measure=_fake_measure()[0],
                         device="cpu")
    assert (tuner_env / "tune.torch-cpu.json").exists()
    assert not (tuner_env / "tune.json").exists()


# ---------------------------------------------------------------------------
# The search under one objective
# ---------------------------------------------------------------------------


def _both_searches(h, d, f, shrink, max_tokens):
    """(reference result, port result, programs the port measured) under
    :func:`_program_measure`."""
    kw = dict(allow_capacity_shrink=shrink, max_tokens=max_tokens)
    jmeasure, _ = _program_measure(h, max_tokens)
    tmeasure, programs = _program_measure(h, max_tokens)
    want = jm.tune_moe_dispatch(h, d, f, measure=jmeasure,
                                cache=jt.ScheduleCache(None), **kw)
    got = tm.tune_moe_dispatch(h, d, f, measure=tmeasure,
                               cache=tt.ScheduleCache(None), **kw)
    return want, got, programs


@pytest.mark.parametrize("name", list(HISTS))
@pytest.mark.parametrize("shrink", [True, False])
@pytest.mark.parametrize("max_tokens", [None, 1024])
def test_search_matches_jax_under_one_objective(tuner_env, name, shrink,
                                                max_tokens):
    h = HISTS[name]
    for d, f in ((128, 256), (4096, 1536)):
        want, got, programs = _both_searches(h, d, f, shrink, max_tokens)
        assert len(set(programs)) == len(programs)
        assert tm.moe_program(h, got.schedule, max_tokens) == (
            tm.moe_program(h, want.schedule, max_tokens))
        assert got.us_per_call == pytest.approx(want.us_per_call, abs=1e-9)


@pytest.mark.parametrize("shrink", [True, False])
def test_search_reaches_further_than_jax_where_tiles_repeat_a_program(
        tuner_env, shrink):
    """The port's pool holds five distinct programs where the reference's
    holds five distinct (tile, cap_pad, d_tile, f_tile): at D 4096, F
    1536 on this histogram the reference's pool is five d/f tilings of
    two programs, and the port, reaching further down the same cost
    ranking, picks a faster program under the same objective."""
    h = np.array([320, 259, 193, 333, 325, 176])
    want, got, programs = _both_searches(h, 4096, 1536, shrink, None)
    assert len(set(programs)) == len(programs)
    assert got.us_per_call < want.us_per_call


def test_default_objective_times_the_kernel_launches(tuner_env,
                                                     monkeypatch):
    """Without ``measure=`` the tuner times the three grouped-matmul
    launches of ``_expert_ffn`` (the plain version on CPU tensors) over
    weights drawn once for the call."""
    from repro_torch.kernels import ops as kops

    launches, draws = [], []
    orig_gmm, orig_draw = kops.grouped_matmul, tm.draw_moe_weights

    def gmm(*args, **kw):
        launches.append((kw["token_tile"], args[0].shape[0],
                         kw["epilogue"].activation))
        return orig_gmm(*args, **kw)

    def draw(*args, **kw):
        draws.append(args)
        return orig_draw(*args, **kw)

    monkeypatch.setattr(kops, "grouped_matmul", gmm)
    monkeypatch.setattr(tm, "draw_moe_weights", draw)
    res = tm.tune_moe_dispatch(BALANCED, 64, 32, max_tokens=512,
                               cache=tt.ScheduleCache(None), device="cpu")
    assert len(draws) == 1 and len(launches) == 3 * res.n_measurements
    assert [a for _, _, a in launches[:3]] == ["silu", None, None]
    for (tile, rows, _), s in zip(launches[::3], res.points.values()):
        assert (tile, rows // BALANCED.shape[0]) == tm.moe_program(
            BALANCED, s, 512)


# ---------------------------------------------------------------------------
# The model: apply_moe(dispatch=) against JAX
# ---------------------------------------------------------------------------


def _layer0(kernel_dispatch):
    jcfg = jsmoke(JARCHS["qwen3-moe-235b-a22b"]).scaled(
        moe_pallas_dispatch=kernel_dispatch)
    tcfg = smoke_config(ARCHS["qwen3-moe-235b-a22b"]).scaled(
        moe_kernel_dispatch=kernel_dispatch)
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(2))
    tparams = params_from_jax(tcfg, jparams, device="cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["moe"]
    return jcfg, tcfg, jp, tparams["layers"][0]["moe"]


@pytest.mark.parametrize("combine", ["sum", "min", "mean"])
@pytest.mark.parametrize("factor", [1.0, 1.25, 2.0])
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("kernel_dispatch", [True, False])
def test_apply_moe_dispatch_matches_jax(kernel_dispatch, tile, factor,
                                        combine):
    jcfg, tcfg, jp, tp = _layer0(kernel_dispatch)
    x = np.random.default_rng(7).normal(
        size=(24, jcfg.d_model)).astype(np.float32)
    disp = tm.MoeDispatchSchedule(token_tile=tile, capacity_factor=factor,
                                  f_tile=32, d_tile=16)
    want, want_aux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x), None,
                                    dispatch=_jsched(disp), combine=combine)
    got, got_aux = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x),
                                  dispatch=disp, combine=combine,
                                  device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=RTOL)


def test_a_small_capacity_drops_tokens_and_still_matches_jax():
    """At factor 1.0 this routing overflows an expert: the dispatch drops
    tokens (the tuner's ``dropped_tokens`` counts them), and both
    packages drop the same ones."""
    jcfg, tcfg, jp, tp = _layer0(True)
    x = np.random.default_rng(7).normal(
        size=(24, jcfg.d_model)).astype(np.float32)
    gates, _ = tmoe._route(tcfg, torch.from_numpy(x), tp["router"])
    lengths = tmoe.expert_lengths_from_gates(gates)
    assert isinstance(lengths, torch.Tensor)
    np.testing.assert_array_equal(
        lengths.numpy(), np.asarray(jmoe.expert_lengths_from_gates(
            jmoe._route(jcfg, jnp.asarray(x), jp["router"])[0])))
    cap = tmoe._capacity(tcfg, 24, 1.0)
    assert cap == jmoe._capacity(jcfg, 24, 1.0)
    assert tm.dropped_tokens(lengths, cap) > 0
    disp = tm.MoeDispatchSchedule(token_tile=8, capacity_factor=1.0)
    got, _ = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x), dispatch=disp,
                            device="cpu")
    want, _ = jmoe.apply_moe(jcfg, jp, jnp.asarray(x), None,
                             dispatch=_jsched(disp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)
    full, _ = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x),
                             dispatch=disp.replace(capacity_factor=4.0),
                             device="cpu")
    assert not torch.allclose(got, full, rtol=RTOL, atol=ATOL)


def test_model_level_helpers_match_jax(tuner_env):
    tcfg = smoke_config(ARCHS["qwen3-moe-235b-a22b"])
    jcfg = jsmoke(JARCHS["qwen3-moe-235b-a22b"])
    for t in (24, 256, 1024):
        np.testing.assert_array_equal(
            tmoe.balanced_expert_lengths(tcfg, t),
            jmoe.balanced_expert_lengths(jcfg, t))
        np.testing.assert_array_equal(
            tmoe.skewed_expert_lengths(tcfg, t, seed=3),
            jmoe.skewed_expert_lengths(jcfg, t, seed=3))
    assert jm.moe_schedule_key(jmoe.default_dispatch(jcfg)) == (
        tm.moe_schedule_key(tmoe.default_dispatch(tcfg)))
    # the same measure gives the same record under the same key
    cache_t, cache_j = tt.ScheduleCache(None), jt.ScheduleCache(None)
    lengths = tmoe.skewed_expert_lengths(tcfg, 256)
    for obs in (None, lengths):
        got = tmoe.moe_tune_dispatch(tcfg, 256, expert_lengths=obs,
                                     cache=cache_t,
                                     measure=_fake_measure()[0])
        want = jmoe.moe_tune_dispatch(jcfg, 256, expert_lengths=obs,
                                      cache=cache_j,
                                      measure=_fake_measure()[0])
        assert got.key == want.key
        assert tmoe.moe_dispatch_schedule(
            tcfg, 256, expert_lengths=obs, cache=cache_t) == got.schedule
        assert jm.moe_schedule_key(jmoe.moe_dispatch_schedule(
            jcfg, 256, expert_lengths=obs, cache=cache_j)) == (
            jm.moe_schedule_key(want.schedule))
    # the collective tuner: a sharded ctx or a ValueError, as the
    # reference; on a one-member mesh (no process group) the reference's
    # key, modes and pick under one objective, then a replay
    from repro_torch.launch.mesh import make_local_mesh

    x = np.random.default_rng(4).normal(size=(24, tcfg.d_model)).astype(
        np.float32)
    with pytest.raises(ValueError, match="sharded ctx"):
        tmoe.moe_tune_collective(tcfg, None, torch.from_numpy(x), None)
    with pytest.raises(ValueError, match="sharded ctx"):
        jmoe.moe_tune_collective(jcfg, None, jnp.asarray(x), None)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jctx = jmoe.ShardingCtx(mesh=jmesh, data_axes=("data",),
                            model_axis="model")
    tctx = tmoe.ShardingCtx(mesh=make_local_mesh(1, device="cpu"),
                            data_axes=("data",), model_axis="model")
    (jmeas, jcalls), (tmeas, tcalls) = _fake_measure(), _fake_measure()
    want = jmoe.moe_tune_collective(jcfg, None, jnp.asarray(x), jctx,
                                    cache=cache_j, measure=jmeas)
    got = tmoe.moe_tune_collective(tcfg, None, torch.from_numpy(x), tctx,
                                   cache=cache_t, measure=tmeas)
    assert got.key == want.key and got.key.endswith("|mesh:1")
    assert got.key.startswith("moedist:")
    assert [tm.moe_schedule_key(s) for s in tcalls] == [
        jm.moe_schedule_key(s) for s in jcalls]
    assert tm.moe_schedule_key(got.schedule) == jm.moe_schedule_key(
        want.schedule)
    again = tmoe.moe_tune_collective(tcfg, None, torch.from_numpy(x), tctx,
                                     cache=cache_t,
                                     measure=_fake_measure()[0])
    assert again.from_cache and again.n_measurements == 0


# ---------------------------------------------------------------------------
# The engine's tuned side channel
# ---------------------------------------------------------------------------


class _TorchAPI:
    """The side channel never touches prefill or decode."""

    def init_cache(self, slots, max_len, device=None):
        return {}


class _JaxAPI:
    def init_cache(self, slots, max_len):
        return {}

    def decode_step(self, params, cache, toks):  # pragma: no cover
        raise NotImplementedError


def _engines(**kw):
    teng = ServeEngine(_TorchAPI(), {"embed": torch.zeros(1)}, slots=1,
                       device="cpu", **kw)
    return teng, JEngine(_JaxAPI(), params={}, slots=1)


def _counting(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def counted(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("n_dense", [4, 16])
def test_engine_spmm_replays_and_matches_jax_engine(tuner_env, monkeypatch,
                                                    n_dense):
    from repro_torch.tune import search

    measured = _counting(monkeypatch, search, "measure_schedule")
    teng, jeng = _engines(tuner_cache=tt.ScheduleCache(None))
    a_j = js.power_law_csr(300, 300, avg_degree=6.0, alpha=1.6, seed=0)
    a_t = ts.power_law_csr(300, 300, avg_degree=6.0, alpha=1.6, seed=0,
                           device="cpu")
    sched = teng.prepare_sparse(a_t, n_dense, value_dtypes=())
    assert measured and sched.value_dtype is None
    assert teng.prepare_sparse(a_t, n_dense) == sched  # replayed
    n_tuned = len(measured)
    b = np.random.default_rng(1).normal(size=(300, n_dense)).astype(
        np.float32)
    got = teng.spmm(a_t, torch.from_numpy(b))
    assert len(measured) == n_tuned  # the request path measured nothing
    assert sched in teng._sched_memo.values()
    # the JAX engine resolves the same record from its cache
    jrec = jt.TuneRecord.from_json(tt.TuneRecord(sched, 1.0).to_json())
    jeng.tuner_cache = jt.ScheduleCache(None)
    jeng.tuner_cache.put(jt.cache_key(a_j, n_dense), jrec)
    want = np.asarray(jeng.spmm(a_j, jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # a fresh engine on the same cache replays it with no memo
    teng2, _ = _engines(tuner_cache=teng.tuner_cache)
    got2 = teng2.spmm(a_t, torch.from_numpy(b))
    assert len(measured) == n_tuned
    torch.testing.assert_close(got2, got, rtol=0, atol=0)
    # a non-CSR operand runs the library default
    g = a_t.grouped(256, group_size=8)
    torch.testing.assert_close(
        teng.spmm(g, torch.from_numpy(b)),
        ts.spmm(g, torch.from_numpy(b), schedule="auto", device="cpu"))


def test_engine_prepare_moe_matches_jax_engine_keys(tuner_env, monkeypatch):
    tcfg = smoke_config(ARCHS["qwen3-moe-235b-a22b"])
    jcfg = jsmoke(JARCHS["qwen3-moe-235b-a22b"])
    fake, _ = _fake_measure()
    monkeypatch.setattr(jm, "measure_moe_dispatch",
                        lambda lengths, d, f, s, **kw: fake(s))
    measured = _counting(monkeypatch, tm, "measure_moe_dispatch")
    teng, jeng = _engines(tuner_cache=tt.ScheduleCache(None))
    jeng.tuner_cache = jt.ScheduleCache(None)
    lengths = tmoe.skewed_expert_lengths(tcfg, 64)
    for obs in (None, lengths):
        sched = teng.prepare_moe(tcfg, 64, expert_lengths=obs)
        jsched = jeng.prepare_moe(jcfg, 64, expert_lengths=obs)
        assert measured
        before = len(measured)
        assert teng.moe_dispatch_schedule(tcfg, 64, obs) == sched
        assert teng.prepare_moe(tcfg, 64, expert_lengths=obs) == sched
        assert len(measured) == before  # memo and cache: no measurement
        assert jm.moe_schedule_key(jeng.moe_dispatch_schedule(
            jcfg, 64, obs)) == jm.moe_schedule_key(jsched)
        measured.clear()
    assert set(teng._sched_memo) == set(jeng._sched_memo)
    assert any(k.endswith("|ns") for k in teng._sched_memo)
    # a second engine on the same cache resolves with no measurement
    teng2, _ = _engines(tuner_cache=teng.tuner_cache)
    assert teng2.moe_dispatch_schedule(tcfg, 64, lengths) == (
        teng.moe_dispatch_schedule(tcfg, 64, lengths))
    assert measured == []
    # an untuned histogram resolves to the static default
    assert teng2.moe_dispatch_schedule(tcfg, 96) == tmoe.default_dispatch(
        tcfg)


def test_engine_moe_histogram_from_gates_on_its_device(tuner_env):
    """A histogram from ``expert_lengths_from_gates`` (a tensor) keys as
    its numpy copy; the real objective runs on the engine's device."""
    tcfg = smoke_config(ARCHS["qwen3-moe-235b-a22b"])
    gates = torch.zeros(64, tcfg.n_experts)
    gates[:, 0] = gates[::2, 1] = gates[1::2, 2] = 0.5
    lengths = tmoe.expert_lengths_from_gates(gates)
    teng, _ = _engines()
    sched = teng.prepare_moe(tcfg, 64, expert_lengths=lengths)
    assert teng.moe_dispatch_schedule(tcfg, 64, lengths.numpy()) == sched
    assert (tuner_env / "tune.torch-cpu.json").exists()


def test_engine_prepare_dist_raises_naming_its_item(tuner_env):
    """``prepare_dist`` is ported: on a one-member mesh it tunes, memoizes
    under the reference's key and replays (four ranks in
    ``test_torch_dist_ranks.py``)."""
    from repro_torch.launch.mesh import make_reduction_mesh
    from repro_torch.tune import cache_key

    teng, _ = _engines(tuner_cache=tt.ScheduleCache(None))
    a = ts.random_csr(20, 20, density=0.2, seed=0, device="cpu")
    mesh = make_reduction_mesh(device="cpu")
    sched = teng.prepare_dist(a, 4, mesh=mesh, axis="shards")
    assert sched.collective in ("row", "nnz_ar", "nnz_rs")
    assert teng._sched_memo == {f"dist:{cache_key(a, 4)}|mesh:1": sched}
    assert teng.prepare_dist(a, 4, mesh=mesh, axis="shards") == sched


def test_hillclimb_moe_second_run_replays_every_cell(tuner_env, capsys):
    hillclimb.main(["--moe", "--device", "cpu"])
    first = capsys.readouterr().out
    assert first.count(" meas] ---") == 2
    hillclimb.main(["--moe", "--device", "cpu"])
    second = capsys.readouterr().out
    assert second.count("[cache] ---") == 2 and " meas]" not in second
    assert "tune.torch-cpu.json" in second
