"""Parity of the port's tuner (``repro_torch.tune``, the measured planner
and ``launch.hillclimb``) with the JAX package's (``repro.tune``) on the
CPU: schedule keys byte for byte, fingerprints and cache keys, records
read back across the packages, the search order of ``drive`` under one
deterministic objective injected into both, calibration's fit and
regret, and the port's own contracts (no measurement on replay or in
``cached_or_auto``, the card's feasibility predicate, the not yet ported
entry points).

Every test keeps its cache in ``tmp_path`` (``REPRO_TUNE_CACHE``) or in
memory, and restores the cost weights it may install.  Default
measurements run the kernels' plain versions at tiny sizes, one timed
call each (``REPRO_BENCH_ITERS=1``, ``REPRO_BENCH_WARMUP=0``).
Tolerance: calibration's weights and regret within 1e-9 (both packages
solve the same NNLS in float64 with scipy).
"""
import dataclasses
import importlib
import zlib

import numpy as np
import pytest
import torch

import repro.core as jc
import repro.fuse as JF
import repro.sparse as js
import repro.tune as jt
import repro_torch.core as tc
import repro_torch.fuse as TF
import repro_torch.sparse as ts
import repro_torch.tune as tt
from repro_torch.core.dtypes import storage_dtype
from repro_torch.core.selector import DEFAULT_COST_WEIGHTS
from repro_torch.kernels import ops as kops
from repro_torch.launch import hillclimb


@pytest.fixture
def tuner_env(tmp_path, monkeypatch):
    """A tmp cache base, one timed call per measurement, the default
    caches and cost weights restored afterwards."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_BENCH_ITERS", "1")
    monkeypatch.setenv("REPRO_BENCH_WARMUP", "0")
    weights = tc.get_cost_weights()
    tt.set_default_cache(None)
    yield tmp_path
    tt.set_default_cache(None)
    tc.set_cost_weights(weights)


def _fake(key_fn):
    """Deterministic objective shared by both packages: seconds from a
    CRC of the point's key.  Returns (measure, keys measured)."""
    calls = []

    def measure(point):
        k = key_fn(point)
        calls.append(k)
        return (zlib.crc32(k.encode()) % 997 + 1) * 1e-6

    return measure, calls


def _pair(maker, *args, **kw):
    """The same generator call in both packages (CPU tensors for the
    port)."""
    return (getattr(js, maker)(*args, **kw),
            getattr(ts, maker)(*args, **kw, device="cpu"))


def _key_variants(n):
    out = list(tc.candidate_schedules(n))
    base = out[0]
    out += [base.replace(split_threshold=16, merge_threshold=4),
            base.replace(split_threshold=8, merge_threshold=0),
            base.replace(strategy="parallel", split_threshold=8,
                         merge_threshold=0),
            base.with_epilogue("relu", bias=True),
            base.with_epilogue("gelu", bias=True, residual=True,
                               out_dtype="bfloat16"),
            base.replace(value_dtype="bf16", collective="nnz_rs"),
            tc.Schedule("rb", row_tile=16, strategy="parallel")
            .with_epilogue("silu")]
    return out


# ---------------------------------------------------------------------------
# Keys, fingerprints and records: the JAX package's bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 40, 256])
def test_schedule_key_is_byte_equal_to_jax(n):
    assert [str(s) for s in tc.candidate_schedules(n)] == [
        str(s) for s in jc.candidate_schedules(n)]
    for s in _key_variants(n):
        js_ = jc.Schedule(**dataclasses.asdict(s))
        assert tt.schedule_key(s) == jt.schedule_key(js_)


def test_schedule_axes_match_jax():
    assert tc.schedule_axes() == jc.schedule_axes()
    # every axis the key composes owns the fields schedule_axes names
    from repro_torch.tune.space import SCHEDULE_AXES

    assert {ax.name for ax in SCHEDULE_AXES} == set(tc.schedule_axes())


@pytest.mark.parametrize("maker,args,kw", [
    ("power_law_csr", (300, 300), dict(avg_degree=6.0, alpha=1.6, seed=0)),
    ("power_law_csr", (200, 150), dict(avg_degree=4.0, alpha=2.2, seed=3)),
    ("random_csr", (256, 256), dict(density=0.02, seed=1)),
    ("random_csr", (180, 240), dict(density=0.05, skew=1.5, seed=7)),
])
def test_fingerprint_and_cache_key_equal_jax(maker, args, kw):
    a_j, a_t = _pair(maker, *args, **kw)
    assert tt.fingerprint(a_t) == jt.fingerprint(a_j)
    for n in (4, 40, 256):
        assert tt.cache_key(a_t, n) == jt.cache_key(a_j, n)
    # memoized on the CSR: the histogram pass runs once
    assert a_t.__dict__["_convcache"]["fingerprint"] == tt.fingerprint(a_t)


def test_port_record_reads_back_through_jax(tuner_env):
    from repro_torch.fuse import FuseDecision

    for s in _key_variants(40)[-6:]:
        rec = tt.TuneRecord(schedule=s, us_per_call=12.5,
                            measured={tt.schedule_key(s): 12.5})
        back = jt.TuneRecord.from_json(rec.to_json())
        assert jt.schedule_key(back.schedule) == tt.schedule_key(s)
        assert back.us_per_call == 12.5 and back.measured == rec.measured
        assert tt.TuneRecord.from_json(rec.to_json()) == rec
    fuse = tt.TuneRecord(schedule=FuseDecision((True, False)),
                         us_per_call=3.0)
    assert jt.TuneRecord.from_json(fuse.to_json()).schedule.fused == (
        True, False)
    # a file the port saved reads back through the JAX cache class
    path = tuner_env / "shared.json"
    cache = tt.ScheduleCache(path)
    s = tc.Schedule("eb", nnz_tile=512, group_size=16)
    cache.put("k", tt.TuneRecord(schedule=s, us_per_call=1.0))
    cache.save()
    assert jt.schedule_key(jt.ScheduleCache(path).get("k").schedule) == (
        tt.schedule_key(s))
    # the namespaces and files differ from the JAX package's
    assert tt.cache_namespace("cpu") == "torch-cpu"
    assert tt.default_cache_path("torch-cpu").name == "tune.torch-cpu.json"
    assert tt.default_cache_path() != jt.default_cache_path()
    assert tt.default_cache("cpu").path.name == "tune.torch-cpu.json"


def test_cache_schema_merge_and_moe_records(tuner_env):
    path = tuner_env / "c.json"
    a, b = tt.ScheduleCache(path), tt.ScheduleCache(path)
    a.put("a", tt.TuneRecord(tc.Schedule(), 1.0))
    a.save()
    b.put("b", tt.TuneRecord(tc.Schedule("rb", strategy="parallel"), 2.0))
    b.save()  # merges a's record under the lock
    assert set(tt.ScheduleCache(path).keys()) == {"a", "b"}
    raw = path.read_text().replace('"version": 4', '"version": 3')
    path.write_text(raw)
    assert len(tt.ScheduleCache(path)) == 0  # v3 -> v4 drops and re-tunes
    assert tt.migrate_records("x", {"k": {}}) == {}
    # a moe record round-trips and reads back through the JAX classes
    moe = tt.TuneRecord(tt.MoeDispatchSchedule(token_tile=32,
                                               capacity_factor=1.5), 2.0)
    assert moe.to_json()["kind"] == "moe"
    assert tt.TuneRecord.from_json(moe.to_json()) == moe
    assert jt.moe_schedule_key(jt.TuneRecord.from_json(
        moe.to_json()).schedule) == tt.moe_schedule_key(moe.schedule)
    c = tt.ScheduleCache(path)
    c.put("moe:k", moe)
    c.save()
    assert jt.ScheduleCache(path).get("moe:k").schedule == (
        jt.MoeDispatchSchedule(token_tile=32, capacity_factor=1.5))


# ---------------------------------------------------------------------------
# drive: the same search under one injected objective
# ---------------------------------------------------------------------------


def _tune_both(a_j, a_t, n, **kw):
    mj, calls_j = _fake(jt.schedule_key)
    mt, calls_t = _fake(tt.schedule_key)
    rj = jt.tune_schedule(a_j, n, cache=jt.ScheduleCache(None), measure=mj,
                          **kw)
    rt = tt.tune_schedule(a_t, n, cache=tt.ScheduleCache(None), measure=mt,
                          **kw)
    return rj, rt, calls_j, calls_t


@pytest.mark.parametrize("n", [4, 40, 256])
def test_drive_matches_jax_on_a_low_cv_matrix(n):
    a_j, a_t = _pair("random_csr", 400, 400, density=0.01, seed=2)
    stats = ts.matrix_stats(a_t)
    assert stats["row_cv"] < 1.0
    # both feasibility filters keep the whole grid here
    assert all(kops.schedule_fits_card(s, n_rows=400,
                                       row_max=stats["row_max"])
               for s in tc.candidate_schedules(n))
    rj, rt, calls_j, calls_t = _tune_both(a_j, a_t, n)
    assert calls_t == calls_j
    assert list(rt.measured) == list(rj.measured)
    assert tt.schedule_key(rt.schedule) == jt.schedule_key(rj.schedule)
    assert rt.key == rj.key and rt.us_per_call == rj.us_per_call


def test_drive_on_a_high_cv_matrix_measures_valid_port_points():
    a_j, a_t = _pair("power_law_csr", 600, 600, avg_degree=8.0, alpha=1.2,
                     seed=4)
    assert ts.matrix_stats(a_t)["row_cv"] > 1.0
    rj, rt, _, calls_t = _tune_both(a_j, a_t, 8,
                                    epilogue=tc.Epilogue("relu"))
    assert any(":s" in k for k in calls_t)  # the skew axis was searched
    for k, p in rt.points.items():
        assert tc.Schedule(**dataclasses.asdict(p)) == p  # validates
        assert tt.schedule_key(p) == k and p.epilogue.activation == "relu"
    assert rt.us_per_call == min(rt.measured.values())
    assert tt.schedule_key(rt.schedule) == min(rt.measured,
                                               key=rt.measured.get)
    assert rt.key == rj.key


def test_tune_segment_reduce_matches_jax():
    rng = np.random.default_rng(5)
    seg = np.sort(rng.integers(0, 30, 400)).astype(np.int32)
    mj, cj = _fake(jt.schedule_key)
    mt, ct = _fake(tt.schedule_key)
    rj = jt.tune_segment_reduce(seg, 6, 30, cache=jt.ScheduleCache(None),
                                measure=mj)
    rt = tt.tune_segment_reduce(torch.from_numpy(seg), 6, 30,
                                cache=tt.ScheduleCache(None), measure=mt)
    assert ct == cj and len(ct) == 8 and rt.key == rj.key
    assert tt.schedule_key(rt.schedule) == jt.schedule_key(rj.schedule)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_tune_sparse_attention_matches_jax(direction):
    a_j, a_t = _pair("power_law_csr", 64, 64, avg_degree=5.0, alpha=1.6,
                     seed=1)
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((64, 3, 8)).astype(np.float32)
               for _ in range(3))
    coo_j, coo_t = a_j.tocoo(), a_t.tocoo()
    mj, cj = _fake(jt.schedule_key)
    mt, ct = _fake(tt.schedule_key)
    import jax.numpy as jnp

    rj = jt.tune_sparse_attention(
        np.asarray(coo_j.rows), np.asarray(coo_j.cols),
        *(jnp.asarray(x) for x in (q, k, v)), n_rows=64,
        direction=direction, cache=jt.ScheduleCache(None), measure=mj)
    rt = tt.tune_sparse_attention(
        coo_t.rows, coo_t.cols, *(torch.from_numpy(x) for x in (q, k, v)),
        n_rows=64, direction=direction, cache=tt.ScheduleCache(None),
        measure=mt)
    assert ct == cj and rt.key == rj.key and f"|H3|{direction}" in rt.key
    assert tt.schedule_key(rt.schedule) == jt.schedule_key(rj.schedule)


@pytest.mark.parametrize("final_activation", [None, "relu"])
def test_tune_plan_matches_jax(final_activation):
    import jax.numpy as jnp

    a_j, a_t = _pair("random_csr", 60, 60, density=0.1, seed=3)
    rng = np.random.default_rng(1)
    w0, w1, b0 = (rng.standard_normal(s).astype(np.float32)
                  for s in ((8, 16), (16, 4), (16,)))
    x = rng.standard_normal((60, 8)).astype(np.float32)
    cj, pj = JF.gcn_chain(a_j, (jnp.asarray(w0), jnp.asarray(w1)),
                          (jnp.asarray(b0), None),
                          final_activation=final_activation)
    ct, pt = TF.gcn_chain(a_t, (torch.from_numpy(w0), torch.from_numpy(w1)),
                          (torch.from_numpy(b0), None),
                          final_activation=final_activation)
    assert TF.plan_key(ct, torch.from_numpy(x), pt) == JF.plan_key(
        cj, jnp.asarray(x), pj)
    tag = lambda p: p.decision.tag  # noqa: E731
    mj, calls_j = _fake(tag)
    mt, calls_t = _fake(tag)
    rj = JF.tune_plan(cj, jnp.asarray(x), pj, cache=jt.ScheduleCache(None),
                      measure=mj)
    rt = TF.tune_plan(ct, torch.from_numpy(x), pt,
                      cache=tt.ScheduleCache(None), measure=mt)
    assert calls_t == calls_j and rt.key == rj.key
    assert rt.schedule.fused == rj.schedule.fused


def test_tune_plan_default_measure_and_tuned_plan_replay(tuner_env):
    from repro_torch.models import gcn_two_layer

    a = ts.random_csr(50, 50, density=0.1, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    x, w0, w1 = (torch.randn(s, generator=g) for s in ((50, 6), (6, 8),
                                                        (8, 3)))
    chain, params = TF.gcn_chain(a, (w0, w1))
    res = TF.tune_plan(chain, x, params)
    assert not res.from_cache and res.n_measurements >= 1
    again = TF.tune_plan(chain, x, params, measure=lambda p: 1 / 0)
    assert again.from_cache and again.n_measurements == 0
    p = TF.tuned_plan(chain, x, params)
    assert p.decision == res.schedule
    got = gcn_two_layer(a, x, w0, w1, plan=p, device="cpu")
    want = TF.run_chain_ref(chain, x, params)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Calibration and the cost weights
# ---------------------------------------------------------------------------


def _samples(mod):
    rng = np.random.default_rng(3)
    out = []
    for g in range(4):
        for _ in range(9):
            terms = tuple(float(x) for x in rng.uniform(1, 100, 4))
            secs = float(np.dot((1.0, 0.3, 3.0, 0.1), terms)
                         * rng.uniform(0.9, 1.1) * 1e-6)
            out.append(mod.CalibrationSample(group=g, terms=terms,
                                             seconds=secs))
    return out


def test_fit_weights_and_regret_match_jax():
    st, sj = _samples(tt), _samples(jt)
    wt, wj = tt.fit_weights(st), jt.fit_weights(sj)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-9)
    for w in (wt, DEFAULT_COST_WEIGHTS, (0.0, 1.0, 0.0, 0.0)):
        assert abs(tt.model_regret(st, w) - jt.model_regret(sj, w)) <= 1e-9


def test_calibrate_never_ships_a_worse_fit(tuner_env, monkeypatch):
    samples = _samples(tt)
    res = tt.calibrate(samples=samples, apply=True)
    assert res.regret_after <= res.regret_before
    assert tc.get_cost_weights() == res.weights
    # a fit that ranks worse than the active weights is not shipped
    cal = importlib.import_module("repro_torch.tune.calibrate")
    worst = (0.0, 0.0, 0.0, 1.0)
    assert tt.model_regret(samples, worst) > tt.model_regret(samples,
                                                             res.weights)
    monkeypatch.setattr(cal, "fit_weights", lambda s: worst)
    again = tt.calibrate(samples=samples, apply=True)
    assert again.weights == res.weights
    assert again.regret_after == again.regret_before
    assert tc.get_cost_weights() == res.weights


def test_calibrate_from_tuning_results_measures_nothing_more(tuner_env):
    a = ts.random_csr(200, 200, density=0.03, seed=1, device="cpu")
    measure, calls = _fake(tt.schedule_key)
    res = tt.tune_schedule(a, 8, cache=tt.ScheduleCache(None),
                           measure=measure)
    n = len(calls)
    samples = tt.samples_from_results([(a, 8, res)])
    assert len(samples) == n and len(calls) == n
    out = tt.calibrate(samples=samples)
    assert out.n_samples == n and out.regret_after <= out.regret_before


def test_set_cost_weights_validation(tuner_env):
    for bad in ((1.0, 2.0), (-1.0, 1.0, 1.0, 1.0), (0.0, 0.0, 0.0, 0.0)):
        with pytest.raises(ValueError):
            tc.set_cost_weights(bad)
    stats = ts.matrix_stats(ts.random_csr(100, 100, density=0.05, seed=0,
                                          device="cpu"))
    s = tc.candidate_schedules(8)[0]
    tc.set_cost_weights((2.0, 0.0, 0.0, 0.0))
    assert tc.predict_cost(stats, s, 8) == 2.0 * tc.cost_terms(stats, s,
                                                                8)[0]
    tc.set_cost_weights(None)
    assert tc.get_cost_weights() == DEFAULT_COST_WEIGHTS


# ---------------------------------------------------------------------------
# The port's contracts
# ---------------------------------------------------------------------------


def test_cached_or_auto_never_measures_and_replays(tuner_env):
    a = ts.random_csr(150, 150, density=0.04, seed=13, device="cpu")
    auto = tc.select_schedule(ts.matrix_stats(a), 4)
    assert tt.cached_or_auto(a, 4) == auto  # a miss: the selector's pick
    measure, calls = _fake(tt.schedule_key)
    tuned = tt.tune_schedule(a, 4, measure=measure)
    assert calls and tt.cached_or_auto(a, 4) == tuned.schedule
    n = len(calls)
    replay = tt.tune_schedule(a, 4, measure=measure)
    assert replay.from_cache and replay.n_measurements == 0
    assert len(calls) == n and replay.schedule == tuned.schedule


def test_default_measure_times_the_wrappers_on_cpu(tuner_env):
    a = ts.random_csr(120, 120, density=0.05, seed=2, device="cpu")
    res = tt.tune_schedule(a, 8, epilogue=tc.Epilogue("relu", bias=True))
    assert res.n_measurements >= 4 and all(
        t > 0 for t in res.measured.values())
    assert res.schedule.epilogue == tc.Epilogue("relu", bias=True)
    assert tt.default_cache_path("torch-cpu").exists()
    fn, args = tt.make_runner(a, 8, res.schedule)
    b = args[1].float()
    bias = torch.randn(8, generator=torch.Generator().manual_seed(1))
    # the values the pick stores (the dtype axis may narrow them), in f32
    vd = res.schedule.value_dtype
    stored = (a.quantized().dequantize().vals if vd == "int8" else
              a.astype(storage_dtype(vd)).vals.float())
    dense = ts.CSR(a.indptr, a.indices, stored, a.shape).todense()
    torch.testing.assert_close(
        fn(*args), torch.relu(dense @ b + bias), rtol=1e-5, atol=1e-5)
    assert tt.time_fn(fn, *args, iters=3) > 0


def test_schedule_fits_card_refuses_what_the_wrappers_refuse(monkeypatch):
    from repro_torch.kernels import spmm_eb
    from repro_torch.sparse import formats

    stats = dict(n_rows=100, row_max=30)
    fits = lambda s, **kw: kops.schedule_fits_card(  # noqa: E731
        s, **{**stats, **kw})
    for s in tc.candidate_schedules(40):
        assert fits(s)
    assert fits(tc.Schedule(nnz_tile=spmm_eb.MAX_NNZ_TILE, group_size=32))
    assert not fits(tc.Schedule(nnz_tile=2 * spmm_eb.MAX_NNZ_TILE))
    for vd in ("bf16", "float16", "fp8", "int8"):
        assert fits(tc.Schedule(value_dtype=vd))
    tc.register_strategy("t_tune_user", tc.spec_accumulate, overwrite=True)
    tc.register_strategy("t_tune_max", tc.spec_accumulate, combine="max",
                         overwrite=True)
    for name in ("t_tune_user", "t_tune_max"):
        assert fits(tc.Schedule(strategy=name))
    # narrow storage runs on the CPU path too; an ELL too large is refused
    a = ts.random_csr(100, 100, density=0.1, seed=0, device="cpu")
    b = torch.ones(100, 4)
    np.testing.assert_allclose(
        kops.spmm(a, b, tc.Schedule(value_dtype="bf16")).numpy(),
        kops.spmm(a.astype(torch.bfloat16), b, tc.Schedule()).numpy(),
        rtol=0, atol=0)
    row_max = ts.matrix_stats(a)["row_max"]
    rb = tc.Schedule("rb", row_tile=8, strategy="parallel")
    limit = 104 * row_max * 8
    monkeypatch.setattr(formats, "ELL_MAX_BYTES", limit - 1)
    monkeypatch.setattr(kops, "ELL_MAX_BYTES", limit - 1)
    assert not kops.schedule_fits_card(rb, n_rows=100,
                                       row_max=row_max)
    with pytest.raises(ValueError, match="ELL_MAX_BYTES"):
        kops.spmm(ts.random_csr(100, 100, density=0.1, seed=0,
                                device="cpu"), b, rb)
    monkeypatch.setattr(formats, "ELL_MAX_BYTES", limit)
    monkeypatch.setattr(kops, "ELL_MAX_BYTES", limit)
    assert kops.schedule_fits_card(rb, n_rows=100,
                                   row_max=row_max)
    assert kops.spmm(a, b, rb).shape == (100, 4)


def test_value_dtype_axis_admits_what_fits_the_budget():
    from repro_torch.tune.space import ValueDtypeAxis

    memo = tt.driver._Memo(lambda s: 1.0, tt.schedule_key)
    errors = {"bfloat16": 0.01, "float16": 0.001, "int8": 0.2}
    ax = ValueDtypeAxis(tt.DEFAULT_VALUE_DTYPES, error_budget=0.05,
                        parity=lambda c, vd: errors[vd])
    got = ax.variants(None, tc.Schedule(), memo)
    assert [s.value_dtype for s in got] == ["bfloat16", "float16"]
    # a parity that cannot be computed refuses the dtype
    def unquantizable(ctx, vd):
        raise ValueError(vd)

    ax = ValueDtypeAxis(("int8",), parity=unquantizable)
    assert ax.variants(None, tc.Schedule(), memo) == []
    assert ValueDtypeAxis(tt.DEFAULT_VALUE_DTYPES).admit(
        None, tc.Schedule(value_dtype="int8"))  # no gate: admitted


def test_not_ported_parts_raise_naming_their_item(tuner_env, capsys,
                                                  tmp_path):
    """Every mode is ported: the distributed tuner (a one-member mesh
    here; four ranks in ``test_torch_dist_ranks.py``) and the roofline
    mode (``--cell``, on a smoke cell; ``test_torch_dryrun.py`` holds
    it); only a variant of the reference's XLA fields raises, naming
    why."""
    from repro_torch.launch.mesh import make_reduction_mesh
    from repro_torch.tune import measure, search

    a = ts.random_csr(20, 20, density=0.2, seed=0, device="cpu")
    mesh = make_reduction_mesh(device="cpu")
    sched = tc.Schedule(nnz_tile=32, group_size=8, collective="nnz_rs")
    res = search.tune_dist_spmm(a, 4, mesh=mesh, axis="shards",
                                cache=tt.ScheduleCache(None),
                                measure=lambda s: 1.0, top_k=1,
                                hill_steps=0)
    assert res.key.endswith("|mesh:1") and res.n_measurements > 0
    fn, args = measure.make_dist_runner(a, 4, sched, mesh=mesh,
                                        axis="shards")
    torch.testing.assert_close(fn(*args),
                               ts.spmm(a, args[3], device="cpu"))
    assert measure.measure_dist_schedule(a, 4, sched, mesh=mesh,
                                         axis="shards") > 0.0
    hillclimb.main(["--dist", "--device", "cpu"])
    assert capsys.readouterr().out.count("mesh=1 [") == 2
    hillclimb.main(["--cell", "qwen2-7b:decode_32k:mb16", "--smoke",
                    "--out", str(tmp_path)])
    assert "--- qwen2-7b × decode_32k [mb16] ---" in \
        capsys.readouterr().out
    assert len(list((tmp_path / "smoke").glob("qwen2-7b__*.json"))) == 2
    with pytest.raises(ValueError, match="decode_inplace_cache"):
        hillclimb.main(["--cell", "qwen2-7b:decode_32k:inplace"])


def test_hillclimb_spmm_second_run_replays_every_cell(tuner_env, capsys):
    hillclimb.main(["--spmm", "--device", "cpu"])
    first = capsys.readouterr().out
    assert first.count(" meas] ---") == 4
    hillclimb.main(["--spmm", "--device", "cpu"])
    second = capsys.readouterr().out
    assert second.count("[cache] ---") == 4 and " meas]" not in second
    assert "tune.torch-cpu.json" in second
