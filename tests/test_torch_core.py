"""Parity of the PyTorch port's core (``repro_torch.core``) with the JAX
reference: Schedule/Epilogue validation, the selector's choices and cost
terms, the strategy specs and the segment-group counters.  Inputs are
made with numpy from a seed and handed to both packages.

Tolerance: f32 results compare at rtol = atol = 1e-5; the cost terms are
float64 arithmetic in both packages and compare at rtol 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.sparse as js
import repro_torch.core as tc

RTOL = ATOL = 1e-5


def _outcome(fn):
    try:
        return str(fn())
    except (ValueError, TypeError) as e:
        return f"raises {type(e).__name__}"


SCHEDULE_KWARGS = [
    {},
    dict(kernel="rb", row_tile=16, strategy="parallel"),
    dict(kernel="xb"),
    dict(nnz_tile=100, group_size=32),
    dict(strategy="nope"),
    dict(split_threshold=8, merge_threshold=2, group_size=8, nnz_tile=32),
    dict(split_threshold=0),
    dict(merge_threshold=-1),
    dict(split_threshold=4, merge_threshold=6),
    dict(kernel="rb", split_threshold=4),
    dict(collective="nnz_rs"),
    dict(collective="bogus"),
    dict(value_dtype="bf16"),
    dict(value_dtype="float32"),
    dict(value_dtype="int4"),
    dict(epilogue={"activation": "relu", "bias": True}),
    dict(epilogue={"activation": "swish"}),
    dict(kernel="eb", strategy="parallel", split_threshold=8,
         merge_threshold=0, group_size=8, nnz_tile=32),
]


@pytest.mark.parametrize("kw", SCHEDULE_KWARGS, ids=str)
def test_schedule_validation_matches_reference(kw):
    assert _outcome(lambda: tc.Schedule(**kw)) == \
        _outcome(lambda: jc.Schedule(**kw))


# the one rule the port adds (ROADMAP §3.1): 'parallel' on 'eb' only where
# no group can span rows (skew layout, merge_threshold=0)
@pytest.mark.parametrize("split,merge", [(None, None), (8, None), (8, 1),
                                         (8, 2), (None, 3)])
def test_parallel_on_spanning_layouts_rejected(split, merge):
    kw = dict(kernel="eb", strategy="parallel", group_size=8, nnz_tile=32,
              split_threshold=split, merge_threshold=merge)
    jc.Schedule(**kw)  # the reference accepts it
    with pytest.raises(ValueError, match="merge_threshold=0"):
        tc.Schedule(**kw)


@pytest.mark.parametrize("kw", [
    {}, dict(activation="gelu", bias=True), dict(residual=True),
    dict(out_dtype="bfloat16"), dict(activation="relu", out_dtype="float16"),
    dict(activation="mish"), dict(out_dtype="notatype")], ids=str)
def test_epilogue_validation_and_tag(kw):
    def tag(cls):
        return lambda: (cls(**kw).tag, cls(**kw).is_noop)
    assert _outcome(tag(tc.Epilogue)) == _outcome(tag(jc.Epilogue))


@pytest.mark.parametrize("name", sorted(jc.DA_SPMM_POINTS))
def test_named_schedules_match(name):
    assert str(tc.Schedule.named(name)) == str(jc.Schedule.named(name))
    p = jc.DA_SPMM_POINTS[name]
    tp = tc.AtomicParallelism(p.split, p.x, p.c, p.r)
    assert str(tc.as_schedule(tp)) == str(jc.as_schedule(p))


def test_as_schedule_coercions(tmp_path, monkeypatch):
    for sg in [(8, "segment"), (16, "accumulate")]:
        assert str(tc.as_schedule(tc.SegmentGroup(*sg))) == \
            str(jc.as_schedule(jc.SegmentGroup(*sg)))
    assert str(tc.as_schedule(None)) == str(jc.as_schedule(None))
    # 'tune' needs the matrix, as in the JAX package, and then routes to
    # the tuner, which persists what it picked
    with pytest.raises(ValueError, match="matrix"):
        tc.as_schedule("tune")
    with pytest.raises(ValueError, match="matrix"):
        jc.as_schedule("tune")
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_BENCH_ITERS", "1")
    monkeypatch.setenv("REPRO_BENCH_WARMUP", "0")
    from repro_torch.sparse import random_csr
    from repro_torch.tune import cached_or_auto

    csr = random_csr(120, 120, density=0.05, seed=9, device="cpu")
    s = tc.as_schedule("tune", matrix=csr, n_dense_cols=4)
    assert isinstance(s, tc.Schedule) and cached_or_auto(csr, 4) == s
    with pytest.raises(ValueError):
        tc.as_schedule("auto")
    with pytest.raises(TypeError):
        tc.as_schedule(3.5)


def _stats_cases():
    return [
        js.random_csr(64, 64, density=0.1, seed=1),
        js.random_csr(200, 150, density=0.02, skew=1.5, seed=2),
        js.power_law_csr(300, 300, avg_degree=6, alpha=1.8, seed=3),
        js.graph_pattern_csr("social", 400, seed=4),
        js.graph_pattern_csr("roadnet", 400, seed=5),
        js.graph_pattern_csr("web", 256, seed=6),
    ]


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("n_dense", [4, 40, 128, 256])
def test_auto_selects_same_schedule(case, n_dense):
    stats = js.matrix_stats(_stats_cases()[case])
    assert str(tc.Schedule.auto(stats, n_dense)) == \
        str(jc.Schedule.auto(stats, n_dense))


def test_candidates_and_cost_terms_match():
    from repro.core import selector as jsel
    from repro_torch.core import selector as tsel

    stats = js.matrix_stats(js.power_law_csr(300, 300, seed=7))
    for n in (8, 64, 300):
        jc_s = jsel.candidate_schedules(n)
        assert [str(s) for s in tsel.candidate_schedules(n)] == \
            [str(s) for s in jc_s]
    extra = [dict(split_threshold=16, merge_threshold=2, group_size=8,
                  nnz_tile=32),
             dict(split_threshold=16, group_size=16, nnz_tile=64),
             dict(value_dtype="bfloat16"), dict(value_dtype="int8"),
             dict(kernel="rb", strategy="parallel")]
    for kw in extra:
        for n in (8, 128):
            got = tsel.cost_terms(stats, tc.Schedule(**kw), n)
            want = jsel.cost_terms(stats, jc.Schedule(**kw), n)
            np.testing.assert_allclose(got, want, rtol=1e-12)
            assert tsel.predict_cost(stats, tc.Schedule(**kw), n) == \
                pytest.approx(jsel.predict_cost(stats, jc.Schedule(**kw), n),
                              rel=1e-12)


def _spec_inputs(seed, T=64, C=5, n_seg=40):
    rng = np.random.default_rng(seed)
    partials = rng.standard_normal((T, C)).astype(np.float32)
    # non-decreasing ids with occasional jumps wider than a group
    steps = rng.choice([0, 0, 1, 1, 2, 12], size=T)
    seg = np.minimum(np.cumsum(steps), n_seg - 1).astype(np.int32)
    return partials, seg, n_seg


@pytest.mark.parametrize("spec", ["spec_segment", "spec_parallel",
                                  "spec_accumulate"])
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("G", [4, 8, 32])
def test_strategy_specs_match(spec, op, G):
    from repro.core import segment_group as jsg

    partials, seg, n_seg = _spec_inputs(G)
    want = getattr(jsg, spec)(jnp.asarray(partials), jnp.asarray(seg),
                              n_seg, G, monoid=jc.get_monoid(op))
    got = getattr(tc, spec)(torch.from_numpy(partials),
                            torch.from_numpy(seg), n_seg, G,
                            monoid=tc.get_monoid(op))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_make_monoid_spec_matches():
    from repro.core import segment_group as jsg

    partials, seg, n_seg = _spec_inputs(3, T=32, C=3, n_seg=12)
    jm = jc.make_monoid("mx", jnp.maximum, -1e9)
    tm = tc.make_monoid("mx", torch.maximum, -1e9)
    want = jsg.spec_segment(jnp.asarray(partials), jnp.asarray(seg), n_seg,
                            8, monoid=jm)
    got = tc.spec_segment(torch.from_numpy(partials), torch.from_numpy(seg),
                          n_seg, 8, monoid=tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("G", [4, 8, 16])
def test_group_counters_match(G):
    _, seg, _ = _spec_inputs(G, T=64)
    np.testing.assert_array_equal(
        tc.group_writeback_counts(torch.from_numpy(seg), G).numpy(),
        np.asarray(jc.group_writeback_counts(jnp.asarray(seg), G)))
    lengths = np.random.default_rng(G).integers(0, 50, size=30)
    assert tc.group_waste_fraction(lengths, G) == \
        jc.group_waste_fraction(lengths, G)


@pytest.mark.parametrize("act", sorted(jc.ACTIVATIONS))
def test_activations_match(act):
    x = np.linspace(-6, 6, 301, dtype=np.float32)
    got = tc.ACTIVATIONS[act](torch.from_numpy(x)).numpy()
    want = np.asarray(jc.ACTIVATIONS[act](jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gelu_is_the_tanh_approximation():
    x = jnp.linspace(-4, 4, 101, dtype=jnp.float32)
    exact = jax.nn.gelu(x, approximate=False)
    got = tc.ACTIVATIONS["gelu"](torch.from_numpy(np.array(x))).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), rtol=RTOL,
                               atol=ATOL)
    assert np.abs(got - np.asarray(exact)).max() > 1e-4


@pytest.mark.parametrize("name", [None, "float32", "f32", "bf16", "fp16",
                                  "fp8", "int8", "float64", np.float32])
def test_value_dtype_canonicalization(name):
    assert _outcome(lambda: tc.canonical_value_dtype(name)) == \
        _outcome(lambda: jc.canonical_value_dtype(name))


def test_strategy_registry_validation():
    with pytest.raises(ValueError, match="already registered"):
        tc.register_strategy("segment", tc.spec_segment)
    with pytest.raises(ValueError, match="identity"):
        tc.register_strategy("t_core_x", tc.spec_segment,
                             combine=torch.maximum)
    with pytest.raises(ValueError, match="only meaningful"):
        tc.register_strategy("t_core_y", tc.spec_segment, identity=0.0)
    e = tc.register_strategy("t_core_max", tc.spec_accumulate,
                             combine="max", overwrite=True)
    assert tc.get_strategy("t_core_max", op="add") == e
    with pytest.raises(ValueError, match="own combine"):
        tc.get_strategy("t_core_max", op="min")
    assert tc.get_strategy("segment", op="max").monoid.name == "max"
    assert {"segment", "parallel", "accumulate"} <= set(
        tc.available_strategies())
