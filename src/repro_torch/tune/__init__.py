"""``repro_torch.tune``: the empirical schedule tuner (port of
``repro.tune``), measuring the port's kernels on the card.

``tune_schedule(csr, n_dense_cols)`` warm-starts from the static cost
model, measures the top-k candidates the card takes on the kernels
themselves, hillclimbs around the winner, and persists the result in a
fingerprint-keyed file per device (``REPRO_TUNE_CACHE`` with a
``torch-cuda-<device name>`` or ``torch-cpu`` namespace), so the search
runs once per matrix profile.  ``schedule="tune"`` on
``repro_torch.sparse.spmm`` / ``sddmm`` / ``segment_reduce`` /
``sparse_attention`` routes here; ``cached_or_auto`` is the
measurement-free serving resolver; ``calibrate`` feeds measured timings
back into ``Schedule.auto``'s cost model.  Every tuner is a thin wrapper
over one search framework: ``tune.space`` declares the axes and
``tune.driver.drive`` runs the one budgeted loop.  ``tune_moe_dispatch``
tunes the MoE grouped-matmul dispatch on the kernel, keyed by the
expert-segment histogram; ``moe_cached_or_default`` is its serving
resolver.  ``tune_dist_spmm`` tunes a sharded SpMM over a mesh of
ranks: the local tiling, the collective mode and the value storage in
one search, the same pick on every rank (``dist_spmm(schedule="tune")``
and ``ServeEngine.prepare_dist`` route here).
"""
from .cache import (  # noqa: F401
    MIGRATIONS,
    SCHEMA_VERSION,
    ScheduleCache,
    TuneRecord,
    cache_key,
    cache_namespace,
    default_cache,
    default_cache_path,
    fingerprint,
    fingerprint_from_lengths,
    legacy_cache_path,
    migrate_records,
    set_default_cache,
)
from .attention import (  # noqa: F401
    attention_cache_key,
    tune_sparse_attention,
)
from .calibrate import (  # noqa: F401
    CalibrationResult,
    CalibrationSample,
    calibrate,
    collect_samples,
    fit_weights,
    model_regret,
    samples_from_results,
)
from .measure import (  # noqa: F401
    bench_iters,
    make_dist_runner,
    make_eb_runner,
    make_rb_runner,
    make_runner,
    measure_dist_schedule,
    measure_schedule,
    spmd_time,
    time_fn,
)
from .moe import (  # noqa: F401
    MoeDispatchSchedule,
    dropped_tokens,
    measure_moe_dispatch,
    moe_cache_key,
    moe_cached_or_default,
    moe_capacity,
    moe_schedule_key,
    tune_moe_dispatch,
)
from .driver import (  # noqa: F401
    TuneResult,
    drive,
)
from .space import (  # noqa: F401
    Axis,
    CapacityAxis,
    CollectiveAxis,
    EpilogueAxis,
    FuseBoundaryAxis,
    MoeTilingAxis,
    SearchContext,
    SearchSpace,
    SkewAxis,
    StrategyAxis,
    TilingAxis,
    ValueDtypeAxis,
)
from .search import (  # noqa: F401
    DEFAULT_VALUE_DTYPES,
    DIST_VALUE_DTYPES,
    cached_or_auto,
    schedule_key,
    tune_dist_spmm,
    tune_schedule,
    tune_segment_reduce,
)
