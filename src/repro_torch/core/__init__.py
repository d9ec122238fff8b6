"""Core of the port: atomic parallelism points, segment-group specs, the
unified ``Schedule`` with its strategy registry, and the selector."""
from .atomic_parallelism import DA_SPMM_POINTS, AtomicParallelism  # noqa: F401
from .device import resolve_device  # noqa: F401
from .dtypes import (  # noqa: F401
    VALUE_DTYPES,
    Fp8Fallback,
    canonical_value_dtype,
    fp8_supported,
    operand_dtype,
    storage_dtype,
)
from .schedule import (  # noqa: F401
    ACTIVATIONS,
    COLLECTIVES,
    Epilogue,
    ReductionStrategy,
    Schedule,
    as_schedule,
    available_strategies,
    get_strategy,
    register_strategy,
    schedule_axes,
)
from .segment_group import (  # noqa: F401
    MONOIDS,
    GroupReduceStrategy,
    Monoid,
    SegmentGroup,
    get_monoid,
    group_waste_fraction,
    group_writeback_counts,
    make_monoid,
    spec_accumulate,
    spec_parallel,
    spec_segment,
)
from .selector import (  # noqa: F401
    WIRE_COST_WEIGHT,
    candidate_schedules,
    collective_cost_terms,
    cost_terms,
    get_cost_weights,
    predict_cost,
    predict_dist_cost,
    select_schedule,
    set_cost_weights,
)
