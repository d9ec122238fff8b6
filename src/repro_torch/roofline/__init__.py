"""repro_torch.roofline — the roofline of the port's programs: the H100's
constants, the cost counter of an eager step (``count_costs``),
``analyze`` and the parameter counts (the dry run's arithmetic,
``launch/dryrun.py``), the report of its records (``report``), and the
byte models of the EB SpMM's dtype axis and of the distributed SpMM's
and attention's collectives."""
from .analysis import (  # noqa: F401
    H100,
    Hardware,
    analyze,
    combine_costs,
    count_active_params,
    count_costs,
    count_params,
    dtype_itemsize,
    predict_attention_collective_bytes,
    predict_collective_bytes,
    predict_spmm_arg_bytes,
    predict_spmm_traffic_bytes,
)
