"""repro_torch.roofline — the SpMM byte model of the dtype axis and the
collective byte models of the distributed SpMM and attention."""
from .analysis import (  # noqa: F401
    predict_attention_collective_bytes,
    predict_collective_bytes,
    predict_spmm_arg_bytes,
    predict_spmm_traffic_bytes,
)
