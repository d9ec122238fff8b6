"""repro_torch.roofline — the SpMM byte model of the dtype axis."""
from .analysis import predict_spmm_arg_bytes, predict_spmm_traffic_bytes  # noqa: F401
