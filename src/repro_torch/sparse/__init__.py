"""repro_torch.sparse — formats (``QuantizedCSR`` among them), generators
and the public ``spmm``,
``sddmm``, ``segment_reduce``, ``sparse_attention`` and ``make_spmm``."""
from ..core.schedule import Epilogue, Schedule, as_schedule  # noqa: F401
from .formats import (  # noqa: F401
    COO,
    CSR,
    ELL,
    GroupedCOO,
    QuantizedCSR,
    dequantize,
    quantize_csr,
)
from .autodiff import make_spmm  # noqa: F401
from .ops import segment_reduce, sddmm, sparse_attention, spmm  # noqa: F401
from .random import (  # noqa: F401
    GRAPH_PATTERNS,
    graph_pattern_csr,
    matrix_stats,
    power_law_csr,
    random_csr,
)
