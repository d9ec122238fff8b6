"""repro_torch.sparse — formats, generators and the public ``spmm``,
``sddmm``, ``sparse_attention`` and ``make_spmm``."""
from ..core.schedule import Epilogue, Schedule, as_schedule  # noqa: F401
from .formats import COO, CSR, ELL, GroupedCOO  # noqa: F401
from .autodiff import make_spmm  # noqa: F401
from .ops import sddmm, sparse_attention, spmm  # noqa: F401
from .random import (  # noqa: F401
    GRAPH_PATTERNS,
    graph_pattern_csr,
    matrix_stats,
    power_law_csr,
    random_csr,
)
