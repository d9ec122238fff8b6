"""repro_torch.sparse — formats (``QuantizedCSR`` among them), generators,
the public ``spmm``, ``sddmm``, ``segment_reduce``, ``sparse_attention``
and ``make_spmm``, and the distributed SpMM and attention over a mesh
(``dist_spmm``, ``spmm_shard_map``, ``dist_attention_shard_map`` and
their partition helpers)."""
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
from .distributed import (  # noqa: F401
    COLLECTIVES,
    dist_attention_shard_map,
    dist_spmm,
    partition_nnz_coo,
    partition_rows_coo,
    shard_nnz_counts,
    spmm_shard_map,
)
from .ops import segment_reduce, sddmm, sparse_attention, spmm  # noqa: F401
from .random import (  # noqa: F401
    GRAPH_PATTERNS,
    graph_pattern_csr,
    matrix_stats,
    power_law_csr,
    random_csr,
)
