"""Models of the port: the fused GCN layer, the two-layer GCN and graph
attention."""
from .attention import graph_attention  # noqa: F401
from .gcn import GCN, normalized_adjacency  # noqa: F401
from .layers import gcn_layer  # noqa: F401
