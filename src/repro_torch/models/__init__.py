"""Models of the port: the fused GCN layer and the two-layer GCN."""
from .gcn import GCN, normalized_adjacency  # noqa: F401
from .layers import gcn_layer  # noqa: F401
