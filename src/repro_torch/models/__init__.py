"""Models of the port: the fused GCN layer, the two-layer GCN, graph
attention, and the transformer LM (dense and MoE) behind ``get_model``."""
from .attention import graph_attention  # noqa: F401
from .gcn import GCN, normalized_adjacency  # noqa: F401
from .layers import gcn_layer, gcn_two_layer  # noqa: F401
from .registry import ModelApi, get_model  # noqa: F401
