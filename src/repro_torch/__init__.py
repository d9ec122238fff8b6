"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The layout mirrors ``repro``: ``core`` (schedules, strategies, selector),
``sparse`` (formats, generators, the public ``spmm``, ``sddmm``,
``segment_reduce`` and ``sparse_attention``), ``kernels`` (hand-written
CUDA kernels for ``sm_90a`` beside their plain PyTorch versions),
``fuse`` (the fusion IR and planner), ``models`` (the GCN, the planned
two-layer GCN, graph attention, and the dense and MoE transformer LM),
``configs`` (the dense and MoE architectures), ``serve`` (the
continuous-batching engine) and ``launch`` (the serving launcher).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device they raise instead of falling back to the CPU.
"""
