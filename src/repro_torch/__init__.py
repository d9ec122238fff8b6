"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The layout mirrors ``repro``: ``core`` (schedules, strategies, selector),
``sparse`` (formats, generators, the public ``spmm``), ``kernels``
(hand-written CUDA kernels for ``sm_90a`` beside their plain PyTorch
versions) and ``models`` (the GCN).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device they raise instead of falling back to the CPU.
"""
