"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and
their plain PyTorch versions.  Importing this package builds nothing:
each library is compiled at its first launch (``kernels.build``)."""
