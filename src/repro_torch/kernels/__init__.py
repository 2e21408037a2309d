"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their plain PyTorch
versions, and the oracles in ``ref.py``.  Importing needs no nvcc: a kernel
is built on its first launch (``_build.py``)."""
