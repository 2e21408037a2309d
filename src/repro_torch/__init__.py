"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

Same sub-package layout as ``repro``; each module names its counterpart.
The port imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
"""
