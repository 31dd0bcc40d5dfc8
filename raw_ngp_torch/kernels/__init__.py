"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version only for CPU tensors. The sources live in
``raw_ngp_torch/csrc/`` and are built on first use (``_build``).
"""
