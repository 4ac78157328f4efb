"""Hand-written Hopper kernels and their wrappers.

Each wrapper launches its CUDA kernel (``csrc/``) for CUDA tensors and runs
its plain PyTorch version for CPU tensors (``dispatch``); the library is
built at first launch (``_build``).
"""
