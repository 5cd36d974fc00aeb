"""openvision_tpu_torch -- the PyTorch and CUDA port of openvision_tpu.

A second package beside the JAX one, with the same tree and names. It
imports torch and numpy and never JAX. The encoder's Pallas kernels become
hand-written CUDA kernels for Hopper (``csrc/``, built with nvcc on first
use); each keeps a plain PyTorch version that the CPU runs.
"""
