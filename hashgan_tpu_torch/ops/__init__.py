"""Packed-code ops: sign->bitpack and the exact top-k engine.

Every CUDA kernel (``hashgan_tpu_torch/csrc``) is reached through a wrapper
here that launches it for CUDA tensors and runs its plain PyTorch twin for
CPU tensors; ``_build`` compiles, loads and counts the kernels.
"""
