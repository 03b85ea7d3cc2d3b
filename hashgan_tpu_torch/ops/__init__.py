"""Packed-code ops: sign->bitpack, Hamming distances and the exact top-k
engines.

Every CUDA kernel (``hashgan_tpu_torch/csrc``) is reached through a wrapper
here that launches it for CUDA tensors and runs its plain PyTorch twin for
CPU tensors; ``_build`` compiles, loads and counts the kernels. The host
oracles are ``ref_numpy`` (numpy) and ``native`` (a C++ scanner built by
g++, independent of the CUDA kernels).
"""
