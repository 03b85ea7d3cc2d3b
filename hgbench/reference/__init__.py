"""Plain references, in PyTorch and NumPy, that decide ``correct``.

They import neither ``jax`` nor the JAX package nor anything of the
program, take only what the benchmark made (inputs and weights), and work
out again whatever the program derived from them.
"""
