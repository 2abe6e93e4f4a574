"""PyTorch/CUDA port of ``repro`` (the JAX/TPU reference package).

The port runs on an NVIDIA GPU by default; pass ``device="cpu"`` (as the
tests do) to use the kernels' plain versions.  It imports nothing of JAX or
of the reference package.
"""
