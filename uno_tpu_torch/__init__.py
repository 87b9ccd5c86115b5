"""uno_tpu_torch: the PyTorch/CUDA port of uno_tpu for NVIDIA Hopper.

It grows beside the JAX package ``uno_tpu``, which stays the reference the
port is tested against.  It imports ``torch`` and never ``jax``.  Its hand
written CUDA kernels live in ``csrc/`` and are built at first use
(``ops/kernels/_build.py``).
"""
