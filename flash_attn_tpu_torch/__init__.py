"""PyTorch and CUDA port of flash_attn_tpu for NVIDIA Hopper (H100).

The JAX package `flash_attn_tpu` stays the reference; this package mirrors
its module tree and public names. Hand-written CUDA kernels live in `csrc/`
and build with `nvcc` at first use (see `kernels/_build.py`).
"""
