"""PyTorch and CUDA port of flash_attn_tpu for NVIDIA Hopper (H100).

The JAX package `flash_attn_tpu` stays the reference; this package mirrors
its module tree and public names. Hand-written CUDA kernels live in `csrc/`
and build with `nvcc` at first use (see `kernels/_build.py`).
"""

from flash_attn_tpu_torch.flash_attn_interface import (
    compile_flash_attn_varlen_func_from_specs,
    flash_attn_combine,
    flash_attn_func,
    flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func,
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_varlen_qkvpacked_func,
    flash_attn_with_kvcache,
    sparse_attn_func,
)
from flash_attn_tpu_torch.kernels.flash_varlen import (
    VarlenPlan,
    make_varlen_plan,
)

__all__ = [
    "VarlenPlan",
    "compile_flash_attn_varlen_func_from_specs",
    "flash_attn_combine",
    "flash_attn_func",
    "flash_attn_kvpacked_func",
    "flash_attn_qkvpacked_func",
    "flash_attn_varlen_func",
    "flash_attn_varlen_kvpacked_func",
    "flash_attn_varlen_qkvpacked_func",
    "flash_attn_with_kvcache",
    "make_varlen_plan",
    "sparse_attn_func",
]
