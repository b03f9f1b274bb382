"""Helpers shared by the port's kernel wrappers (counterpart of
flash_attn_tpu/kernels/common.py, of which only the pieces the paged-decode
path needs are kept here)."""

from __future__ import annotations

import math

# Large-but-finite mask value, so exp(m - m) never sees inf - inf (NaN).
DEFAULT_MASK_VALUE = -0.7 * 3.4028234663852886e38  # -0.7 * float32 max

LOG2E = math.log2(math.e)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
