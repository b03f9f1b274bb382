"""Helpers shared by the port's kernel wrappers (counterpart of
flash_attn_tpu/kernels/common.py, of which only the pieces the ported
kernels need are kept here)."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

# Large-but-finite mask value, so exp(m - m) never sees inf - inf (NaN).
DEFAULT_MASK_VALUE = -0.7 * 3.4028234663852886e38  # -0.7 * float32 max

LOG2E = math.log2(math.e)

NUM_LANES = 128  # the JAX package's aux-table padding unit


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class AuxData(NamedTuple):
    """Runtime captures handed to a mask_mod as its trailing `aux`
    argument: `tensors` (lookup tables such as per-token document ids) and
    `scalars` (fp32 0-d tensors)."""

    tensors: tuple = ()
    scalars: tuple = ()


def pad_aux_table(a: torch.Tensor) -> torch.Tensor:
    """Edge-pad a 1-D aux table to a multiple of 128 entries, as the JAX
    package does before a kernel reads it. Edge mode keeps the clamped-index
    meaning of `aux_take` at the tail."""
    n = a.shape[0]
    n_pad = round_up(max(n, NUM_LANES), NUM_LANES)
    if n_pad == n:
        return a
    return torch.cat([a, a[-1:].expand(n_pad - n)])


def aux_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`table[idx]` over the flattened table, indices clamped into range;
    `idx` may have any shape (the mods receive broadcast coordinates):
        aux_take(aux.tensors[0], q_idx) == aux_take(aux.tensors[0], kv_idx)
    """
    flat = table.reshape(-1)
    return flat[idx.clamp(0, flat.shape[0] - 1)]


def aux_at(table: torch.Tensor, i) -> torch.Tensor:
    """Lookup `table[i]` for a (possibly broadcast) index, clamped, e.g.
    aux_at(aux.tensors[0], h) for a per-head table."""
    flat = table.reshape(-1)
    if not isinstance(i, torch.Tensor):
        i = torch.tensor(i, device=flat.device)
    return flat[i.clamp(0, flat.shape[0] - 1)]


def call_mod(mod, *args, aux: Optional[AuxData] = None):
    """Invoke a mask_mod, appending `aux` only when it holds captures:
    mask_mod(b, h, q_idx, kv_idx[, aux])."""
    if aux is not None and (aux.tensors or aux.scalars):
        return mod(*args, aux)
    return mod(*args)


def default_alibi_slopes(nheads: int) -> torch.Tensor:
    """Geometric ALiBi slopes, (nheads,) fp32 (the JAX package's
    `default_alibi_slopes`): for a power of two n, start * start**i with
    start = 2**(-2**-(log2 n - 3)); otherwise the closest power of two's
    slopes, then every other slope of twice that count."""

    def slopes_power_of_2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if math.log2(nheads).is_integer():
        s = slopes_power_of_2(nheads)
    else:
        closest = 2 ** math.floor(math.log2(nheads))
        s = (slopes_power_of_2(closest)
             + slopes_power_of_2(2 * closest)[0::2][: nheads - closest])
    return torch.tensor(s, dtype=torch.float32)


def normalize_window(
    window_size: Tuple[Optional[int], Optional[int]], causal: bool,
) -> Tuple[int, int]:
    """Map the (-1 = infinite) window convention onto concrete ints, as the
    JAX package does: causal sets the right edge to 0. Returns (left,
    right); a negative value means unbounded on that side."""
    left, right = window_size
    if causal:
        right = 0
    if left is None:
        left = -1
    if right is None:
        right = -1
    return int(left), int(right)


def visible_mask(seqlen_q: int, seqlen_k: int, window: Tuple[int, int],
                 device=None) -> torch.Tensor:
    """(seqlen_q, seqlen_k) bool, True where query row i sees key column j
    under a normalised window (left, right), bottom-right aligned: with
    diag = i + seqlen_k - seqlen_q, j >= diag - left (left >= 0) and
    j <= diag + right (right >= 0). The CUDA kernels apply the same rule
    per element (`fa::in_window` in csrc/mma_utils.cuh)."""
    left, right = window
    diag = (torch.arange(seqlen_q, device=device)[:, None]
            + (seqlen_k - seqlen_q))
    col = torch.arange(seqlen_k, device=device)[None]
    mask = torch.ones(seqlen_q, seqlen_k, dtype=torch.bool, device=device)
    if left >= 0:
        mask &= col >= diag - left
    if right >= 0:
        mask &= col <= diag + right
    return mask


def raise_unported(table, extras) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for the first
    argument in `extras` that the caller set to something other than its
    "not used" value; `table` maps each name to (that value, its item)."""
    for name, value in extras.items():
        unused, item = table[name]
        if value is unused or (
                not isinstance(value, torch.Tensor) and unused is not None
                and value == unused):
            continue
        raise NotImplementedError(
            f"flash attention argument {name!r} is not ported yet: ROADMAP "
            f"{item}"
        )


def rows_readable(t: torch.Tensor) -> bool:
    unit = 16 // t.element_size()  # elements of 16 bytes
    return (t.stride(-1) == 1 and not any(s % unit for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def check_rows_dense(name: str, t: torch.Tensor) -> None:
    """Raise unless `t` can be read by the kernels' 16-byte row copies:
    last dim dense, every other stride a multiple of 16 bytes (8 elements
    of a 16-bit tensor, 16 of a 1-byte one), and the base 16-byte
    aligned."""
    if not rows_readable(t):
        raise ValueError(
            f"{name} must have a dense last dim, strides that are multiples "
            f"of 16 bytes and a 16-byte aligned base; got strides "
            f"{t.stride()}"
        )


def rows_dense(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when `check_rows_dense` accepts it, else a contiguous
    copy."""
    return t if rows_readable(t) else t.contiguous()


# 1-byte KV-cache element types: int8, or fp8 e4m3 (the JAX package's
# float8_e4m3fn). The kernels take a pool of either beside q's 16-bit type.
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)


def upcast_e4m3_bits(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's integer-domain e4m3 -> bf16 upcast, on the bytes:
    a normal e4m3 s.eeee.mmm is the fp32 sign << 31 | (e + 120) << 23 |
    m << 20, a subnormal (e == 0) m * 2^-9. Exact for every e4m3 value;
    the NaN pattern 0x7F / 0xFF decodes to 480 here, where torch and the
    hardware give NaN (a cache written by `quantize_to_cache_dtype` never
    holds it)."""
    b = x.view(torch.uint8).to(torch.int32)
    sign = (b & 0x80) << 24
    expman = b & 0x7F
    bits = sign | ((expman << 20) + (120 << 23))
    sub = (expman.float() * 2.0**-9).view(torch.int32) | sign
    bits = torch.where(expman < 8, sub, bits)
    return bits.view(torch.float32).to(torch.bfloat16)


def upcast_quant_tile(x: torch.Tensor) -> torch.Tensor:
    """bf16 view of a 1-byte (int8 / e4m3) tile, exact; 16-bit tiles as
    they are."""
    if x.element_size() >= 2:
        return x
    if x.dtype == torch.int8:
        return x.to(torch.bfloat16)
    return x.float().to(torch.bfloat16)


def descale_of(scale: Optional[torch.Tensor], b: int, hk: int,
               device) -> torch.Tensor:
    """A k/v descale as (b, hk) fp32: None is 1, (hk,) is broadcast over the
    batch, (b, hk) as it is."""
    if scale is None:
        return torch.ones(b, hk, dtype=torch.float32, device=device)
    s = scale.to(device, torch.float32)
    if s.numel() == hk and s.shape[-1:] == (hk,):
        return s.reshape(1, hk).expand(b, hk)
    if s.shape != (b, hk):
        raise ValueError(f"a descale must be ({hk},) or ({b}, {hk}), got "
                         f"{tuple(s.shape)}")
    return s
