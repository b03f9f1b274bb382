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
                 device=None, *, attention_chunk: int = 0,
                 sink_token_length: int = 0,
                 q_segment_ids: Optional[torch.Tensor] = None,
                 kv_segment_ids: Optional[torch.Tensor] = None,
                 ) -> torch.Tensor:
    """(seqlen_q, seqlen_k) bool, True where query row i sees key column j
    under a normalised window (left, right), bottom-right aligned: with
    diag = i + seqlen_k - seqlen_q, j >= diag - left (left >= 0) and
    j <= diag + right (right >= 0). The CUDA kernels apply the same rule
    per element (`fa::in_window` in csrc/mma_utils.cuh).

    The features narrow it as the JAX kernels' mask does (and
    `fa::visible_ext` in csrc/attn_features.cuh): keys below
    sink_token_length escape the left edge (only that edge), a chunk keeps
    j in [diag - diag mod chunk, + chunk) (mod towards -inf), and segment
    ids (b, sq) and (b, sk) keep pairs of equal ids, which makes the mask
    (b, 1, seqlen_q, seqlen_k)."""
    left, right = window
    diag = (torch.arange(seqlen_q, device=device)[:, None]
            + (seqlen_k - seqlen_q))
    col = torch.arange(seqlen_k, device=device)[None]
    mask = torch.ones(seqlen_q, seqlen_k, dtype=torch.bool, device=device)
    if left >= 0:
        in_left = col >= diag - left
        if sink_token_length > 0:
            in_left |= col < sink_token_length
        mask &= in_left
    if right >= 0:
        mask &= col <= diag + right
    if attention_chunk > 0:
        lo = diag - torch.remainder(diag, attention_chunk)
        mask &= (col >= lo) & (col < lo + attention_chunk)
    if q_segment_ids is not None:
        same = (q_segment_ids.to(device)[:, :, None]
                == kv_segment_ids.to(device)[:, None, :])
        mask = (mask[None] & same)[:, None]
    return mask


# murmur3 constants of the dropout hash, in the JAX package's order (see
# csrc/dropout.cuh): seed, batch, head, row, col multipliers, then fmix32's
# two.
MURMUR3 = (0x27D4EB2F, 0x165667B1, 0x9E3779B9, 0x9E3779B1, 0x85EBCA77,
           0x85EBCA6B, 0xC2B2AE35)
_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 on int64 holding uint32 values, without an int64
    overflow: c is split into its 16-bit halves, so no product passes
    2^48."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & _U32


def keep_threshold(keep_prob: float) -> int:
    """The dropout hash's threshold, min(int(keep_prob 2^32), 2^32 - 1),
    computed in Python floats as the JAX wrapper does."""
    return min(int(keep_prob * (2**32)), 2**32 - 1)


def dropout_keep_mask(seed: int, b, h, row0: int, col0: int,
                      shape: Tuple[int, int], keep_prob: float,
                      device=None) -> torch.Tensor:
    """The JAX package's `_dropout_keep_mask` (flash_attn_tpu/kernels/
    flash_fwd.py:67) in torch: bool of `shape` (rows, cols), broadcast
    against b and h (ints, or int tensors such as (b, 1, 1, 1) and
    (1, n, 1, 1)), True where the element at absolute row row0 + i and
    column col0 + j of batch row b and query head h is kept. Every product
    wraps in uint32 on int64 tensors masked to 32 bits (torch has no
    wrapping uint32 multiply); the seed enters as its 32 low bits (a
    negative seed as its two's complement). The kernels draw the same bits
    (csrc/dropout.cuh)."""
    c_seed, c_b, c_h, c_row, c_col, c_m1, c_m2 = MURMUR3
    b = torch.as_tensor(b, dtype=torch.int64, device=device)
    h = torch.as_tensor(h, dtype=torch.int64, device=device)
    rows = torch.arange(row0, row0 + shape[0], dtype=torch.int64,
                        device=device)[:, None]
    cols = torch.arange(col0, col0 + shape[1], dtype=torch.int64,
                        device=device)[None]
    base = ((int(seed) & _U32) * c_seed & _U32)
    base = (base + _mul32(b & _U32, c_b) + _mul32(h & _U32, c_h)) & _U32
    x = _mul32(rows & _U32, c_row) ^ _mul32(cols & _U32, c_col) ^ base
    x = x ^ (x >> 16)
    x = _mul32(x, c_m1)
    x = x ^ (x >> 13)
    x = _mul32(x, c_m2)
    x = x ^ (x >> 16)
    return x < keep_threshold(keep_prob)


def alibi_bias(slopes: torch.Tensor, heads: slice, seqlen_q: int,
               seqlen_k: int, device=None,
               offset: Optional[int] = None) -> torch.Tensor:
    """The ALiBi term -slope |j - i - offset| of query heads `heads`, fp32
    natural-log units, (1 or b, n, seqlen_q, seqlen_k), from slopes (h,) or
    (b, h) (the JAX kernels subtract it in base 2, after the softcap). The
    diagonal's offset is seqlen_k - seqlen_q unless given (a packed
    sequence's is used_k - used_q)."""
    s = slopes.to(device=device, dtype=torch.float32)
    s = s.reshape(1, -1) if s.dim() == 1 else s
    if offset is None:
        offset = seqlen_k - seqlen_q
    rel = (torch.arange(seqlen_k, device=device)[None]
           - torch.arange(seqlen_q, device=device)[:, None]
           - offset).abs().float()
    return -s[:, heads, None, None] * rel


def fold_seed(seed: int, *data: int) -> int:
    """A dropout seed (int32 range) derived from `seed` and the ints
    `data` (a step, a microbatch, a layer index) by murmur3's fmix32, so
    that each step and each layer draw their own mask from one host int,
    with no device read."""
    x = int(seed) & _U32
    for d in data:
        x = (x ^ ((int(d) * 0x9E3779B9) & _U32)) & _U32
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & _U32
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & _U32
        x ^= x >> 16
    return x - (1 << 32) if x >= (1 << 31) else x


class Features(NamedTuple):
    """The dense kernels' features beyond scale, window, GQA and softcap
    (kernels 1-3, csrc/attn_features.cuh): ALiBi slopes (h,) or (b, h),
    the learnable sink (h,), segment ids (b, sq) and (b, sk),
    attention_chunk, sink_token_length, and dropout with its seed (an int;
    its 32 low bits are used).

    A packed sequence of the varlen kernels (6-8) sets the two coordinates
    of its slice: `origin`, the absolute (row, column) of its first query
    row and key in the keep mask (batch row 0), and `diag_offset`, its
    ALiBi diagonal's offset (used_k - used_q); None is seqlen_k -
    seqlen_q."""

    alibi_slopes: Optional[torch.Tensor] = None
    sink: Optional[torch.Tensor] = None
    q_segment_ids: Optional[torch.Tensor] = None
    kv_segment_ids: Optional[torch.Tensor] = None
    attention_chunk: int = 0
    sink_token_length: int = 0
    dropout_p: float = 0.0
    dropout_seed: int = 0
    origin: Tuple[int, int] = (0, 0)
    diag_offset: Optional[int] = None

    @property
    def extended(self) -> bool:
        """Whether the score or visibility rules change (not dropout)."""
        return (self.alibi_slopes is not None or self.sink is not None
                or self.q_segment_ids is not None or self.attention_chunk > 0
                or self.sink_token_length > 0)

    def visible(self, seqlen_q, seqlen_k, window, device):
        return visible_mask(seqlen_q, seqlen_k, window, device,
                            attention_chunk=self.attention_chunk,
                            sink_token_length=self.sink_token_length,
                            q_segment_ids=self.q_segment_ids,
                            kv_segment_ids=self.kv_segment_ids)

    def keep(self, b: int, heads: slice, seqlen_q: int, seqlen_k: int,
             device) -> torch.Tensor:
        """The keep mask (b, n, seqlen_q, seqlen_k) of query heads
        `heads`."""
        return dropout_keep_mask(
            self.dropout_seed, torch.arange(b).reshape(-1, 1, 1, 1),
            torch.arange(heads.start, heads.stop).reshape(1, -1, 1, 1),
            *self.origin, (seqlen_q, seqlen_k), 1.0 - self.dropout_p,
            device=device)


def seed_int(seed) -> int:
    """A dropout seed as a host int: an int, a numpy or CPU scalar, or a
    CUDA scalar tensor (read back, one host sync)."""
    if seed is None:
        return 0
    if isinstance(seed, torch.Tensor):
        return int(seed.reshape(()).item())
    return int(seed)


def make_features(*, alibi_slopes=None, sink=None, q_segment_ids=None,
                  kv_segment_ids=None, attention_chunk: int = 0,
                  sink_token_length: int = 0, dropout_p: float = 0.0,
                  dropout_seed=None) -> Optional[Features]:
    """`Features` of the JAX signature's arguments, or None when none is
    set; raises ValueError on what the kernels do not take."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    if not 0.0 <= float(dropout_p) < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if attention_chunk < 0 or sink_token_length < 0:
        raise ValueError("attention_chunk and sink_token_length must be >= 0")
    f = Features(alibi_slopes, sink, q_segment_ids, kv_segment_ids,
                 int(attention_chunk), int(sink_token_length),
                 float(dropout_p),
                 seed_int(dropout_seed) if dropout_p > 0 else 0)
    return f if f.extended or f.dropout_p > 0 else None


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
    copy with every stride rewritten (`contiguous()` would return a
    tensor whose only odd stride is on a size-1 dimension, such as the
    gradients autograd hands a batch of one, as it is)."""
    return (t if rows_readable(t)
            else t.clone(memory_format=torch.contiguous_format))


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
