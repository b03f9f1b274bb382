"""KV-cache containers and append (counterpart of
flash_attn_tpu/runtime/kv_cache.py).

The JAX package appends functionally and relies on buffer donation for an
in-place update; here every `update_*` function writes into the given
tensors IN PLACE (advanced-index assignment) and returns them.

Contiguous caches are (batch, kv_heads, max_seqlen, head_dim). Paged caches
are (num_pages, kv_heads, page_size, head_dim) with a (batch, max_pages)
int32 block table. The fused pool holds K|V on the last dim, each section
padded to 128 (`_lane_pad`), so pools convert one to one with the JAX
package's.

Quantized pools hold 1-byte elements (int8 or float8_e4m3fn) beside
per-kv-head dequant scales (`QuantPagedKV`): x = x_q * scale. New tokens are
quantized on write (`quantize_to_cache_dtype`) and the decode kernels
dequantize in-kernel.

The allocators place their tensors on the card unless `device` names
another (`utils.device.resolve_device`), as every entry point of the port
does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from flash_attn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class QuantPagedKV:
    """A 1-byte paged KV pool of one engine layer and its per-head dequant
    scales (the JAX package's `QuantPagedKV`): `k` and `v` hold int8 or
    float8_e4m3fn pages, or `k` is a fused K|V pool
    (`allocate_fused_paged_kv_cache` layout) and `v` is None; `k_scale` and
    `v_scale` are (hk,) fp32, and dequantization is x_q * scale."""

    k: torch.Tensor
    v: Optional[torch.Tensor]
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @property
    def fused(self) -> bool:
        return self.v is None


def quantize_to_cache_dtype(x: torch.Tensor, scale: torch.Tensor,
                            dtype: torch.dtype) -> torch.Tensor:
    """New K/V tokens (b, s, hk, d) for a 1-byte cache, with the per-head
    dequant scale (hk,): x / scale, int8 rounded half to even and clipped to
    +-127; e4m3 clipped to +-448, then |x| < 2^-6 flushed to 0, so that
    every stored pattern is normal (as the JAX package writes it)."""
    # fp32 (the scale's type) by promotion; then in place: fewer launches
    # on the decode path, which quantizes every layer's new K and V.
    xs = x / scale.to(x.device, torch.float32).reshape(1, 1, -1, 1)
    if dtype == torch.int8:
        return xs.round_().clamp_(-127, 127).to(torch.int8)
    info = torch.finfo(dtype)
    xs.clamp_(info.min, info.max)
    return xs.masked_fill_(xs.abs() < info.tiny, 0.0).to(dtype)


def quantize_kv(
    k: torch.Tensor,
    v: torch.Tensor,
    dtype: torch.dtype = torch.int8,
    head_axis: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-kv-head symmetric quantization of a KV cache (the JAX package's
    `quantize_kv`). Returns (k_q, v_q, k_scale, v_scale), scales (hk,) fp32
    = max(amax / qmax, 1e-8), qmax 127 for int8 and 448 for e4m3."""
    axes = tuple(i for i in range(k.dim()) if i != head_axis)
    qmax = 127.0 if dtype == torch.int8 else float(torch.finfo(dtype).max)

    def quant(x):
        xf = x.float()
        scale = (xf.abs().amax(dim=axes) / qmax).clamp_min(1e-8)
        shape = [1] * x.dim()
        shape[head_axis] = -1
        xq = xf / scale.reshape(shape)
        if dtype == torch.int8:
            xq = torch.round(xq).clamp(-127, 127)
        return xq.to(dtype), scale

    k_q, k_scale = quant(k)
    v_q, v_scale = quant(v)
    return k_q, v_q, k_scale, v_scale


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A 1-byte tensor as its bytes (uint8 view: index writes, pads and
    concatenations of float8 tensors are not implemented on every device),
    other tensors as they are."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` in the cache's dtype, as the cache's bytes where it is 1-byte."""
    return _raw(x.to(dtype))


def update_kv_cache(
    k_cache: torch.Tensor,  # (b, hk, smax, d)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,    # (b, snew, hk, d)
    v_new: torch.Tensor,
    cache_seqlens: torch.Tensor,  # (b,) int32 lengths BEFORE append
    *,
    cache_batch_idx: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the new tokens at each sequence's current length, in place."""
    b, snew = k_new.shape[0], k_new.shape[1]
    dev = k_cache.device
    rows = (
        cache_batch_idx.long() if cache_batch_idx is not None
        else torch.arange(b, device=dev)
    )
    pos = cache_seqlens.long()[:, None] + torch.arange(snew, device=dev)[None]
    r = rows[:, None].expand(b, snew)
    # Advanced indices around a slice put (b, snew) first: value (b, snew, hk, d).
    _raw(k_cache)[r, :, pos] = _to(k_new, k_cache.dtype)
    _raw(v_cache)[r, :, pos] = _to(v_new, v_cache.dtype)
    return k_cache, v_cache


def _page_slots(pool, cache_seqlens, block_table, snew):
    """(page ids, slots), each (b * snew,), of the new tokens. Positions past
    the block table land on the pool's last page, which the engine keeps as
    its trash page."""
    page_size = pool.shape[2]
    max_pages = block_table.shape[1]
    pos = (cache_seqlens.long()[:, None]
           + torch.arange(snew, device=pool.device)[None])
    pidx = pos // page_size
    pages = torch.gather(block_table.long(), 1, pidx.clamp(max=max_pages - 1))
    pages = torch.where(pidx < max_pages, pages, pool.shape[0] - 1)
    return pages.reshape(-1), (pos % page_size).reshape(-1)


def update_paged_kv_cache(
    k_pages: torch.Tensor,  # (npages, hk, page_size, d)
    v_pages: torch.Tensor,
    k_new: torch.Tensor,    # (b, snew, hk, d)
    v_new: torch.Tensor,
    cache_seqlens: torch.Tensor,  # (b,) lengths BEFORE append
    block_table: torch.Tensor,    # (b, max_pages) int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter the new tokens into their pages, in place."""
    b, snew, hk, d = k_new.shape
    pi, si = _page_slots(k_pages, cache_seqlens, block_table, snew)
    _raw(k_pages)[pi, :, si] = _to(k_new.reshape(b * snew, hk, d),
                                   k_pages.dtype)
    _raw(v_pages)[pi, :, si] = _to(v_new.reshape(b * snew, hk, -1),
                                   v_pages.dtype)
    return k_pages, v_pages


def allocate_kv_cache(
    batch: int,
    max_seqlen: int,
    num_heads_kv: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contiguous cache pair in (b, hk, s, d) layout."""
    device = resolve_device(device)
    shape = (batch, num_heads_kv, max_seqlen, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def allocate_paged_kv_cache(
    num_pages: int,
    page_size: int,
    num_heads_kv: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    device = resolve_device(device)
    shape = (num_pages, num_heads_kv, page_size, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _lane_pad(d: int) -> int:
    return -(-d // 128) * 128


def allocate_fused_paged_kv_cache(
    num_pages: int,
    page_size: int,
    num_heads_kv: int,
    head_dim: int,
    head_dim_v: Optional[int] = None,
    dtype=torch.bfloat16,
    device=None,
) -> torch.Tensor:
    """One pool holding K|V fused on the last dim: K at [:head_dim], V at
    [Kpad:Kpad + head_dim_v], each section padded to 128, so one page's K
    and V rows sit side by side."""
    dv = head_dim if head_dim_v is None else head_dim_v
    device = resolve_device(device)
    return torch.zeros(
        (num_pages, num_heads_kv, page_size, _lane_pad(head_dim) + _lane_pad(dv)),
        dtype=dtype, device=device,
    )


def update_fused_paged_kv_cache(
    kv_pages: torch.Tensor,  # (npages, hk, page_size, Kpad + Vpad)
    k_new: torch.Tensor,     # (b, snew, hk, d)
    v_new: torch.Tensor,     # (b, snew, hk, dv)
    cache_seqlens: torch.Tensor,  # (b,) lengths BEFORE append
    block_table: torch.Tensor,    # (b, max_pages) int32
) -> torch.Tensor:
    """Scatter the new tokens into the fused pool, in place: one write for
    K and V."""
    b, snew, hk, d = k_new.shape
    dv = v_new.shape[3]
    kvn = torch.cat(
        [F.pad(_to(k_new, kv_pages.dtype), (0, _lane_pad(d) - d)),
         F.pad(_to(v_new, kv_pages.dtype), (0, _lane_pad(dv) - dv))],
        dim=-1,
    ).reshape(b * snew, hk, kv_pages.shape[3])
    pi, si = _page_slots(kv_pages, cache_seqlens, block_table, snew)
    _raw(kv_pages)[pi, :, si] = kvn
    return kv_pages
