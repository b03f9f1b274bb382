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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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
    k_cache[r, :, pos] = k_new.to(k_cache.dtype)
    v_cache[r, :, pos] = v_new.to(v_cache.dtype)
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
    k_pages[pi, :, si] = k_new.reshape(b * snew, hk, d).to(k_pages.dtype)
    v_pages[pi, :, si] = v_new.reshape(b * snew, hk, -1).to(v_pages.dtype)
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
        [F.pad(k_new, (0, _lane_pad(d) - d)),
         F.pad(v_new, (0, _lane_pad(dv) - dv))],
        dim=-1,
    ).reshape(b * snew, hk, kv_pages.shape[3])
    pi, si = _page_slots(kv_pages, cache_seqlens, block_table, snew)
    kv_pages[pi, :, si] = kvn.to(kv_pages.dtype)
    return kv_pages
