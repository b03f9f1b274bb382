"""Decode attention dispatcher (counterpart of
flash_attn_tpu/kernels/flash_decode.py `flash_attention_decode`).

Only the two paged routes to the multipage kernel are ported
(flash_attn_tpu/kernels/flash_decode.py:337-402): a fused K|V page pool, and
split K and V page pools. Every other route runs the general decode kernel
(`_decode_kernel`), which is not ported yet, and raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import torch

from flash_attn_tpu_torch.kernels.flash_decode_multipage import (
    flash_attention_decode_multipage,
)

_GENERAL_KERNEL = "ROADMAP queue 2, kernel 5 (flash_decode.py _decode_kernel)"


def flash_attention_decode(
    q: torch.Tensor,        # (b, sq, h, d) new query tokens
    k_cache: torch.Tensor,  # paged (npages, hk, page, d), or a fused pool
    v_cache: Optional[torch.Tensor],
    cache_seqlens: torch.Tensor,  # (b,) int32 TOTAL valid lengths
    *,
    qv: Optional[torch.Tensor] = None,
    block_table: Optional[torch.Tensor] = None,  # (b, max_pages) int32
    cache_batch_idx: Optional[torch.Tensor] = None,
    cache_leftpad: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    sink: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    causal: bool = True,
    window_left: int = -1,
    attention_chunk: int = 0,
    sink_token_length: int = 0,
    softcap: float = 0.0,
    fused_kv_dim: int = 0,
    fused_kv_dim_v: int = 0,
):
    """Decode attention over a paged KV cache. Returns (out (b, sq, h, d),
    lse (b, h, sq) fp32). Causal within the new tokens: query token i of sq
    attends cache positions <= seqlen - sq + i."""
    unported = {
        "a contiguous cache (block_table=None)": block_table is None,
        "causal=False": not causal,
        "cache_batch_idx": cache_batch_idx is not None,
        "cache_leftpad": cache_leftpad is not None,
        "alibi_slopes": alibi_slopes is not None,
        "sink": sink is not None,
        "attention_chunk": attention_chunk != 0,
        "sink_token_length": sink_token_length != 0,
    }
    missing = [name for name, hit in unported.items() if hit]
    if missing:
        raise NotImplementedError(
            f"decode with {', '.join(missing)} needs the general decode "
            f"kernel, not ported yet: {_GENERAL_KERNEL}"
        )
    if fused_kv_dim > 0 and v_cache is not None:
        raise ValueError("a fused K|V pool takes v_cache=None")
    return flash_attention_decode_multipage(
        q, k_cache, v_cache, cache_seqlens, block_table, qv=qv,
        fused_kv_dim=fused_kv_dim, fused_kv_dim_v=fused_kv_dim_v,
        k_scale=k_scale, v_scale=v_scale, softmax_scale=softmax_scale,
        window_left=window_left, softcap=softcap,
    )
